"""Landmark / face detection backends (offline prep and benchmark eval
only, never on the train path; numpy on the host).

The port's copy of ``sr3d_tpu/utils/landmarks.py``: a RETINAFACE backend
(insightface) and a FAN backend (face_alignment), both returning
``(bboxes [N,5], kpss [N,5,2])`` with the FAN 68→5 keypoint reduction
(eye centres from lmk51 pairs, nose, mouth corners).  Both packages are
optional: construction imports them and raises ``ImportError`` where they
are absent, and the detection-free ``center_fallback`` keeps pipelines
runnable.
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger("sr3d_torch")

RETINAFACE = "RETINAFACE"
FAN = "FAN"


def fan_landmarks_to_kps(lmks68: np.ndarray) -> np.ndarray:
    """[N,68,2] FAN landmarks → [N,5,2] arcface keypoints: lmk51 indices
    20/27 → eye pair means, 13 nose, 43/47 mouth."""
    lmk51 = np.asarray(lmks68)[:, 17:, :]
    kpss = lmk51[:, [20, 27, 13, 43, 47], :].copy()
    kpss[:, 0, :] = lmk51[:, [21, 24], :].mean(1)   # left-eye centre
    kpss[:, 1, :] = lmk51[:, [27, 29], :].mean(1)   # right-eye centre
    return kpss


class LandmarksDetector:
    def __init__(self, model: str = "retinaface", det_size: int = 224):
        self.predictor = model.upper()
        if self.predictor == RETINAFACE:
            from insightface.app import FaceAnalysis  # gated import

            self._detector = FaceAnalysis(name="antelopev2")
            self._detector.prepare(ctx_id=-1, det_size=(det_size, det_size))
        elif self.predictor == FAN:
            import face_alignment  # gated import

            self._detector = face_alignment.FaceAlignment(
                face_alignment.LandmarksType.TWO_D, device="cpu")
        else:
            raise ValueError(f"landmark predictor not supported: {model}")
        logger.info("[DETECTOR] Selected %s as landmark detector.",
                    self.predictor)

    def detect(self, img: np.ndarray):
        """img: uint8 BGR (the reference feeds cv2 images).  Returns
        (bboxes [N,5], kpss [N,5,2])."""
        if self.predictor == RETINAFACE:
            return self._detector.det_model.detect(img, max_num=0,
                                                   metric="default")
        lmks, scores, boxes = self._detector.get_landmarks_from_image(
            img, return_landmark_score=True, return_bboxes=True)
        if boxes is None:
            return np.empty(0), np.empty(0)
        return np.stack(boxes), fan_landmarks_to_kps(np.stack(lmks))


def center_fallback(img: np.ndarray):
    """Detection-free stand-in: one full-image bbox + centred 5 keypoints
    roughly at canonical face positions (keeps prep runnable without the
    detector packages)."""
    h, w = img.shape[:2]
    bbox = np.array([[0, 0, w, h, 1.0]], np.float32)
    kps = np.array([[[0.35, 0.40], [0.65, 0.40], [0.50, 0.58],
                     [0.38, 0.76], [0.62, 0.76]]], np.float32)
    kps = kps * np.array([w, h], np.float32)
    return bbox, kps
