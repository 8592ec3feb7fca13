"""NoW / Stirling benchmark harness.

The port's copy of ``sr3d_tpu/eval/tester.py``: walk a benchmark image
tree, align each face to the 112×112 ArcFace blob (``data.creation.
align_face``: insightface RetinaFace where it is installed, else the
center crop), predict the FLAME mesh on the modules' device, and export
the NoW submission bundle (``.ply`` + 7 landmarks in millimetres); then
score it: 7-landmark rigid alignment, masked point-to-surface distance,
pooled statistics.

The prediction runs on the device, a batch a call, and its vertices and
landmarks come back to the host once per batch.  The geometry is numpy and
scipy on the host in the JAX package's dtypes: its ``k = 16`` centroid
candidates are part of the result, so the numbers equal the JAX
package's.  The blob cache is the same ``.npz`` as the JAX package's, so
either package reads the other's.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from .export import landmarks_7, read_ply, write_ply

logger = logging.getLogger("sr3d_torch")

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png"}


def center_crop_blob(img_u8: np.ndarray, size: int = 112) -> np.ndarray:
    """Detection-free fallback: center square crop → resize → BGR ±1 blob."""
    from PIL import Image

    h, w = img_u8.shape[:2]
    s = min(h, w)
    y0, x0 = (h - s) // 2, (w - s) // 2
    crop = img_u8[y0:y0 + s, x0:x0 + s]
    crop = np.asarray(Image.fromarray(crop).resize((size, size),
                                                   Image.BILINEAR),
                      np.float32)
    return (crop[..., ::-1] - 127.5) / 127.5


def detect_and_blob(img_u8: np.ndarray, size: int = 112) -> np.ndarray:
    """RGB image → eval arcface blob [size,size,3] BGR ±1, made exactly
    like the training blobs: the shared ``align_face`` (RetinaFace
    norm_crop at 224, center-crop fallback) + ``arcface_blob_of``
    (224→size resample) from data/creation.py, so train and eval inputs
    do not skew."""
    from ..data.creation import align_face, arcface_blob_of

    crop = align_face(img_u8, size=224)
    if crop is None:  # pragma: no cover — detector found nothing
        return center_crop_blob(img_u8, size)
    return arcface_blob_of(crop, size).transpose(1, 2, 0)


def rigid_align_7(src_lmk7: np.ndarray, dst_lmk7: np.ndarray):
    """Similarity transform (s, R, t) minimising ‖s·R·src + t − dst‖
    (Umeyama) — the NoW protocol's 7-point rigid alignment."""
    mu_s, mu_d = src_lmk7.mean(0), dst_lmk7.mean(0)
    sc = src_lmk7 - mu_s
    dc = dst_lmk7 - mu_d
    cov = dc.T @ sc / len(src_lmk7)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (sc ** 2).sum() / len(src_lmk7)
    s = np.trace(np.diag(D) @ S) / var_s
    t = mu_d - s * R @ mu_s
    return s, R, t


def closest_point_on_triangles(p: np.ndarray, tri: np.ndarray) -> np.ndarray:
    """Closest point on each triangle to each query point (vectorized
    Ericson region test).  ``p`` broadcastable to tri[..., 0, :];
    ``tri`` [..., 3, 3].  Returns [..., 3]."""
    a, b, c = tri[..., 0, :], tri[..., 1, :], tri[..., 2, :]
    ab, ac, ap = b - a, c - a, p - a
    d1 = np.sum(ab * ap, -1)
    d2 = np.sum(ac * ap, -1)
    bp = p - b
    d3 = np.sum(ab * bp, -1)
    d4 = np.sum(ac * bp, -1)
    cp = p - c
    d5 = np.sum(ab * cp, -1)
    d6 = np.sum(ac * cp, -1)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    denom_abc = np.where(va + vb + vc != 0, va + vb + vc, 1.0)
    v_face = vb / denom_abc
    w_face = vc / denom_abc
    face_pt = a + ab * v_face[..., None] + ac * w_face[..., None]

    # edge AB
    denom_ab = np.where((d1 - d3) != 0, d1 - d3, 1.0)
    t_ab = np.clip(d1 / denom_ab, 0.0, 1.0)
    pt_ab = a + ab * t_ab[..., None]
    # edge AC
    denom_ac = np.where((d2 - d6) != 0, d2 - d6, 1.0)
    t_ac = np.clip(d2 / denom_ac, 0.0, 1.0)
    pt_ac = a + ac * t_ac[..., None]
    # edge BC
    denom_bc = np.where(((d4 - d3) + (d5 - d6)) != 0,
                        (d4 - d3) + (d5 - d6), 1.0)
    t_bc = np.clip((d4 - d3) / denom_bc, 0.0, 1.0)
    pt_bc = b + (c - b) * t_bc[..., None]

    out = face_pt
    out = np.where(((vc <= 0) & (d1 >= 0) & (d3 <= 0))[..., None], pt_ab, out)
    out = np.where(((vb <= 0) & (d2 >= 0) & (d6 <= 0))[..., None], pt_ac, out)
    out = np.where(((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0))[..., None],
                   pt_bc, out)
    out = np.where(((d1 <= 0) & (d2 <= 0))[..., None], a, out)
    out = np.where(((d3 >= 0) & (d4 <= d3))[..., None], b, out)
    out = np.where(((d6 >= 0) & (d5 <= d6))[..., None], c, out)
    return out


def point_to_surface_distance(points: np.ndarray, verts: np.ndarray,
                              faces: np.ndarray, k: int = 16) -> np.ndarray:
    """Per-point distance to the mesh *surface* (point-to-triangle), the
    official NoW protocol's error measure — point-to-nearest-vertex
    systematically overestimates it.  Candidate triangles come from a
    KD-tree over triangle centroids (k per point; exact on face meshes
    whose triangles are small relative to spacing)."""
    tris = verts[faces]                                # [F,3,3]
    if len(faces) <= 2048:
        # exact: test every triangle (chunked over points)
        out = np.empty(len(points))
        for i in range(0, len(points), 4096):
            p = points[i:i + 4096]
            closest = closest_point_on_triangles(
                p[:, None, :], tris[None, :, :, :])
            out[i:i + 4096] = np.linalg.norm(
                closest - p[:, None, :], axis=-1).min(axis=1)
        return out
    from scipy.spatial import cKDTree

    k = min(k, len(faces))
    _, idx = cKDTree(tris.mean(1)).query(points, k=k)
    idx = np.atleast_2d(idx)
    if idx.shape[0] != len(points):
        idx = idx.reshape(len(points), -1)
    cand = tris[idx]                                   # [P,k,3,3]
    closest = closest_point_on_triangles(points[:, None, :], cand)
    d = np.linalg.norm(closest - points[:, None, :], axis=-1)
    return d.min(axis=1)


def mask_scan_points(scan_mm: np.ndarray, mask: np.ndarray | None = None,
                     lmk7_mm: np.ndarray | None = None,
                     radius_mm: float | None = None) -> np.ndarray:
    """Face-region masking of a raw GT scan — the official NoW protocol
    computes distances only over the *masked* (face-cropped) scan region
    (the reference outsources this to ``now_validation.sh``, which consumes
    pre-masked scans — lib/MICA/micalib/validator.py:180-195).  Feeding a
    full raw head/bust scan inflates the error with hair/neck/shoulder
    points that have no counterpart on the FLAME face mesh.

    ``mask`` may be a boolean array over scan points or an integer index
    array (the NoW release ships per-scan face-region index masks).
    Alternatively ``radius_mm`` crops to points within that distance of the
    7-landmark centroid — a reasonable stand-in when no official mask is
    available (the face fits comfortably in ~95 mm).  Explicit ``mask``
    wins when both are given."""
    if mask is not None:
        mask = np.asarray(mask)
        n = scan_mm.shape[0]
        if mask.dtype == np.bool_:
            if mask.shape[0] != n:
                raise ValueError(
                    f"boolean scan mask has {mask.shape[0]} entries for "
                    f"{n} scan points")
            out = scan_mm[mask]
        else:
            idx = mask.astype(np.int64).ravel()
            # an int-typed 0/1 array of per-point length is a boolean mask
            # saved without the bool dtype (common via image tools /
            # casts) — indexing with it would silently collapse the scan
            # to copies of points 0 and 1
            if idx.shape[0] == n and idx.size and idx.min() >= 0 \
                    and idx.max() <= 1 and n > 2:
                import warnings

                warnings.warn(
                    "scan mask is an int-typed 0/1 array of per-point "
                    "length — interpreting it as a boolean mask, not "
                    "point indices; save masks with dtype=bool (or as a "
                    "proper index list) to silence this", stacklevel=2)
                out = scan_mm[idx.astype(bool)]
            else:
                if idx.size and (idx.min() < 0 or idx.max() >= n):
                    raise ValueError(
                        f"scan index mask has entries outside [0, {n}) "
                        f"(min {idx.min()}, max {idx.max()})")
                out = scan_mm[idx]
    elif radius_mm is not None:
        if lmk7_mm is None:
            raise ValueError("radius_mm cropping needs the scan's lmk7")
        d = np.linalg.norm(scan_mm - np.asarray(lmk7_mm).mean(0), axis=-1)
        out = scan_mm[d <= float(radius_mm)]
    else:
        return scan_mm
    if scan_mm.shape[0] and not out.shape[0]:
        raise ValueError(
            "scan face-masking selected 0 of %d points — an all-False "
            "mask, or a crop radius smaller than every landmark-centroid "
            "distance (unit mismatch? scans/landmarks must be in mm); "
            "NoW statistics over an empty scan would be nan"
            % scan_mm.shape[0])
    return out


def now_distance(pred_verts_mm: np.ndarray, pred_lmk7_mm: np.ndarray,
                 scan_points_mm: np.ndarray,
                 scan_lmk7_mm: np.ndarray,
                 faces: np.ndarray | None = None) -> dict:
    """NoW error: 7-point rigid align pred→scan, then per-scan-point
    distance to the aligned prediction (mm) — point-to-surface when
    ``faces`` is given (the official protocol,
    reference lib/MICA/micalib/tester.py:242-334 exports feed
    now_evaluation's masked point-to-surface), else nearest-vertex."""
    s, R, t = rigid_align_7(pred_lmk7_mm, scan_lmk7_mm)
    aligned = (s * (R @ pred_verts_mm.T)).T + t
    if faces is not None:
        d = point_to_surface_distance(scan_points_mm, aligned,
                                      np.asarray(faces))
    else:
        from scipy.spatial import cKDTree

        d, _ = cKDTree(aligned).query(scan_points_mm, k=1)
    return {"median": float(np.median(d)), "mean": float(np.mean(d)),
            "std": float(np.std(d))}


def _host(x) -> np.ndarray:
    """A prediction output as a host array (one device → host copy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


class Tester:
    """``predict_fn(modules, state, blobs)`` → ``(vertices [B, V, 3],
    shape code, landmarks [B, 68, 3])`` for NHWC blobs on the modules'
    device (``train.mica_only.make_mica_predict()``)."""

    def __init__(self, modules, predict_fn, cache_path: str | None = None):
        self.modules = modules
        self.predict = predict_fn
        # np.savez appends .npz to suffix-less names; normalise so the
        # cache-hit check tests the file that actually gets written
        if cache_path and not str(cache_path).endswith(".npz"):
            cache_path = str(cache_path) + ".npz"
        self.cache_path = cache_path

    def _predict(self, state, blobs: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
        """One batch on the modules' device → (vertices, landmarks) on the
        host."""
        x = torch.from_numpy(blobs).to(self.modules.device)
        verts, _, lmk68 = self.predict(self.modules, state, x)
        return _host(verts), _host(lmk68)

    def _load_blobs(self, image_root: str | os.PathLike) -> dict:
        """{relative/path/stem: blob} ('/'-separated), cached like the
        reference's ``test_now_cache.pt`` (tester.py:179-196)."""
        if self.cache_path and Path(self.cache_path).exists():
            data = np.load(self.cache_path, allow_pickle=True)
            return {k: data[k] for k in data.files}
        from PIL import Image

        blobs = {}
        root = Path(image_root)
        for p in sorted(root.rglob("*")):
            if p.suffix.lower() in IMG_EXTENSIONS:
                img = np.asarray(Image.open(p).convert("RGB"))
                key = str(p.relative_to(root).with_suffix("")).replace(
                    os.sep, "/")
                blobs[key] = detect_and_blob(img)
        if self.cache_path:
            Path(self.cache_path).parent.mkdir(parents=True, exist_ok=True)
            np.savez(self.cache_path, **blobs)
        return blobs

    def run(self, state, image_root: str | os.PathLike,
            out_dir: str | os.PathLike, batch: int = 8) -> int:
        """Predict + export the OFFICIAL NoW submission tree
        (reference tester.py:288-334):
        ``{out}/predicted_meshes/{subject}/{challenge}/{image}.ply`` (mm)
        + ``{image}.npy`` 7-landmark (mm) — the layout the official NoW
        evaluation consumes.  ``image_root`` is the NoW pictures tree
        (``{subject}/{challenge}/{image}.jpg``); shallower trees keep
        their relative structure.  Returns #images."""
        blobs = self._load_blobs(image_root)
        keys = sorted(blobs.keys())
        out = Path(out_dir) / "predicted_meshes"
        faces = _host(self.modules.flame.faces)
        for i in range(0, len(keys), batch):
            chunk = keys[i:i + batch]
            arr = np.stack([np.asarray(blobs[k], np.float32)
                            for k in chunk])
            verts, lmk68 = self._predict(state, arr)
            for j, key in enumerate(chunk):
                dst = out.joinpath(*key.split("/")[:-1])
                dst.mkdir(parents=True, exist_ok=True)
                stem = key.split("/")[-1]
                write_ply(dst / f"{stem}.ply", verts[j] * 1000.0, faces)
                np.save(dst / f"{stem}.npy",
                        landmarks_7(np.asarray(lmk68[j]).reshape(68, 3))
                        * 1000.0)
        logger.info("tester: exported %d predictions -> %s", len(keys), out)
        return len(keys)

    def run_stirling(self, state, pictures_root: str | os.PathLike,
                     out_dir: str | os.PathLike, batch: int = 8) -> dict:
        """Stirling benchmark with the HQ/LQ split (reference
        tester.py:198-286): walks
        ``{root}/Real_images__Subset_2D_FG2018/{HQ,LQ}/*.jpg``, groups by
        the 9-char uppercase actor prefix, and exports
        ``predicted_meshes/{quality}/{actor[:5]}/{stem}.ply`` +
        7-landmark ``.npy`` per image.  Returns per-split image counts."""
        from PIL import Image

        root = Path(pictures_root) / "Real_images__Subset_2D_FG2018"
        out = Path(out_dir) / "predicted_meshes"
        faces = _host(self.modules.flame.faces)
        counts = {}
        for quality in ("HQ", "LQ"):
            qdir = root / quality
            paths = sorted(p for p in qdir.glob("*")
                           if p.suffix.lower() in IMG_EXTENSIONS) \
                if qdir.is_dir() else []
            n = 0
            for i in range(0, len(paths), batch):
                chunk = paths[i:i + batch]
                arr = np.stack([
                    detect_and_blob(np.asarray(
                        Image.open(p).convert("RGB"))) for p in chunk
                ]).astype(np.float32)
                verts, lmk68 = self._predict(state, arr)
                for j, p in enumerate(chunk):
                    actor = p.stem[:9].upper()
                    dst = out / quality / actor[:5]
                    dst.mkdir(parents=True, exist_ok=True)
                    write_ply(dst / f"{actor}.ply", verts[j] * 1000.0,
                              faces)
                    np.save(dst / f"{actor}.npy",
                            landmarks_7(lmk68[j]) * 1000.0)
                    n += 1
            counts[quality] = n
            logger.info("tester: Stirling %s — %d images processed",
                        quality, n)
        return counts

    @staticmethod
    def evaluate_now(pred_dir: str | os.PathLike,
                     gt_dir: str | os.PathLike,
                     point_to_surface: bool = True,
                     face_crop_radius_mm: float | None = None) -> dict:
        """Score a :meth:`run` submission tree against per-SUBJECT GT scans
        — the official NoW protocol: predictions at
        ``predicted_meshes/{subject}/{challenge}/{image}.ply`` (+ ``.npy``
        7-landmarks), GT at ``{gt_dir}/{subject}/scan.npy`` [P,3] mm +
        ``lmk7.npy`` [7,3] mm (one scan per subject, every image of that
        subject is compared to it).  Statistics are computed over ALL
        distances pooled (``np.median(np.hstack(errors))`` — reference
        lib/MICA/micalib/validator.py:187-190), not per-scan means; uses
        the official masked point-to-surface distance by default.

        **Scan face-masking** (the official protocol scores only the face
        region of the scan): if ``{gt_dir}/{subject}/mask.npy`` exists it
        is applied to the scan points first (boolean [P] or integer index
        array — the NoW release's face-region masks); otherwise, when
        ``face_crop_radius_mm`` is given, the scan is cropped to points
        within that radius of its 7-landmark centroid.  A *raw* (unmasked)
        full-head scan with neither yields inflated errors — hair/neck
        points have no FLAME counterpart (see :func:`mask_scan_points`)."""
        pred_root = Path(pred_dir)
        if (pred_root / "predicted_meshes").is_dir():
            pred_root = pred_root / "predicted_meshes"

        per_image = []
        all_d = []
        n_images = 0
        for subject in sorted(p for p in pred_root.iterdir() if p.is_dir()):
            gt = Path(gt_dir) / subject.name
            if not (gt / "scan.npy").exists():
                continue
            scan = np.load(gt / "scan.npy")
            gt7 = np.load(gt / "lmk7.npy")
            mask = (np.load(gt / "mask.npy")
                    if (gt / "mask.npy").exists() else None)
            scan = mask_scan_points(scan, mask=mask, lmk7_mm=gt7,
                                    radius_mm=face_crop_radius_mm)
            for ply in sorted(subject.rglob("*.ply")):
                verts, faces = read_ply(ply)
                lmk7 = np.load(ply.with_suffix(".npy"))
                s, R, t = rigid_align_7(lmk7, gt7)
                aligned = (s * (R @ verts.T)).T + t
                if point_to_surface and len(faces):
                    d = point_to_surface_distance(scan, aligned, faces)
                else:
                    from scipy.spatial import cKDTree

                    d, _ = cKDTree(aligned).query(scan, k=1)
                all_d.append(d)
                n_images += 1
                per_image.append({
                    "image": str(ply.relative_to(pred_root).with_suffix("")),
                    "median": float(np.median(d)),
                    "mean": float(np.mean(d)), "std": float(np.std(d))})
        if all_d:
            pooled = np.hstack(all_d)
            agg = {"median": float(np.median(pooled)),
                   "mean": float(np.mean(pooled)),
                   "std": float(np.std(pooled))}
        else:
            agg = {"median": 0.0, "mean": 0.0, "std": 0.0}
        agg["n"] = n_images
        agg["per_image"] = per_image
        if all_d:
            # NoW-style cumulative error curve: fraction of scan points under
            # each mm threshold (the benchmark's standard plot)
            thresholds = np.linspace(0, 7, 15)
            agg["cumulative_curve"] = {
                "threshold_mm": thresholds.tolist(),
                "fraction": [float((pooled <= t).mean())
                             for t in thresholds],
            }
        return agg
