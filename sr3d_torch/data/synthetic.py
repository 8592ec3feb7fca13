"""Procedural synthetic faces, for the train steps of the tests and of
``chip_smoke.py`` while no face data is in the repository.

The port's copy of ``sr3d_tpu/data/synthetic.py::synthetic_face_batch``
(numpy; the same images for a seed).
"""

from __future__ import annotations

import numpy as np


def synthetic_face_batch(n: int, size: int, seed: int = 0) -> np.ndarray:
    """``[n, size, size, 3]`` float32 in [−1, 1]: smooth blob-and-gradient
    images with face-like structure (ellipse, two eyes, a mouth)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    out = np.zeros((n, size, size, 3), np.float32)
    for i in range(n):
        cx, cy = 0.5 + rng.uniform(-0.08, 0.08, 2)
        a, b = 0.32 + rng.uniform(-0.05, 0.05), 0.42 + rng.uniform(-0.05, 0.05)
        skin = rng.uniform(0.3, 0.9, 3)
        bg = rng.uniform(-0.9, -0.2, 3)
        face = np.exp(-(((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2) ** 2)
        img = bg[None, None] + (skin - bg)[None, None] * face[..., None]
        for ex in (cx - 0.13, cx + 0.13):
            eye = np.exp(-(((xx - ex) / 0.05) ** 2
                           + ((yy - (cy - 0.1)) / 0.035) ** 2))
            img -= 0.9 * eye[..., None]
        mouth = np.exp(-(((xx - cx) / 0.12) ** 2
                         + ((yy - (cy + 0.18)) / 0.03) ** 2))
        img -= 0.5 * mouth[..., None] * np.array([0.2, 0.7, 0.7])
        out[i] = np.clip(img, -1, 1)
    return out
