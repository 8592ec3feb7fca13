"""The benchmark's inputs, made from the seed: synthetic LR faces and a
synthetic FLAME.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* ``synthetic_face_batch``: copied from ``sr3d_torch/data/synthetic.py`` at
  commit b9e9277;
* ``synthetic_flame``: the arrays of ``sr3d_torch/models/flame.py::
  synthetic_flame`` at commit b9e9277, returned as numpy (the harness wraps
  them for the program, the reference reads them as they are).

Both draw from ``np.random.RandomState``, which takes a seed below 2**32:
``seed32`` folds the run's seed (any whole number) into that range.
"""

from __future__ import annotations

import hashlib

import numpy as np


def seed32(seed: int, salt: str) -> int:
    """A 32-bit seed for ``salt``'s draws, from any whole number."""
    h = hashlib.sha256(f"{int(seed)}:{salt}".encode()).digest()
    return int.from_bytes(h[:4], "little")


def synthetic_face_batch(n: int, size: int, seed: int = 0) -> np.ndarray:
    """[n, size, size, 3] float32 in [-1, 1]: smooth blob-and-gradient images
    with face-ish structure (ellipse + two eyes + mouth), deterministic."""
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


def lr_faces_u8(n: int, size: int, seed: int) -> np.ndarray:
    """``n`` LR faces as the serving CLI reads them from image files:
    [n, size, size, 3] uint8."""
    f = synthetic_face_batch(n, size, seed)
    return ((f + 1.0) / 2.0 * 255.0).round().astype(np.uint8)


def synthetic_flame(n_vertices: int, n_shape: int, n_exp: int,
                    n_faces: int, seed: int) -> dict:
    """Random FLAME arrays with the real structure (5 joints, 4 pose-joint
    basis, static 51 + dynamic 79×17 + full 68 landmark tables).  Returns
    numpy arrays under the program's ``FlameModel`` field names, with
    ``parents``."""
    rng = np.random.RandomState(seed)
    J = 5
    F = n_faces
    faces = rng.randint(0, n_vertices, size=(F, 3)).astype(np.int32)
    parents = np.array([-1, 0, 1, 1, 1], dtype=np.int32)
    lbs_w = rng.rand(n_vertices, J).astype(np.float32)
    lbs_w /= lbs_w.sum(1, keepdims=True)
    jreg = rng.rand(J, n_vertices).astype(np.float32)
    jreg /= jreg.sum(1, keepdims=True)

    def bary(*shape):
        b = rng.rand(*shape, 3).astype(np.float32)
        return b / b.sum(-1, keepdims=True)

    arrays = dict(faces=faces)
    arrays["v_template"] = rng.randn(n_vertices, 3).astype(np.float32) * 0.1
    arrays["shapedirs"] = rng.randn(
        n_vertices, 3, n_shape + n_exp).astype(np.float32) * 1e-2
    arrays["posedirs"] = rng.randn(
        (J - 1) * 9, n_vertices * 3).astype(np.float32) * 1e-3
    arrays["J_regressor"] = jreg
    arrays["lbs_weights"] = lbs_w
    arrays["lmk_faces_idx"] = rng.randint(0, F, size=(51,)).astype(np.int32)
    arrays["lmk_bary_coords"] = bary(51)
    arrays["dynamic_lmk_faces_idx"] = rng.randint(
        0, F, size=(79, 17)).astype(np.int32)
    arrays["dynamic_lmk_bary_coords"] = bary(79, 17)
    arrays["full_lmk_faces_idx"] = rng.randint(
        0, F, size=(68,)).astype(np.int32)
    arrays["full_lmk_bary_coords"] = bary(68)
    arrays["parents"] = parents
    return arrays
