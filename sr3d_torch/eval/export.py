"""Mesh, landmark and image export (numpy and PIL only).

The port's copy of ``sr3d_tpu/eval/export.py`` (the writers and
``read_ply`` / ``read_obj``, which read back what they write) plus
``save_img``: per-sample ``mesh.ply`` / ``mesh.obj`` with vertices scaled
×1000 (millimetres), ``identity.npy`` shape code, ``kpt7.npy`` /
``kpt68.npy`` landmarks in mm.  The 7-point subset is
landmark_51[[19, 22, 25, 28, 16, 31, 37]] of the 68-point set.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

LANDMARK_7_OF_51 = np.array([19, 22, 25, 28, 16, 31, 37])


def landmarks_7(lmk68: np.ndarray) -> np.ndarray:
    """[...,68,3] → [...,7,3] (reference model/sr3d/model.py:396-397)."""
    lmk51 = lmk68[..., 17:, :]
    return lmk51[..., LANDMARK_7_OF_51, :]


def write_ply(path: str | os.PathLike, vertices: np.ndarray,
              faces: np.ndarray) -> None:
    """Binary-little-endian PLY, vertex xyz float32 + face vertex_indices."""
    vertices = np.asarray(vertices, dtype=np.float32)
    faces = np.asarray(faces, dtype=np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    face_rec = np.empty(
        len(faces),
        dtype=[("n", np.uint8), ("idx", np.int32, (3,))])
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(vertices.astype("<f4").tobytes())
        f.write(face_rec.tobytes())


def read_ply(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Read the binary-little-endian PLY :func:`write_ply` produces
    (xyz float32 vertices + uchar-count int32 triangle faces)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    n_vert = n_face = 0
    for line in data[:end].decode("ascii").splitlines():
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n_vert = int(parts[2])
        elif parts[:2] == ["element", "face"]:
            n_face = int(parts[2])
    verts = np.frombuffer(data, "<f4", count=n_vert * 3, offset=end
                          ).reshape(n_vert, 3)
    face_rec = np.frombuffer(
        data, dtype=[("n", np.uint8), ("idx", "<i4", (3,))],
        count=n_face, offset=end + n_vert * 12)
    return verts.copy(), face_rec["idx"].astype(np.int32)


def write_obj(path: str | os.PathLike, vertices: np.ndarray,
              faces: np.ndarray) -> None:
    vertices = np.asarray(vertices, dtype=np.float64)
    faces = np.asarray(faces, dtype=np.int64)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
        for tri in faces + 1:  # OBJ is 1-indexed
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def read_obj(path: str | os.PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Vertices (float32) and 0-based triangle faces (int32) of an OBJ;
    ``f a/b/c`` entries keep their vertex index."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(p.split("/")[0]) - 1 for p in parts[1:4]])
    return (np.asarray(verts, dtype=np.float32),
            np.asarray(faces, dtype=np.int32))


def export_prediction(
    dst: str | os.PathLike,
    vertices: np.ndarray,       # [V,3] metres
    faces: np.ndarray,          # [F,3]
    shape_code: np.ndarray,     # [n_shape]
    lmk68: np.ndarray,          # [68,3] metres (or [1,68,3])
) -> None:
    """Full per-sample export bundle in millimetres (reference :407-415)."""
    dst = Path(dst)
    dst.mkdir(parents=True, exist_ok=True)
    lmk68 = np.asarray(lmk68)
    lmk68_b = lmk68 if lmk68.ndim == 3 else lmk68[None]
    write_ply(dst / "mesh.ply", vertices * 1000.0, faces)
    write_obj(dst / "mesh.obj", vertices * 1000.0, faces)
    np.save(dst / "identity.npy", np.asarray(shape_code))
    np.save(dst / "kpt7.npy", landmarks_7(lmk68_b[0]) * 1000.0)
    np.save(dst / "kpt68.npy", lmk68_b * 1000.0)


def save_img(img: np.ndarray, img_path: str | os.PathLike) -> None:
    """Write a uint8 RGB (HWC) image as PNG."""
    from PIL import Image

    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    Image.fromarray(img).save(img_path)
