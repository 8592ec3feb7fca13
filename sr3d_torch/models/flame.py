"""FLAME 2020 head model decoder.

Counterpart of ``sr3d_tpu/models/flame.py``: the model is a frozen bundle of
buffers and the decode is a few einsums (blendshapes, joint regression,
skinning).  ``load_flame`` reads the licensed ``generic_model.pkl`` +
``landmark_embedding.npy``; ``synthetic_flame`` and ``sphere_flame`` build
structurally identical stand-ins from the same numpy ``RandomState`` code
as the JAX package, so a seed gives bit-identical arrays in both, and
``write_reference_format_assets`` writes such a stand-in in the licensed
files' formats.  The PCA-basis helpers (``project_to_shape_basis``,
``compute_distance_to_basis``, ``get_std``, ``compute_closest_shape``) run
on the model's device.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Any

import numpy as np
import torch

from . import lbs as lbs_ops


def _to_np(array: Any, dtype=np.float32) -> np.ndarray:
    """Convert FLAME pickle entries (numpy / chumpy / scipy-sparse)."""
    if hasattr(array, "todense"):
        array = array.todense()
    if hasattr(array, "r"):
        array = array.r
    return np.array(array, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class FlameModel:
    """FLAME buffers: float32/int64 tensors on one device, except the
    kinematic tree (``parents``, ``neck_kin_chain``), which stays numpy
    because the decode walks it on the host.  Real model: V=5023, J=5,
    F=9976, n_shape≤300, n_exp=100, P=36."""

    faces: torch.Tensor                    # [F, 3]
    v_template: torch.Tensor               # [V, 3]
    shapedirs: torch.Tensor                # [V, 3, n_shape + n_exp]
    posedirs: torch.Tensor                 # [P, V*3]
    J_regressor: torch.Tensor              # [J, V]
    parents: np.ndarray                    # [J], parents[0] = -1
    lbs_weights: torch.Tensor              # [V, J]
    lmk_faces_idx: torch.Tensor            # [51]
    lmk_bary_coords: torch.Tensor          # [51, 3]
    dynamic_lmk_faces_idx: torch.Tensor    # [79, 17]
    dynamic_lmk_bary_coords: torch.Tensor  # [79, 17, 3]
    full_lmk_faces_idx: torch.Tensor       # [68]
    full_lmk_bary_coords: torch.Tensor     # [68, 3]
    neck_kin_chain: np.ndarray             # [K]
    n_shape: int = 300
    n_exp: int = 100

    @property
    def n_vertices(self) -> int:
        return int(self.v_template.shape[0])


def _neck_kin_chain(parents: np.ndarray, neck_idx: int = 1) -> np.ndarray:
    chain = []
    curr = neck_idx
    while curr != -1:
        chain.append(curr)
        curr = int(parents[curr])
    return np.asarray(chain, dtype=np.int64)


def _make(arrays: dict, parents: np.ndarray, n_shape: int, n_exp: int,
          device) -> FlameModel:
    def tensor(a):
        a = np.asarray(a)
        dt = torch.int64 if np.issubdtype(a.dtype, np.integer) \
            else torch.float32
        return torch.as_tensor(a).to(device=device, dtype=dt)

    return FlameModel(**{k: tensor(v) for k, v in arrays.items()},
                      parents=np.asarray(parents, np.int64),
                      neck_kin_chain=_neck_kin_chain(parents),
                      n_shape=n_shape, n_exp=n_exp)


def load_flame(flame_model_path: str, lmk_embedding_path: str,
               n_shape: int = 300, device="cpu") -> FlameModel:
    """Load the real FLAME2020 assets; ``FileNotFoundError`` when absent."""
    with open(flame_model_path, "rb") as f:
        ss = pickle.load(f, encoding="latin1")
    shapedirs = _to_np(ss["shapedirs"])
    # the first n_shape shape dirs + the 100 expression dirs at [300:400]
    shapedirs = np.concatenate(
        [shapedirs[:, :, :n_shape], shapedirs[:, :, 300:]], axis=2)
    num_pose_basis = ss["posedirs"].shape[-1]
    posedirs = np.reshape(_to_np(ss["posedirs"]), [-1, num_pose_basis]).T
    parents = _to_np(ss["kintree_table"], dtype=np.int64)[0]
    parents[0] = -1

    lmk = np.load(lmk_embedding_path, allow_pickle=True, encoding="latin1")
    lmk = lmk[()]

    def as_np(x, dtype=np.float32):
        if hasattr(x, "detach"):  # a torch tensor stored in the npy
            x = x.detach().cpu().numpy()
        return np.asarray(x, dtype=dtype)

    return _make(dict(
        faces=_to_np(ss["f"], dtype=np.int64),
        v_template=_to_np(ss["v_template"]),
        shapedirs=shapedirs,
        posedirs=posedirs,
        J_regressor=_to_np(ss["J_regressor"]),
        lbs_weights=_to_np(ss["weights"]),
        lmk_faces_idx=as_np(lmk["static_lmk_faces_idx"], np.int64),
        lmk_bary_coords=as_np(lmk["static_lmk_bary_coords"]),
        dynamic_lmk_faces_idx=as_np(lmk["dynamic_lmk_faces_idx"], np.int64),
        dynamic_lmk_bary_coords=as_np(lmk["dynamic_lmk_bary_coords"]),
        full_lmk_faces_idx=as_np(lmk["full_lmk_faces_idx"],
                                 np.int64).reshape(-1),
        full_lmk_bary_coords=as_np(lmk["full_lmk_bary_coords"])
        .reshape(-1, 3),
    ), parents, n_shape, int(shapedirs.shape[2]) - n_shape, device)


def synthetic_flame(n_vertices: int = 128, n_shape: int = 16, n_exp: int = 8,
                    seed: int = 0, n_faces: int | None = None,
                    device="cpu") -> FlameModel:
    """Random FLAME with the real structure (5 joints, 4 pose-joint basis,
    static 51 + dynamic 79×17 + full 68 landmark tables), for tests and
    serving without the licensed assets.  ``n_faces`` defaults to the JAX
    package's ``max(2·V, 64)``; the real model has 9976."""
    rng = np.random.RandomState(seed)
    J = 5
    F = n_faces if n_faces is not None else max(2 * n_vertices, 64)
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
    return _make(arrays, parents, n_shape, n_exp, device)


def sphere_flame(n_rings: int = 16, n_segments: int = 24, n_shape: int = 16,
                 n_exp: int = 8, seed: int = 0, radius: float = 0.15,
                 amp: float = 0.012, device="cpu") -> FlameModel:
    """Renderable stand-in: a UV-sphere head whose shape space is a bank of
    smooth radial deformation fields with decaying amplitudes; zero pose is
    exactly rigid."""
    rng = np.random.RandomState(seed)
    J = 5
    ring_t = (np.arange(1, n_rings) / n_rings) * np.pi
    seg_p = (np.arange(n_segments) / n_segments) * 2 * np.pi
    tt, pp = np.meshgrid(ring_t, seg_p, indexing="ij")
    xyz = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], axis=-1).reshape(-1, 3)
    unit = np.concatenate([[[0.0, 1.0, 0.0]], xyz, [[0.0, -1.0, 0.0]]],
                          0).astype(np.float32)
    V = unit.shape[0]

    def vid(r, s):
        return 1 + r * n_segments + (s % n_segments)

    faces = []
    for s in range(n_segments):
        faces.append((0, vid(0, s), vid(0, s + 1)))
    for r in range(n_rings - 2):
        for s in range(n_segments):
            a, b = vid(r, s), vid(r, s + 1)
            c, d = vid(r + 1, s), vid(r + 1, s + 1)
            faces.append((a, c, b))
            faces.append((b, c, d))
    for s in range(n_segments):
        faces.append((V - 1, vid(n_rings - 2, s + 1), vid(n_rings - 2, s)))
    faces = np.asarray(faces, np.int32)
    F = faces.shape[0]

    K = n_shape + n_exp
    w = rng.uniform(1.0, 4.0, (K, 3)) * rng.choice([-1, 1], (K, 3))
    phi = rng.uniform(0, 2 * np.pi, K)
    prof = np.cos(unit @ w.T + phi)
    amps = amp / (1.0 + 0.15 * np.arange(K))
    shapedirs = (unit[:, :, None] * (prof * amps)[:, None, :]
                 ).astype(np.float32)
    parents = np.array([-1, 0, 1, 1, 1], dtype=np.int32)
    lbs_w = np.zeros((V, J), np.float32)
    lbs_w[:, 0] = 1.0
    jreg = np.full((J, V), 1.0 / V, np.float32)

    def bary(*shape):
        b = rng.rand(*shape, 3).astype(np.float32)
        return b / b.sum(-1, keepdims=True)

    arrays = dict(
        faces=faces, v_template=unit * radius, shapedirs=shapedirs,
        posedirs=np.zeros(((J - 1) * 9, V * 3), np.float32),
        J_regressor=jreg, lbs_weights=lbs_w)
    arrays["lmk_faces_idx"] = rng.randint(0, F, size=(51,)).astype(np.int32)
    arrays["lmk_bary_coords"] = bary(51)
    arrays["dynamic_lmk_faces_idx"] = rng.randint(
        0, F, size=(79, 17)).astype(np.int32)
    arrays["dynamic_lmk_bary_coords"] = bary(79, 17)
    arrays["full_lmk_faces_idx"] = rng.randint(
        0, F, size=(68,)).astype(np.int32)
    arrays["full_lmk_bary_coords"] = bary(68)
    return _make(arrays, parents, n_shape, n_exp, device)


def write_reference_format_assets(out_dir: str, n_vertices: int = 64,
                                  seed: int = 0) -> dict[str, str]:
    """Write a random FLAME asset set in the licensed files' on-disk
    formats: ``generic_model.pkl`` (a dict with 400-column shapedirs,
    kintree_table, posedirs ``[V, 3, 36]``, …), ``landmark_embedding.npy``
    (a pickled dict) and ``FLAME_masks.pkl``, so that :func:`load_flame`
    and the bootstrap's install run without the download.  The same files
    as the JAX package's for a seed.

    Returns ``{"flame_model": ..., "lmk_embedding": ..., "masks": ...}``.
    """
    import os

    from .masking import synthetic_masks

    rng = np.random.RandomState(seed)
    J = 5
    F = max(2 * n_vertices, 64)
    kintree = np.zeros((2, J), dtype=np.uint32)
    kintree[0] = np.array([4294967295, 0, 1, 1, 1], dtype=np.uint32)
    kintree[1] = np.arange(J, dtype=np.uint32)
    jreg = rng.rand(J, n_vertices).astype(np.float64)
    jreg /= jreg.sum(1, keepdims=True)
    lbs_w = rng.rand(n_vertices, J).astype(np.float64)
    lbs_w /= lbs_w.sum(1, keepdims=True)
    model = {
        "v_template": rng.randn(n_vertices, 3) * 0.1,
        "f": rng.randint(0, n_vertices, size=(F, 3)).astype(np.uint32),
        # the real pickle always carries 300 shape + 100 expression
        # columns; load_flame slices [:n_shape] and [300:]
        "shapedirs": rng.randn(n_vertices, 3, 400) * 1e-2,
        "posedirs": rng.randn(n_vertices, 3, (J - 1) * 9) * 1e-3,
        "kintree_table": kintree,
        "J_regressor": jreg,
        "weights": lbs_w,
    }

    def bary(*shape):
        b = rng.rand(*shape, 3).astype(np.float32)
        return b / b.sum(-1, keepdims=True)

    lmk = {
        "static_lmk_faces_idx": rng.randint(0, F, size=(51,)).astype(np.int64),
        "static_lmk_bary_coords": bary(51),
        "dynamic_lmk_faces_idx": rng.randint(
            0, F, size=(79, 17)).astype(np.int64),
        "dynamic_lmk_bary_coords": bary(79, 17),
        # the real npy stores these with a leading singleton dim
        "full_lmk_faces_idx": rng.randint(0, F, size=(1, 68)).astype(np.int64),
        "full_lmk_bary_coords": bary(1, 68),
    }

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "flame_model": os.path.join(out_dir, "generic_model.pkl"),
        "lmk_embedding": os.path.join(out_dir, "landmark_embedding.npy"),
        "masks": os.path.join(out_dir, "FLAME_masks.pkl"),
    }
    with open(paths["flame_model"], "wb") as f:
        pickle.dump(model, f)
    np.save(paths["lmk_embedding"], np.asarray(lmk, dtype=object),
            allow_pickle=True)
    with open(paths["masks"], "wb") as f:
        pickle.dump(synthetic_masks(n_vertices, seed=seed), f)
    return paths


def _find_dynamic_lmk_idx_and_bcoords(model: FlameModel,
                                      full_pose: torch.Tensor):
    """Contour-landmark table rows picked by the neck's y-rotation."""
    B = full_pose.shape[0]
    chain = model.neck_kin_chain.tolist()
    aa_pose = full_pose.view(B, -1, 3)[:, chain]
    rot_mats = lbs_ops.batch_rodrigues(aa_pose.reshape(-1, 3)) \
        .view(B, -1, 3, 3)
    rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device) \
        .expand(B, 3, 3)
    for k in range(len(chain)):
        rel = torch.matmul(rot_mats[:, k], rel)
    y = torch.round(torch.clamp(
        lbs_ops.rot_mat_to_euler(rel) * 180.0 / np.pi, max=39)).long()
    neg_mask = (y < 0).long()
    mask = (y < -39).long()
    neg_vals = mask * 78 + (1 - mask) * (39 - y)
    y = neg_mask * neg_vals + (1 - neg_mask) * y
    return model.dynamic_lmk_faces_idx[y], model.dynamic_lmk_bary_coords[y]


def flame_forward(model: FlameModel, shape_params: torch.Tensor,
                  expression_params: torch.Tensor | None = None,
                  pose_params: torch.Tensor | None = None,
                  eye_pose_params: torch.Tensor | None = None,
                  neck_pose_params: torch.Tensor | None = None):
    """FLAME decode → ``(vertices [B, V, 3], landmarks2d [B, 68, 3],
    landmarks3d [B, 68, 3])``: 2d uses the pose-dependent dynamic contour,
    3d the static full 68-point embedding."""
    B = shape_params.shape[0]
    new = shape_params.new_zeros
    if pose_params is None:
        pose_params = new(B, 6)
    if eye_pose_params is None:
        eye_pose_params = new(B, 6)
    if neck_pose_params is None:
        neck_pose_params = new(B, 3)
    if expression_params is None:
        expression_params = new(B, model.n_exp)
    betas = torch.cat([shape_params, expression_params], dim=1)
    full_pose = torch.cat([pose_params[:, :3], neck_pose_params,
                           pose_params[:, 3:], eye_pose_params], dim=1)
    vertices, _ = lbs_ops.lbs(
        betas, full_pose, model.v_template, model.shapedirs, model.posedirs,
        model.J_regressor, model.parents, model.lbs_weights)
    dyn_faces, dyn_bary = _find_dynamic_lmk_idx_and_bcoords(model, full_pose)
    lmk_faces_idx = torch.cat(
        [dyn_faces, model.lmk_faces_idx[None].expand(B, -1)], dim=1)
    lmk_bary = torch.cat(
        [dyn_bary, model.lmk_bary_coords[None].expand(B, -1, -1)], dim=1)
    landmarks2d = lbs_ops.vertices2landmarks(vertices, model.faces,
                                             lmk_faces_idx, lmk_bary)
    landmarks3d = compute_landmarks(model, vertices)
    return vertices, landmarks2d, landmarks3d


def compute_landmarks(model: FlameModel, vertices: torch.Tensor
                      ) -> torch.Tensor:
    """68-point 3D landmarks of decoded vertices."""
    return lbs_ops.vertices2landmarks(vertices, model.faces,
                                      model.full_lmk_faces_idx,
                                      model.full_lmk_bary_coords)


# --------------------------------------------------------------------------
# PCA-basis helpers: the shape basis is shapedirs[..., :n_shape]
# --------------------------------------------------------------------------

def _shape_basis(model: FlameModel) -> torch.Tensor:
    """``[3·V, n_shape]``, rows in (vertex, xyz) order."""
    return model.shapedirs[:, :, :model.n_shape].reshape(-1, model.n_shape)


def project_to_shape_basis(model: FlameModel, shape_vector: torch.Tensor,
                           shape_as_offset: bool = False) -> torch.Tensor:
    """``[B, V, 3]`` vertices (or offsets from the template) → their
    ``[B, n_shape]`` projection on the shape basis."""
    diff = shape_vector if shape_as_offset \
        else shape_vector - model.v_template
    return torch.matmul(diff.reshape(diff.shape[0], -1), _shape_basis(model))


def compute_distance_to_basis(model: FlameModel, shape_vector: torch.Tensor,
                              shape_as_offset: bool = False
                              ) -> torch.Tensor:
    """``[B, V, 3]``: what of the offset the basis does not span (the
    offset less the basis times its projection)."""
    B, V = shape_vector.shape[0], model.n_vertices
    diff = shape_vector if shape_as_offset \
        else shape_vector - model.v_template
    basis = _shape_basis(model)
    params = torch.matmul(diff.reshape(B, -1), basis)
    return diff - torch.matmul(params, basis.T).reshape(B, V, 3)


def get_std(model: FlameModel) -> torch.Tensor:
    """``[n_shape]``: the L2 norm of each shape direction."""
    return torch.linalg.norm(_shape_basis(model), dim=0)


def compute_closest_shape(model: FlameModel, shape_vector: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The basis shape nearest ``[B, V, 3]`` vertices, each direction
    scaled by 1/std²: ``(vertices [B, V, 3], params [B, n_shape])``."""
    B, V = shape_vector.shape[0], model.n_vertices
    basis = _shape_basis(model)
    diff = (shape_vector - model.v_template).reshape(B, -1)
    inv = 1.0 / torch.square(torch.linalg.norm(basis, dim=0))
    params = inv * torch.matmul(diff, basis)
    verts = model.v_template + torch.matmul(params, basis.T).reshape(B, V, 3)
    return verts, params
