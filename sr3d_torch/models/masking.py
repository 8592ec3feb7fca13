"""FLAME region masks → per-vertex loss weights, and the masked vertex L1.

The port's copy of ``sr3d_tpu/models/masking.py``: ``WEIGHT_REGIONS``,
``load_masks``, ``synthetic_masks``, ``weights_per_vertex``, the
triangle weights, the soft-ring falloff (``vertex_neighbours``,
``make_soft``, ``weights_with_soft_rings``) and the masked submesh
(``binary_triangle_mask``, ``masked_submesh``) are numpy on the host and
give the same arrays; ``masked_vertex_l1`` is torch.
"""

from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch

# regions the reference weighting consumes
WEIGHT_REGIONS = ("face", "nose", "lips", "forehead", "lr_eye_region",
                  "eye_region", "ears", "eyes")


def load_masks(masks_path: str) -> dict[str, np.ndarray]:
    """Load ``FLAME_masks.pkl`` (dict region → vertex-index array)."""
    with open(masks_path, "rb") as f:
        masks = pickle.load(f, encoding="latin1")
    return {k: np.asarray(v, dtype=np.int64) for k, v in masks.items()}


def synthetic_masks(n_vertices: int, seed: int = 0) -> dict[str, np.ndarray]:
    """Random region partition with the real mask's keys, for running
    without the licensed asset."""
    rng = np.random.RandomState(seed)
    masks = {}
    for name in WEIGHT_REGIONS:
        size = max(1, n_vertices // (len(WEIGHT_REGIONS) + 2))
        masks[name] = rng.choice(n_vertices, size=size, replace=False)
    half = len(masks["eye_region"]) // 2
    masks["left_eye_region"] = masks["eye_region"][:half]
    masks["right_eye_region"] = masks["eye_region"][half:]
    return masks


def weights_per_vertex(masks: Mapping[str, np.ndarray],
                       mask_weights: Mapping[str, float],
                       n_vertices: int) -> np.ndarray:
    """``[V, 1]`` float32 weights: the ``whole`` baseline, then each region
    of ``WEIGHT_REGIONS`` in that order (later regions overwrite earlier
    ones)."""
    w = np.full((n_vertices,), float(mask_weights.get("whole", 1.0)),
                dtype=np.float32)
    for region in WEIGHT_REGIONS:
        if region in mask_weights and region in masks:
            idx = masks[region]
            idx = idx[idx < n_vertices]
            w[idx] = float(mask_weights[region])
    return w[:, None]


def masked_vertex_l1(pred: torch.Tensor, gt: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """``mean(|pred − gt| · w) × 1000``, the MICA loss in ≈ millimetres;
    ``pred``/``gt`` ``[B, V, 3]``, ``weights`` ``[V, 1]``."""
    return ((pred - gt).abs() * weights[None]).mean() * 1000.0


def triangle_weights(vertex_weights: np.ndarray,
                     faces: np.ndarray) -> np.ndarray:
    """``[F, 1]`` per-triangle weights: the mean of the 3 vertex
    weights."""
    vw = vertex_weights.reshape(-1)
    return vw[faces].mean(axis=1, keepdims=True).astype(np.float32)


def vertex_neighbours(faces: np.ndarray, n_vertices: int) -> list:
    """Per-vertex neighbour sets from the triangle list."""
    nbrs: list[set] = [set() for _ in range(n_vertices)]
    for a, b, c in np.asarray(faces):
        nbrs[a].update((b, c))
        nbrs[b].update((a, c))
        nbrs[c].update((a, b))
    return nbrs


def make_soft(mask: np.ndarray, value: float, neighbours: list,
              degree: int = 4) -> list[tuple[np.ndarray, float]]:
    """Grow the region ``degree`` rings outward; ring r (0-based) gets
    weight ``value / (r + 2)``.  Returns ``[(ring_vertex_indices,
    ring_value), ...]``."""
    grown = set(int(v) for v in np.asarray(mask).reshape(-1))
    soft = []
    for ring in range(degree):
        ring_verts = []
        for v in sorted(grown.copy()):
            for n in neighbours[v]:
                if n in grown:
                    continue
                ring_verts.append(n)
                grown.add(n)
        soft.append((np.asarray(sorted(set(ring_verts)), np.int64),
                     value / (ring + 2)))
    return soft


def weights_with_soft_rings(masks: Mapping[str, np.ndarray],
                            mask_weights: Mapping[str, float],
                            faces: np.ndarray, n_vertices: int,
                            soft_regions: tuple = ("face",),
                            degree: int = 4) -> np.ndarray:
    """Per-vertex weights with soft-ring falloff around the given regions:
    the hard weights first, then each region's rings write value/(r+2)
    where they don't already carry a higher weight."""
    w = weights_per_vertex(masks, mask_weights, n_vertices)[:, 0]
    nbrs = vertex_neighbours(faces, n_vertices)
    whole = float(mask_weights.get("whole", 1.0))
    for region in soft_regions:
        if region not in masks or region not in mask_weights:
            continue
        for ring_idx, ring_val in make_soft(
                masks[region], float(mask_weights[region]), nbrs, degree):
            ring_idx = ring_idx[ring_idx < n_vertices]
            cur = w[ring_idx]
            w[ring_idx] = np.where(cur <= whole,
                                   np.maximum(cur, ring_val), cur)
    return w[:, None].astype(np.float32)


def binary_triangle_mask(faces: np.ndarray,
                         vertex_mask: np.ndarray) -> np.ndarray:
    """``[F]`` bool: the faces whose three vertices are all in the vertex
    mask."""
    m = np.zeros(int(np.max(faces)) + 1, bool)
    m[np.asarray(vertex_mask).reshape(-1)] = True
    fm = m[np.asarray(faces)]
    return fm.all(axis=1)


def masked_submesh(vertices: np.ndarray, faces: np.ndarray,
                   triangle_mask: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The submesh of the masked faces, unreferenced vertices dropped and
    the faces reindexed."""
    faces = np.asarray(faces)[np.asarray(triangle_mask, bool)]
    used = np.unique(faces)
    remap = np.full(int(np.max(faces, initial=0)) + 1, -1, np.int64)
    remap[used] = np.arange(len(used))
    return np.asarray(vertices)[used], remap[faces]
