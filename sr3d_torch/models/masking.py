"""FLAME region masks → per-vertex loss weights, and the masked vertex L1.

The port's copy of ``sr3d_tpu/models/masking.py`` (``WEIGHT_REGIONS``,
``load_masks``, ``synthetic_masks``, ``weights_per_vertex``: numpy, the
same arrays for a seed) and ``masked_vertex_l1`` in torch.
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
