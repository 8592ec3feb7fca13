"""The data layer: host datasets feeding fixed-shape NHWC batches to the
card.

The port's counterpart of ``sr3d_tpu/data``: the LR/HR/SR and joint
per-actor datasets (host numpy and PIL, the same items as the JAX package),
the threaded ``BatchLoader`` and ``prefetch_to_device``, which copies each
batch from pinned host memory on a side stream while the previous step
runs.  ``build_train`` / ``build_val`` / ``random_split`` build and split
the joint datasets as the JAX package does (the same ``RandomState``
permutation).
"""

from __future__ import annotations

import numpy as np

from .joint import JointFaceDataset
from .lrhr import LRHRDataset
from .pipeline import BatchLoader, prefetch_to_device
from .synthetic import (
    generate_synthetic_faces,
    generate_synthetic_joint_root,
    synthetic_face_batch,
)

__all__ = ["BatchLoader", "ConcatDataset", "JointFaceDataset",
           "LRHRDataset", "Subset", "build_train", "build_val",
           "generate_synthetic_faces", "generate_synthetic_joint_root",
           "prefetch_to_device", "random_split", "synthetic_face_batch"]


def build_train(cfg) -> "ConcatDataset":
    """The joint training dataset of ``cfg.mica.datasets`` (one
    ``JointFaceDataset`` per ``training_data`` name, at the SR train
    resolutions; LYHM sources keep their paired ``_1C``/``_2C`` views)."""
    roots = cfg.mica.datasets
    return ConcatDataset([JointFaceDataset(
        root=roots.root, name=name, K=roots.K,
        lr_res=cfg.sr.datasets.train.l_resolution,
        hr_res=cfg.sr.datasets.train.r_resolution,
        n_shape=cfg.mica.model.n_shape, n_exp=cfg.mica.model.n_exp,
        is_train=True, use_pairs=name.startswith("LYHM"))
        for name in roots.training_data])


def build_val(cfg) -> "ConcatDataset":
    """The joint eval dataset of ``cfg.mica.datasets.eval_data`` (the SR
    val resolutions, the dataset-wide eval K, no augmentation)."""
    roots = cfg.mica.datasets
    return ConcatDataset([JointFaceDataset(
        root=roots.root, name=name, K=roots.K,
        lr_res=cfg.sr.datasets.val.l_resolution,
        hr_res=cfg.sr.datasets.val.r_resolution,
        n_shape=cfg.mica.model.n_shape, n_exp=cfg.mica.model.n_exp,
        is_train=False) for name in roots.eval_data])


class Subset:
    """The items of ``dataset`` at ``indices``, in that order."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = [int(i) for i in indices]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int):
        return self.dataset[self.indices[idx]]

    def skip_item(self, idx: int) -> None:
        skip = getattr(self.dataset, "skip_item", None)
        if skip is not None:
            skip(self.indices[idx])


def random_split(dataset, train_frac: float = 0.8, seed: int = 0
                 ) -> tuple[Subset, Subset]:
    """The seeded train/val split: ``RandomState(seed).permutation(n)``,
    its first ``int(train_frac · n)`` indices for training."""
    n = len(dataset)
    idx = np.random.RandomState(seed).permutation(n)
    n_train = int(train_frac * n)
    return Subset(dataset, idx[:n_train]), Subset(dataset, idx[n_train:])


class ConcatDataset:
    """Datasets one after another, indexed as one."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = []
        total = 0
        for d in self.datasets:
            self._offsets.append(total)
            total += len(d)
        self._total = total

    def __len__(self) -> int:
        return self._total

    def _locate(self, idx: int):
        if idx < 0:
            idx += self._total
        for off, d in zip(reversed(self._offsets), reversed(self.datasets)):
            if idx >= off:
                return d, idx - off
        raise IndexError(idx)

    def __getitem__(self, idx: int):
        d, i = self._locate(idx)
        return d[i]

    def skip_item(self, idx: int) -> None:
        d, i = self._locate(idx)
        skip = getattr(d, "skip_item", None)
        if skip is not None:
            skip(i)
