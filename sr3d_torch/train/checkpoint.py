"""The JAX package's checkpoints, read without JAX.

Counterpart of ``sr3d_tpu/train/checkpoint.py`` (``save_state_npz`` /
``load_state_npz`` / ``load_leaves_into`` and its ``CheckpointManager``'s
numpy layout).  A checkpoint there is a ``.npz`` of arrays ``leaf_0``,
``leaf_1``, … in ``jax.tree_util``'s flatten order of a pytree:

* dict keys in sorted order at every level, tuple and NamedTuple fields in
  order, ``None`` with no leaf;
* a train state is ``{"meta": {"epoch", "global_step"}, "state":
  JointTrainState(step, params {arcface, mapping, sr}, arcface_stats,
  opt_state, ema)}``, so leaf 0 is ``epoch``, leaf 1 ``global_step``, leaf
  2 the step; ``ema`` is ``EmaState(params, step)`` where the config has an
  EMA scheduler, else ``None``;
* a converted reference network (``utils/convert.py``) is the leaves of
  that network's tree alone.

``jax_tree_flatten`` / ``jax_tree_unflatten`` reproduce that order on
nested dicts, lists, tuples and ``None``.  The optimizer state's leaf count
depends on the optimizer (optax's ``multi_transform``, the frozen labels,
``MultiSteps`` at ``grad_accum`` > 1), and serving needs none of it, so
``load_state_npz`` counts the leaves it knows from both ends and skips the
block between.  Every leaf it reads is checked against the shape the modules
give it.  The orbax layout needs orbax, which is JAX's: the port reads the
``.npz`` layouts only.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ..utils.bridge import export_jax_params


LEAF = object()  # a leaf's place in a treedef


def jax_tree_flatten(tree: Any) -> tuple[list, Any]:
    """``(leaves, treedef)`` in ``jax.tree_util``'s order: a dict's values
    by sorted key, a list's or tuple's (NamedTuples' too) in order, ``None``
    contributing nothing; anything else is a leaf."""
    leaves: list = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, Mapping):
            keys = sorted(node)
            return (dict, tuple(keys), tuple(walk(node[k]) for k in keys))
        if isinstance(node, (list, tuple)):
            return (type(node), None, tuple(walk(v) for v in node))
        leaves.append(node)
        return LEAF

    return leaves, walk(tree)


def jax_tree_unflatten(treedef: Any, leaves: list) -> Any:
    """The inverse of :func:`jax_tree_flatten`."""
    it = iter(leaves)

    def build(d):
        if d is None:
            return None
        if d is LEAF:
            return next(it)
        kind, keys, children = d
        vals = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, vals))
        if kind is list:
            return vals
        if kind is tuple:
            return tuple(vals)
        return kind(*vals)   # a NamedTuple

    out = build(treedef)
    if next(it, LEAF) is not LEAF:
        raise ValueError("more leaves than the treedef has places")
    return out


def npz_leaves(path: str | os.PathLike) -> list[np.ndarray]:
    """The ``leaf_0 … leaf_{n-1}`` arrays of a ``.npz``, in order."""
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        return [data[f"leaf_{i}"] for i in range(n)]


def _check_shapes(path, leaves: list, template: list, offset: int = 0
                  ) -> None:
    for i, (a, b) in enumerate(zip(leaves, template)):
        if np.shape(a) != np.shape(b):
            raise ValueError(
                f"{path}: leaf {offset + i} shape {np.shape(a)} != target "
                f"{np.shape(b)} — checkpoint does not match this config")


def load_leaves_into(path: str | os.PathLike, target: Any) -> Any:
    """A flat ``leaf_i`` ``.npz`` (the converter's output) in ``target``'s
    structure; the leaf count and every shape must match (ValueError)."""
    leaves = npz_leaves(path)
    t_leaves, treedef = jax_tree_flatten(target)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"{path}: {len(leaves)} arrays, target has {len(t_leaves)}")
    _check_shapes(path, leaves, t_leaves)
    return jax_tree_unflatten(treedef, leaves)


def load_state_npz(path: str | os.PathLike, modules, cfg) -> dict:
    """A ``save_state_npz`` joint train state (or a ``ckpt_*.npz`` of the
    numpy ``CheckpointManager``) for ``modules`` (a
    ``train.joint.JointModules``) built from ``cfg``.

    Returns numpy trees in the JAX package's layouts: ``{"params": {"sr",
    "arcface", "mapping"}, "arcface_stats", "ema": {"params", "step"} or
    None (the config has no EMA scheduler), "step", "meta": {"epoch",
    "global_step"}}``.  The optimizer's leaves are skipped.  Raises
    ValueError where the file has too few leaves or any leaf read has
    another shape than the modules give it."""
    tmpl = export_jax_params(modules)
    params = {k: tmpl[k] for k in ("arcface", "mapping", "sr")}
    head_leaves, head_def = jax_tree_flatten(
        ({"epoch": 0, "global_step": 0}, 0, params, tmpl["arcface_stats"]))
    tail_leaves, tail_def = [], None
    if cfg.sr.train.ema_scheduler:
        tail_leaves, tail_def = jax_tree_flatten((tmpl["sr"], 0))
    leaves = npz_leaves(path)
    n_head, n_tail = len(head_leaves), len(tail_leaves)
    if len(leaves) < n_head + n_tail:
        raise ValueError(
            f"{path}: {len(leaves)} arrays, fewer than the {n_head + n_tail} "
            f"of this config's parameters, statistics and EMA")
    tail = leaves[len(leaves) - n_tail:]
    _check_shapes(path, leaves[:n_head], head_leaves)
    _check_shapes(path, tail, tail_leaves, len(leaves) - n_tail)
    meta, step, params, stats = jax_tree_unflatten(head_def,
                                                   leaves[:n_head])
    ema = None
    if tail_def is not None:
        ema_params, ema_step = jax_tree_unflatten(tail_def, tail)
        ema = {"params": ema_params, "step": int(ema_step)}
    return {"params": params, "arcface_stats": stats, "ema": ema,
            "step": int(step),
            "meta": {k: int(v) for k, v in meta.items()}}


def latest_npz_step(directory: str | os.PathLike) -> int | None:
    """The newest step of the ``ckpt_{step:010d}.npz`` files in
    ``directory`` (the auto-resume), or None where there is none.  A
    directory that holds only orbax steps raises: the port reads the
    ``.npz`` layouts only."""
    d = Path(directory)
    steps = [int(p.stem.split("_")[-1]) for p in d.glob("ckpt_*.npz")]
    if steps:
        return max(steps)
    orbax = sorted(p.name for p in d.glob("*")
                   if p.is_dir() and p.name.isdigit())
    if orbax:
        raise ValueError(
            f"{d} holds orbax checkpoint steps {orbax}; the port reads only "
            f"the .npz layouts (save_state_npz files and the numpy "
            f"CheckpointManager's ckpt_*.npz)")
    return None


def npz_step_path(directory: str | os.PathLike, step: int) -> Path:
    """The numpy ``CheckpointManager``'s file of ``step``."""
    return Path(directory) / f"ckpt_{step:010d}.npz"
