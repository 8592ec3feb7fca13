"""The JAX package's checkpoints, read and written without JAX.

Counterpart of ``sr3d_tpu/train/checkpoint.py`` (``save_state_npz`` /
``load_state_npz`` / ``load_leaves_into`` / ``load_arcface_npz`` /
``transfer_sr_adam_moments`` and its ``CheckpointManager``'s numpy
layout).  A checkpoint there is a ``.npz`` of arrays ``leaf_0``,
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
nested dicts, lists, tuples and ``None``.

The optimizer state is optax's ``multi_transform`` over the labels
``arcface``, ``frozen``, ``mapping``, ``sr`` (sorted), each masked to its
label's leaves: ``adam`` keeps ``(count, mu, nu)``, ``adamw`` that and its
learning-rate schedule's count, ``set_to_zero`` (``frozen``) nothing; at
``grad_accum`` k > 1 ``MultiSteps`` wraps it as ``(mini_step,
gradient_step, inner state, acc_grads)``, ``acc_grads`` the running mean
of the gradients over the whole parameter tree.  ``optimizer_tree`` builds
that tree from a port optimizer whose param groups carry the labels
(``step``, ``exp_avg``, ``exp_avg_sq`` per parameter; the accumulated mean
in ``.grad`` between micro-steps) through the weight bridge's names and
transposes, and ``load_optimizer_tree`` puts one back; an ``OptLayout``
says which labels and networks a tree has: ``joint_layout`` (the above),
``mica_layout`` (the MICA-only trainer's: without ``sr``) and
``sr_layout`` (SR-only training's plain ``optax.adam``, or its
``finetune_norm`` ``multi_transform`` with the label ``train``).  So
``save_train_state`` writes files that the JAX package's
``load_state_npz`` and ``CheckpointManager`` read, and ``load_train_state``
resumes from the JAX package's own.  The frozen ArcFace prefix has no
gradient in the port: its ``acc_grads`` are written as zeros (its update
is zero either way).

``load_state_npz`` (serving) counts the leaves it knows from both ends and
skips the optimizer's block between.  Every leaf read is checked against
the shape the modules give it.  The orbax layout needs orbax, which is
JAX's: the port reads and writes the ``.npz`` layouts only.

``CheckpointManager`` writes its ``ckpt_{step:010d}.npz`` files in the
background, as the JAX one's orbax manager does (``save(wait=False)``,
``wait()``); every other writer here is synchronous, as in JAX.  A write
goes through ``{name}.tmp``, which no reader takes for a checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from ..utils.bridge import (
    export_jax_params,
    flax_to_state_dict,
    load_jax_ema,
    load_jax_params,
    state_dict_to_flax,
)
from .joint import group_update_count


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


_CKPT_NAME = re.compile(r"ckpt_(\d+)\.npz")


def npz_steps(directory: str | os.PathLike) -> list[tuple[int, Path]]:
    """The ``ckpt_{digits}.npz`` files in ``directory`` with their steps,
    oldest first; other names (a write's temporary file) are not
    checkpoints."""
    found = ((_CKPT_NAME.fullmatch(p.name), p)
             for p in Path(directory).glob("ckpt_*"))
    return sorted((int(m.group(1)), p) for m, p in found if m)


def latest_npz_step(directory: str | os.PathLike) -> int | None:
    """The newest step of the ``ckpt_{step:010d}.npz`` files in
    ``directory`` (the auto-resume), or None where there is none.  A
    directory that holds only orbax steps raises: the port reads the
    ``.npz`` layouts only."""
    d = Path(directory)
    steps = npz_steps(d)
    if steps:
        return steps[-1][0]
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


# --------------------------------------------------------------------------
# the optimizer state in optax's layout, and whole train states
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OptLayout:
    """Where an optax opt_state's leaves come from in a port optimizer.

    ``nets``: the networks of the parameter tree by its top-level key (one
    network: the tree is that network's own, as SR-only training's UNet
    variables); ``labels``: each param group (its ``name``) that has
    leaves, and the key in ``nets`` of its parameters, in optax's label
    order (sorted; the frozen label holds no leaf); ``scheduled``: the
    labels whose transformation is ``adamw`` over a learning-rate schedule
    (a count after the Adam state); ``multi``: an ``optax.multi_transform``
    (False: one plain ``optax.adam``, a single label).  ``grad_accum`` > 1
    wraps it in ``MultiSteps``."""

    nets: Mapping[str, torch.nn.Module]
    labels: Mapping[str, str]
    scheduled: tuple[str, ...] = ()
    multi: bool = True

    @property
    def device(self) -> torch.device:
        return next(next(iter(self.nets.values())).parameters()).device


def joint_layout(modules) -> OptLayout:
    """The joint optimizer's (``train.joint.make_optimizer``): labels
    ``arcface``, ``mapping`` (adamw + StepLR), ``sr`` (adam), ``frozen``."""
    return OptLayout(nets={"arcface": modules.arcface,
                           "mapping": modules.mapping, "sr": modules.unet},
                     labels={"arcface": "arcface", "mapping": "mapping",
                             "sr": "sr"},
                     scheduled=("arcface", "mapping"))


def mica_layout(modules) -> OptLayout:
    """The MICA-only optimizer's (``train.mica_only.make_mica_optimizer``):
    the joint's without ``sr``."""
    return OptLayout(nets={"arcface": modules.arcface,
                           "mapping": modules.mapping},
                     labels={"arcface": "arcface", "mapping": "mapping"},
                     scheduled=("arcface", "mapping"))


def sr_layout(unet: torch.nn.Module, finetune_norm: bool = False
              ) -> OptLayout:
    """SR-only training's: ``optax.adam`` over the UNet (its param group
    ``sr``), or under ``finetune_norm`` a ``multi_transform`` whose label
    ``train`` holds the attention parameters alone."""
    if finetune_norm:
        return OptLayout(nets={"sr": unet}, labels={"train": "sr"})
    return OptLayout(nets={"sr": unet}, labels={"sr": "sr"}, multi=False)


def _wrap(key: str, tree: dict) -> dict:
    """The UNet's and the mapping network's flax trees sit under
    ``params``; ArcFace's parameters do not."""
    return tree if key == "arcface" else {"params": tree}


def _group_names(opt: torch.optim.Optimizer, layout: OptLayout
                 ) -> dict[str, list[tuple[str, torch.nn.Parameter]]]:
    """Each param group's parameters by module name, in the module's
    order, for the groups ``layout`` labels (a layout of the ``sr`` group
    alone reads a joint optimizer's)."""
    out = {}
    for g in opt.param_groups:
        if g["name"] not in layout.labels:
            continue
        ids = {id(p) for p in g["params"]}
        net = layout.nets[layout.labels[g["name"]]]
        out[g["name"]] = [(n, p) for n, p in net.named_parameters()
                          if id(p) in ids]
    return out


def _group_count(opt: torch.optim.Optimizer, name: str) -> int:
    return next(group_update_count(opt, g) for g in opt.param_groups
                if g["name"] == name)


def optimizer_tree(layout: OptLayout, state, accum: int | None = None,
                   tensors: bool = False) -> Any:
    """The port's optimizer state (``state.opt``; ``state.grad_accum`` and
    ``state.mini_step`` where it has them) as the optax opt_state tree of
    ``layout``, of numpy arrays (plain tuples in place of the
    NamedTuples: the same leaves in the same order; the tensors' leaves
    fp32 tensors under ``tensors``, as in ``state_dict_to_flax``).
    ``accum`` overrides ``state.grad_accum``."""
    opt = state.opt

    def flax(sd):
        return state_dict_to_flax(sd, tensors=tensors)

    named = _group_names(opt, layout)
    inner = {}
    for label in sorted(layout.labels):
        key = layout.labels[label]
        mu, nu = {}, {}
        for n, p in named[label]:
            st = opt.state.get(p, {})
            mu[n] = st.get("exp_avg", torch.zeros_like(p))
            nu[n] = st.get("exp_avg_sq", torch.zeros_like(p))
        count = np.asarray(_group_count(opt, label), np.int32)
        adam = (count, _wrap(key, flax(mu)), _wrap(key, flax(nu)))
        inner[label] = ((adam, (), (count,)) if label in layout.scheduled
                        else (adam, ()))
    if not layout.multi:
        (inner,) = inner.values()
    k = int(getattr(state, "grad_accum", 1) if accum is None else accum)
    if k <= 1:
        return inner
    mid = state.mini_step > 0
    acc = {key: _wrap(key, flax({
        n: p.grad if mid and p.grad is not None else torch.zeros_like(p)
        for n, p in net.named_parameters()}))
        for key, net in layout.nets.items()}
    updates = max(_group_count(opt, label) for label in layout.labels)
    return (np.asarray(state.mini_step, np.int32),
            np.asarray(updates, np.int32), inner, acc, ())


def _tensors(key: str, tree, device) -> dict[str, torch.Tensor]:
    return {n: t.to(device) for n, t in flax_to_state_dict(
        tree if key == "arcface" else tree["params"]).items()}


def load_optimizer_tree(layout: OptLayout, state, tree,
                        accum: int | None = None) -> None:
    """Put an opt_state tree of :func:`optimizer_tree`'s layout (numpy)
    into ``state``'s optimizer, in place: moments and counts per group; at
    ``grad_accum`` > 1 also ``mini_step`` and, between micro-steps, the
    accumulated mean into the trainable parameters' ``.grad``."""
    opt = state.opt
    k = int(getattr(state, "grad_accum", 1) if accum is None else accum)
    if k > 1:
        mini, _, inner, acc, _ = tree
        state.mini_step = int(mini)
    else:
        inner, acc = tree, None
        if hasattr(state, "mini_step"):
            state.mini_step = 0
    if not layout.multi:
        inner = dict.fromkeys(layout.labels, inner)
    dev = layout.device
    for label, params in _group_names(opt, layout).items():
        (count, mu, nu) = inner[label][0]
        count = int(count)
        key = layout.labels[label]
        mu, nu = _tensors(key, mu, dev), _tensors(key, nu, dev)
        for n, p in params:
            if count == 0:
                opt.state.pop(p, None)
                continue
            opt.state[p] = {"step": torch.tensor(float(count),
                                                 dtype=torch.float32),
                            "exp_avg": mu[n], "exp_avg_sq": nu[n]}
    for key, net in layout.nets.items():
        grads = (_tensors(key, acc[key], dev)
                 if acc is not None and state.mini_step > 0 else None)
        for n, p in net.named_parameters():
            p.grad = (grads[n] if grads is not None and p.requires_grad
                      else None)


def train_state_tree(modules, state, meta: Mapping[str, int],
                     tensors: bool = False) -> dict:
    """``{"meta", "state"}`` in the JAX package's layout (numpy; under
    ``tensors`` the tensors' leaves fp32 tensors, as in
    ``state_dict_to_flax``): the tree ``save_state_npz`` flattens for a
    ``JointTrainState``."""
    tmpl = export_jax_params(modules, tensors=tensors)
    params = {k: tmpl[k] for k in ("arcface", "mapping", "sr")}
    ema = None
    if state.ema is not None:
        ema = ({"params": state_dict_to_flax(state.ema.params,
                                             tensors=tensors)},
               np.asarray(state.ema.step, np.int32))
    return {"meta": {k: np.asarray(int(v), np.int64)
                     for k, v in meta.items()},
            "state": (np.asarray(state.step, np.int32), params,
                      tmpl["arcface_stats"],
                      optimizer_tree(joint_layout(modules), state,
                                     tensors=tensors),
                      ema)}


def _write_npz(f, arrays: Mapping[str, np.ndarray]) -> None:
    """``np.savez(f, **arrays)`` (uncompressed members ``{name}.npy``,
    format 1.0), each array's bytes handed to the zip member in one call
    and never copied: the CRC and the write release the GIL for their
    whole length, where ``np.savez`` copies every 16 MiB chunk under it
    (a background writer then holds up the training thread)."""
    fmt = np.lib.format
    with zipfile.ZipFile(f, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        for name, a in arrays.items():
            a = np.asarray(a, order="C")     # 0-d stays 0-d
            with z.open(f"{name}.npy", "w", force_zip64=True) as out:
                fmt.write_array_header_1_0(
                    out, fmt.header_data_from_array_1_0(a))
                out.write(a.reshape(-1).view(np.uint8))


def save_leaves(path: str | os.PathLike, tree: Any, **named) -> Path:
    """Write ``tree``'s leaves (numpy arrays, or CPU tensors) as ``leaf_0
    …`` (``jax.tree_util``'s order, the JAX package's ``save_state_npz``
    layout) and the ``named`` arrays into the ``.npz`` ``path``, through
    ``{path}.tmp``, so that an interrupted write leaves no half file under
    a name that a reader of ``.npz`` files takes."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, _ = jax_tree_flatten(tree)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        _write_npz(f, {**named, **{
            f"leaf_{i}": x.numpy() if torch.is_tensor(x) else np.asarray(x)
            for i, x in enumerate(leaves)}})
    os.replace(tmp, path)
    return path


def save_train_state(path: str | os.PathLike, modules, state,
                     meta: Mapping[str, int]) -> Path:
    """Write ``modules`` and ``state`` (params, ArcFace statistics, the
    optimizer in optax's layout, the EMA) and ``meta`` as the JAX
    package's ``save_state_npz`` does."""
    return save_leaves(path, train_state_tree(modules, state, meta))


def load_train_state(path: str | os.PathLike, modules, state,
                     reset_optimizer: bool = False) -> dict:
    """Resume ``modules`` and ``state`` in place from a train-state
    ``.npz`` (the port's or the JAX package's): parameters, ArcFace
    statistics, the step, the EMA and, unless ``reset_optimizer``, the
    optimizer.  Returns the file's ``meta``.  Raises ValueError where the
    leaf count or a shape differs from this config's state (e.g. a
    converted network, not a train state)."""
    tree = train_state_tree(modules, state, {"epoch": 0, "global_step": 0})
    t_leaves, treedef = jax_tree_flatten(tree)
    leaves = npz_leaves(path)
    if len(leaves) != len(t_leaves):
        raise ValueError(
            f"{path}: {len(leaves)} arrays, target has {len(t_leaves)}")
    _check_shapes(path, leaves, t_leaves)
    got = jax_tree_unflatten(treedef, leaves)
    step, params, stats, opt_tree, ema = got["state"]
    load_jax_params(modules, dict(params, arcface_stats=stats))
    state.step = int(step)
    if ema is not None:
        state.ema = load_jax_ema(ema[0], int(ema[1]), modules.device)
    if not reset_optimizer:
        load_optimizer_tree(joint_layout(modules), state, opt_tree)
    return {k: int(v) for k, v in got["meta"].items()}


def load_arcface_npz(path: str | os.PathLike, modules) -> None:
    """A converted ArcFace (``utils/convert.py --kind arcface``: the leaves
    of ``{"batch_stats", "params"}``) into ``modules.arcface``."""
    tmpl = export_jax_params(modules)
    tree = load_leaves_into(path, {"batch_stats": tmpl["arcface_stats"],
                                   "params": tmpl["arcface"]})
    load_jax_params(modules, dict(tmpl, arcface=tree["params"],
                                  arcface_stats=tree["batch_stats"]))


def transfer_sr_adam_moments(modules, state, opt_npz_path
                             ) -> bool:
    """An SR-only run's Adam state (``I*_E*_opt.npz``: the leaves of
    ``optax.adam(lr).init(sr_params)``, i.e. ``count``, ``mu``, ``nu``)
    into the optimizer's ``sr`` group: moments and count.  Returns False,
    changing nothing, where the file does not match this UNet."""
    layout = sr_layout(modules.unet)
    try:
        tree = load_leaves_into(opt_npz_path,
                                optimizer_tree(layout, state, accum=1))
    except ValueError:
        return False
    load_optimizer_tree(layout, state, tree, accum=1)
    return True


class HostSnapshot:
    """The host copy of a checkpoint's tensors: one flat fp32 buffer,
    pinned where a tensor is on the card, kept and reused from one
    snapshot to the next (a write must have finished with it before the
    next :meth:`copy`); it grows when a tree needs more.

    :meth:`copy` copies each tensor leaf into its slice on the current
    stream (``non_blocking``) and records an event after the copies: a
    reader waits on it before it reads a byte.  Work queued on that stream
    after the copies (the next optimizer step, the EMA update, the
    accumulation of ``.grad``, the reuse of a freed tensor's memory) runs
    after them, so the snapshot holds the state as it was at ``copy``."""

    def __init__(self):
        self._buf: torch.Tensor | None = None
        self.alloc_bytes = 0     # allocated by the last copy

    def copy(self, tree: Any) -> tuple[Any, Any]:
        """``tree`` with each tensor leaf (fp32) replaced by its host copy,
        and the event after the copies (None where none was on the
        card)."""
        leaves, treedef = jax_tree_flatten(tree)
        tensors = [x for x in leaves if torch.is_tensor(x)]
        n = sum(t.numel() for t in tensors)
        card = next((t.device for t in tensors if t.is_cuda), None)
        self.alloc_bytes = 0
        if self._buf is None or self._buf.numel() < n \
                or self._buf.is_pinned() != (card is not None):
            self._buf = None
            self._buf = torch.empty(n, dtype=torch.float32,
                                    pin_memory=card is not None)
            self.alloc_bytes = 4 * n
        out, at = [], 0
        for x in leaves:
            if torch.is_tensor(x):
                dst = self._buf[at:at + x.numel()].view(x.shape)
                dst.copy_(x, non_blocking=True)
                at += x.numel()
                x = dst
            out.append(x)
        ready = None
        if card is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(card))
        return jax_tree_unflatten(treedef, out), ready


@dataclasses.dataclass(frozen=True)
class Written:
    """A finished background write: its step, file, the writer's seconds
    (from its start to the rename and the rotation) and the file's
    bytes."""

    step: int
    path: Path
    seconds: float
    nbytes: int


class CheckpointManager:
    """The JAX package's numpy ``CheckpointManager`` layout:
    ``{directory}/ckpt_{step:010d}.npz`` train states, the newest
    ``max_to_keep`` kept.

    As the JAX one's orbax manager, ``save`` writes in the background:
    it copies every leaf of the train state off the live tensors
    (:class:`HostSnapshot`) and returns; a writer thread turns the copy
    into the ``.npz``, renames it into place, then rotates.  A ``save``
    while a write is in flight first waits for it (one snapshot held at
    a time); ``wait`` drains; ``latest_step`` and ``restore`` wait first.
    A failed write's exception is raised from the next ``save``,
    ``wait``, ``poll``, ``latest_step`` or ``restore``."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = 5):
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)
        self._host = HostSnapshot()
        self._thread: threading.Thread | None = None
        self._outcome: Written | BaseException | None = None
        self._done: list[Written] = []
        # the last save's seconds blocked on the write before it, and in
        # its snapshot (tree and copies, pinned buffers allocated), and
        # the bytes of host buffers it allocated
        self.last_wait_s = self.last_snapshot_s = 0.0
        self.last_alloc_bytes = 0

    def save(self, step: int, modules, state, metadata: Mapping[str, int],
             wait: bool = False) -> Path:
        t0 = time.perf_counter()
        self.wait()
        t1 = time.perf_counter()
        # the leaves as views of the live tensors, then copied at once
        tree, ready = self._host.copy(train_state_tree(
            modules, state, metadata, tensors=True))
        self.last_wait_s, self.last_snapshot_s = t1 - t0, \
            time.perf_counter() - t1
        self.last_alloc_bytes = self._host.alloc_bytes
        self._thread = threading.Thread(
            target=self._write, args=(int(step), tree, ready),
            name=f"checkpoint-{step}")
        self._thread.start()
        if wait:
            self.wait()
        return npz_step_path(self.directory, step)

    def _write(self, step: int, tree, ready) -> None:
        """The writer thread: no metrics, no logging; its outcome is read
        on the caller's thread."""
        try:
            t0 = time.perf_counter()
            if ready is not None:
                ready.synchronize()
            path = save_leaves(npz_step_path(self.directory, step), tree)
            for _, old in npz_steps(self.directory)[:-self.max_to_keep]:
                old.unlink()
            self._outcome = Written(step, path, time.perf_counter() - t0,
                                    path.stat().st_size)
        except BaseException as e:   # raised on the caller's thread
            self._outcome = e

    def wait(self) -> None:
        """Block until the write in flight (if any) has finished; raise
        its exception where it failed."""
        if self._thread is None:
            return
        self._thread.join()
        self._thread = None
        out, self._outcome = self._outcome, None
        if isinstance(out, BaseException):
            raise out
        self._done.append(out)

    @property
    def in_flight(self) -> bool:
        """A write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def poll(self) -> list[Written]:
        """The writes finished since the last call, without waiting for
        one in flight."""
        if self._thread is not None and not self.in_flight:
            self.wait()
        done, self._done = self._done, []
        return done

    def latest_step(self) -> int | None:
        self.wait()
        return latest_npz_step(self.directory)

    def restore(self, step: int | None, modules, state,
                reset_optimizer: bool = False) -> dict:
        """Resume from ``step`` (None: the newest) in place; returns the
        meta.  FileNotFoundError where there is none."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return load_train_state(npz_step_path(self.directory, step),
                                modules, state, reset_optimizer)
