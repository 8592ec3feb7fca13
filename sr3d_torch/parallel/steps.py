"""Mesh-parallel train and sampling steps, and the tensor-parallel layout
of a train state.

Counterpart of ``sr3d_tpu/parallel/steps.py``:

* ``pjit_train_step``: data parallel.  Each rank runs the step on its rows
  of the global batch under the mesh's data ``Layout``; the step averages
  its gradients over the data axis before its optimizer runs
  (``layout.average_gradients``: the joint step does in
  ``train.joint.accumulate_and_step``), so every rank applies the same
  update; the metrics come back as global-batch means.
* ``pjit_sample``: data-parallel sampling.  Each rank runs the whole
  reverse loop on its rows; the result is gathered on every rank.
* ``pjit_sample_spatial``: spatial sampling.  The image height is split
  over the ``model`` axis: the UNet's 3×3 convs exchange a halo row with
  their neighbours, GroupNorm sums its moments over the axis, attention
  gathers its keys and values (``models/``), the draws are the global
  ones.
* ``tp_param_sharding`` / ``state_shardings`` / ``shard_state_dp_tp``:
  the JAX rule — a weight whose output dim divides over the ``model`` axis
  and is at least ``min_channels`` wide is split on that dim, everything
  else is replicated — and the port's layout of it: each such ``Conv2d``
  / ``Linear`` keeps its rows of the weight (and the optimizer moments and
  EMA entries that mirror it), computes its output channels and gathers
  the rest (``models/layers.py``).  ``unsharded`` gathers them for a
  checkpoint and splits them again after, so files keep the JAX layout.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
import torch.distributed as dist
from torch import nn

from . import layout as lay
from .mesh import DATA_AXIS, MODEL_AXIS, Axis, Mesh, local_rows


def data_layout(mesh: Mesh) -> lay.Layout:
    """The batch split over the data axis."""
    return lay.Layout(batch=mesh.axis(DATA_AXIS))


def spatial_layout(mesh: Mesh, axis: str = MODEL_AXIS) -> lay.Layout:
    """The image height split over ``axis``."""
    return lay.Layout(rows=mesh.axis(axis))


def pjit_train_step(train_step: Callable, mesh: Mesh,
                    batch_argnum: int = 1) -> Callable:
    """``step(*args, **kw) -> (state, metrics)`` running ``train_step``
    with its positional argument ``batch_argnum`` (the global batch, a
    dict; JAX's ``train_step(state, batch, rng)`` convention by default)
    cut to this rank's rows, under the data layout.  ``train_step`` calls
    ``layout.average_gradients`` on its parameters before its optimizer
    steps (the JAX step gets the same mean from the psum XLA inserts).
    The 0-d floating metrics come back as global-batch means."""
    dp = data_layout(mesh)

    def step(*args, **kw):
        args = list(args)
        args[batch_argnum] = local_rows(args[batch_argnum], dp.batch)
        with lay.use(dp):
            state, metrics = train_step(*args, **kw)
            metrics = {k: (lay.mean_metric(v) if isinstance(v, torch.Tensor)
                           and v.dim() == 0 and v.is_floating_point() else v)
                       for k, v in metrics.items()}
        return state, metrics

    return step


def pjit_sample(sample_fn: Callable, mesh: Mesh) -> Callable:
    """``fn(cond, *args, **kw)``: ``sample_fn`` on this rank's rows of the
    NCHW conditioning, the draws the global ones, the samples gathered on
    every rank."""
    dp = data_layout(mesh)

    def fn(cond, *args, **kw):
        with lay.use(dp):
            return lay.gather(sample_fn(lay.local(cond), *args, **kw))

    return fn


def pjit_sample_spatial(sample_fn: Callable, mesh: Mesh,
                        axis: str = MODEL_AXIS, row_dim: int = 2
                        ) -> Callable:
    """``fn(cond, *args, **kw)``: ``sample_fn`` on this rank's band of
    image rows (``row_dim`` of the NCHW conditioning split over ``axis``),
    gathered on every rank.  For batches smaller than the devices: one
    face's sampling spread over several."""
    sp = spatial_layout(mesh, axis)

    def fn(cond, *args, **kw):
        with lay.use(sp):
            out = sample_fn(lay.local(cond, row_dim), *args, **kw)
            return lay.gather(out, row_dim)

    return fn


def _tp_rule(p: torch.Tensor, n: int, min_size: int, min_channels: int
             ) -> bool:
    # the port's weights put the output channels first (OIHW, [out, in]):
    # the JAX kernel's last dim
    return (p.dim() >= 2 and n >= min_size and p.shape[0] % n == 0
            and p.shape[0] >= min_channels)


def tp_param_sharding(mesh: Mesh, module: nn.Module, axis: str = MODEL_AXIS,
                      min_size: int = 2, min_channels: int = 128
                      ) -> dict[str, str | None]:
    """Each parameter name of ``module`` → ``axis`` where its output dim is
    split over it, else None (replicated): conv and dense weights whose
    output dim ``axis`` divides and that are at least ``min_channels``
    wide, on an axis of at least ``min_size`` ranks."""
    n = mesh.shape[axis]
    return {name: (axis if _tp_rule(p, n, min_size, min_channels) else None)
            for name, p in module.named_parameters()}


def _nets(modules) -> dict[str, nn.Module]:
    return {"sr": modules.unet, "arcface": modules.arcface,
            "mapping": modules.mapping}


def state_shardings(mesh: Mesh, modules, min_channels: int = 128
                    ) -> dict[str, dict[str, str | None]]:
    """``tp_param_sharding`` of each network of a ``JointModules``
    (``"sr"``, ``"arcface"``, ``"mapping"``, the JAX state's parts); the
    optimizer moments and the EMA follow their parameters.  With a 1-wide
    model axis nothing is split (pure DP)."""
    return {part: tp_param_sharding(mesh, net, min_channels=min_channels)
            for part, net in _nets(modules).items()}


def _owners(net: nn.Module) -> dict[str, nn.Module]:
    """Each parameter name of ``net`` → the module that holds it."""
    return {f"{mn}.{pn}" if mn else pn: m
            for mn, m in net.named_modules()
            for pn, _ in m.named_parameters(recurse=False)}


def _tp_params(modules) -> list[tuple[str, str, nn.Module, torch.Tensor]]:
    """(part, name, owner, parameter) of every split parameter of a
    ``JointModules``."""
    out = []
    for part, net in _nets(modules).items():
        owners = _owners(net)
        for name, p in net.named_parameters():
            owner = owners[name]
            if getattr(owner, "tp", None) is not None and name.endswith(
                    "weight"):
                out.append((part, name, owner, p))
    return out


def _split(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    n = t.shape[0] // axis.size
    return t.narrow(0, axis.index * n, n).clone()


def _mirrors(state, p: torch.Tensor, name: str, part: str,
             shape: torch.Size) -> list[tuple[dict, str]]:
    """The optimizer-moment and EMA slots of parameter ``p`` that have
    ``shape`` (its full or its split shape)."""
    slots = []
    if state is None:
        return slots
    st = state.opt.state.get(p, {})
    slots += [(st, k) for k, v in st.items()
              if isinstance(v, torch.Tensor) and v.shape == shape]
    if part == "sr" and state.ema is not None and name in state.ema.params \
            and state.ema.params[name].shape == shape:
        slots.append((state.ema.params, name))
    return slots


@torch.no_grad()
def shard_module_tp(mesh: Mesh, net: nn.Module, min_channels: int = 128,
                    state=None, part: str = "sr") -> nn.Module:
    """Split ``net``'s weights per :func:`tp_param_sharding`, in place:
    each keeps this rank's rows of its output dim, its module computes
    those channels and gathers the rest.  With a train ``state``, the
    optimizer moments (and, for ``part`` ``"sr"``, the EMA entries) that
    mirror a split weight are split with it."""
    axis = mesh.axis(MODEL_AXIS)
    specs = tp_param_sharding(mesh, net, min_channels=min_channels)
    owners = _owners(net)
    for name, p in net.named_parameters():
        if specs[name] is None:
            continue
        owner = owners[name]
        if not hasattr(owner, "tp"):
            raise TypeError(f"{name}: {type(owner).__name__} has no "
                            f"tensor-parallel forward")
        if state is not None:
            for slot, k in _mirrors(state, p, name, part, p.shape):
                slot[k] = _split(slot[k], axis)
        p.data = _split(p.data, axis)
        owner.tp = axis
    return net


def shard_state_dp_tp(mesh: Mesh, modules, state, min_channels: int = 128):
    """Lay a ``JointModules`` and its train ``state`` out per
    :func:`state_shardings` (``shard_module_tp`` of each network, its
    moments and EMA entries with it).  Returns ``state``."""
    for part, net in _nets(modules).items():
        shard_module_tp(mesh, net, min_channels, state, part)
    return state


@contextlib.contextmanager
def unsharded(modules, state) -> Iterator[None]:
    """The block sees every split weight, moment and EMA entry whole (each
    gathered from its ranks; the modules compute unsplit), e.g. to write or
    read a checkpoint in the JAX layout; after it they are split again,
    from what the block left in them.  Collective: every rank of the model
    axis enters it."""
    tp = _tp_params(modules)
    if not tp:
        yield
        return
    with torch.no_grad():
        for part, name, owner, p in tp:
            axis = owner.tp
            shard = p.shape
            for slot, k in _mirrors(state, p, name, part, shard):
                slot[k] = _gather_plain(slot[k], axis)
            p.data = _gather_plain(p.data, axis)
            owner.tp = None
            owner._tp_saved = axis
    try:
        yield
    finally:
        with torch.no_grad():
            for part, name, owner, p in tp:
                axis = owner._tp_saved
                full = p.shape
                for slot, k in _mirrors(state, p, name, part, full):
                    slot[k] = _split(slot[k], axis)
                p.data = _split(p.data, axis)
                owner.tp = axis
                del owner._tp_saved


def _gather_plain(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t.contiguous(), group=axis.group)
    return torch.cat(parts, 0)

