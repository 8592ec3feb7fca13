"""The device mesh over ``torch.distributed``: one process per rank.

Counterpart of ``sr3d_tpu/parallel/mesh.py``.  The JAX package is one
program over a ``jax.sharding.Mesh`` whose ``data`` axis splits the batch
and whose ``model`` axis splits the widest weights (or, for spatial serving,
the image height); GSPMD places every collective.  Here each rank is a
process that holds its own part of each tensor, and the collectives are
written out (``collectives.py``), so the mesh is a pair of process groups
per rank:

* ``make_mesh(shape, names)``: ranks laid out row-major over ``(data,
  model)``, as ``np.reshape`` lays the JAX package's devices out; one
  ``-1`` takes the rest of the world.  A mesh larger than the world raises
  ``ValueError``, as JAX's does; so does one smaller than a live world
  (a rank outside the mesh would have nothing to run).  Without a process
  group the world is this one process, and a mesh of one device needs no
  group at all, so one-process runs are the one-device code, bit for bit.
* ``Mesh.axis(name)``: this rank's ``Axis`` along a mesh axis (its group,
  its index on it, the axis size).
* ``init_distributed(backend)``: the default group from ``torchrun``'s
  environment.

The groups are made with ``dist.new_group`` on the default group's
backend (NCCL with one card per rank, ``gloo`` where several ranks share a
card or run on the CPU).  ``torch.distributed.device_mesh.DeviceMesh``
gives the same groups on ``gloo``; it is not used so that a one-process
run needs no process group, and the groups' backend is always the default
group's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Axis:
    """This rank's place along one mesh axis: the process ``group`` of the
    ranks that differ from it on this axis only (None where the axis has
    one rank), its ``index`` in that group and the axis ``size``."""

    name: str
    group: Any
    index: int
    size: int


class Mesh:
    """``shape`` maps each axis name to its size (``jax.sharding.Mesh.shape``);
    ``axis(name)`` is this rank's ``Axis`` along it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 rank: int = 0, groups: Mapping[str, Any] | None = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.rank = int(rank)
        self.size = int(np.prod(list(self.shape.values())))
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        groups = dict(groups or {})
        self._axes = {n: Axis(n, groups.get(n), int(c), self.shape[n])
                      for n, c in zip(self.axis_names, coords)}

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(mesh_shape: Sequence[int] = (-1, 1),
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS)) -> Mesh:
    """A mesh over the world; a single ``-1`` entry absorbs the ranks the
    others leave.  Collective over the default group: every rank calls it,
    in the same order as its other group constructions."""
    rank, n_world = world()
    shape = [int(s) for s in mesh_shape]
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = max(1, n_world // known)
    n = int(np.prod(shape))
    if n > n_world:
        raise ValueError(f"mesh {shape} needs {n} devices, have {n_world}")
    if n < n_world:
        raise ValueError(f"mesh {shape} covers {n} of the world's {n_world} "
                         f"ranks; start {n} processes")
    groups: dict[str, Any] = {}
    if n > 1:
        ranks = np.arange(n).reshape(shape)
        for ax, name in enumerate(axis_names):
            if shape[ax] == 1:
                continue
            lines = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
            for line in lines:   # every rank makes every group, in order
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[name] = g
    return Mesh(shape, axis_names, rank, groups)


def local_mesh_or_single() -> Mesh:
    """Every rank on the data axis."""
    return make_mesh((-1, 1))


def init_distributed(backend: str | None = None) -> tuple[int, int]:
    """Start the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) and return ``(rank, world size)``.

    ``backend=None`` is NCCL with one card per rank: the rank takes card
    ``LOCAL_RANK``, and it raises where the node's ranks outnumber its
    cards (NCCL refuses two ranks on one card).  Callers that put several
    ranks on one card, or run on the CPU, pass ``backend="gloo"``.  Where
    a default group exists it is used as it is; without ``torchrun``'s
    environment this is one process and no group is made."""
    if dist.is_initialized():
        return world()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1
    rank, n = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if backend is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        cards = torch.cuda.device_count()
        if per_node > cards:
            raise ValueError(
                f"{per_node} ranks on a node with {cards} CUDA device(s): "
                f"NCCL takes one card per rank; pass backend='gloo' to "
                f"share a card")
        torch.cuda.set_device(local)
        backend = "nccl"
    dist.init_process_group(backend, rank=rank, world_size=n)
    return rank, n


def barrier() -> None:
    """Wait for every rank of the default group (nothing without one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def is_main_rank() -> bool:
    """Rank 0 of the default group writes the files and the logs."""
    return world()[0] == 0


def local_rows(batch: Mapping[str, Any], axis: Axis | None) -> dict:
    """This rank's rows (dim 0) of every array or tensor of ``batch``
    split over ``axis`` (the counterpart of ``batch_sharding`` /
    ``shard_batch_pytree``); other entries pass through.  A leading dim
    the axis does not divide raises ``ValueError``."""
    if axis is None or axis.size == 1:
        return dict(batch)
    out = {}
    for k, v in batch.items():
        if isinstance(v, (np.ndarray, torch.Tensor)) and np.ndim(v):
            n = v.shape[0]
            if n % axis.size:
                raise ValueError(f"batch entry {k!r}: {n} rows not "
                                 f"divisible by the {axis.name} axis "
                                 f"({axis.size})")
            m = n // axis.size
            v = v[axis.index * m:(axis.index + 1) * m]
        out[k] = v
    return out


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` broadcast from the mesh's
    rank 0, in place (``jax.device_put(x, NamedSharding(mesh, P()))``)."""
    if mesh.size > 1:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=0)
    return module
