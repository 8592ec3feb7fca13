"""Which part of each activation this rank holds, for the code that needs
the whole tensor's statistics.

Under the JAX package's GSPMD every batch statistic, abs-max, loss mean and
random draw is over the global array, whatever its sharding.  Here a rank
holds only its rows of the batch (data parallel) or its band of image rows
(spatial), so the few places that reduce over those dims ask the active
``Layout`` which axis holds the rest:

* ``randn`` / ``rand`` / ``local``: a draw (or a replayed draw) of the
  global shape, this rank's part kept (``diffusion/gaussian.py``, dropout);
* ``amax``: a max over the global tensor (the int8 dynamic scale);
* ``gather``: the global tensor on every rank (the served image);
* ``average_gradients``, ``mean_metric``: the global-batch mean.

The batch and row counts of the global tensor are this rank's times the
axis sizes (the mesh splits evenly; ``mesh.local_rows`` checks it).  The
layout is set for a region of code with ``use(layout)`` and read with
``current()``.  It is process-wide, not per thread, so the autograd
engine's threads (which run checkpointed recomputes) see it too; with no
layout set (``Layout()``), every helper is the one-device identity.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, Sequence

import torch
import torch.distributed as dist

from .collectives import all_gather, all_reduce_max
from .mesh import Axis


@dataclasses.dataclass(frozen=True)
class Layout:
    """``batch``: the axis dim 0 is split over (DP); ``rows``: the axis the
    image height is split over (spatial).  None: not split."""

    batch: Axis | None = None
    rows: Axis | None = None

    def axes(self) -> list[Axis]:
        return [a for a in (self.batch, self.rows)
                if a is not None and a.size > 1]


_ACTIVE = Layout()


def current() -> Layout:
    return _ACTIVE


@contextlib.contextmanager
def use(layout: Layout) -> Iterator[Layout]:
    """Make ``layout`` the active one for the block (nested blocks
    restore the outer one)."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, layout
    try:
        yield layout
    finally:
        _ACTIVE = outer


def _part(t: torch.Tensor, dim: int, axis: Axis | None) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return t
    n = t.shape[dim] // axis.size
    return t.narrow(dim, axis.index * n, n)


def local(t: torch.Tensor, row_dim: int | None = None) -> torch.Tensor:
    """This rank's part of a global tensor: its rows of dim 0, and of
    ``row_dim`` (the image height) its band."""
    lay = current()
    t = _part(t, 0, lay.batch)
    if row_dim is not None and t.dim() > row_dim:
        t = _part(t, row_dim, lay.rows)
    return t


def global_shape(shape: Sequence[int], row_dim: int | None = None
                 ) -> list[int]:
    lay = current()
    shape = list(shape)
    if lay.batch is not None and shape:
        shape[0] *= lay.batch.size
    if lay.rows is not None and row_dim is not None and len(shape) > row_dim:
        shape[row_dim] *= lay.rows.size
    return shape


def randn(shape: Sequence[int], *, generator: torch.Generator | None,
          device, row_dim: int | None = None) -> torch.Tensor:
    """``torch.randn`` of this rank's ``shape``: the global draw from the
    shared ``generator``, this rank's part kept, so that a sharded run
    draws what the one-device run draws."""
    full = torch.randn(global_shape(shape, row_dim), generator=generator,
                       device=device, dtype=torch.float32)
    return local(full, row_dim)


def rand(shape: Sequence[int], *, generator: torch.Generator | None,
         device, row_dim: int | None = None) -> torch.Tensor:
    """``torch.rand`` as :func:`randn` draws."""
    full = torch.rand(global_shape(shape, row_dim), generator=generator,
                      device=device)
    return local(full, row_dim)


def gather(t: torch.Tensor, row_dim: int | None = None) -> torch.Tensor:
    """The global tensor from every rank's part (dim 0 over the batch
    axis, ``row_dim`` over the rows axis)."""
    lay = current()
    if row_dim is not None:
        t = all_gather(t, row_dim, lay.rows)
    return all_gather(t, 0, lay.batch)


def amax(x: torch.Tensor) -> torch.Tensor:
    """``x`` (a per-rank maximum) maximised over every axis that holds a
    part of the tensor it came from."""
    for axis in current().axes():
        x = all_reduce_max(x, axis)
    return x


@torch.no_grad()
def average_gradients(params: Sequence[torch.Tensor]) -> None:
    """Each ``.grad`` of ``params`` averaged over the batch axis, in place
    (one all-reduce of a flat buffer per dtype): every rank then steps its
    optimizer on the global-batch gradient.  Nothing without a batch
    axis."""
    axis = current().batch
    if axis is None or axis.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, group=axis.group)
        flat /= axis.size
        torch._foreach_copy_(same, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in same]), same)])


@torch.no_grad()
def mean_metric(x: torch.Tensor) -> torch.Tensor:
    """A per-rank mean over its rows, as the global batch's mean (equal
    shards)."""
    axis = current().batch
    if axis is None or axis.size == 1:
        return x
    y = x.detach().float().clone()
    dist.all_reduce(y, group=axis.group)
    return (y / axis.size).to(x.dtype)
