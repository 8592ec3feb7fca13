"""The collectives that GSPMD inserts for the JAX package, written out as
``torch.autograd.Function``s over a mesh ``Axis``.

They use only ``all_reduce``, ``all_gather``, ``broadcast`` and
``barrier``: ``gloo`` (the backend of several ranks on one card, and of the
CPU) has these for CPU and CUDA tensors, and has no ``reduce_scatter``.
(``torch.distributed.nn.functional.all_gather`` is not used: its backward
needs ``reduce_scatter`` or a CUDA ``all_to_all``.)

* ``all_gather(x, dim, axis)``: the ranks' parts concatenated along
  ``dim``.  Backward: the gradient all-reduced, then this rank's slice —
  the adjoint where each rank's result feeds its own part of the loss (the
  k and v of spatial attention, a halo).  ``replicated_grad=True`` keeps
  the slice without the all-reduce: the adjoint where every rank computes
  the same thing from the gathered tensor (the output of a tensor-parallel
  layer), whose gradients are then already the whole one on every rank.
* ``all_reduce_sum(x, axis)``: the sum; backward, the gradient's sum.
* ``copy_to(x, axis)``: the identity; backward, the gradient's sum (the
  input of a tensor-parallel layer, which each rank differentiates for its
  own output channels only).
* ``all_reduce_max(x, axis)``: the maximum, no gradient.
* ``halo_rows(x, axis, dim)``: the row above and the row below this rank's
  band of rows, zeros at the image's edges (SAME padding).

An axis of one rank (or None) makes each of them the identity, without a
copy, so one-device paths run as they did.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Axis


def _trivial(axis: Axis | None) -> bool:
    return axis is None or axis.size == 1


def _gather(x: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(parts, x, group=axis.group)
    return torch.cat(parts, dim)


def _sum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=axis.group)
    return y


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis, replicated_grad):
        ctx.dim, ctx.axis, ctx.n = dim, axis, x.shape[dim]
        ctx.replicated_grad = replicated_grad
        return _gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated_grad:
            g = _sum(g, ctx.axis)
        g = g.narrow(ctx.dim, ctx.axis.index * ctx.n, ctx.n).contiguous()
        return g, None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.axis), None


def all_gather(x: torch.Tensor, dim: int, axis: Axis | None,
               replicated_grad: bool = False) -> torch.Tensor:
    if _trivial(axis):
        return x
    return _AllGather.apply(x, dim, axis, replicated_grad)


def all_reduce_sum(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    if _trivial(axis):
        return x
    return _AllReduceSum.apply(x, axis)


def copy_to(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    if _trivial(axis):
        return x
    return _CopyTo.apply(x, axis)


@torch.no_grad()
def all_reduce_max(x: torch.Tensor, axis: Axis | None) -> torch.Tensor:
    if _trivial(axis):
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=axis.group)
    return y


def halo_rows(x: torch.Tensor, axis: Axis, dim: int = 2
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(above, below)``: the last row of the band above this rank's and
    the first row of the band below it, one row each along ``dim``; zeros
    where the band is the image's first or last.  One all-gather of every
    rank's first and last row; differentiable (a neighbour's use of a row
    comes back to its owner)."""
    n = x.shape[dim]
    edges = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, n - 1, 1)], dim)
    rows = all_gather(edges, dim, axis)         # [..., 2·size, ...]
    i = axis.index
    zero = torch.zeros_like(edges.narrow(dim, 0, 1))
    above = rows.narrow(dim, 2 * i - 1, 1) if i > 0 else zero
    below = (rows.narrow(dim, 2 * i + 2, 1) if i < axis.size - 1 else zero)
    return above, below
