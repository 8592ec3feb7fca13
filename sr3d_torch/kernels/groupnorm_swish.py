"""GroupNorm → Swish: wrappers of the CUDA kernels and their plain versions.

Counterpart of ``sr3d_tpu/kernels/groupnorm_swish.py`` (``_gn_stats_pallas``
and ``_gn_swish_pallas``).  Layout is NCHW; ``gn_stats`` also takes NHWC
(``channels_last=True``) for the fused block of ``fused_block.py``.  The
kernels live in ``csrc/groupnorm_swish.cu``; its header says what bounds
them on an H100 and how the design handles it.

``gn_swish`` is differentiable: on CUDA a ``torch.autograd.Function`` runs
the kernels forward and, backward, autograd of the plain version recomputed
from the saved ``x`` (the JAX train step, too, differentiates its XLA
reference and has no GN backward kernel).

A wrapper runs the plain PyTorch version for a CPU tensor and the kernel for
a CUDA tensor; it never falls back from one to the other.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import check, function

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NHWC_ROWS_PER_BLOCK = 256  # pixels one block of the NHWC stats kernel sums


def gn_stats_reference(x: torch.Tensor, channels_last: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σx, Σx²) over (H, W) in fp32: ``[B, C]`` each."""
    xf = x.float()
    dims = (1, 2) if channels_last else (2, 3)
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


def gn_mean_scale(s: torch.Tensor, q: torch.Tensor, gamma: torch.Tensor,
                  n_per_group: float, groups: int, eps: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) ``mean`` and ``a = rstd·γ`` of GroupNorm from the
    per-channel moments ``[B, C]``, fp32.

    The group variance ``E[x²] − E[x]²`` is clamped at 0: for a
    near-constant map with a large mean the one-pass form cancels to a
    small negative number in fp32, and rsqrt of it would be NaN."""
    B, C = s.shape
    cg = C // groups
    g_mean = s.view(B, groups, cg).sum(-1) / n_per_group
    g_var = (q.view(B, groups, cg).sum(-1) / n_per_group
             - g_mean * g_mean).clamp_min(0)
    mean_c = g_mean.repeat_interleave(cg, dim=1)
    a = (1.0 / torch.sqrt(g_var + eps)).repeat_interleave(cg, dim=1) \
        * gamma.float()
    return mean_c, a


def gn_swish_reference(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, groups: int, eps: float = 1e-5
                       ) -> torch.Tensor:
    """GroupNorm with one-pass fp32 statistics over contiguous channel
    groups, then γ/β and swish, in ``x.dtype`` — the kernel's arithmetic,
    ``(x − mean)·(rstd·γ) + β``."""
    B, C, H, W = x.shape
    s, q = gn_stats_reference(x)
    mean_c, a = gn_mean_scale(s, q, gamma, float(H * W * (C // groups)),
                              groups, eps)
    xn = ((x.float() - mean_c[:, :, None, None]) * a[:, :, None, None]
          + beta.float()[None, :, None, None])
    return (xn * torch.sigmoid(xn)).to(x.dtype)


def _check_input(x: torch.Tensor, name: str) -> int:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous 4-D tensor, got "
                         f"shape {tuple(x.shape)}")
    return _DTYPES[x.dtype]


def gn_stats(x: torch.Tensor, channels_last: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σx, Σx²) over (H, W), fp32 ``[B, C]``, of NCHW ``x``
    or, with ``channels_last``, of NHWC ``x``."""
    if x.device.type == "cpu":
        return gn_stats_reference(x, channels_last)
    is_bf16 = _check_input(x, "gn_stats")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if channels_last:
        B, H, W, C = x.shape
        splits = -(-H * W // _NHWC_ROWS_PER_BLOCK)
        ps = torch.empty(B, splits, C, device=x.device, dtype=torch.float32)
        pq = torch.empty_like(ps)
        fn = function("groupnorm_swish", "sr3d_gn_stats_nhwc",
                      [_P, _P, _P, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int, _P])
        check(fn(x.data_ptr(), ps.data_ptr(), pq.data_ptr(), B, H * W, C,
                 _NHWC_ROWS_PER_BLOCK, is_bf16, stream), "gn_stats")
        gn_stats.launches += 1
        return ps.sum(1), pq.sum(1)
    B, C, H, W = x.shape
    s = torch.empty(B, C, device=x.device, dtype=torch.float32)
    q = torch.empty_like(s)
    fn = function("groupnorm_swish", "sr3d_gn_stats",
                  [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   _P])
    check(fn(x.data_ptr(), s.data_ptr(), q.data_ptr(), B * C, H * W, is_bf16,
             stream), "gn_stats")
    gn_stats.launches += 1
    return s, q


gn_stats.launches = 0


def _gn_swish_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    is_bf16 = _check_input(x, "gn_swish")
    B, C, H, W = x.shape
    if C % groups:
        raise ValueError(f"gn_swish: {C} channels do not split into "
                         f"{groups} groups")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != (C,) or not p.is_contiguous()):
            raise ValueError(f"gn_swish: {name} must be a contiguous fp32 "
                             f"[{C}] tensor on {x.device}")
    s, q = gn_stats(x)
    y = torch.empty_like(x)
    fn = function("groupnorm_swish", "sr3d_gn_swish_apply",
                  [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                   _P])
    check(fn(x.data_ptr(), s.data_ptr(), q.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), y.data_ptr(), B, C, groups, H * W, eps, is_bf16,
             torch.cuda.current_stream(x.device).cuda_stream), "gn_swish")
    gn_swish.launches += 1
    return y


class _GnSwish(torch.autograd.Function):
    """The CUDA kernels forward; backward, autograd of
    ``gn_swish_reference`` recomputed from the saved ``x``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps = groups, eps
        return _gn_swish_cuda(x, gamma, beta, groups, eps)

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip((x, gamma, beta), need)]
            y = gn_swish_reference(*ins, ctx.groups, ctx.eps)
            wanted = [t for t, n in zip(ins, need) if n]
            got = iter(torch.autograd.grad(y, wanted, gy))
        return (*(next(got) if n else None for n in need), None, None)


def gn_swish(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``swish(GroupNorm(x)·γ + β)`` of NCHW ``x``, in ``x.dtype``;
    ``gamma``/``beta`` are fp32 ``[C]``.  On CUDA: the stats kernel, then
    the apply kernel; differentiable in x, γ and β."""
    if x.device.type == "cpu":
        return gn_swish_reference(x, gamma, beta, groups, eps)
    return _GnSwish.apply(x, gamma, beta, groups, eps)


gn_swish.launches = 0
