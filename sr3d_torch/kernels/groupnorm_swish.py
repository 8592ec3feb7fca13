"""GroupNorm → Swish: wrappers of the CUDA kernels and their plain versions.

Counterpart of ``sr3d_tpu/kernels/groupnorm_swish.py`` (``_gn_stats_pallas``
and ``_gn_swish_pallas``).  Layout is NCHW; ``gn_stats`` also takes NHWC
(``channels_last=True``) for the fused block of ``fused_block.py``.  The
kernels live in ``csrc/groupnorm_swish.cu``; its header says what bounds
them on an H100 and how the design handles it.

``gn_plan`` picks ``gn_swish``'s kernel by shape: ``onepass`` (one launch,
x read once, a cluster of CTAs per group holding it in shared memory) where
a group fits, else ``two_pass`` (``gn_stats``, then the apply kernel).  It is
pure Python, so the CPU tests hold its choices.

``gn_swish`` is differentiable: on CUDA a ``torch.autograd.Function`` runs
the forward kernels, and its backward ``gn_swish_backward``, the backward
kernels (``gn_bwd_plan``: one pass over a cluster holding a group's x and
gy, or three passes).  Their plain twin is the closed form
``gn_swish_backward_reference``; the JAX train step takes the same gradient
by XLA's autodiff of its reference and has no GN backward kernel.  On the
CPU ``gn_swish`` is the plain version, differentiated by autograd.

A wrapper runs the plain PyTorch version for a CPU tensor and the kernel for
a CUDA tensor; it never falls back from one to the other.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ._build import check, function

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NHWC_ROWS_PER_BLOCK = 256  # pixels one block of the NHWC stats kernel sums
GN_THREADS = 256             # threads of a one-pass CTA, at most
GN_SHARE_BYTES = 49152       # a CTA's share of a group, where it can be ...
GN_CTA_BYTES = 65536         # ... and at most (the kernel's shared memory)
GN_MAX_CLUSTER = 8           # the portable cluster size
GN_BWD_SHARE_BYTES = 65536   # a backward CTA's x + gy share, where it can be
GN_BWD_CTA_BYTES = 196608    # ... and at most (the kernel's shared memory)
GN_BWD_MAX_CG = 64           # channels a group, at most, on the one-pass path


@dataclass(frozen=True)
class GnPlan:
    """How one ``gn_swish`` call runs on the card.  ``path`` is
    ``"onepass"`` (``gn_swish_onepass_kernel``: a cluster of ``cluster``
    CTAs of ``threads`` threads per (b, group), each rank holding its share
    of the group's ``group_vectors`` 16-byte vectors in shared memory) or
    ``"two_pass"`` (``gn_stats``, then ``gn_swish_apply_kernel``); ``why``
    says why."""

    path: str
    why: str
    cluster: int = 0
    threads: int = 0
    group_vectors: int = 0


def gn_plan(B: int, C: int, G: int, HW: int, dtype: torch.dtype,
            sm_count: int = 132) -> GnPlan:
    """The kernel for NCHW x ``[B, C, H, W]`` (HW = H·W) in ``G`` groups on
    a card with ``sm_count`` SMs.  The cluster grows (1, 2, 4, 8) while a
    rank's share of a group exceeds ``GN_SHARE_BYTES``, or while there are
    fewer than two CTAs an SM and a share keeps ≥ 8 KB; a CTA has a thread
    per vector of its share, up to ``GN_THREADS``.  (Measured on the H100
    with ``python -m sr3d_torch.profile_gn``: larger shares win while the
    CTAs fill the card twice over.)"""
    per_vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if HW % per_vec:
        return GnPlan("two_pass", f"H·W = {HW} is not a multiple of the "
                                  f"{per_vec} values of a 16-byte vector")
    n = C // G * HW // per_vec
    S = 1
    while S < GN_MAX_CLUSTER and (
            16 * -(-n // S) > GN_SHARE_BYTES
            or (B * G * S < 2 * sm_count and 16 * -(-n // S) >= 2 * 8192)):
        S *= 2
    share = -(-n // S)
    if 16 * share > GN_CTA_BYTES:
        return GnPlan("two_pass", f"a group of {16 * n} bytes exceeds a "
                                  f"cluster of {GN_MAX_CLUSTER} CTAs' "
                                  f"{GN_CTA_BYTES} bytes each")
    T = min(GN_THREADS, 32 * -(-share // 32))
    return GnPlan("onepass", f"{S} CTA(s) of {T} threads, {16 * share} "
                             f"bytes each, per group", S, T, n)


@dataclass(frozen=True)
class GnBwdPlan:
    """How one ``gn_swish_backward`` call runs on the card.  ``path`` is
    ``"onepass"`` (``gn_bwd_onepass_kernel``: a cluster of ``cluster`` CTAs
    of ``threads`` threads per (b, group), each rank holding its share of
    the group's ``group_vectors`` 16-byte vectors of x and as many of gy in
    shared memory) or ``"multipass"`` (``gn_stats``' kernel, then
    ``gn_bwd_reduce_kernel`` and ``gn_bwd_dx_kernel``); ``why`` says why."""

    path: str
    why: str
    cluster: int = 0
    threads: int = 0
    group_vectors: int = 0


def gn_bwd_plan(B: int, C: int, G: int, HW: int, dtype: torch.dtype,
                sm_count: int = 132) -> GnBwdPlan:
    """The backward kernels for NCHW x ``[B, C, H, W]`` (HW = H·W) in ``G``
    groups on a card with ``sm_count`` SMs.  As ``gn_plan``, with a rank's
    share counting x and gy: the cluster grows (1, 2, 4, 8) while a share
    exceeds ``GN_BWD_SHARE_BYTES``, or while there are fewer than two CTAs
    an SM and a share keeps ≥ 16 KB; one thread per vector of x in the
    share, up to ``GN_THREADS``.  Groups of more than ``GN_BWD_MAX_CG``
    channels, H·W not a multiple of a 16-byte vector and shares above
    ``GN_BWD_CTA_BYTES`` take the multi-pass path."""
    per_vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    if HW % per_vec:
        return GnBwdPlan("multipass", f"H·W = {HW} is not a multiple of the "
                                      f"{per_vec} values of a 16-byte vector")
    cg = C // G
    if cg > GN_BWD_MAX_CG:
        return GnBwdPlan("multipass", f"{cg} channels a group, more than "
                                      f"the one-pass kernel's "
                                      f"{GN_BWD_MAX_CG}")
    n = cg * HW // per_vec
    S = 1
    while S < GN_MAX_CLUSTER and (
            32 * -(-n // S) > GN_BWD_SHARE_BYTES
            or (B * G * S < 2 * sm_count and 32 * -(-n // S) >= 2 * 16384)):
        S *= 2
    share = -(-n // S)
    if 32 * share > GN_BWD_CTA_BYTES:
        return GnBwdPlan("multipass", f"a group's x and gy, {32 * n} bytes, "
                                      f"exceed a cluster of {GN_MAX_CLUSTER} "
                                      f"CTAs' {GN_BWD_CTA_BYTES} bytes each")
    T = min(GN_THREADS, 32 * -(-share // 32))
    return GnBwdPlan("onepass", f"{S} CTA(s) of {T} threads, {32 * share} "
                                f"bytes of x and gy each, per group", S, T, n)


def gn_stats_reference(x: torch.Tensor, channels_last: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (Σx, Σx²) over (H, W) in fp32: ``[B, C]`` each."""
    xf = x.float()
    dims = (1, 2) if channels_last else (2, 3)
    return xf.sum(dim=dims), (xf * xf).sum(dim=dims)


def _group_moments(s: torch.Tensor, q: torch.Tensor, n_per_group: float,
                   groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, G) mean and one-pass variance ``E[x²] − E[x]²`` (not yet
    clamped) from the per-channel moments ``[B, C]``, fp32."""
    B, C = s.shape
    cg = C // groups
    g_mean = s.view(B, groups, cg).sum(-1) / n_per_group
    return g_mean, (q.view(B, groups, cg).sum(-1) / n_per_group
                    - g_mean * g_mean)


def _per_channel(t: torch.Tensor, C: int) -> torch.Tensor:
    """``[B, G]`` → ``[B, C]``, each group's value on its channels: a
    broadcast, not repeat_interleave, whose backward is then a sum, not an
    index_add (atomics on CUDA, so run-to-run differences)."""
    B, G = t.shape
    return t[:, :, None].expand(B, G, C // G).reshape(B, C)


def gn_mean_scale(s: torch.Tensor, q: torch.Tensor, gamma: torch.Tensor,
                  n_per_group: float, groups: int, eps: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) ``mean`` and ``a = rstd·γ`` of GroupNorm from the
    per-channel moments ``[B, C]``, fp32.

    The group variance ``E[x²] − E[x]²`` is clamped at 0: for a
    near-constant map with a large mean the one-pass form cancels to a
    small negative number in fp32, and rsqrt of it would be NaN."""
    C = s.shape[1]
    g_mean, g_var = _group_moments(s, q, n_per_group, groups)
    return _per_channel(g_mean, C), \
        _per_channel(1.0 / torch.sqrt(g_var.clamp_min(0) + eps), C) \
        * gamma.float()


def gn_swish_apply_reference(x: torch.Tensor, s: torch.Tensor,
                             q: torch.Tensor, gamma: torch.Tensor,
                             beta: torch.Tensor, groups: int, eps: float,
                             count: int) -> torch.Tensor:
    """``swish(GroupNorm(x)·γ + β)`` of NCHW ``x`` from per-channel
    moments ``s``, ``q`` ``[B, C]`` taken over ``count`` values per channel
    (H·W of x, or of the whole image where x is a band of its rows)."""
    C = x.shape[1]
    mean_c, a = gn_mean_scale(s, q, gamma, float(count * (C // groups)),
                              groups, eps)
    xn = ((x.float() - mean_c[:, :, None, None]) * a[:, :, None, None]
          + beta.float()[None, :, None, None])
    return (xn * torch.sigmoid(xn)).to(x.dtype)


def gn_swish_reference(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, groups: int, eps: float = 1e-5
                       ) -> torch.Tensor:
    """GroupNorm with one-pass fp32 statistics over contiguous channel
    groups, then γ/β and swish, in ``x.dtype`` — the kernel's arithmetic,
    ``(x − mean)·(rstd·γ) + β``."""
    s, q = gn_stats_reference(x)
    return gn_swish_apply_reference(x, s, q, gamma, beta, groups, eps,
                                    x.shape[2] * x.shape[3])


def gn_swish_backward_reference(x: torch.Tensor, gamma: torch.Tensor,
                                beta: torch.Tensor, gy: torch.Tensor,
                                groups: int, eps: float = 1e-5
                                ) -> tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """``(dx, dγ, dβ)`` of ``gn_swish_reference`` given ``gy`` = dL/dy, in
    closed form, fp32 (dx in ``x.dtype``), with ``gn_mean_scale``'s
    statistics.  With x̂ = (x − μ)·r, z = x̂·γ + β:
    dz = gy·σ(z)·(1 + z·(1 − σ(z))); dβ = Σ dz, dγ = Σ dz·x̂ over (b, h, w);
    dx = r·(dz·γ − mean_g(dz·γ) − x̂·mean_g(dz·γ·x̂)), the group means
    formed from the per-(b, c) sums of dz and dz·x̂.  Where the clamp holds a
    group's variance at 0 the last term drops out, as in autograd of the
    clamp.  The backward kernels' plain twin."""
    B, C, H, W = x.shape
    n = float(H * W * (C // groups))
    s, q = gn_stats_reference(x)
    g_mean, g_var = _group_moments(s, q, n, groups)
    r = _per_channel(1.0 / torch.sqrt(g_var.clamp_min(0) + eps), C)
    keep = _per_channel((g_var >= 0).float(), C)
    xh = (x.float() - _per_channel(g_mean, C)[:, :, None, None]) \
        * r[:, :, None, None]
    gam = gamma.float()[None, :, None, None]
    z = xh * gam + beta.float()[None, :, None, None]
    sg = torch.sigmoid(z)
    dz = gy.float() * sg * (1 + z * (1 - sg))
    P, Q = dz.sum((2, 3)), (dz * xh).sum((2, 3))

    def group_mean(t: torch.Tensor) -> torch.Tensor:
        return _per_channel(
            (t * gamma.float()).view(B, groups, C // groups).sum(-1) / n, C)

    m1, m2 = group_mean(P), group_mean(Q) * keep
    dx = r[:, :, None, None] * (dz * gam - m1[:, :, None, None]
                                - xh * m2[:, :, None, None])
    return dx.to(x.dtype), Q.sum(0), P.sum(0)


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
    s, q = _launch_stats(x, "gn_stats")
    gn_stats.launches += 1
    return s, q


gn_stats.launches = 0


def _launch_stats(x: torch.Tensor, what: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The NCHW stats kernel on a checked ``x``, without counting a
    launch."""
    B, C, H, W = x.shape
    s = torch.empty(B, C, device=x.device, dtype=torch.float32)
    q = torch.empty_like(s)
    fn = function("groupnorm_swish", "sr3d_gn_stats",
                  [_P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   _P])
    check(fn(x.data_ptr(), s.data_ptr(), q.data_ptr(), B * C, H * W,
             _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream), what)
    return s, q


def _launch_gn_swish(x: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, groups: int, eps: float,
                     plan: GnPlan) -> torch.Tensor:
    """Run ``plan``'s kernel(s) on inputs ``gn_swish`` has checked, without
    counting a launch.  ``gn_swish`` passes ``gn_plan``'s plan; the tuning
    sweep ``profile_gn`` times others."""
    B, C, H, W = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    is_bf16 = _DTYPES[x.dtype]
    if plan.path == "onepass":
        if x.data_ptr() % 16:   # 16-byte loads; a view may start anywhere
            x = x.clone()
        y = torch.empty_like(x)
        fn = function("groupnorm_swish", "sr3d_gn_swish_onepass",
                      [_P] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float]
                      + [ctypes.c_int] * 3 + [_P])
        check(fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                 y.data_ptr(), B, C, groups, H * W, eps, plan.cluster,
                 plan.threads, is_bf16, stream), "gn_swish")
        return y
    s, q = gn_stats(x)
    return _launch_apply(x, s, q, gamma, beta, groups, eps, H * W)


def _launch_apply(x, s, q, gamma, beta, groups, eps, count) -> torch.Tensor:
    """The apply kernel on checked inputs, without counting a launch."""
    B, C, H, W = x.shape
    y = torch.empty_like(x)
    fn = function("groupnorm_swish", "sr3d_gn_swish_apply",
                  [_P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_float, ctypes.c_int, _P])
    check(fn(x.data_ptr(), s.data_ptr(), q.data_ptr(), gamma.data_ptr(),
             beta.data_ptr(), y.data_ptr(), B, C, groups, H * W, count, eps,
             _DTYPES[x.dtype],
             torch.cuda.current_stream(x.device).cuda_stream), "gn_swish")
    return y


def _check_gn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              groups: int, what: str) -> None:
    _check_input(x, what)
    C = x.shape[1]
    if C % groups:
        raise ValueError(f"{what}: {C} channels do not split into "
                         f"{groups} groups")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if (p.device != x.device or p.dtype != torch.float32
                or tuple(p.shape) != (C,) or not p.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous fp32 "
                             f"[{C}] tensor on {x.device}")


def _gn_swish_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   groups: int, eps: float) -> torch.Tensor:
    _check_gn(x, gamma, beta, groups, "gn_swish")
    B, C, H, W = x.shape
    plan = gn_plan(B, C, groups, H * W, x.dtype,
                   torch.cuda.get_device_properties(
                       x.device).multi_processor_count)
    y = _launch_gn_swish(x, gamma, beta, groups, eps, plan)
    gn_swish.launches += 1
    return y


def gn_swish_backward(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, gy: torch.Tensor, groups: int,
                      eps: float = 1e-5,
                      need: tuple[bool, bool, bool] = (True, True, True)
                      ) -> tuple[torch.Tensor | None, ...]:
    """``(dx, dγ, dβ)`` of ``gn_swish`` at ``x`` given ``gy`` = dL/dy (x's
    shape and dtype; a view is made contiguous); each None where ``need``
    says it is not wanted.  On CUDA: the kernels ``gn_bwd_plan`` picks (one
    launch counted per call); on the CPU: the closed form."""
    if x.device.type == "cpu":
        got = gn_swish_backward_reference(x, gamma, beta, gy, groups, eps)
        return tuple(t if n else None for t, n in zip(got, need))
    _check_gn(x, gamma, beta, groups, "gn_swish_backward")
    if (gy.shape != x.shape or gy.dtype != x.dtype
            or gy.device != x.device):
        raise ValueError(f"gn_swish_backward: gy must match x "
                         f"({tuple(x.shape)}, {x.dtype}, {x.device}), got "
                         f"({tuple(gy.shape)}, {gy.dtype}, {gy.device})")
    gy = gy.contiguous()
    # the one-pass kernel's bulk copies take 16-byte aligned addresses; a
    # view may start anywhere
    x, gy = (t.clone() if t.data_ptr() % 16 else t for t in (x, gy))
    B, C, H, W = x.shape
    dev = x.device
    plan = gn_bwd_plan(B, C, groups, H * W, x.dtype,
                       torch.cuda.get_device_properties(
                           dev).multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = _DTYPES[x.dtype]
    dx = torch.empty_like(x) if need[0] else None
    want_p = plan.path == "multipass" or need[1] or need[2]
    pdz = torch.empty(B, C, device=dev, dtype=torch.float32) \
        if want_p else None
    pdzx = torch.empty_like(pdz) if want_p else None
    if plan.path == "onepass":
        fn = function("groupnorm_swish", "sr3d_gn_swish_bwd_onepass",
                      [_P] * 7 + [ctypes.c_int] * 4 + [ctypes.c_float]
                      + [ctypes.c_int] * 3 + [_P])
        check(fn(x.data_ptr(), gy.data_ptr(), gamma.data_ptr(),
                 beta.data_ptr(), *(None if t is None else t.data_ptr()
                                    for t in (dx, pdz, pdzx)),
                 B, C, groups, H * W, eps, plan.cluster, plan.threads,
                 is_bf16, stream), "gn_swish_backward")
    else:
        s, q = _launch_stats(x, "gn_swish_backward")
        fn = function("groupnorm_swish", "sr3d_gn_swish_bwd_reduce",
                      [_P] * 8 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int64, ctypes.c_float,
                                  ctypes.c_int, _P])
        check(fn(x.data_ptr(), gy.data_ptr(), s.data_ptr(), q.data_ptr(),
                 gamma.data_ptr(), beta.data_ptr(), pdz.data_ptr(),
                 pdzx.data_ptr(), B, C, groups, H * W, eps, is_bf16, stream),
              "gn_swish_backward")
        if need[0]:
            fn = function("groupnorm_swish", "sr3d_gn_swish_bwd_dx",
                          [_P] * 9 + [ctypes.c_int64, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int64,
                                      ctypes.c_float, ctypes.c_int, _P])
            check(fn(x.data_ptr(), gy.data_ptr(), s.data_ptr(), q.data_ptr(),
                     gamma.data_ptr(), beta.data_ptr(), pdz.data_ptr(),
                     pdzx.data_ptr(), dx.data_ptr(), B, C, groups, H * W,
                     eps, is_bf16, stream), "gn_swish_backward")
    gn_swish_backward.launches += 1
    # dγ, dβ: the per-(b, c) sums added over b in a fixed order
    return (dx, pdzx.sum(0) if need[1] else None,
            pdz.sum(0) if need[2] else None)


gn_swish_backward.launches = 0


class _GnSwish(torch.autograd.Function):
    """The CUDA kernels forward (``gn_plan``) and backward
    (``gn_swish_backward``), from the saved ``x``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.groups, ctx.eps = groups, eps
        return _gn_swish_cuda(x, gamma, beta, groups, eps)

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta = ctx.saved_tensors
        # a profiler range, so that profile_train can attribute its time
        with torch.profiler.record_function("gn_swish.backward"):
            got = gn_swish_backward(x, gamma, beta, gy, ctx.groups, ctx.eps,
                                    ctx.needs_input_grad[:3])
        return (*got, None, None)


def gn_swish(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             groups: int, eps: float = 1e-5) -> torch.Tensor:
    """``swish(GroupNorm(x)·γ + β)`` of NCHW ``x``, in ``x.dtype``;
    ``gamma``/``beta`` are fp32 ``[C]``.  On CUDA: the kernel ``gn_plan``
    picks (one launch counted per call); differentiable in x, γ and β."""
    if x.device.type == "cpu":
        return gn_swish_reference(x, gamma, beta, groups, eps)
    return _GnSwish.apply(x, gamma, beta, groups, eps)


gn_swish.launches = 0


def gn_swish_apply(x: torch.Tensor, s: torch.Tensor, q: torch.Tensor,
                   gamma: torch.Tensor, beta: torch.Tensor, groups: int,
                   eps: float = 1e-5, count: int | None = None
                   ) -> torch.Tensor:
    """``swish(GroupNorm(x)·γ + β)`` of NCHW ``x`` from given per-channel
    moments ``s``, ``q`` (fp32 ``[B, C]``, e.g. ``gn_stats`` of each band
    of an image's rows summed over the bands) over ``count`` values per
    channel (default H·W of ``x``).  On CUDA: the apply kernel, one launch
    counted in ``gn_swish.launches`` (it is half of ``gn_swish``'s
    two-pass path); no gradient there (the spatial serving path)."""
    count = x.shape[2] * x.shape[3] if count is None else int(count)
    if x.device.type == "cpu":
        return gn_swish_apply_reference(x, s, q, gamma, beta, groups, eps,
                                        count)
    _check_gn(x, gamma, beta, groups, "gn_swish_apply")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, s, q, gamma, beta)):
        raise NotImplementedError("gn_swish_apply has no backward on CUDA "
                                  "(spatial sharding serves only)")
    B, C = x.shape[:2]
    for name, t in (("s", s), ("q", q)):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (B, C) or not t.is_contiguous()):
            raise ValueError(f"gn_swish_apply: {name} must be a contiguous "
                             f"fp32 [{B}, {C}] tensor on {x.device}")
    y = _launch_apply(x, s, q, gamma, beta, groups, eps, count)
    gn_swish.launches += 1
    return y
