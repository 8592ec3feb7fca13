"""Spatial self-attention: the wrapper of the CUDA kernel, its plain
version and its gradient.

Counterpart of ``sr3d_tpu/kernels/attention.py`` (``_attn_pallas`` and its
custom VJP ``_attn_bwd``).  q, k, v are ``[B, HW, C]``; the softmax scale is
``1/sqrt(channels)`` over the full channel count, as the reference einsum
attention has it.  The forward kernel lives in ``csrc/attention.cu``.  On
CUDA a ``torch.autograd.Function`` runs it forward and ``_attn_bwd``'s math
backward (``spatial_attention_backward``: recomputed fp32 scores, products
through ``torch.einsum``; the JAX package computes this backward in XLA,
outside any Pallas kernel).

``attn_plan`` names the kernel for a shape (``mma``: bf16 on the tensor
cores over a thread-block cluster; ``simt``: CUDA cores, for fp32 and bf16
with C not a multiple of 8; ``long``: CUDA cores in two passes over key
tiles, for more than ``MAX_TOKENS`` tokens in either dtype); it is pure
Python, so the CPU tests hold its choices.

The wrapper runs the plain version for a CPU tensor and a kernel for a CUDA
tensor, never one in place of the other, and counts kernel launches in
``spatial_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ._build import check, function

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TOKENS = 256  # score rows the mma and simt kernels keep on chip
SLICE = 64  # channels of one CTA's slice
MAX_CLUSTER = 8  # the portable cluster size


@dataclass(frozen=True)
class AttnPlan:
    """How one attention call runs on the card.  ``path`` is ``"mma"``
    (``attn_mma_kernel``: a cluster of ``cluster`` CTAs, one per 64-channel
    slice, for each (64-query tile, image) pair), ``"simt"``
    (``attn_fwd_kernel``) or ``"long"`` (``attn_long_kernel``); ``why`` says
    why."""

    path: str
    why: str
    cluster: int = 0


def attn_plan(HW: int, C: int, dtype: torch.dtype) -> AttnPlan:
    """The kernel for q, k, v ``[B, HW, C]`` of ``dtype``."""
    if HW > MAX_TOKENS:
        return AttnPlan("long", f"{HW} tokens > {MAX_TOKENS}: two passes "
                                f"over key tiles")
    if dtype != torch.bfloat16:
        return AttnPlan("simt", "fp32: tensor cores would mean TF32")
    if C % 8:
        return AttnPlan("simt", f"C = {C} is not a multiple of 8 "
                                f"(16-byte rows)")
    cluster = min(MAX_CLUSTER, -(-C // SLICE))
    return AttnPlan("mma", f"bf16: {cluster} channel slices a cluster",
                    cluster)


def spatial_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, scale: float
                                ) -> torch.Tensor:
    """``softmax(q kᵀ · scale) v`` with fp32 scores; the probabilities are
    rounded to ``v.dtype`` before the product, as the TPU kernel does."""
    s = torch.einsum("bic,bjc->bij", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bij,bjc->bic", p.float(), v.float()).to(q.dtype)


def spatial_attention_backward(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, g: torch.Tensor, scale: float
                               ) -> tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``(dq, dk, dv)`` of the attention for the output gradient ``g``, as
    ``_attn_bwd`` computes them: fp32 scores recomputed, ``dv = Pᵀg``,
    ``ds = P∘(dp − Σ dp∘P)``, ``dq = ds·k·scale``, ``dk = dsᵀ·q·scale``,
    each cast to its input's dtype."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    p = torch.softmax(torch.einsum("bic,bjc->bij", qf, kf) * scale, dim=-1)
    dv = torch.einsum("bij,bic->bjc", p, gf)
    dp = torch.einsum("bic,bjc->bij", gf, vf)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.einsum("bij,bjc->bic", ds, kf) * scale
    dk = torch.einsum("bij,bic->bjc", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"spatial_attention: expected a CPU or CUDA tensor, "
                         f"got {q.device}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"spatial_attention: dtype {q.dtype} not supported "
                        f"(float32, bfloat16)")
    for t in (q, k, v):
        if (t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or not t.is_contiguous() or t.dim() != 3):
            raise ValueError("spatial_attention: q, k, v must be contiguous "
                             "[B, HW, C] tensors of one shape, dtype, device")
    B, HW, Cq = q.shape
    plan = attn_plan(HW, Cq, q.dtype)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if plan.path == "long":
        fn = function("attention", "sr3d_attention_long_fwd",
                      [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, ctypes.c_int, _P])
        check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, HW, Cq, scale, _DTYPES[q.dtype], stream),
              "spatial_attention")
        spatial_attention.launches += 1
        return out
    if plan.path == "mma":   # 16-byte loads; a view may start anywhere
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
    fn = function("attention", "sr3d_attention_fwd",
                  [_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_int, _P])
    check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, HW,
             Cq, scale, _DTYPES[q.dtype], plan.cluster, stream),
          "spatial_attention")
    spatial_attention.launches += 1
    return out


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("spatial_attention.backward"):
            return (*spatial_attention_backward(q, k, v, g, ctx.scale),
                    None)


def spatial_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      channels: int | None = None) -> torch.Tensor:
    """q, k, v: ``[B, HW, C]`` → ``[B, HW, C]``; scale ``1/sqrt(channels
    or C)``.  Differentiable in q, k and v."""
    C = channels if channels is not None else q.shape[-1]
    scale = 1.0 / math.sqrt(C)
    if q.device.type == "cpu":
        return spatial_attention_reference(q, k, v, scale)
    return _Attention.apply(q, k, v, scale)


spatial_attention.launches = 0
