"""3×3 stride-1 SAME convolution: the wrapper of the CUDA kernel and its
plain version.

Counterpart of ``sr3d_tpu/kernels/conv3x3.py`` (``conv3x3_pallas``), in the
JAX package's layout: x ``[B, H, W, C]`` NHWC, w ``[3, 3, C, O]`` HWIO,
out ``[B, H, W, O]`` in ``x.dtype`` with fp32 accumulation.  The kernel
(``csrc/conv3x3.cu``) is an implicit GEMM on CUDA cores; its header says
what bounds it and how.

Like the TPU kernel it is a public function that no model path calls: the
JAX package left it unwired after it lost to XLA's convolution, and the
port's ``ConvBlock`` keeps ``F.conv2d`` until the card's numbers say
otherwise.  It is forward-only, as the TPU kernel is.

The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, never one in place of the other, and counts kernel launches in
``conv3x3.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import check, function

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv2d`` on the NCHW/OIHW views in fp32 (fp32 accumulation of
    the same operands), plus the fp32 bias, cast back to ``x.dtype``."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.to(x.dtype).float().permute(3, 2, 0, 1),
                   None if bias is None else bias.float(), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def check_conv_inputs(name: str, x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None) -> int:
    """Device, dtype, shape and contiguity checks shared with the fused
    block; returns the kernel's dtype code."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be a contiguous [B, H, W, C] "
                         f"tensor, got shape {tuple(x.shape)}")
    C = x.shape[-1]
    if (w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C) or w.dtype != x.dtype
            or w.device != x.device or not w.is_contiguous()):
        raise ValueError(f"{name}: w must be a contiguous [3, 3, {C}, O] "
                         f"{x.dtype} tensor on {x.device}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    O = w.shape[-1]
    if bias is not None and (tuple(bias.shape) != (O,)
                             or bias.dtype != torch.float32
                             or bias.device != x.device
                             or not bias.is_contiguous()):
        raise ValueError(f"{name}: bias must be a contiguous fp32 [{O}] "
                         f"tensor on {x.device}")
    return _DTYPES[x.dtype]


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """x ``[B, H, W, C]``, w ``[3, 3, C, O]`` → ``[B, H, W, O]`` in
    ``x.dtype``; stride 1, SAME zero padding, fp32 accumulation, optional
    fp32 bias.  On CUDA, ``w`` is cast to ``x.dtype`` first (as
    ``fused_gn_swish_conv3x3`` does in the JAX package)."""
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, bias)
    w = w.to(x.dtype).contiguous()
    bias = None if bias is None else bias.float().contiguous()
    is_bf16 = check_conv_inputs("conv3x3", x, w, bias)
    B, H, W, C = x.shape
    O = w.shape[-1]
    out = torch.empty(B, H, W, O, device=x.device, dtype=x.dtype)
    fn = function("conv3x3", "sr3d_conv3x3",
                  [_P, _P, _P, _P] + [ctypes.c_int] * 6 + [_P])
    check(fn(x.data_ptr(), w.data_ptr(),
             None if bias is None else bias.data_ptr(), out.data_ptr(), B, H,
             W, C, O, is_bf16,
             torch.cuda.current_stream(x.device).cuda_stream), "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
