"""w8a8 int8 3×3 convolution: the wrapper of the CUDA kernel and its plain
version.

Counterpart of ``sr3d_tpu/ops/quant.py::int8_conv`` (``lax.conv`` of int8
operands into int32; no Pallas kernel, but eager PyTorch has no CUDA int8
convolution).  The scheme, as the JAX package has it:

* activations: one scale for the tensor, ``max|x| / 127`` over the whole
  batch (dynamic) or a given ``a_scale`` (static);
* weights: one scale per output channel, ``max|w[o]| / 127``, derived from
  the fp32 weights at every call;
* ``clip(round(v / scale), −127, 127)`` with a true division and rounding
  half to even;
* int8 × int8 summed exactly in int32, then ``float(y) · (a_scale ·
  w_scale[o]) + bias[o]`` in fp32, each operation rounded on its own, and
  one rounding to ``out_dtype``.

x is NCHW and the weight OIHW (the port's layouts).  The kernel
(``csrc/int8_conv.cu``) takes 3×3, padding 1, stride 1 or 2, x in bf16 or
fp32; it quantizes x as it loads it, from a scale that stays on the device.
The wrapper quantizes the weights with torch ops.  The plain version
computes the int32 sums exactly in fp64 (``|sum| < 2⁵³``), so the kernel
equals it bit for bit.

The wrapper runs the plain version for a CPU tensor and the kernel for a
CUDA tensor, never one in place of the other, and counts kernel launches in
``int8_conv.launches``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import check, function

_P = ctypes.c_void_p
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
CIN_CHUNK = 32  # the kernel's input channels per k-step: Cin is padded to it
_ACC_LIMIT = 2 ** 31  # int32 accumulators: 127² · 9 · Cin must stay below


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The per-tensor activation step ``max(max|x|, 1e-8) / 127`` (fp32,
    0-d, on ``x``'s device)."""
    return x.abs().amax().float().clamp_min(1e-8) / 127.0


def quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(xf / scale), −127, 127)`` as int8; ``torch.round``
    rounds half to even, as ``jnp.round`` does."""
    return torch.round(xf / scale).clamp_(-127, 127).to(torch.int8)


def quantize_weight(weight: torch.Tensor) -> tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Per-output-channel int8 weights of an OIHW ``weight`` and their
    steps ``max(max|w[o]|, 1e-8) / 127`` (fp32 ``[O]``)."""
    wf = weight.float()
    w_scale = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-8) / 127.0
    return quantize(wf, w_scale[:, None, None, None]), w_scale


def _a_scale(x: torch.Tensor, a_scale) -> torch.Tensor:
    if a_scale is None:
        return dynamic_scale(x)
    return torch.as_tensor(a_scale, dtype=torch.float32, device=x.device)


def int8_conv_reference(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None, *, stride: int = 1,
                        padding: int = 1, out_dtype: torch.dtype | None = None,
                        a_scale=None) -> torch.Tensor:
    """The plain version: any kernel size, stride and padding.  The int8
    convolution runs in fp64 with cuDNN off (an im2col product, no Winograd
    or FFT; oneDNN takes no fp64), which sums integers exactly."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    a = _a_scale(xf, a_scale)
    wq, w_scale = quantize_weight(weight)
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(quantize(xf, a).double(), wq.double(), None, stride,
                     padding)
    out = y.float() * (a * w_scale)[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(out_dtype)


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """OIHW int8 → the kernel's ``[O][3][3][Cin rounded up to 32]``, zero
    past Cin."""
    O, Cin = wq.shape[:2]
    kpad = -(-Cin // CIN_CHUNK) * CIN_CHUNK
    w = wq.permute(0, 2, 3, 1)
    if kpad == Cin:
        return w.contiguous()
    return F.pad(w, (0, kpad - Cin)).contiguous()


def _int8_conv_cuda(x, weight, bias, stride, padding, out_dtype, a_scale):
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _BF16 or out_dtype not in _BF16:
        raise TypeError(f"int8_conv: x {x.dtype} -> {out_dtype} not "
                        f"supported (float32, bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("int8_conv: x must be a contiguous NCHW tensor")
    B, Cin, H, W = x.shape
    if (weight.dim() != 4 or tuple(weight.shape[1:]) != (Cin, 3, 3)
            or weight.device != x.device):
        raise ValueError(f"int8_conv: the kernel takes an [O, {Cin}, 3, 3] "
                         f"weight on {x.device}, got {tuple(weight.shape)}")
    if padding != 1 or stride not in (1, 2):
        raise ValueError(f"int8_conv: the kernel takes padding 1 and stride "
                         f"1 or 2, got padding {padding}, stride {stride}")
    if 127 * 127 * 9 * Cin >= _ACC_LIMIT:
        raise ValueError(f"int8_conv: Cin = {Cin} could overflow the int32 "
                         f"sums")
    O = weight.shape[0]
    if bias is not None and (tuple(bias.shape) != (O,)
                             or bias.device != x.device):
        raise ValueError(f"int8_conv: bias must be [{O}] on {x.device}")
    a = _a_scale(x, a_scale).reshape(())
    if a.device != x.device:
        raise ValueError("int8_conv: a_scale must be on x's device")
    wq, w_scale = quantize_weight(weight)
    wk = pack_weight(wq)
    b = None if bias is None else bias.float().contiguous()
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty(B, O, Ho, Wo, dtype=out_dtype, device=x.device)
    fn = function("int8_conv", "sr3d_int8_conv3x3",
                  [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, _P])
    check(fn(x.data_ptr(), wk.data_ptr(), a.data_ptr(), w_scale.data_ptr(),
             None if b is None else b.data_ptr(), out.data_ptr(), B, Cin, H,
             W, O, stride, _BF16[x.dtype], _BF16[out_dtype],
             torch.cuda.current_stream(x.device).cuda_stream), "int8_conv")
    int8_conv.launches += 1
    return out


@torch.no_grad()
def int8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None, *, stride: int = 1,
              padding: int = 1, out_dtype: torch.dtype | None = None,
              a_scale=None) -> torch.Tensor:
    """w8a8 conv of NCHW ``x`` with the OIHW fp32 ``weight``: the plain
    version on the CPU, the kernel on CUDA.  ``a_scale`` (a float or a 0-d
    tensor) is the static activation step; None takes the dynamic one.
    Returns ``out_dtype`` (default ``x.dtype``).  Inference only: rounding
    has no gradient."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv_reference(x, weight, bias, stride=stride,
                                   padding=padding, out_dtype=out_dtype,
                                   a_scale=a_scale)
    return _int8_conv_cuda(x, weight, bias, stride, padding, out_dtype,
                           a_scale)


int8_conv.launches = 0
