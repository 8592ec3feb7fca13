"""3×3 stride-1 SAME convolution: the wrapper of the CUDA kernels, the plan
that picks one by shape, and the plain version.

Counterpart of ``sr3d_tpu/kernels/conv3x3.py`` (``conv3x3_pallas``), in the
JAX package's layout: x ``[B, H, W, C]`` NHWC, w ``[3, 3, C, O]`` HWIO,
out ``[B, H, W, O]`` in ``x.dtype`` with fp32 accumulation.  The kernels
(``csrc/conv3x3.cu``, whose header says what bounds them and how):

* ``wgmma``: bf16 with C and O multiples of 64 — an implicit GEMM on the
  tensor cores over a shared-memory row band, TMA-fed weights, split K
  where the output tiles cannot fill the card;
* ``simt``: fp32, and the bf16 shapes the tensor-core path cannot take
  (C = 6 at ``conv_in``, ragged O) — CUDA-core FMAs, any shape.

``conv_plan`` names the path for a shape; it is pure Python, so the CPU
tests hold its choices.  There is no fallback on failure: a build or launch
error raises.

Like the TPU kernel it is a public function that no model path calls: the
JAX package left it unwired after it lost to XLA's convolution, and the
port's ``ConvBlock`` keeps ``F.conv2d``.  It is forward-only, as the TPU
kernel is.

The wrapper runs the plain version for a CPU tensor and a kernel for a
CUDA tensor, never one in place of the other, and counts kernel launches in
``conv3x3.launches``.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ._build import check, function

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CHUNK = 64              # input channels per K chunk (128-byte rows)
STAGES = 4              # the kernel's ring of weight tiles
SMEM_LIMIT = 232448     # dynamic shared memory a block may use on sm_90


@dataclass(frozen=True)
class ConvPlan:
    """How one conv runs on the card.  ``path`` is ``"wgmma"`` (tensor
    cores) or ``"simt"`` (CUDA cores, ``conv3x3_kernel``); ``why`` says why.
    For ``wgmma``: a tile is ``images`` × ``rows`` × ``tile_w`` output
    pixels by ``bn`` output channels; ``m_tiles`` × O/bn tiles × ``splits``
    K splits (``split_chunks``) are the work items that ``blocks``
    persistent blocks share."""

    path: str
    why: str
    bn: int = 0
    tile_w: int = 0
    rows: int = 0
    images: int = 0
    m_tiles: int = 0
    splits: int = 1
    blocks: int = 0

    @property
    def band_pixels(self) -> int:
        """Pixels of the row band a block stages per channel chunk."""
        return self.images * (self.rows + 2) * (self.tile_w + 2)

    @property
    def smem_bytes(self) -> int:
        """The kernel's dynamic shared memory: alignment slack, the weight
        ring, two bands, two warpgroups' output staging, the barriers."""
        band = -(-self.band_pixels * 128 // 1024) * 1024
        return (1024 + STAGES * self.bn * 128 + 2 * band
                + 2 * 64 * (128 // self.bn) * self.bn * 2
                + (2 * STAGES + 6) * 8)


def conv_plan(B: int, H: int, W: int, C: int, O: int, dtype: torch.dtype,
              sm_count: int = 132) -> ConvPlan:
    """The path, tile and split count for x ``[B, H, W, C]`` → O outputs
    on a card with ``sm_count`` SMs."""
    if dtype != torch.bfloat16:
        return ConvPlan("simt", "fp32: tensor cores would mean TF32")
    for name, n in (("C", C), ("O", O)):
        if n % 64:
            return ConvPlan("simt", f"{name} = {n} is not a multiple of 64 "
                                    f"(64-channel TMA boxes)")
    bn = 128 if O % 128 == 0 else 64
    tile = 128 * (128 // bn)        # output pixels: 128, or 256 at BN 64
    tile_w = min(W, 128)
    rows = min(H, tile // tile_w)
    images = (min(B, tile // (rows * tile_w))
              if (rows, tile_w) == (H, W) else 1)
    m_tiles = (math.ceil(B / images) * math.ceil(H / rows)
               * math.ceil(W / tile_w))
    tiles = m_tiles * (O // bn)
    chunks = C // CHUNK
    splits = 1 if tiles >= sm_count else min(chunks,
                                             max(1, sm_count // tiles))
    why = "bf16, C and O multiples of 64"
    if splits > 1:
        why = f"{tiles} tiles < {sm_count} SMs: K split {splits} ways"
    plan = ConvPlan("wgmma", why, bn, tile_w, rows, images, m_tiles, splits,
                    min(tiles * splits, sm_count))
    if plan.smem_bytes > SMEM_LIMIT:
        return ConvPlan("simt", f"a band of {plan.band_pixels} pixels needs "
                                f"{plan.smem_bytes} bytes of shared memory")
    return plan


def split_chunks(chunks: int, splits: int) -> list[tuple[int, int]]:
    """The 64-channel chunks ``[lo, hi)`` of each split, as the kernel
    computes them; each split takes all nine taps of its chunks."""
    return [(s * chunks // splits, (s + 1) * chunks // splits)
            for s in range(splits)]


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch_conv(name: str, x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor | None, gn: tuple | None = None
                ) -> torch.Tensor:
    """Run the kernel ``conv_plan`` picks; ``gn`` = (mean, scale, beta)
    fp32 selects the fused GN→Swish prologue.  Inputs already checked."""
    B, H, W, C = x.shape
    O = w.shape[-1]
    out = torch.empty(B, H, W, O, device=x.device, dtype=x.dtype)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    mean, scale, beta = gn if gn is not None else (None, None, None)
    plan = conv_plan(B, H, W, C, O, x.dtype, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    if plan.path == "wgmma":
        # TMA needs 16-byte aligned bases; a view may start anywhere
        x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, w))
        ws = (torch.empty(plan.splits, B * H * W, O, device=x.device,
                          dtype=torch.float32) if plan.splits > 1 else None)
        fn = function("conv3x3", "sr3d_conv3x3_wgmma",
                      [_P] * 8 + [ctypes.c_int] * 12 + [_P])
        status = fn(x.data_ptr(), w.data_ptr(), _ptr(bias), _ptr(mean),
                    _ptr(scale), _ptr(beta), out.data_ptr(), _ptr(ws), B, H,
                    W, C, O, plan.tile_w, plan.rows, plan.images, plan.bn,
                    plan.splits, plan.blocks, int(gn is not None), stream)
    elif gn is None:
        fn = function("conv3x3", "sr3d_conv3x3",
                      [_P, _P, _P, _P] + [ctypes.c_int] * 6 + [_P])
        status = fn(x.data_ptr(), w.data_ptr(), _ptr(bias), out.data_ptr(),
                    B, H, W, C, O, _DTYPES[x.dtype], stream)
    else:
        fn = function("conv3x3", "sr3d_fused_gn_swish_conv3x3",
                      [_P] * 7 + [ctypes.c_int] * 6 + [_P])
        status = fn(x.data_ptr(), mean.data_ptr(), scale.data_ptr(),
                    beta.data_ptr(), w.data_ptr(), _ptr(bias),
                    out.data_ptr(), B, H, W, C, O, _DTYPES[x.dtype], stream)
    check(status, name)
    return out


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv2d`` on the NCHW/OIHW views in fp32 (fp32 accumulation of
    the same operands), plus the fp32 bias, cast back to ``x.dtype``."""
    out = F.conv2d(x.float().permute(0, 3, 1, 2),
                   w.to(x.dtype).float().permute(3, 2, 0, 1),
                   None if bias is None else bias.float(), padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def check_conv_inputs(name: str, x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor | None) -> None:
    """Device, dtype, shape and contiguity checks shared with the fused
    block."""
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
    check_conv_inputs("conv3x3", x, w, bias)
    out = launch_conv("conv3x3", x, w, bias)
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
