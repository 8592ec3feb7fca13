"""w8a8 int8 3×3 convolution: the wrapper of the CUDA kernels, the plan
that picks one by shape, and the plain version.

Counterpart of ``sr3d_tpu/ops/quant.py::int8_conv`` (``lax.conv`` of int8
operands into int32; no Pallas kernel, but eager PyTorch has no CUDA int8
convolution).  The scheme, as the JAX package has it:

* activations: one scale for the tensor, ``max|x| / 127`` over the whole
  batch (dynamic) or a given ``a_scale`` (static);
* weights: one scale per output channel, ``max|w[o]| / 127``, derived from
  the fp32 weights;
* ``clip(round(v / scale), −127, 127)`` with a true division and rounding
  half to even;
* int8 × int8 summed exactly in int32, then ``float(y) · (a_scale ·
  w_scale[o]) + bias[o]`` in fp32, each operation rounded on its own, and
  one rounding to ``out_dtype``.

x is NCHW and the weight OIHW (the port's layouts).  The kernels
(``csrc/int8_conv.cu``, whose header says what bounds them and how) take
3×3, padding 1, stride 1 or 2, x in bf16 or fp32; they quantize x as they
load it, from a scale that stays on the device:

* ``wgmma``: Cin and O multiples of 64 and a row of x a multiple of 16
  bytes (every int8 conv of the flagship UNet) — s8 ``wgmma`` over a
  TMA-loaded band, K split over a thread-block cluster where the output
  tiles cannot fill the card;
* ``deep``: Cin and O multiples of 64 where a row of x is no multiple of
  16 bytes (no TMA box: the 4² and 2² levels of the 8→32 UNet) and an
  output image has at most 128 pixels — s8 ``wgmma`` over whole images,
  the weights streamed by many CTAs at once through a K split over (tap,
  chunk) units in a thread-block cluster;
* ``mma``: every other shape — the first version, ``mma.sync`` s8.

``int8_plan`` names the path for a shape; it is pure Python, so the CPU
tests hold its choices.  There is no fallback on failure: a build or launch
error raises.

``int8_conv_quantized`` takes the weights already quantized and packed
(``prepare_weight``), so a caller that keeps them (``ops/quant.py::
Int8Conv``, once per weight version) launches one kernel a call;
``int8_conv`` quantizes the fp32 weights, then calls it.  The plain
versions compute the int32 sums exactly in fp64 (``|sum| < 2⁵³``), so the
kernels equal them bit for bit.

Each wrapper runs its plain version for a CPU tensor and the kernel for a
CUDA tensor, never one in place of the other; kernel launches count in
``int8_conv.launches``, and by path in ``int8_conv.path_launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ._build import check, function

_P = ctypes.c_void_p
_BF16 = {torch.float32: 0, torch.bfloat16: 1}
CIN_CHUNK = 32  # the first version's input channels per k-step: Cin is
# padded to it in the packed weights
_ACC_LIMIT = 2 ** 31  # int32 accumulators: 127² · 9 · Cin must stay below
CHUNK = 64          # the tensor-core path's input channels per K chunk
STAGES = 4          # its ring of weight tiles (one tap of a chunk each)
PIX_BYTES = 80      # bytes per pixel of its quantized band: 64 channels,
# padded so that the 8 rows of an ldmatrix land on distinct banks
MAX_CLUSTER = 8     # K splits share one portable thread-block cluster
MAX_RAW_STAGES = 8  # the ring of raw band stages (TMA boxes in flight)
SMEM_LIMIT = 232448  # dynamic shared memory a block may use on sm_90
DEEP_BN = 64        # the short-row path's output channels a CTA
DEEP_STAGES = 16    # its ring of weight tiles (one unit each)
DEEP_PIXELS = 128   # its tile: whole output images, at most this many pixels
DEEP_RECV = 36864   # its received partials: splits × 128 pixels × the
# channels a rank finishes, for any splits ≤ 8


def _align(n: int, a: int = 1024) -> int:
    return -(-n // a) * a


@dataclass(frozen=True)
class Int8Plan:
    """How one int8 conv runs on the card.  ``path`` is ``"wgmma"`` (s8
    tensor cores fed by TMA), ``"deep"`` (s8 tensor cores over whole
    images, rows too short for TMA) or ``"mma"`` (the first version,
    ``mma.sync``); ``why`` says why.  For ``wgmma``: a tile is ``images``
    × ``rows`` × ``tile_w`` output pixels (at most 128 · ``mw``) by ``bn``
    output channels; ``m_tiles`` × ``n_tiles`` tiles, each computed by a
    cluster of ``splits`` CTAs that share its 64-channel chunks
    (``split_chunks``) and sum their int32 partials through distributed
    shared memory.  ``ks``
    is the channel depth of one TMA box of the band, ``raw_stages`` how
    many are in flight; ``smem_bytes`` the block's dynamic shared memory.
    For ``deep``: ``images`` whole images (``rows`` × ``tile_w`` = Ho × Wo
    output pixels each, padded bands ``band_h`` × ``band_w``) by ``bn`` =
    64 channels a tile; the ``splits`` CTAs of a tile's cluster share its
    9 · Cin / 64 (tap, chunk) units (``split_chunks``)."""

    path: str
    why: str
    bn: int = 0
    mw: int = 0
    tile_w: int = 0
    rows: int = 0
    images: int = 0
    band_h: int = 0
    band_w: int = 0
    m_tiles: int = 0
    n_tiles: int = 0
    splits: int = 1
    ks: int = 0
    raw_stages: int = 0
    smem_bytes: int = 0

    @property
    def tile_pixels(self) -> int:
        """Output pixels of a tile: 128 · ``mw`` (some may fall outside)."""
        return 128 * self.mw

    @property
    def tiles(self) -> int:
        return self.m_tiles * self.n_tiles

    @property
    def ctas(self) -> int:
        """The grid: a cluster of ``splits`` CTAs a tile."""
        return self.tiles * self.splits


def tc_smem_bytes(bn: int, mw: int, band_pixels: int, ks: int,
                  in_bytes: int, raw_stages: int) -> int:
    """The tensor-core kernel's dynamic shared memory (as
    ``csrc/int8_conv.cu::tc_smem`` computes it): alignment slack, the
    weight ring, two quantized bands and ``raw_stages`` raw band stages;
    after the main loop the int32 partial tile [bn][128·mw + 4] reuses
    them; then the barriers."""
    pipe = (STAGES * bn * 64 + 2 * _align(band_pixels * PIX_BYTES)
            + raw_stages * _align(band_pixels * ks * in_bytes))
    part = bn * (128 * mw + 4) * 4
    return (1024 + _align(max(pipe, part), 8)
            + (2 * STAGES + 2 * MAX_RAW_STAGES + 4) * 8)


@functools.lru_cache(maxsize=None)
def int8_plan(B: int, Cin: int, H: int, W: int, O: int, stride: int,
              sm_count: int = 132, *, in_dtype: torch.dtype = torch.bfloat16
              ) -> Int8Plan:
    """The path, tile, K splits and shared memory for x ``[B, Cin, H, W]``
    (``in_dtype``) → O outputs at ``stride`` on a card with ``sm_count``
    SMs.  Chooses by shape alone; kept per shape (the host path runs it
    at every call)."""
    el = 2 if in_dtype == torch.bfloat16 else 4
    for name, n in (("Cin", Cin), ("O", O)):
        if n % CHUNK:
            return Int8Plan("mma", f"{name} = {n} is not a multiple of 64")
    if W * el % 16:
        return _deep_plan(B, Cin, H, W, O, stride, sm_count, el)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    bn = 128 if O % 128 == 0 else 64
    # two m64 products a warpgroup at BN 64, so a weight tile feeds as many
    # products as at BN 128; stride 2's band (four input pixels an output
    # pixel) would not fit twice at 256 pixels
    mw = 2 if bn == 64 and stride == 1 else 1
    bm = 128 * mw
    al = 16 // el   # a box row is a multiple of 16 bytes and starts on a
    # 16-byte boundary at or left of the tile's halo

    def band(tile_w: int) -> tuple[int, int, int]:
        rows = min(Ho, bm // tile_w)
        return (rows, (rows - 1) * stride + 3,
                _align((tile_w - 1) * stride + 3 + al - 1, al))

    def cost(tile_w: int) -> tuple:
        """Input pixels quantized, then loaded, a tile pixel: the columns
        some tap reads, then the box's."""
        rows, band_h, band_w = band(tile_w)
        read = band_h * ((tile_w - 1) * stride + 3)
        return read / (rows * tile_w), band_h * band_w / (rows * tile_w)

    widths = [w for w in (8, 16, 32, 64, 128, 256) if w < min(Wo, bm)]
    widths.append(min(Wo, bm))
    def depth(pixels: int) -> tuple[int, int] | None:
        """The raw stages: the most channels in flight, up to two chunks,
        that shared memory holds, counting no more than one chunk; the
        deeper box of equals (fewer, larger copies), then more stages."""
        options = [(ks, rs) for ks in (64, 32, 16)
                   for rs in range(2, MAX_RAW_STAGES + 1)
                   if ks * rs <= 2 * CHUNK
                   and tc_smem_bytes(bn, mw, pixels, ks, el, rs)
                   <= SMEM_LIMIT]
        return max(options, key=lambda o: (min(o[0] * o[1], CHUNK), o[0],
                                           o[1]), default=None)

    # the cheapest tile shape whose band fits a TMA box and shared memory:
    # whole images a tile at the deep levels, as many as fit
    fits = None
    for tile_w in sorted(widths, key=cost):
        rows, band_h, band_w = band(tile_w)
        if band_w > 256 or band_h > 256:
            continue
        images = (min(B, bm // (rows * tile_w))
                  if (rows, tile_w) == (Ho, Wo) else 1)
        for images in range(images, 0, -1):
            ring = depth(images * band_h * band_w)
            if ring is not None:
                fits = tile_w, rows, band_h, band_w, images, *ring
                break
        if fits:
            break
    if fits is None:
        return Int8Plan("mma", "no tile's band fits a TMA box and shared "
                               "memory")
    tile_w, rows, band_h, band_w, images, ks, raw_stages = fits
    pixels = images * band_h * band_w
    m_tiles = (math.ceil(B / images) * math.ceil(Ho / rows)
               * math.ceil(Wo / tile_w))
    n_tiles = O // bn
    tiles = m_tiles * n_tiles
    chunks = Cin // CHUNK
    splits = (1 if tiles >= sm_count
              else min(chunks, MAX_CLUSTER, max(1, sm_count // tiles)))
    smem = tc_smem_bytes(bn, mw, pixels, ks, el, raw_stages)
    why = "Cin and O multiples of 64"
    if splits > 1:
        why = f"{tiles} tiles < {sm_count} SMs: K split {splits} ways"
    return Int8Plan("wgmma", why, bn, mw, tile_w, rows, images, band_h,
                    band_w, m_tiles, n_tiles, splits, ks, raw_stages, smem)


def deep_smem_bytes(band_pixels: int, raw_bytes: int) -> int:
    """The short-row kernel's dynamic shared memory (as
    ``csrc/int8_conv.cu::deep_smem`` computes it): alignment slack, the
    weight ring, the quantized band, the raw chunk of x (``raw_bytes``),
    the int32 partials the CTA receives, then the barriers."""
    return (1024 + DEEP_STAGES * DEEP_BN * 64
            + _align(band_pixels * PIX_BYTES) + raw_bytes + DEEP_RECV
            + 2 * DEEP_STAGES * 8)


def _deep_plan(B: int, Cin: int, H: int, W: int, O: int, stride: int,
               sm_count: int, el: int) -> Int8Plan:
    """Rows of x too short for a TMA box: whole images a tile, as many as
    128 output pixels and shared memory hold, and K split over (tap, chunk)
    units until the tiles' CTAs reach the SMs."""
    short = f"a row of x ({W} × {el} bytes) is not a multiple of 16 bytes"
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    if Ho * Wo > DEEP_PIXELS:
        return Int8Plan("mma", f"{short} (TMA) and an output image of "
                               f"{Ho} × {Wo} pixels is more than a tile")
    band_h, band_w = (Ho - 1) * stride + 3, (Wo - 1) * stride + 3

    def smem(images: int) -> int:
        return deep_smem_bytes(images * band_h * band_w,
                               images * CHUNK * H * W * el)

    images = min(B, DEEP_PIXELS // (Ho * Wo))
    while smem(images) > SMEM_LIMIT:
        images -= 1
        if images == 0:
            return Int8Plan("mma", f"{short} (TMA) and one image's band "
                                   f"does not fit shared memory")
    m_tiles, n_tiles = math.ceil(B / images), O // DEEP_BN
    tiles, units = m_tiles * n_tiles, 9 * (Cin // CHUNK)
    splits = (1 if tiles >= sm_count
              else min(units, MAX_CLUSTER, max(1, sm_count // tiles)))
    return Int8Plan("deep", f"{short}: {tiles} tiles of whole images, K "
                            f"split {splits} ways", DEEP_BN, 1, Wo, Ho,
                    images, band_h, band_w, m_tiles, n_tiles, splits,
                    smem_bytes=smem(images))


def split_chunks(chunks: int, splits: int) -> list[tuple[int, int]]:
    """The 64-channel chunks ``[lo, hi)`` of each K split, as the kernels
    compute them; each split of the tensor-core kernel takes all nine taps
    of its chunks.  The short-row kernel splits (tap, chunk) units this
    way: unit u is tap u % 9 of chunk u // 9."""
    return [(s * chunks // splits, (s + 1) * chunks // splits)
            for s in range(splits)]


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
    """OIHW int8 → the kernels' ``[O][3][3][Cin rounded up to 32]``, zero
    past Cin (K-major: what s8 ``wgmma`` requires of B)."""
    O, Cin = wq.shape[:2]
    kpad = -(-Cin // CIN_CHUNK) * CIN_CHUNK
    w = wq.permute(0, 2, 3, 1)
    if kpad == Cin:
        return w.contiguous()
    return F.pad(w, (0, kpad - Cin)).contiguous()


def prepare_weight(weight: torch.Tensor) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The fp32 OIHW ``weight`` as ``int8_conv_quantized`` takes it: the
    packed int8 weights and their per-output-channel steps."""
    wq, w_scale = quantize_weight(weight)
    return pack_weight(wq), w_scale


def int8_conv_quantized_reference(x: torch.Tensor, wk: torch.Tensor,
                                  w_scale: torch.Tensor,
                                  bias: torch.Tensor | None = None, *,
                                  stride: int = 1, padding: int = 1,
                                  out_dtype: torch.dtype | None = None,
                                  a_scale=None) -> torch.Tensor:
    """``int8_conv_reference`` on weights that ``prepare_weight`` made: the
    same arithmetic, so the same bits."""
    out_dtype = out_dtype or x.dtype
    xf = x.float()
    a = _a_scale(xf, a_scale)
    # OIHW and contiguous, so the output's layout is the plain version's
    wq = wk[..., :x.shape[1]].permute(0, 3, 1, 2).contiguous()
    with torch.backends.cudnn.flags(enabled=False):
        y = F.conv2d(quantize(xf, a).double(), wq.double(), None, stride,
                     padding)
    out = y.float() * (a * w_scale)[None, :, None, None]
    if bias is not None:
        out = out + bias.float()[None, :, None, None]
    return out.to(out_dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """TMA needs 16-byte aligned bases; a view may start anywhere."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, wk, w_scale, a, bias, out, stride, plan=None):
    """One kernel launch on ``int8_plan``'s path, or on ``plan``'s (a
    profiler's comparison of paths)."""
    B, Cin, H, W = x.shape
    O = out.shape[1]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan is None:
        sm_count = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        plan = int8_plan(B, Cin, H, W, O, stride, sm_count, in_dtype=x.dtype)
    args = (a.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr())
    int8_conv.path_launches[plan.path] += 1
    if plan.path == "wgmma":
        fn = function("int8_conv", "sr3d_int8_conv3x3_wgmma",
                      [_P] * 6 + [ctypes.c_int] * 17 + [_P])
        status = fn(_aligned(x).data_ptr(), _aligned(wk).data_ptr(), *args,
                    B, Cin, H, W, O, stride, _BF16[x.dtype],
                    _BF16[out.dtype], plan.bn, plan.mw, plan.tile_w,
                    plan.rows, plan.images, plan.band_w, plan.ks,
                    plan.raw_stages, plan.splits, stream)
    elif plan.path == "deep":
        fn = function("int8_conv", "sr3d_int8_conv3x3_deep",
                      [_P] * 6 + [ctypes.c_int] * 10 + [_P])
        status = fn(_aligned(x).data_ptr(), _aligned(wk).data_ptr(), *args,
                    B, Cin, H, W, O, stride, _BF16[x.dtype],
                    _BF16[out.dtype], plan.images, plan.splits, stream)
    else:
        fn = function("int8_conv", "sr3d_int8_conv3x3",
                      [_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])
        status = fn(x.data_ptr(), wk.data_ptr(), *args, B, Cin, H, W, O,
                    stride, _BF16[x.dtype], _BF16[out.dtype], stream)
    check(status, "int8_conv")


def _check_cuda(x, bias, O, stride, padding, out_dtype):
    if x.device.type != "cuda":
        raise ValueError(f"int8_conv: expected a CPU or CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _BF16 or out_dtype not in _BF16:
        raise TypeError(f"int8_conv: x {x.dtype} -> {out_dtype} not "
                        f"supported (float32, bfloat16)")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("int8_conv: x must be a contiguous NCHW tensor")
    if padding != 1 or stride not in (1, 2):
        raise ValueError(f"int8_conv: the kernel takes padding 1 and stride "
                         f"1 or 2, got padding {padding}, stride {stride}")
    Cin = x.shape[1]
    if 127 * 127 * 9 * Cin >= _ACC_LIMIT:
        raise ValueError(f"int8_conv: Cin = {Cin} could overflow the int32 "
                         f"sums")
    if bias is not None and (tuple(bias.shape) != (O,)
                             or bias.device != x.device):
        raise ValueError(f"int8_conv: bias must be [{O}] on {x.device}")


def _int8_conv_cuda(x, wk, w_scale, bias, stride, padding, out_dtype,
                    a_scale):
    O = wk.shape[0]
    _check_cuda(x, bias, O, stride, padding, out_dtype)
    B, Cin, H, W = x.shape
    kpad = -(-Cin // CIN_CHUNK) * CIN_CHUNK
    if (wk.dim() != 4 or tuple(wk.shape[1:]) != (3, 3, kpad)
            or wk.dtype != torch.int8 or not wk.is_contiguous()
            or wk.device != x.device or w_scale.dtype != torch.float32
            or tuple(w_scale.shape) != (O,) or w_scale.device != x.device):
        raise ValueError(f"int8_conv: the kernel takes packed int8 weights "
                         f"[O, 3, 3, {kpad}] and fp32 steps [O] on "
                         f"{x.device}, got {tuple(wk.shape)} {wk.dtype}")
    a = _a_scale(x, a_scale).reshape(())
    if a.device != x.device:
        raise ValueError("int8_conv: a_scale must be on x's device")
    b = None if bias is None else bias.float().contiguous()
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    out = torch.empty(B, O, Ho, Wo, dtype=out_dtype, device=x.device)
    _launch(x, wk, w_scale.contiguous(), a, b, out, stride)
    int8_conv.launches += 1
    return out


@torch.no_grad()
def int8_conv_quantized(x: torch.Tensor, wk: torch.Tensor,
                        w_scale: torch.Tensor,
                        bias: torch.Tensor | None = None, *, stride: int = 1,
                        padding: int = 1,
                        out_dtype: torch.dtype | None = None,
                        a_scale=None) -> torch.Tensor:
    """w8a8 conv of NCHW ``x`` with weights that ``prepare_weight`` made
    (``wk`` packed int8, ``w_scale`` their fp32 steps): the plain version
    on the CPU, one kernel launch on CUDA.  ``a_scale`` as for
    ``int8_conv``."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv_quantized_reference(
            x, wk, w_scale, bias, stride=stride, padding=padding,
            out_dtype=out_dtype, a_scale=a_scale)
    return _int8_conv_cuda(x, wk, w_scale, bias, stride, padding, out_dtype,
                           a_scale)


@torch.no_grad()
def int8_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor | None = None, *, stride: int = 1,
              padding: int = 1, out_dtype: torch.dtype | None = None,
              a_scale=None) -> torch.Tensor:
    """w8a8 conv of NCHW ``x`` with the OIHW fp32 ``weight``: the plain
    version on the CPU, the kernel on CUDA (the weights quantized first,
    with torch ops).  ``a_scale`` (a float or a 0-d tensor) is the static
    activation step; None takes the dynamic one.  Returns ``out_dtype``
    (default ``x.dtype``).  Inference only: rounding has no gradient."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return int8_conv_reference(x, weight, bias, stride=stride,
                                   padding=padding, out_dtype=out_dtype,
                                   a_scale=a_scale)
    Cin = x.shape[1] if x.dim() == 4 else -1
    if (weight.dim() != 4 or tuple(weight.shape[1:]) != (Cin, 3, 3)
            or weight.device != x.device):
        raise ValueError(f"int8_conv: the kernel takes an [O, {Cin}, 3, 3] "
                         f"weight on {x.device}, got {tuple(weight.shape)}")
    wk, w_scale = prepare_weight(weight)
    return _int8_conv_cuda(x, wk, w_scale, bias, stride, padding, out_dtype,
                           a_scale)


int8_conv.launches = 0
int8_conv.path_launches = dict.fromkeys(("wgmma", "deep", "mma"), 0)
