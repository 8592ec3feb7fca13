"""The int8 conv's plan (``sr3d_torch.kernels.int8_conv.int8_plan``) on the
CPU: which path each shape takes, its tile, K splits and shared memory at
every int8 conv of the flagship UNet, at the short-row convs of the 8→32
UNet and at ragged and tiny shapes; that the plans of every other served
UNet's convs are those in ``tests/golden/int8_plans_wgmma.json``; that
every split plan covers K once; that the reciprocal quantize with its tie
check gives the true division's integers; and, through torch emulations
of the tensor-core kernel (tile decode, the 16-byte aligned band, the
quantize, tap offsets, per-split int32 partials, one dequant) and of the
short-row kernel (whole images in a zero-padded band, per-split partials
over (tap, chunk) units), that the plan's tiles cover every output once
and give the plain version's bits.  The kernels themselves are held to
the plain version on the card by tests/test_torch_cuda.py."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from sr3d_torch.kernels.int8_conv import (
    MAX_CLUSTER,
    SMEM_LIMIT,
    deep_smem_bytes,
    dynamic_scale,
    int8_conv_reference,
    int8_plan,
    prepare_weight,
    quantize,
    split_chunks,
)

torch.set_num_threads(1)
BF16 = torch.bfloat16
SMS = 132

# (B, Cin, H, W, O, stride, scale) of the 27 distinct int8 convs of one
# flagship UNet forward at the serving CLI's default (quant_min_res 1,
# resampling on, B = 8): chip_smoke.py's meta-device trace,
# main_path_int8_convs.  The plan does not depend on the scale's kind.
FLAGSHIP = [
    (8, 192, 128, 128, 64, 1, "static"), (8, 128, 128, 128, 128, 1, "dynamic"),
    (8, 128, 128, 128, 64, 1, "static"), (8, 384, 64, 64, 128, 1, "static"),
    (8, 64, 128, 128, 64, 1, "static"), (8, 64, 128, 128, 64, 2, "dynamic"),
    (8, 256, 64, 64, 256, 1, "dynamic"), (8, 256, 64, 64, 128, 1, "static"),
    (8, 768, 32, 32, 256, 1, "static"), (8, 192, 64, 64, 128, 1, "static"),
    (8, 128, 64, 64, 128, 1, "static"), (8, 128, 64, 64, 128, 2, "dynamic"),
    (8, 512, 32, 32, 512, 1, "dynamic"), (8, 512, 32, 32, 256, 1, "static"),
    (8, 384, 32, 32, 256, 1, "static"), (8, 64, 64, 64, 128, 1, "static"),
    (8, 256, 32, 32, 256, 1, "static"), (8, 256, 32, 32, 256, 2, "dynamic"),
    (8, 1024, 16, 16, 512, 1, "static"), (8, 768, 16, 16, 512, 1, "static"),
    (8, 128, 32, 32, 256, 1, "static"), (8, 512, 16, 16, 512, 1, "static"),
    (8, 512, 16, 16, 512, 2, "dynamic"), (8, 512, 16, 16, 512, 1, "dynamic"),
    (8, 256, 16, 16, 512, 1, "static"), (8, 1024, 8, 8, 512, 1, "static"),
    (8, 512, 8, 8, 512, 1, "static"),
]


def _check_plan(plan, B, Cin, H, W, O, stride, dtype, sm_count=SMS):
    el = 2 if dtype == BF16 else 4
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    assert plan.path == "wgmma", plan.why
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.bn in (64, 128) and O % plan.bn == 0
    assert plan.mw in (1, 2) and (plan.bn, plan.mw) != (128, 2)
    assert plan.images * plan.rows * plan.tile_w <= plan.tile_pixels
    assert plan.band_h == (plan.rows - 1) * stride + 3 <= 256
    assert plan.band_w * el % 16 == 0 and plan.band_w <= 256
    assert plan.band_w >= (plan.tile_w - 1) * stride + 3 + 16 // el - 1
    assert plan.tile_w % 8 == 0 or plan.tile_w == Wo
    assert plan.ks in (16, 32, 64) and 2 <= plan.raw_stages <= 8
    assert plan.ks * plan.raw_stages <= 128
    assert plan.m_tiles == (math.ceil(B / plan.images)
                            * math.ceil(Ho / plan.rows)
                            * math.ceil(Wo / plan.tile_w))
    # the work items reach the SMs, or K is split as far as it goes
    tiles, chunks = plan.m_tiles * plan.n_tiles, Cin // 64
    if tiles >= sm_count:
        assert plan.splits == 1
    else:
        assert plan.splits == min(chunks, MAX_CLUSTER, sm_count // tiles)
    assert plan.tiles == tiles and plan.ctas == tiles * plan.splits


@pytest.mark.parametrize("conv", FLAGSHIP)
def test_plan_flagship_shapes(conv):
    shape = conv[:6]
    _check_plan(int8_plan(*shape), *shape, BF16)


def test_plan_flagship_tiles():
    """The widest input takes BN 64 with 256-pixel tiles and no split; the
    deep levels fill the card through the cluster split."""
    widest = int8_plan(8, 192, 128, 128, 64, 1)
    assert (widest.bn, widest.mw, widest.splits) == (64, 2, 1)
    assert widest.ctas >= SMS
    for shape, splits in (((8, 512, 8, 8, 512, 1), 8),
                          ((8, 1024, 8, 8, 512, 1), 8),
                          ((8, 512, 16, 16, 512, 2), 8),
                          ((8, 1024, 16, 16, 512, 1), 2)):
        plan = int8_plan(*shape)
        assert plan.splits == splits and plan.ctas == 128, (shape, plan)


@pytest.mark.parametrize("stride", [1, 2])
def test_plan_fp32(stride):
    """The four fp32 cases of chip_smoke.py take the tensor cores too."""
    shape = (8, 64, 128, 128, 64, stride)
    _check_plan(int8_plan(*shape, in_dtype=torch.float32), *shape,
                torch.float32)


@pytest.mark.parametrize("shape,dtype,why", [
    ((1, 40, 9, 13, 24, 1), BF16, "Cin = 40"),      # ragged channels
    ((2, 32, 16, 16, 32, 1), BF16, "Cin = 32"),     # the tiny test UNets
    ((2, 6, 16, 16, 64, 1), BF16, "Cin = 6"),
    ((2, 64, 16, 16, 24, 2), BF16, "O = 24"),
    ((1, 64, 12, 13, 64, 1), BF16, "more than a tile"),  # no TMA rows, and
    # 156 output pixels an image
])
def test_plan_first_version_shapes(shape, dtype, why):
    plan = int8_plan(*shape, in_dtype=dtype)
    assert plan.path == "mma" and why in plan.why


def test_plans_of_the_other_cells_are_unchanged():
    """Every int8 conv of the 16→128 UNet at B = 8, 32 and 1 and of the
    64→512 UNet at B = 4 keeps the tensor-core plan it had before the
    short-row path: no input row of theirs is under 16 bytes."""
    golden = json.loads((Path(__file__).parent / "golden"
                         / "int8_plans_wgmma.json").read_text())
    assert len(golden["plans"]) == 114
    fields = golden["fields"][6:]
    for row in golden["plans"]:
        plan = int8_plan(*row[:6])
        assert plan.path == "wgmma", (row, plan)
        assert [getattr(plan, k) for k in fields] == row[6:], (row, plan)


# (B, Cin, H, W, O, stride, scale) of the 8 distinct int8 convs of one
# 8→32 UNet forward at the serving CLI's default (B = 8) whose rows of x
# are under 16 bytes (the 4² and 2² levels): 22 of its 58 int8 convs
SHORT_ROW = [
    (8, 512, 2, 2, 512, 1, "static"), (8, 1024, 2, 2, 512, 1, "static"),
    (8, 256, 4, 4, 512, 1, "static"), (8, 512, 4, 4, 512, 1, "static"),
    (8, 512, 4, 4, 512, 1, "dynamic"), (8, 512, 4, 4, 512, 2, "dynamic"),
    (8, 1024, 4, 4, 512, 1, "static"), (8, 768, 4, 4, 512, 1, "static"),
]


def _check_deep_plan(plan, B, Cin, H, W, O, stride, dtype=BF16,
                     sm_count=SMS):
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    assert plan.path == "deep", plan.why
    assert (plan.rows, plan.tile_w) == (Ho, Wo)
    assert (plan.band_h, plan.band_w) == ((Ho - 1) * stride + 3,
                                          (Wo - 1) * stride + 3)
    el = 2 if dtype == BF16 else 4
    assert plan.smem_bytes == deep_smem_bytes(
        plan.images * plan.band_h * plan.band_w,
        plan.images * 64 * H * W * el) <= SMEM_LIMIT
    assert plan.images * Ho * Wo <= plan.tile_pixels == 128
    # every output pixel once: the tiles' images cover the batch once, the
    # channel tiles O once
    assert [b for m in range(plan.m_tiles)
            for b in range(m * plan.images, min(B, (m + 1) * plan.images))
            ] == list(range(B))
    assert plan.bn == 64 and plan.n_tiles * plan.bn == O
    # every (tap, chunk) unit once, each split some
    units = 9 * (Cin // 64)
    ranges = split_chunks(units, plan.splits)
    assert all(hi > lo for lo, hi in ranges)
    assert [u for lo, hi in ranges for u in range(lo, hi)] == \
        list(range(units))
    # the CTAs reach the SMs, or K is split as far as it goes
    tiles = plan.m_tiles * plan.n_tiles
    if tiles >= sm_count:
        assert plan.splits == 1
    else:
        assert plan.splits == min(units, MAX_CLUSTER, sm_count // tiles)
    assert plan.tiles == tiles and plan.ctas == tiles * plan.splits


@pytest.mark.parametrize("shape,dtype", [(c[:6], BF16) for c in SHORT_ROW]
                         + [((1, 64, 9, 13, 64, 1), BF16),   # odd W
                            ((1, 64, 8, 6, 64, 1), torch.float32)])
def test_plan_short_row_shapes(shape, dtype):
    """Rows of x under 16 bytes (no TMA box) take the short-row kernel;
    at the 8→32 UNet's 4² and 2² levels (B = 8) that is 8 channel tiles of
    all 8 images, each split 8 ways: 64 CTAs, one an SM."""
    plan = int8_plan(*shape, in_dtype=dtype)
    _check_deep_plan(plan, *shape, dtype)
    if shape[0] == 8:
        assert (plan.images, plan.m_tiles, plan.splits, plan.ctas) == \
            (8, 1, 8, 64)


@pytest.mark.parametrize("B", [1, 3, 32, 200])
def test_plan_short_row_tiles_any_batch(B):
    """The serve CLI takes any batch size: whole images a tile, ⌈B / 8⌉
    tiles at 4² and ⌈B / 32⌉ at 2², the split shrinking as tiles grow."""
    for H, stride in ((4, 1), (4, 2), (2, 1)):
        shape = (B, 512, H, H, 512, stride)
        _check_deep_plan(int8_plan(*shape), *shape)


def test_split_count_follows_the_sm_count():
    shape = (8, 512, 8, 8, 512, 1)     # 16 tiles, 8 chunks
    for sm_count, splits in ((16, 1), (32, 2), (64, 4), (132, 8),
                             (1000, 8)):
        plan = int8_plan(*shape, sm_count=sm_count)
        assert plan.splits == splits, sm_count
        _check_plan(plan, *shape, BF16, sm_count)


@pytest.mark.parametrize("chunks", range(1, 17))
def test_every_split_plan_covers_k_once(chunks):
    for splits in range(1, min(chunks, MAX_CLUSTER) + 1):
        ranges = split_chunks(chunks, splits)
        assert all(hi > lo for lo, hi in ranges)
        assert [c for lo, hi in ranges for c in range(lo, hi)] == \
            list(range(chunks))


ROUND = torch.tensor(12582912.0)   # 1.5 * 2^23, the kernel's kRound


def _quantize_fast(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The kernel's quantize_fast / quantize_exact in fp32 torch ops: the
    product with fl(1/a), rounded in the adder (the integer in t's low
    bits, clipped as an integer), a tie check 2^-12 around half-integers,
    the IEEE division and a float clip there."""
    r = torch.tensor(1.0) / a
    y = v * r
    t = y + ROUND
    tie = (y - (t - ROUND)).abs() > 0.5 - 2.0 ** -12
    q = (t.view(torch.int32) - ROUND.view(torch.int32)).clamp(-127, 127)
    exact = (((v / a).clamp(-127, 127) + ROUND) - ROUND).to(torch.int32)
    return torch.where(tie, exact, q).to(torch.int64)


def test_quantize_fast_equals_true_division():
    """Random values and values within a few ulp of every half-integer
    step, at several steps: the same integers as round(v / a)."""
    g = torch.Generator().manual_seed(3)
    for a in (0.05, 0.0123, 1.0 / 127, 3.7e-4, 1.3):
        a = torch.tensor(a, dtype=torch.float32)
        k = torch.arange(-130, 130, dtype=torch.float32) + 0.5
        ties = (k * a).repeat(9)
        ties = ties + torch.repeat_interleave(torch.arange(-4, 5), len(k)) \
            * torch.finfo(torch.float32).eps * ties.abs()
        v = torch.cat([torch.randn(20000, generator=g) * 90 * a, ties,
                       torch.tensor([0.0, -0.0, 1e30, -1e30]) * a])
        assert torch.equal(_quantize_fast(v, a),
                           quantize(v, a).to(torch.int64)), float(a)


def _emulate(x, w, bias, stride, a_scale, plan, out_dtype):
    """The tensor-core kernel's arithmetic in torch: per tile (channels
    fastest), the raw box from the 16-byte aligned column wb with zeros
    outside x, the quantize of the columns some tap reads (the others hold
    a sentinel no tap may read), the nine taps as offsets from each
    pixel's centre, int32 partials per K split summed in int32, one dequant
    in fp32.  Returns the output and how often each element was written."""
    B, C, H, W = x.shape
    O, s = w.shape[0], stride
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    al = 16 // (2 if x.dtype == BF16 else 4)
    wk, w_scale = prepare_weight(w)
    a = (dynamic_scale(x) if a_scale is None
         else torch.as_tensor(a_scale, dtype=torch.float32))
    TW, R, IM, BR, BWp, bn = (plan.tile_w, plan.rows, plan.images,
                              plan.band_h, plan.band_w, plan.bn)
    tiles_w, tiles_h = math.ceil(Wo / TW), math.ceil(Ho / R)
    cols = (TW - 1) * s + 3
    p = torch.arange(plan.tile_pixels)
    i, rem = p // (R * TW), p % (R * TW)
    bi, rr, cc = (t.reshape(-1) for t in torch.meshgrid(
        torch.arange(IM), torch.arange(BR), torch.arange(BWp),
        indexing="ij"))
    xf = x.float().permute(0, 2, 3, 1)
    out = torch.zeros(B, O, Ho, Wo, dtype=out_dtype)
    written = torch.zeros(B, O, Ho, Wo, dtype=torch.int64)
    for tile in range(plan.m_tiles * plan.n_tiles):
        t = tile
        n0 = t % plan.n_tiles * bn
        t //= plan.n_tiles
        w0 = t % tiles_w * TW
        t //= tiles_w
        h0, b0 = t % tiles_h * R, t // tiles_h * IM
        wneed = w0 * s - 1
        wb = wneed // al * al           # floor: -1 -> -al
        shift0 = wneed - wb
        gb, gh, gw = b0 + bi, h0 * s - 1 + rr, wb + cc
        ok = (gb < B) & (gh >= 0) & (gh < H) & (gw >= 0) & (gw < W)
        raw = torch.zeros(len(bi), C)
        raw[ok] = xf[gb[ok], gh[ok], gw[ok]]
        q = _quantize_fast(raw, a)
        q[(cc < shift0) | (cc >= shift0 + cols)] = 99   # never read
        centre = torch.where(
            i < IM, (i * BR + rem // TW * s) * BWp + rem % TW * s + shift0,
            0)
        total = torch.zeros(plan.tile_pixels, bn, dtype=torch.int32)
        for lo, hi in split_chunks(C // 64, plan.splits):
            acc = torch.zeros(plan.tile_pixels, bn, dtype=torch.int64)
            for c in range(lo, hi):
                for tap in range(9):
                    src = centre + tap // 3 * BWp + tap % 3
                    acc += q[src, c * 64:(c + 1) * 64] @ \
                        wk[n0:n0 + bn, tap // 3, tap % 3,
                           c * 64:(c + 1) * 64].long().t()
            assert int(acc.abs().max()) < 2 ** 31
            total = total + acc.to(torch.int32)
        v = total.float() * (a * w_scale[n0:n0 + bn])
        if bias is not None:
            v = v + bias[n0:n0 + bn]
        ob, oh, ow = b0 + i, h0 + rem // TW, w0 + rem % TW
        valid = (i < IM) & (ob < B) & (oh < Ho) & (ow < Wo)
        idx = (ob[valid][:, None], torch.arange(n0, n0 + bn)[None],
               oh[valid][:, None], ow[valid][:, None])
        out[idx] = v[valid].to(out_dtype)
        written[idx] += 1
    return out, written


@pytest.mark.parametrize("shape,dtype,sm_count", [
    ((2, 128, 9, 24, 64, 1), BF16, SMS),     # odd H, W = 24 below a tile
    ((3, 128, 15, 16, 128, 2), BF16, SMS),   # odd H at stride 2, images
    ((1, 256, 8, 8, 128, 1), BF16, SMS),     # the deep level: split 4
    ((2, 64, 5, 8, 64, 1), BF16, SMS),       # two ragged images a tile
    ((1, 128, 7, 12, 64, 2), torch.float32, 3),  # fp32, stride 2, split
    ((2, 128, 20, 40, 128, 1), BF16, 5),     # column tiles, split 2
])
def test_tensor_core_emulation_matches_plain(shape, dtype, sm_count):
    B, C, H, W, O, stride = shape
    plan = int8_plan(*shape, sm_count=sm_count, in_dtype=dtype)
    _check_plan(plan, *shape, dtype, sm_count)
    rng = np.random.RandomState(sum(shape))
    x = torch.from_numpy((rng.randn(B, C, H, W) * 2).astype(np.float32)) \
        .to(dtype)
    w = torch.from_numpy((rng.randn(O, C, 3, 3) * C ** -0.5)
                         .astype(np.float32))
    bias = torch.from_numpy(rng.randn(O).astype(np.float32))
    for b, a, out_dtype in ((bias, 0.04, dtype), (None, None, torch.float32)):
        got, written = _emulate(x, w, b, stride, a, plan, out_dtype)
        assert torch.equal(written, torch.ones_like(written))
        want = int8_conv_reference(x, w, b, stride=stride,
                                   out_dtype=out_dtype, a_scale=a)
        assert torch.equal(got, want)


def _emulate_deep(x, w, bias, stride, a_scale, plan, out_dtype):
    """The short-row kernel's arithmetic in torch: per tile of whole
    images, the band (each image's quantized pixels inside a zero halo,
    images past the batch zero), each split's int32 partial over its (tap,
    chunk) units (unit u: tap u % 9 of chunk u // 9) at each pixel's
    shifted band row, the partials summed in int32, one dequant in fp32,
    written a channel tile at a time.  Products in fp64, exact below 2^53.
    Returns the output and how often each element was written."""
    B, C, H, W = x.shape
    O, s = w.shape[0], stride
    Ho, Wo = (H - 1) // s + 1, (W - 1) // s + 1
    hw, BH, BW = Ho * Wo, plan.band_h, plan.band_w
    wk, w_scale = prepare_weight(w)
    wk = wk.double()
    a = (dynamic_scale(x) if a_scale is None
         else torch.as_tensor(a_scale, dtype=torch.float32))
    xq = _quantize_fast(x.float().permute(0, 2, 3, 1), a).double()
    out = torch.zeros(B, O, Ho, Wo, dtype=out_dtype)
    written = torch.zeros(B, O, Ho, Wo, dtype=torch.int64)
    for m in range(plan.m_tiles):
        b0 = m * plan.images
        imgs = min(plan.images, B - b0)
        band = torch.zeros(plan.images, BH, BW, C, dtype=torch.float64)
        band[:imgs, 1:H + 1, 1:W + 1] = xq[b0:b0 + imgs]
        band = band.reshape(-1, C)
        p = torch.arange(imgs * hw)
        i, ho, wo = p // hw, p % hw // Wo, p % Wo
        centre = (i * BH + ho * s) * BW + wo * s
        total = torch.zeros(len(p), O, dtype=torch.int32)
        for lo, hi in split_chunks(9 * (C // 64), plan.splits):
            us = range(lo, hi)
            rows = torch.cat([band[centre + u % 9 // 3 * BW + u % 3,
                                   u // 9 * 64:(u // 9 + 1) * 64]
                              for u in us], 1)
            cols = torch.cat([wk[:, u % 9 // 3, u % 3,
                                 u // 9 * 64:(u // 9 + 1) * 64]
                              for u in us], 1)
            part = rows @ cols.t()
            assert float(part.abs().max()) < 2 ** 31
            total = total + part.to(torch.int32)
        v = total.float() * (a * w_scale)
        if bias is not None:
            v = v + bias
        for n0 in range(0, plan.n_tiles * plan.bn, plan.bn):
            idx = (b0 + i[:, None], torch.arange(n0, n0 + plan.bn)[None],
                   ho[:, None], wo[:, None])
            out[idx] = v[:, n0:n0 + plan.bn].to(out_dtype)
            written[idx] += 1
    return out, written


@pytest.mark.parametrize("conv", SHORT_ROW)
def test_short_row_emulation_matches_plain(conv):
    """At each short-row conv of the 8→32 UNet: bit-equal to the plain
    version with a static scale and a bias (bf16 out) and with the dynamic
    scale and none (fp32 out), every output written once."""
    B, C, H, W, O, stride, _ = conv
    plan = int8_plan(B, C, H, W, O, stride)
    rng = np.random.RandomState(C + H + stride)
    x = torch.from_numpy((rng.randn(B, C, H, W) * 2).astype(np.float32)) \
        .to(BF16)
    w = torch.from_numpy((rng.randn(O, C, 3, 3) * (9 * C) ** -0.5)
                         .astype(np.float32))
    bias = torch.from_numpy(rng.randn(O).astype(np.float32))
    for b, a, out_dtype in ((bias, 0.04, BF16), (None, None, torch.float32)):
        got, written = _emulate_deep(x, w, b, stride, a, plan, out_dtype)
        assert torch.equal(written, torch.ones_like(written))
        want = int8_conv_reference(x, w, b, stride=stride,
                                   out_dtype=out_dtype, a_scale=a)
        assert torch.equal(got, want)
