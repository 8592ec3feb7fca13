"""The conv kernels' plan (``sr3d_torch.kernels.conv3x3.conv_plan``) on the
CPU: which path each shape takes, its tile and split count, that every
split plan covers K once, and, through a torch emulation of the
tensor-core kernel's index arithmetic (tile decode, row band, tap offsets,
split ranges), that the plan's tiles cover every output pixel once and
give the plain version's conv.  The kernels themselves are held to the
plain version on the card by tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest
import torch

from sr3d_torch.kernels.conv3x3 import (
    conv3x3_reference,
    conv_plan,
    split_chunks,
)

torch.set_num_threads(1)
BF16 = torch.bfloat16


@pytest.mark.parametrize("shape,want", [
    # the flagship UNet's widths: an Upsample conv, the fused blocks
    ((8, 128, 128, 128, 128), dict(bn=128, tile_w=128, rows=1, images=1,
                                   m_tiles=1024, splits=1, blocks=132)),
    ((8, 128, 128, 192, 64), dict(bn=64, tile_w=128, rows=2, images=1,
                                  m_tiles=512, splits=1, blocks=132)),
    ((8, 128, 128, 64, 64), dict(bn=64, tile_w=128, rows=2, images=1,
                                 m_tiles=512, splits=1, blocks=132)),
    # the deepest level: 16 tiles of 128 x 128 for 132 SMs -> split K
    ((8, 8, 8, 1024, 512), dict(bn=128, tile_w=8, rows=8, images=2,
                                m_tiles=4, splits=8, blocks=128)),
    # H*W < 128: a tile spans two images
    ((4, 8, 8, 64, 128), dict(bn=128, tile_w=8, rows=8, images=2,
                              m_tiles=2, splits=1, blocks=2)),
    # W not a divisor of the tile: 12 rows of 20
    ((1, 20, 20, 64, 64), dict(bn=64, tile_w=20, rows=12, images=1,
                               m_tiles=2, splits=1, blocks=2)),
    # W > 128: column tiles with a real halo column between them
    ((1, 4, 160, 64, 64), dict(bn=64, tile_w=128, rows=2, images=1,
                               m_tiles=4, splits=1, blocks=4)),
])
def test_plan_tensor_core_shapes(shape, want):
    plan = conv_plan(*shape, BF16, sm_count=132)
    assert plan.path == "wgmma", plan.why
    assert {k: getattr(plan, k) for k in want} == want
    assert plan.images * plan.rows * plan.tile_w <= 128 * (128 // plan.bn)
    assert plan.smem_bytes <= 232448


@pytest.mark.parametrize("shape,dtype,why", [
    ((8, 128, 128, 6, 64), BF16, "C = 6"),             # conv_in
    ((1, 5, 7, 64, 40), BF16, "O = 40"),               # ragged O
    ((2, 16, 16, 64, 3), BF16, "O = 3"),               # final_conv's O
    ((2, 16, 16, 32, 16), BF16, "C = 32"),
    ((8, 128, 128, 128, 128), torch.float32, "fp32"),  # no TF32
    ((128, 1, 1, 64, 64), BF16, "shared memory"),      # 1x1 images
])
def test_plan_simt_shapes(shape, dtype, why):
    plan = conv_plan(*shape, dtype)
    assert plan.path == "simt" and why in plan.why


def test_split_count_follows_the_sm_count():
    """Split only while the output tiles leave SMs idle, as far as the SMs
    hold whole splits, at most one split per 64-channel chunk."""
    shape = (8, 8, 8, 1024, 512)
    assert conv_plan(*shape, BF16, sm_count=16).splits == 1
    assert conv_plan(*shape, BF16, sm_count=64).splits == 4
    assert conv_plan(*shape, BF16, sm_count=10 ** 4).splits == 16
    assert conv_plan(1, 8, 8, 64, 64, BF16).splits == 1   # one chunk


def test_activation_count_per_input_element():
    """(R+2)/R per output-column tile: 2 at W = 128 with O = 64 (BM 256),
    3 with O = 128, 1.25 at 8x8 (the CUDA-core kernel: 9 per 64 outputs)."""
    for shape, per in (((8, 128, 128, 192, 64), 2.0),
                       ((8, 128, 128, 128, 128), 3.0),
                       ((8, 8, 8, 1024, 512), 1.25)):
        p = conv_plan(*shape, BF16)
        assert (p.rows + 2) / p.rows == per


@pytest.mark.parametrize("chunks", [1, 2, 3, 7, 16])
def test_every_split_plan_covers_k_once(chunks):
    for splits in range(1, chunks + 1):
        r = split_chunks(chunks, splits)
        assert len(r) == splits
        assert r[0][0] == 0 and r[-1][1] == chunks
        assert all(lo < hi for lo, hi in r)
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))


def _emulate_wgmma(x, w, bias, plan):
    """The tensor-core kernel's index arithmetic in torch (fp32): each
    block stages its band per chunk and gathers the nine taps at each
    pixel's centre offset; split partials are summed in split order.
    Returns the output and how often each pixel was written."""
    B, H, W, C = x.shape
    O = w.shape[-1]
    TW, R, IM = plan.tile_w, plan.rows, plan.images
    BW, BR = TW + 2, R + 2
    n_tw, n_r = math.ceil(W / TW), math.ceil(H / R)
    wt = w.reshape(9 * C, O).t()                       # [O, 9C], K-major
    out = torch.zeros(B * H * W, O)
    written = torch.zeros(B * H * W, dtype=torch.int64)
    bp = torch.arange(IM * BR * BW)
    BM = 128 * (128 // plan.bn)
    p = torch.arange(BM)
    i, rem = p // (R * TW), p % (R * TW)
    centre = torch.where(p < IM * R * TW,
                         (i * BR + rem // TW + 1) * BW + rem % TW + 1,
                         BW + 1)
    for t in range(plan.m_tiles):
        w0 = (t % n_tw) * TW
        h0 = (t // n_tw % n_r) * R
        b0 = t // n_tw // n_r * IM
        b = b0 + bp // BW // BR
        h = h0 + bp // BW % BR - 1
        ww = w0 + bp % BW - 1
        ok = (b < B) & (h >= 0) & (h < H) & (ww >= 0) & (ww < W)
        band = torch.zeros(len(bp), C)
        band[ok] = x[b[ok], h[ok], ww[ok]]
        m_b, m_h, m_w = b0 + i, h0 + rem // TW, w0 + rem % TW
        valid = (p < IM * R * TW) & (m_b < B) & (m_h < H) & (m_w < W)
        m = (m_b * H + m_h) * W + m_w
        acc = torch.zeros(BM, O)
        for lo, hi in split_chunks(C // 64, plan.splits):
            part = torch.zeros(BM, O)
            for c in range(lo, hi):
                for tap in range(9):
                    src = centre + (tap // 3 - 1) * BW + (tap % 3 - 1)
                    k = tap * C + c * 64
                    part += band[src, c * 64:(c + 1) * 64] @ \
                        wt[:, k:k + 64].t()
            acc += part
        out[m[valid]] = acc[valid] + (0 if bias is None else bias)
        written[m[valid]] += 1
    return out.reshape(B, H, W, O), written


@pytest.mark.parametrize("shape,sm_count", [
    ((2, 20, 20, 64, 64), 132),    # W not a multiple of the tile width
    ((3, 8, 8, 64, 128), 132),     # tiles span images; ragged last group
    ((1, 4, 160, 64, 64), 132),    # W > 128: halo columns between tiles
    ((1, 3, 160, 64, 128), 132),   # the same at BN 128, ragged rows
    ((1, 8, 8, 256, 128), 132),    # split K, 4 ways
    ((2, 5, 7, 128, 64), 3),       # ragged rows and columns, split 2 ways
])
def test_wgmma_tiles_cover_pixels_once_and_match_plain(shape, sm_count):
    B, H, W, C, O = shape
    plan = conv_plan(*shape, BF16, sm_count=sm_count)
    assert plan.path == "wgmma"
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, C, O) * (9 * C) ** -0.5)
                         .astype(np.float32))
    bias = torch.from_numpy(rng.randn(O).astype(np.float32))
    got, written = _emulate_wgmma(x, w, bias, plan)
    assert torch.equal(written, torch.ones_like(written))
    np.testing.assert_allclose(got.numpy(),
                               conv3x3_reference(x, w, bias).numpy(),
                               atol=1e-4)
