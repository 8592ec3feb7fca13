"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

CUDA kernels have no CPU mode, so every test here needs an NVIDIA card and
skips without one.  This file imports no JAX, so it also runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from sr3d_torch.kernels import (
    conv3x3,
    fused_gn_swish_conv3x3,
    gn_stats,
    gn_swish,
    gn_swish_backward,
    int8_conv,
    launch_counts,
    reset_launch_counts,
    spatial_attention,
)
from sr3d_torch.kernels.attention import (
    attn_plan,
    spatial_attention_reference,
)
from sr3d_torch.kernels.conv3x3 import conv3x3_reference
from sr3d_torch.kernels.fused_block import fused_block_reference
from sr3d_torch.kernels.groupnorm_swish import (
    gn_bwd_plan,
    gn_plan,
    gn_stats_reference,
    gn_swish_backward_reference,
    gn_swish_reference,
)
from sr3d_torch.kernels.int8_conv import (
    int8_conv_quantized,
    int8_conv_reference,
    int8_plan,
    prepare_weight,
)
from sr3d_torch.models.sr3_unet import SR3UNet
from sr3d_torch.ops.quant import Int8Conv

pytestmark = pytest.mark.cuda

# fp32: the kernels sum in another order than the plain version, so the
# moments agree to fp32 rounding of a 16k-term sum (rtol 1e-4) and the
# normalised outputs to ~1e-5.  bf16: outputs are rounded to bf16, whose
# ulp is 2^-8 relative, so one ulp of difference is allowed.
TOL = {torch.float32: dict(atol=2e-5, rtol=1e-5),
       torch.bfloat16: dict(atol=2e-2, rtol=8e-3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gn_inputs(shape, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    C = shape[1]
    x = (torch.randn(shape, generator=g) * 2 + 0.5).to(dtype)
    gamma = torch.rand(C, generator=g) + 0.5
    beta = torch.randn(C, generator=g) * 0.1
    return x.to(device), gamma.to(device), beta.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups", [
    ((2, 64, 128, 128), 32),   # the 16->128 UNet's widest level
    ((2, 192, 64, 64), 32),
    ((2, 1024, 8, 8), 32),     # its deepest level
    ((2, 32, 8, 8), 8),        # the CPU tests' tiny UNet
    ((1, 16, 5, 7), 4),        # H*W not a multiple of the vector width
    ((2, 32, 16, 16), 32),     # one channel a group
    ((2, 96, 16, 16), 32),     # C not a multiple of 64: 3 channels a group
    ((1, 192, 128, 128), 32),  # B = 1: clusters of 8
    ((1, 512, 128, 128), 32),  # bf16: 64 KB a CTA; fp32: stats + apply
])
def test_gn_kernels_match_plain(cuda, shape, groups, dtype):
    x, gamma, beta = _gn_inputs(shape, dtype, cuda)
    s, q = gn_stats(x)
    s_ref, q_ref = gn_stats_reference(x)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(q, q_ref, rtol=1e-4, atol=1e-3)
    y = gn_swish(x, gamma, beta, groups)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    torch.testing.assert_close(
        y.float(), gn_swish_reference(x, gamma, beta, groups).float(),
        **TOL[dtype])


# every GN width of the 16->128 UNet's levels, and the T=600 path's B = 1
GN_MAIN_PATH = [(8, 192, 128, 128), (8, 64, 128, 128), (8, 384, 64, 64),
                (8, 768, 32, 32), (8, 1024, 16, 16), (8, 1024, 8, 8),
                (8, 512, 8, 8), (1, 64, 128, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GN_MAIN_PATH)
def test_gn_swish_one_pass_main_path_shapes(cuda, shape, dtype):
    B, C, H, W = shape
    assert gn_plan(B, C, 32, H * W, dtype).path == "onepass"
    x, gamma, beta = _gn_inputs(shape, dtype, cuda, seed=2)
    reset_launch_counts()
    y = gn_swish(x, gamma, beta, 32)
    torch.cuda.synchronize()
    assert launch_counts()["gn_swish"] == 1
    assert launch_counts()["gn_stats"] == 0
    torch.testing.assert_close(
        y.float(), gn_swish_reference(x, gamma, beta, 32).float(),
        **TOL[dtype])


def test_gn_swish_two_pass_for_a_group_larger_than_a_cluster(cuda):
    """fp32 [1, 512, 128, 128]: a group of 1 MB, more than a cluster of 8
    CTAs holds, with H·W a multiple of the vector width, so ``gn_plan``
    gives the stats + apply pair and the apply kernel's 16-byte loads."""
    shape = (1, 512, 128, 128)
    assert gn_plan(1, 512, 32, 128 * 128, torch.float32).path == "two_pass"
    x, gamma, beta = _gn_inputs(shape, torch.float32, cuda, seed=3)
    reset_launch_counts()
    y = gn_swish(x, gamma, beta, 32)
    torch.cuda.synchronize()
    assert launch_counts()["gn_swish"] == 1
    assert launch_counts()["gn_stats"] == 1
    torch.testing.assert_close(
        y, gn_swish_reference(x, gamma, beta, 32), **TOL[torch.float32])


@pytest.mark.parametrize("C", [64, 128, 192])
def test_gn_swish_two_pass_at_the_512_level(cuda, C):
    """bf16 [4, C, 512, 512], the 64->512 UNet's outermost GN+Swish
    inputs: groups of 2–6 channels × 512² are larger than a cluster of 8
    CTAs holds, so ``gn_plan`` gives the stats + apply pair."""
    shape = (4, C, 512, 512)
    assert gn_plan(4, C, 32, 512 * 512, torch.bfloat16).path == "two_pass"
    x, gamma, beta = _gn_inputs(shape, torch.bfloat16, cuda, seed=4)
    reset_launch_counts()
    y = gn_swish(x, gamma, beta, 32)
    torch.cuda.synchronize()
    assert launch_counts()["gn_swish"] == 1
    assert launch_counts()["gn_stats"] == 1
    torch.testing.assert_close(
        y.float(), gn_swish_reference(x, gamma, beta, 32).float(),
        **TOL[torch.bfloat16])


def test_gn_near_constant_large_mean_is_finite(cuda):
    """The clamped one-pass variance keeps a constant bf16 map at a large
    magnitude finite; it normalises to ~swish(beta)."""
    C, G = 64, 32
    assert gn_plan(1, C, G, 32 * 32, torch.bfloat16).path == "onepass"
    gamma = torch.ones(C, device=cuda)
    beta = torch.full((C,), 0.3, device=cuda)
    for c in (2285.4912, 1862.8314, 3861.9184):
        x = torch.full((1, C, 32, 32), c, dtype=torch.bfloat16, device=cuda)
        y = gn_swish(x, gamma, beta, G).float()
        assert torch.isfinite(y).all(), c
        want = 0.3 / (1 + torch.exp(torch.tensor(-0.3)))
        assert abs(float(y[0, 0, 0, 0]) - float(want)) < 0.05, c


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (8, 64, 512),    # the 16->128 mid block: clusters of 8
    (1, 64, 512),    # the same at the T=600 path's B = 1
    (2, 256, 128),   # four query tiles, clusters of 2
    (8, 4, 512),     # the 16_32 configs' mid block: HW = 4
    (2, 64, 32),     # one slice, no partner in the cluster
    (1, 37, 40),     # ragged query, key and channel tiles
    (1, 100, 200),   # a ragged last slice, clusters of 4
    (1, 256, 1024),  # two slices a CTA
    (4, 256, 1024),  # the 64->512 UNet's 16² attention levels
    (2, 16, 36),     # bf16 with C % 8 != 0: the CUDA-core kernel
])
def test_attention_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device="cpu").manual_seed(1)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    out = spatial_attention(q, k, v)
    torch.cuda.synchronize()
    ref = spatial_attention_reference(q, k, v, shape[-1] ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


def test_wrappers_count_launches_and_refuse_bad_inputs(cuda):
    reset_launch_counts()
    x, gamma, beta = _gn_inputs((1, 32, 8, 8), torch.float32, cuda)
    gn_swish(x, gamma, beta, 8)
    q = torch.randn(1, 64, 32, device=cuda)
    spatial_attention(q, q, q)
    xh = torch.randn(1, 8, 8, 32, device=cuda)
    w = torch.randn(3, 3, 32, 16, device=cuda)
    conv3x3(xh, w)
    fused_gn_swish_conv3x3(xh, gamma, beta, w, torch.zeros(16, device=cuda),
                           8)
    w8 = torch.randn(16, 32, 3, 3, device=cuda)
    int8_conv(x, w8)
    # gn_swish: one launch, no gn_stats; the fused block's NHWC stats: one
    assert launch_counts() == {"gn_stats": 1, "gn_swish": 1,
                               "gn_swish_backward": 0,
                               "spatial_attention": 1, "conv3x3": 1,
                               "fused_gn_swish_conv3x3": 1, "int8_conv": 1}
    with pytest.raises(TypeError):
        gn_stats(x.half())
    with pytest.raises(ValueError):
        gn_swish(x.transpose(2, 3), gamma, beta, 8)
    with pytest.raises(ValueError):
        spatial_attention(q, q[:, :32], q)
    with pytest.raises(ValueError):
        int8_conv(x.transpose(2, 3), w8)
    with pytest.raises(ValueError):
        int8_conv(x, w8, padding=0)
    with pytest.raises(ValueError):
        int8_conv(x, w8, stride=3)
    with pytest.raises(TypeError):
        int8_conv(x.half(), w8)
    assert launch_counts()["int8_conv"] == 1
    assert launch_counts()["spatial_attention"] == 1
    with pytest.raises(ValueError):
        conv3x3(xh, w[:, :, :16])
    with pytest.raises(ValueError):
        conv3x3(xh.transpose(1, 2), w)
    with pytest.raises(ValueError):
        fused_gn_swish_conv3x3(xh, gamma, beta, w, torch.zeros(16,
                                                               device=cuda),
                               5)
    assert launch_counts()["gn_stats"] == 1
    assert launch_counts()["conv3x3"] == 1


def test_gn_and_attention_repeat_bit_for_bit(cuda):
    """The clusters add their partials in rank order, without atomics:
    repeated calls give equal bits."""
    x, gamma, beta = _gn_inputs((8, 192, 128, 128), torch.bfloat16, cuda)
    assert gn_plan(8, 192, 32, 128 * 128, torch.bfloat16).cluster > 1
    g = torch.Generator(device="cpu").manual_seed(5)
    q, k, v = (torch.randn(8, 64, 512, generator=g).bfloat16().to(cuda)
               for _ in range(3))
    assert attn_plan(64, 512, torch.bfloat16).cluster == 8
    for fn in (lambda: gn_swish(x, gamma, beta, 32),
               lambda: spatial_attention(q, k, v)):
        first = fn()
        for _ in range(3):
            assert torch.equal(fn(), first)


# The conv kernels sum the 9·C products in another order than cuDNN's fp32
# convolution (TF32 off): ~1e-6 relative on outputs of size ~1, so fp32 is
# held to 1e-4.  bf16 outputs are rounded to bf16 on both sides: one ulp.
CONV_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
            torch.bfloat16: dict(atol=2e-2, rtol=8e-3)}
CONV_SHAPES = [
    ((2, 8, 8, 6), 64),       # conv_in's C = 6 (CUDA cores)
    ((1, 5, 7, 16), 40),      # H·W = 35 and O = 40: ragged tiles
    ((2, 16, 16, 32), 16),
    ((2, 32, 32, 128), 128),  # an Upsample conv's widths (tensor cores)
    ((1, 8, 8, 1024), 512),   # the deepest level: K split 16 ways
    ((1, 20, 20, 64), 64),    # W not a multiple of the band's width
    ((2, 16, 16, 64), 3),     # O = 3, final_conv's (CUDA cores)
    ((4, 8, 8, 64), 128),     # H·W < 128: a tile spans two images
    ((1, 4, 160, 64), 64),    # W > 128: tiles share halo columns
]


def _conv_inputs(xshape, O, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    C = xshape[-1]
    x = torch.randn(xshape, generator=g).to(dtype)
    w = (torch.randn(3, 3, C, O, generator=g) * (9 * C) ** -0.5).to(dtype)
    b = torch.randn(O, generator=g) * 0.1
    return x.to(device), w.to(device), b.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,O", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda, xshape, O, dtype):
    x, w, b = _conv_inputs(xshape, O, dtype, cuda)
    for bias in (None, b):
        out = conv3x3(x, w, bias)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == xshape[:3] + (O,)
        torch.testing.assert_close(
            out.float(), conv3x3_reference(x, w, bias).float(),
            **CONV_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,O,G", [
    ((2, 16, 16, 64), 64, 8),
    ((1, 5, 7, 32), 40, 8),      # ragged pixels and outputs
    ((2, 16, 16, 128), 64, 32),
    ((1, 8, 8, 1024), 512, 32),  # the deepest level: split K
    ((1, 20, 20, 64), 64, 32),   # W not a multiple of the band's width
    ((4, 8, 8, 64), 128, 32),    # a tile spans two images
    ((2, 16, 16, 64), 3, 32),    # O = 3 (CUDA cores)
])
def test_fused_block_kernel_matches_plain(cuda, xshape, O, G, dtype):
    x, w, b = _conv_inputs(xshape, O, dtype, cuda, seed=1)
    x = (x.float() * 2 + 0.5).to(dtype)
    gamma = torch.rand(xshape[-1], device=cuda) + 0.5
    beta = torch.randn(xshape[-1], device=cuda) * 0.1
    out = fused_gn_swish_conv3x3(x, gamma, beta, w, b, G)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == xshape[:3] + (O,)
    torch.testing.assert_close(
        out.float(), fused_block_reference(x, gamma, beta, w, b, G).float(),
        **CONV_TOL[dtype])


def test_split_k_repeats_bit_for_bit(cuda):
    """The split-K path sums its fp32 partials in a fixed order, without
    atomics: repeated calls give equal bits; one launch counted a call."""
    x, w, b = _conv_inputs((8, 8, 8, 1024), 512, torch.bfloat16, cuda)
    gamma = torch.rand(1024, device=cuda) + 0.5
    beta = torch.randn(1024, device=cuda) * 0.1
    reset_launch_counts()
    for fn in (lambda: conv3x3(x, w, b),
               lambda: fused_gn_swish_conv3x3(x, gamma, beta, w, b, 32)):
        first = fn()
        for _ in range(3):
            assert torch.equal(fn(), first)
    counts = launch_counts()
    assert counts["conv3x3"] == 4 and counts["fused_gn_swish_conv3x3"] == 4


def test_conv_kernels_take_unaligned_views(cuda):
    """Contiguous views that start 2 bytes into their storage (TMA wants
    16-byte aligned bases): the tensor-core path copies them first."""
    x, w, b = _conv_inputs((2, 16, 16, 64), 64, torch.bfloat16, cuda)
    xv = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:] \
        .view(x.shape).copy_(x)
    wv = torch.empty(w.numel() + 1, dtype=w.dtype, device=cuda)[1:] \
        .view(w.shape).copy_(w)
    assert xv.data_ptr() % 16 and wv.data_ptr() % 16
    torch.testing.assert_close(conv3x3(xv, wv, b).float(),
                               conv3x3(x, w, b).float(), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_stats_nhwc_matches_plain(cuda, dtype):
    x = (torch.randn(2, 33, 17, 96) * 2 + 0.5).to(dtype).to(cuda)
    s, q = gn_stats(x, channels_last=True)
    s_ref, q_ref = gn_stats_reference(x, channels_last=True)
    torch.testing.assert_close(s, s_ref, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(q, q_ref, rtol=1e-4, atol=1e-3)


# Gradients: the wrappers' backward is torch arithmetic on fp32 values, so
# fp32 agrees with autograd of the plain version to summation order.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gn_swish_gradient_matches_plain(cuda, dtype):
    x, gamma, beta = _gn_inputs((2, 64, 16, 16), dtype, cuda, seed=3)
    gy = torch.randn(x.shape, device=cuda).to(dtype)
    grads = []
    for fn in (gn_swish, gn_swish_reference):
        ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        y = fn(*ins, 32)
        assert y.grad_fn is not None
        grads.append(torch.autograd.grad(y, ins, gy))
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


# The GN+Swish backward kernels against their closed form (and autograd of
# the plain version): dx as GN+Swish's outputs (TOL); dγ and dβ are fp32
# sums of B·H·W terms, each term rounded differently (__expf, orders), so
# their error grows with the sum: within 2e-5 of the largest entry.
def _assert_gn_grads_close(got, ref, dtype):
    torch.testing.assert_close(got[0].float(), ref[0].float(), **TOL[dtype])
    for a, b in zip(got[1:], ref[1:]):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b.float(), atol=2e-5 * scale,
                                   rtol=1e-5)


GN_BWD_CASES = [
    ((2, 64, 128, 128), 32, "onepass"),   # the widest level, clusters
    ((4, 192, 64, 64), 32, "onepass"),
    ((2, 1024, 8, 8), 32, "onepass"),     # the deepest level, one CTA
    ((2, 96, 16, 16), 32, "onepass"),     # 3 channels a group
    ((1, 32, 8, 8), 8, "onepass"),        # the CPU tests' tiny UNet
    ((1, 16, 5, 7), 4, "multipass"),      # H*W not a multiple of a vector
    ((2, 1024, 1, 1), 32, "multipass"),   # H*W = 1 (the small configs)
    ((1, 256, 8, 8), 2, "multipass"),     # 128 channels a group
]


def _gn_bwd_inputs(shape, dtype, device, seed=0):
    x, gamma, beta = _gn_inputs(shape, dtype, device, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 100)
    return x, gamma, beta, torch.randn(shape, generator=g).to(dtype).to(
        device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,groups,path", GN_BWD_CASES)
def test_gn_backward_kernel_matches_closed_form(cuda, shape, groups, path,
                                                dtype):
    B, C, H, W = shape
    assert gn_bwd_plan(B, C, groups, H * W, dtype).path == path
    x, gamma, beta, gy = _gn_bwd_inputs(shape, dtype, cuda, seed=4)
    reset_launch_counts()
    got = gn_swish_backward(x, gamma, beta, gy, groups)
    torch.cuda.synchronize()
    assert launch_counts()["gn_swish_backward"] == 1
    assert launch_counts()["gn_stats"] == 0
    ref = gn_swish_backward_reference(x, gamma, beta, gy, groups)
    ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    auto = torch.autograd.grad(gn_swish_reference(*ins, groups), ins, gy)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _assert_gn_grads_close(got, ref, dtype)
    _assert_gn_grads_close(got, auto, dtype)


def test_gn_backward_fp32_group_beyond_a_cluster_is_multipass(cuda):
    shape = (1, 512, 128, 128)
    assert gn_bwd_plan(1, 512, 32, 128 * 128, torch.float32).path == \
        "multipass"
    assert gn_bwd_plan(1, 512, 32, 128 * 128, torch.bfloat16).path == \
        "onepass"
    for dtype in (torch.float32, torch.bfloat16):
        x, gamma, beta, gy = _gn_bwd_inputs(shape, dtype, cuda, seed=5)
        got = gn_swish_backward(x, gamma, beta, gy, 32)
        ref = gn_swish_backward_reference(x, gamma, beta, gy, 32)
        _assert_gn_grads_close(got, ref, dtype)


@pytest.mark.parametrize("shape,groups", [((8, 192, 128, 128), 32),
                                          ((2, 64, 5, 10), 32)])
def test_gn_backward_repeats_bit_for_bit(cuda, shape, groups):
    """Both plan paths add their partials in a fixed order, without
    atomics, and dγ, dβ sum the per-(b, c) partials over b in one."""
    x, gamma, beta, gy = _gn_bwd_inputs(shape, torch.bfloat16, cuda)
    first = gn_swish_backward(x, gamma, beta, gy, groups)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(
            gn_swish_backward(x, gamma, beta, gy, groups), first))


@pytest.mark.parametrize("shape", [(2, 64, 32, 32), (2, 64, 1, 1)])
@pytest.mark.parametrize("need", [(True, False, False), (False, True, True),
                                  (True, True, False), (False, False, True)])
def test_gn_backward_honours_needs_input_grad(cuda, shape, need):
    """Frozen γ and β (``finetune_norm``) or an x that needs no gradient
    (the first block's input): autograd asks only for what is needed, and
    the kernels give the same values as when all three are wanted."""
    x, gamma, beta, gy = _gn_bwd_inputs(shape, torch.float32, cuda, seed=6)
    full = gn_swish_backward(x, gamma, beta, gy, 32)
    part = gn_swish_backward(x, gamma, beta, gy, 32, need=need)
    for n, a, b in zip(need, part, full):
        assert (a is None) != n
        if n:
            assert torch.equal(a, b)
    ins = [t.clone().requires_grad_(n) for t, n in zip((x, gamma, beta),
                                                       need)]
    y = gn_swish(*ins, 32)
    wanted = [t for t in ins if t.requires_grad]
    got = torch.autograd.grad(y, wanted, gy)
    for a, b in zip(got, [f for f, n in zip(full, need) if n]):
        assert torch.equal(a, b)


def test_gn_backward_near_constant_large_mean_is_finite(cuda):
    """A near-constant bf16 map at a large magnitude (the clamped
    variance) gives finite gradients on both paths."""
    C, G = 64, 32
    for hw in (32, 5):   # one pass; multi-pass
        x = torch.full((1, C, hw, hw), 2208.0, device=cuda)
        x[0, 0, 0, 0] = x[0, 33, 3, 1] = 2224.0
        x = x.bfloat16()
        gy = torch.randn(x.shape, device=cuda).bfloat16()
        got = gn_swish_backward(x, torch.ones(C, device=cuda),
                                torch.full((C,), 0.3, device=cuda), gy, G)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in got)


def test_gn_backward_runs_no_plain_version(cuda, monkeypatch):
    """With the plain versions made to raise, a backward through gn_swish
    completes on the card: only the kernels run."""
    import sr3d_torch.kernels.groupnorm_swish as gn

    def boom(*a, **k):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(gn, "gn_swish_reference", boom)
    monkeypatch.setattr(gn, "gn_swish_backward_reference", boom)
    for shape in ((2, 64, 32, 32), (2, 64, 5, 5)):
        x, gamma, beta, gy = _gn_bwd_inputs(shape, torch.bfloat16, cuda)
        ins = [t.clone().requires_grad_() for t in (x, gamma, beta)]
        reset_launch_counts()
        grads = torch.autograd.grad(gn_swish(*ins, 32), ins, gy)
        torch.cuda.synchronize()
        assert launch_counts()["gn_swish_backward"] == 1
        assert all(bool(torch.isfinite(t).all()) for t in grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_gradient_matches_plain(cuda, dtype):
    g = torch.Generator(device="cpu").manual_seed(4)
    q, k, v, go = (torch.randn(8, 64, 512, generator=g).to(dtype).to(cuda)
                   for _ in range(4))
    grads = []
    for fn in (spatial_attention,
               lambda *a: spatial_attention_reference(*a, 512 ** -0.5)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        assert out.grad_fn is not None
        grads.append(torch.autograd.grad(out, ins, go))
    for a, b in zip(*grads):
        torch.testing.assert_close(a.float(), b.float(), **TOL[dtype])


def test_remat_keeps_gradients_with_dropout(cuda):
    """Remat on and off give the same loss and gradients with dropout 0.5:
    the recompute redraws the same masks.  fp32; cuDNN's weight-gradient
    sums may run in another order between the two runs, hence 1e-5."""
    torch.manual_seed(0)
    unet = SR3UNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.float32, dropout=0.5).to(cuda).train()
    x = torch.randn(2, 6, 16, 16, device=cuda)
    t = torch.rand(2, 1, device=cuda)
    res = []
    for remat in (False, True):
        unet.remat = remat
        unet.zero_grad()
        gen = torch.Generator(device=cuda).manual_seed(7)
        loss = unet(x, t, generator=gen,
                    deterministic=False).square().mean()
        loss.backward()
        res.append((loss.detach(), {n: p.grad.clone()
                                    for n, p in unet.named_parameters()}))
    unet.eval()
    with torch.no_grad():
        assert not torch.allclose(unet(x, t).square().mean(), res[0][0])
    torch.testing.assert_close(res[1][0], res[0][0], rtol=1e-6, atol=0)
    for n, gr in res[0][1].items():
        torch.testing.assert_close(res[1][1][n], gr, rtol=1e-5, atol=1e-7,
                                   msg=n)


# Attention past MAX_TOKENS (the long path: two passes over key tiles).  P
# is rounded to v's type after the division on both sides, but the sums of
# exponentials run in other orders, so a P on a rounding boundary may land
# one ulp apart: the attention tolerance above.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 1024, 512),  # 256² data at the default attn_res (16)
    (1, 4096, 512),  # 512² data
    (2, 1024, 256),  # clusters of 4
    (1, 2049, 512),  # a ragged last key tile and query tile
    (1, 257, 64),    # one key past the on-chip limit, a ragged tile
    (1, 300, 40),    # C not a multiple of the channel slice
    (1, 520, 1032),  # 17 slices over 8 ranks: output rounds
])
def test_attention_long_path_matches_plain(cuda, shape, dtype):
    assert attn_plan(shape[1], shape[2], dtype).path == "long"
    g = torch.Generator(device="cpu").manual_seed(6)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    reset_launch_counts()
    out = spatial_attention(q, k, v)
    torch.cuda.synchronize()
    assert launch_counts()["spatial_attention"] == 1
    ref = spatial_attention_reference(q, k, v, shape[-1] ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), **TOL[dtype])


# The tiled kernel (plan paths long and simt) adds the cluster's partial
# scores in rank order and its P V in key-tile order: equal bits each call.
@pytest.mark.parametrize("shape,dtype", [
    ((2, 1024, 512), torch.bfloat16),  # long, tensor cores
    ((1, 300, 40), torch.float32),     # long, 3xTF32
    ((8, 64, 512), torch.float32),     # simt, 3xTF32
    ((2, 16, 36), torch.bfloat16),     # simt, C % 8 != 0
])
def test_tiled_attention_repeats_bit_for_bit(cuda, shape, dtype):
    assert attn_plan(shape[1], shape[2], dtype).path in ("long", "simt")
    g = torch.Generator(device="cpu").manual_seed(8)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    first = spatial_attention(q, k, v)
    for _ in range(3):
        assert torch.equal(spatial_attention(q, k, v), first)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tiled_attention_takes_unaligned_views(cuda, dtype):
    """Views that start off a 16-byte boundary load an element at a time
    (no 16-byte cp.async) and give the same result as aligned copies."""
    g = torch.Generator(device="cpu").manual_seed(9)
    shape = (1, 300, 64)
    flat = [torch.randn(300 * 64 + 1, generator=g).to(dtype).to(cuda)
            for _ in range(3)]
    q, k, v = (f[1:].view(shape) for f in flat)
    assert q.data_ptr() % 16 != 0
    out = spatial_attention(q, k, v)
    ref = spatial_attention(*(t.clone() for t in (q, k, v)))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


# The int8 conv sums integers exactly and dequantizes in the plain
# version's order, without FMA contraction: bit for bit.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("xshape,O", [
    ((2, 64, 16, 16), 64),     # the tiny UNet's widths
    ((1, 40, 9, 13), 24),      # ragged Cin (40 = 32 + 8), odd H, W, O
    ((2, 192, 32, 32), 64),    # an up-block input of the flagship
    ((1, 6, 130, 70), 16),     # Cin below one chunk, W > 64: two tiles
])
def test_int8_conv_matches_plain_bit_for_bit(cuda, xshape, O, stride,
                                             static, dtype):
    g = torch.Generator(device="cpu").manual_seed(7)
    x = (torch.randn(xshape, generator=g) * 2).to(dtype).to(cuda)
    w = (torch.randn(O, xshape[1], 3, 3, generator=g) * 0.05).to(cuda)
    b = torch.randn(O, generator=g).to(cuda)
    a = torch.tensor(0.03, device=cuda) if static else None
    for bias, out_dtype in ((b, dtype), (None, torch.float32)):
        reset_launch_counts()
        out = int8_conv(x, w, bias, stride=stride, out_dtype=out_dtype,
                        a_scale=a)
        torch.cuda.synchronize()
        assert launch_counts()["int8_conv"] == 1
        ref = int8_conv_reference(x, w, bias, stride=stride,
                                  out_dtype=out_dtype, a_scale=a)
        assert out.dtype == out_dtype and out.shape == ref.shape
        assert torch.equal(out, ref)


def test_int8_unet_launches_each_gated_conv(cuda):
    """The tiny UNet at quant_min_res 1 with resampling: 12 ResnetBlock
    convs (2 down blocks, 4 up blocks; the mid blocks never), the
    Downsample and the Upsample conv, one launch each.  quant_min_res 16:
    the 16² level's 6 and both resampling convs (the Upsample gated after
    its resize); 32: none."""
    torch.manual_seed(0)
    for qmr, want in ((1, 14), (16, 8), (32, 0)):
        unet = SR3UNet(inner_channel=32, norm_groups=8,
                       channel_mults=(1, 2), attn_res=(8,), res_blocks=1,
                       image_size=16, dtype=torch.bfloat16,
                       quant_min_res=qmr, quant_resample=True).to(cuda)
        x = torch.randn(2, 6, 16, 16, device=cuda)
        t = torch.rand(2, 1, device=cuda)
        reset_launch_counts()
        with torch.no_grad():
            out = unet.eval()(x, t, quant=True)
        torch.cuda.synchronize()
        assert launch_counts()["int8_conv"] == want, qmr
        assert torch.isfinite(out).all()


# The tensor-core int8 conv (s8 wgmma, K split over a cluster) at its edge
# shapes: W below a tile, odd H at stride 2, O = 64 and 512, split and
# unsplit, bf16 and fp32 in and out.  Bit for bit, and repeats too.
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("xshape,O,stride,splits", [
    ((2, 64, 12, 24), 64, 1, None),     # W = 24 below a tile, ragged rows
    ((3, 128, 15, 16), 128, 2, None),   # odd H at stride 2, odd batch
    ((1, 512, 8, 8), 512, 1, 8),        # the deepest level: 8-way split
    ((2, 256, 16, 16), 512, 2, None),   # stride 2 into 8x8, two images
    ((8, 192, 128, 128), 64, 1, 1),     # the widest: BN 64, 256 pixels
    ((8, 128, 64, 64), 128, 1, 1),      # BN 128, unsplit
    ((4, 192, 512, 512), 64, 1, 1),     # the 64->512 UNet's widest
    ((4, 64, 512, 512), 64, 1, 1),      # its 512² ResnetBlock convs
])
def test_int8_conv_tensor_cores_match_plain(cuda, xshape, O, stride, splits,
                                            dtype, out_dtype):
    B, C, H, W = xshape
    plan = int8_plan(B, C, H, W, O, stride,
                     torch.cuda.get_device_properties(
                         cuda).multi_processor_count, in_dtype=dtype)
    assert plan.path == "wgmma", plan.why
    if splits is not None:
        assert plan.splits == splits
    g = torch.Generator(device="cpu").manual_seed(11)
    x = (torch.randn(xshape, generator=g) * 2).to(dtype).to(cuda)
    w = (torch.randn(O, C, 3, 3, generator=g) * C ** -0.5).to(cuda)
    b = torch.randn(O, generator=g).to(cuda)
    for bias, a in ((b, torch.tensor(0.04, device=cuda)), (None, None)):
        reset_launch_counts()
        out = int8_conv(x, w, bias, stride=stride, out_dtype=out_dtype,
                        a_scale=a)
        again = int8_conv(x, w, bias, stride=stride, out_dtype=out_dtype,
                          a_scale=a)
        torch.cuda.synchronize()
        assert launch_counts()["int8_conv"] == 2
        ref = int8_conv_reference(x, w, bias, stride=stride,
                                  out_dtype=out_dtype, a_scale=a)
        assert out.dtype == out_dtype and out.shape == ref.shape
        assert torch.equal(out, ref)
        assert torch.equal(again, out)


def test_int8_cached_static_conv_is_one_launch(cuda):
    """On the cached path a static-scale int8 conv dispatches one kernel
    and nothing else that computes (views and allocations only); the
    weights are quantized on the first call alone."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    conv = Int8Conv(128, 128, 3, padding=1,
                    compute_dtype=torch.bfloat16).to(cuda)
    x = torch.randn(2, 128, 16, 16, device=cuda).to(torch.bfloat16)
    a = torch.tensor(0.05, device=cuda)
    first = conv(x, quant=True, a_scale=a)
    n = Int8Conv.weight_quantizes
    reset_launch_counts()
    with Ops() as mode:
        out = conv(x, quant=True, a_scale=a)
    torch.cuda.synchronize()
    assert Int8Conv.weight_quantizes == n
    assert launch_counts()["int8_conv"] == 1
    assert set(mode.ops) <= {"empty", "view", "_unsafe_view", "alias",
                             "detach"}, mode.ops
    assert torch.equal(out, first)
    wk, ws = prepare_weight(conv.weight)
    assert torch.equal(out, int8_conv_quantized(
        x, wk, ws, conv.bias, out_dtype=torch.bfloat16, a_scale=a))


def test_int8_unet_repeat_forward_quantizes_no_weight(cuda):
    """A second int8 forward of the tiny UNet launches the kernel once per
    gated conv again, quantizes no weight and gives the same bits."""
    torch.manual_seed(0)
    unet = SR3UNet(inner_channel=64, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.bfloat16, quant_min_res=1,
                   quant_resample=True).to(cuda).eval()
    x = torch.randn(2, 6, 16, 16, device=cuda)
    t = torch.rand(2, 1, device=cuda)
    with torch.no_grad():
        first = unet(x, t, quant=True)
        n = Int8Conv.weight_quantizes
        reset_launch_counts()
        out = unet(x, t, quant=True)
    torch.cuda.synchronize()
    assert launch_counts()["int8_conv"] == 14
    assert Int8Conv.weight_quantizes == n
    assert torch.equal(out, first)


def test_renderer_on_the_card_matches_the_cpu(cuda):
    """The scatter rasterizer on the card against the CPU's, the golden
    render's tolerance (mean |Δ| < 1 level, < 0.5% more than 8 apart), on
    the synthetic FLAME mean head and a batch of two sphere heads."""
    import numpy as np

    from sr3d_torch.eval.renderer import render_mesh, render_meshes
    from sr3d_torch.models.flame import (
        flame_forward,
        sphere_flame,
        synthetic_flame,
    )

    def close(a, b):
        a = (a.cpu().numpy().clip(0, 1) * 255).astype(np.uint8).astype(int)
        b = (b.cpu().numpy().clip(0, 1) * 255).astype(np.uint8).astype(int)
        d = np.abs(a - b)
        assert d.mean() < 1.0 and (d > 8).mean() < 0.005

    fl = synthetic_flame(n_shape=16, n_exp=8, seed=0)
    v, _, _ = flame_forward(fl, torch.zeros((1, 16)))
    close(render_mesh(v[0].to(cuda), fl.faces.to(cuda), image_size=256),
          render_mesh(v[0], fl.faces, image_size=256))
    sp = sphere_flame(n_shape=8, n_exp=4)
    v, _, _ = flame_forward(sp, torch.randn(2, 8,
                                            generator=torch.Generator()
                                            .manual_seed(0)))
    close(render_meshes(v.to(cuda), sp.faces.to(cuda), image_size=128),
          render_meshes(v, sp.faces, image_size=128))


def test_prefetch_matches_a_synchronous_copy(cuda):
    """``prefetch_to_device`` (pinned memory, a side stream, depth 2) gives
    the tensors a synchronous copy gives, in the loader's order, over three
    epochs, while the consumer's stream is busy with other work."""
    import numpy as np

    from sr3d_torch.data.pipeline import (
        BatchLoader,
        prefetch_to_device,
        shard_batch,
    )

    rng = np.random.RandomState(0)
    items = [{"HR": rng.rand(16, 16, 3).astype(np.float32),
              "flame_shape": rng.rand(8).astype(np.float32),
              "name": f"item{i}"} for i in range(10)]
    loader = BatchLoader(items, 3, shuffle=True, seed=1, num_workers=2)
    n = 3 * len(loader)
    ref_loader = BatchLoader(items, 3, shuffle=True, seed=1, num_workers=0)
    it_ref = iter(ref_loader)
    ref = [shard_batch(next(it_ref), cuda) for _ in range(n)]
    it = iter(loader)
    got = prefetch_to_device((next(it) for _ in range(n)), size=2,
                             device=cuda)
    busy = torch.randn(2048, 2048, device=cuda)
    for a, b in zip(got, ref, strict=True):
        busy = busy @ busy / 2048      # keeps the compute stream occupied
        assert a["HR"].is_cuda and a["name"] == b["name"]
        for k in ("HR", "flame_shape"):
            assert torch.equal(a[k] * 1, b[k]), k
    torch.cuda.synchronize()


def _kernel_modules(unet):
    """(GN+Swish modules, those inside the checkpointed blocks, attention
    modules) of a UNet: one launch each a forward; under remat the blocks'
    run again in the backward."""
    from sr3d_torch.models.sr3_unet import GroupNormSwish, SelfAttention

    gn = [n for n, m in unet.named_modules() if isinstance(m, GroupNormSwish)]
    attn = [n for n, m in unet.named_modules() if isinstance(m, SelfAttention)]
    return len(gn), len([n for n in gn if not n.startswith("final_conv")]), \
        len(attn)


def test_ddpm_unet_on_the_card_matches_the_cpu(cuda):
    """The DDPM family's UNet (integer t) on the card, through the GN+Swish
    and attention kernels, against the same weights on the CPU (plain
    versions), fp32; one launch per GN+Swish and attention module."""
    import copy

    from sr3d_torch.models.ddpm_unet import DDPMUNet

    torch.manual_seed(0)
    cpu = DDPMUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.float32).eval()
    gpu = copy.deepcopy(cpu).to(cuda)
    x = torch.randn(2, 6, 16, 16, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([3, 17])
    n_gn, _, n_attn = _kernel_modules(gpu)
    reset_launch_counts()
    with torch.no_grad():
        y = gpu(x.to(cuda), t.to(cuda))
        torch.cuda.synchronize()
        counts = launch_counts()
        ref = cpu(x, t)
    assert counts["gn_swish"] == n_gn and counts["spatial_attention"] == \
        n_attn, counts
    torch.testing.assert_close(y.cpu(), ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("which", ["sr3", "ddpm"])
def test_sr_only_step_on_the_card_matches_the_cpu(cuda, which):
    """One SR-only train step (remat on) on the card against the CPU's
    from the same weights and draws: l_pix to 1e-4, the parameters after
    Adam within 2·lr (99% to 1e-5); the launches: every GN+Swish and
    attention module once forward and, inside the checkpointed blocks,
    once more in the backward."""
    from sr3d_torch.config import get_cfg_defaults
    from sr3d_torch.train.sr_only import SRModel

    cfg = get_cfg_defaults()
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.train_remat = True
    u = cfg.sr.model.unet
    u.inner_channel, u.norm_groups = 16, 8
    u.channel_multiplier, u.attn_res = [1, 2], [8]
    u.res_blocks, u.dropout = 1, 0.0
    cfg.sr.model.diffusion.image_size = 16
    cfg.sr.model.which_model_G = which
    for ph in ("train", "val"):
        cfg.sr.model.beta_schedule[ph].n_timestep = 8
    g = torch.Generator().manual_seed(2)
    batch = {"HR": torch.rand(2, 16, 16, 3, generator=g) * 2 - 1,
             "SR": torch.rand(2, 16, 16, 3, generator=g) * 2 - 1}
    draws = {"noise": torch.randn(2, 3, 16, 16, generator=g),
             "t": torch.tensor([1, 6]), "gamma": torch.tensor([0.9, 0.4])}
    res = []
    for dev in ("cpu", cuda):
        m = SRModel(cfg, device=dev, init_seed=0)
        st = m.init_state()
        reset_launch_counts()
        st, met = m.make_train_step()(st, batch, draws=dict(draws))
        if dev != "cpu":
            torch.cuda.synchronize()
            counts = launch_counts()
            n_gn, n_blocks, n_attn = _kernel_modules(m.unet)
            assert counts["gn_swish"] == n_gn + n_blocks, counts
            assert counts["spatial_attention"] == 2 * n_attn, counts
        res.append((float(met["l_pix"]), {n: p.detach().cpu() for n, p in
                                          m.unet.named_parameters()}))
    assert abs(res[1][0] - res[0][0]) <= 1e-4 * abs(res[0][0])
    lr = float(cfg.sr.train.optimizer.lr)
    off = total = 0
    for n, p in res[0][1].items():
        d = (res[1][1][n] - p).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, n
        off, total = off + int((d > 1e-5).sum()), total + d.numel()
    assert off <= 0.01 * total, f"{off} of {total}"


def _traced_predictor():
    """A DDIM-4 Predictor of the tiny config on the card, warmed up, and a
    request of 3 faces for it."""
    from pathlib import Path

    import numpy as np

    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.serve import Predictor

    cfg = update_cfg(get_cfg_defaults(), str(
        Path(__file__).resolve().parents[1] / "configs"
        / "tiny_8_16_model2.yml"))
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.sampler = "ddim"
    cfg.sr.model.diffusion.ddim_steps = 4
    p = Predictor.from_config(cfg, init_seed=3, batch_size=2,
                              device="cuda")
    lr = np.random.RandomState(0).randint(0, 255, (3, 8, 8, 3), np.uint8)
    p.predict(lr)
    return p, lr


def _profiled_events(fn, activities, tmp_path) -> list:
    import json

    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / f"trace{len(list(tmp_path.iterdir()))}.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def test_spans_map_onto_the_trace_clock_within_50us(cuda, tmp_path):
    """The marker launches place the program's spans on the profiler's
    clock to within 50 µs; in a trace that records the host too, each
    span's own ``record_function`` range, opened just after the span's
    clock read, starts after the mapped start (less that error), by 50 µs
    at the median."""
    from torch.profiler import ProfilerActivity

    from sr3d_torch.utils import profiling

    p, lr = _traced_predictor()
    profiling.take_spans()
    events = _profiled_events(
        lambda: [p.predict(lr) for _ in range(3)],
        [ProfilerActivity.CPU, ProfilerActivity.CUDA], tmp_path)
    spans = profiling.take_spans()
    launches = profiling.marker_launches(events)
    assert len(launches) == 6                    # 3 requests, 2 markers
    offset, error = profiling.clock_offset(launches, spans)
    assert error <= 50.0
    lags = []
    for name in {s.name for s in spans}:
        mine = sorted(s.start_ns / 1e3 + offset for s in spans
                      if s.name == name)
        ranges = sorted(e["ts"] for e in events
                        if e.get("cat") == "user_annotation"
                        and e["name"] == name)
        assert len(mine) == len(ranges), name
        lags += [b - a for a, b in zip(mine, ranges)]
    assert min(lags) >= -error and sorted(lags)[len(lags) // 2] <= 50.0


def test_spans_add_no_synchronising_call(cuda, tmp_path, monkeypatch):
    """A request traced on the device alone makes as many synchronising
    API calls with its spans recorded as without."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity

    from sr3d_torch.utils import profiling

    def syncs(events):
        return sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and ("Synchronize" in e["name"]
                        or e["name"] == "cudaMemcpy") for e in events)

    p, lr = _traced_predictor()
    profiling.take_spans()
    on = _profiled_events(lambda: p.predict(lr), [ProfilerActivity.CUDA],
                          tmp_path)
    # the request, its prep and fetch, 2 chunks × 4 steps and UNet
    # forwards, 2 MICA branches
    assert len(profiling.take_spans()) == 21
    monkeypatch.setattr(profiling, "_prof",
                        SimpleNamespace(_is_profiler_enabled=False))
    off = _profiled_events(lambda: p.predict(lr), [ProfilerActivity.CUDA],
                           tmp_path)
    assert profiling.take_spans() == []
    assert syncs(on) == syncs(off) > 0


# -- the UNet forward as a CUDA graph (models/forward_graph.py) ----------

def _served_unet(config: str, int8: bool, cls=SR3UNet):
    """The UNet of ``configs/<config>`` as the serving CLI builds it (int8
    at its default, or ``--int8 0``), random weights, eval, on the card."""
    from pathlib import Path

    from sr3d_torch.config import get_cfg_defaults, update_cfg
    from sr3d_torch.models.layers import init_lecun_normal_
    from sr3d_torch.models.sr3_unet import unet_from_config
    from sr3d_torch.serve import apply_serving_flags

    cfg = apply_serving_flags(update_cfg(get_cfg_defaults(), str(
        Path(__file__).resolve().parents[1] / "configs" / config)),
        int8=None if int8 else 0)
    unet = unet_from_config(cfg.sr.model.unet, cfg.sr.model.diffusion,
                            cls=cls)
    init_lecun_normal_(unet, torch.Generator().manual_seed(0))
    return unet.eval().to("cuda")


def _unet_inputs(unet, B, res, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, unet.in_channel, res, res, generator=g)
    t = (torch.randint(0, 600, (B,), generator=g)
         if unet.time_name == "time_mlp" else torch.rand(B, 1, generator=g))
    return x.cuda(), t.cuda()


def _eager(unet, x, t, quant):
    return unet._forward(x, t, None, True, None, quant)


def _counted(fn):
    """``fn()``, the kernel wrappers' launches it made, and how the UNet
    forward ran."""
    def ran():
        return (SR3UNet.eager_calls, SR3UNet.graph_captures,
                SR3UNet.graph_replays)

    before = ran()
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = ran()
    mode = ("eager", "capture", "replay")[
        [a - b for a, b in zip(after, before)].index(1)]
    return out, launch_counts(), mode


@pytest.mark.parametrize("config,B,int8,cls", [
    ("sr_sr3_VGGF2_16_128_model3.yml", 8, True, "sr3"),
    ("sr_sr3_VGGF2_16_128_model3.yml", 8, False, "sr3"),
    ("sr_sr3_VGGF2_16_128_model3.yml", 32, True, "sr3"),
    ("sr_sr3_VGGF2_16_128_model3.yml", 32, False, "sr3"),
    ("sr_sr3_VGGF2_8_32_model3.yml", 8, True, "sr3"),
    ("sr_sr3_VGGF2_16_128_model3.yml", 8, True, "ddpm"),
])
def test_unet_graph_replays_the_eager_forward_bit_for_bit(cuda, config, B,
                                                         int8, cls):
    """A served UNet's forward: eager, then captured, then replayed on
    other inputs, each bit-equal to the eager ``_forward`` on its inputs;
    each call counts the eager forward's kernel launches; the capture and
    replays quantize no weight and recompute no cached value; a result is
    not changed by a later replay (no view of the graph's pool)."""
    from sr3d_torch.models.ddpm_unet import DDPMUNet
    from sr3d_torch.ops.quant import Versioned

    unet = _served_unet(config, int8, DDPMUNet if cls == "ddpm" else SR3UNet)
    res = 32 if "8_32" in config else 128
    caches = [v for m in unet.modules() for v in vars(m).values()
              if isinstance(v, Versioned)]
    inputs = [_unet_inputs(unet, B, res, seed) for seed in range(4)]
    outs, counts = [], []
    with torch.no_grad():
        want = [_eager(unet, x, t, int8) for x, t in inputs]
        for (x, t), mode in zip(inputs, ("eager", "capture", "replay",
                                         "replay")):
            if mode == "capture":
                quantizes = Int8Conv.weight_quantizes
                computes = [v.computes for v in caches]
            out, n, ran = _counted(lambda: unet(x, t, quant=int8))
            assert ran == mode
            outs.append(out)
            counts.append(n)
        assert Int8Conv.weight_quantizes == quantizes
        assert [v.computes for v in caches] == computes
    for out, w in zip(outs, want):
        assert out.dtype == w.dtype and torch.equal(out, w)
    assert all(c == counts[0] for c in counts), counts
    assert counts[0]["int8_conv"] == (58 if int8 else 0)
    assert unet._graphs.held() == 1


def test_predictor_request_with_graphs_equals_eager(cuda, monkeypatch):
    """A served request whose UNet forwards replay graphs gives the
    request served with every forward eager, bit for bit."""
    p, lr = _traced_predictor()
    replays = SR3UNet.graph_replays
    got = p.predict(lr)
    assert SR3UNet.graph_replays - replays == 8      # 2 chunks × 4 steps
    monkeypatch.setattr(SR3UNet, "_graph_key", lambda *a: None)
    want = p.predict(lr)
    assert SR3UNet.graph_replays - replays == 8
    for k in want:
        assert (got[k] == want[k]).all(), k


def test_unet_graph_recaptures_after_weight_changes(cuda, monkeypatch):
    """``load_state_dict`` and the EMA's weights under ``functional_call``
    each start the signature over: eager, captured, replayed, bit-equal
    to the eager forward of the weights in force; one graph held."""
    from torch.func import functional_call

    from sr3d_torch.models.layers import init_lecun_normal_

    def small(seed):
        torch.manual_seed(seed)
        u = SR3UNet(inner_channel=64, norm_groups=8, channel_mults=(1, 2),
                    attn_res=(8,), res_blocks=1, image_size=16,
                    quant_min_res=1, quant_resample=True)
        init_lecun_normal_(u, torch.Generator().manual_seed(seed))
        return u.eval().cuda()

    unet, x, t = small(0), *_unet_inputs(small(0), 8, 16, 1)
    ema = {k: v.detach() * 0.9 for k, v in small(1).named_parameters()}
    other = small(2).state_dict()

    def eager(call):
        with monkeypatch.context() as m:
            m.setattr(unet, "_graph_key", lambda *a: None)
            return call()

    plain = lambda: unet(x, t, quant=True)            # noqa: E731
    swapped = lambda: functional_call(unet, ema, (x, t),  # noqa: E731
                                      {"quant": True})
    with torch.no_grad():
        for call, change in ((plain, None),
                             (plain, lambda: unet.load_state_dict(other)),
                             (swapped, None), (plain, None)):
            if change:
                change()
            want = eager(call)
            modes = []
            for _ in range(3):
                out, _, mode = _counted(call)
                modes.append(mode)
                assert torch.equal(out, want)
            assert modes == ["eager", "capture", "replay"]
            assert unet._graphs.held() == 1


def test_unet_inside_an_outer_capture_runs_eagerly(cuda):
    """Inside another CUDA graph's capture (``chip_smoke.py``'s
    ``device_ms``) the forward runs eagerly, and the outer graph replays
    it."""
    unet = _served_unet("sr_sr3_VGGF2_8_32_model3.yml", True)
    x, t = _unet_inputs(unet, 8, 32, 0)
    with torch.no_grad():
        want = _eager(unet, x, t, True)
        for _ in range(3):                  # eager, capture, replay
            unet(x, t, quant=True)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        eager = SR3UNet.eager_calls
        with torch.cuda.graph(g):
            y = unet(x, t, quant=True)
        assert SR3UNet.eager_calls == eager + 1
        g.replay()
        torch.cuda.synchronize()
    assert torch.equal(y, want)


def test_replayed_forward_shows_every_kernel_in_a_device_trace(cuda,
                                                               tmp_path):
    """A device-only trace of the flagship int8 forward at B = 8: a
    replay runs as many kernels as the eager forward launches once its
    caches are full (459), from at most 4 launch calls (the copies in and
    out are memcpys); the capture, under the profiler, runs them too."""
    from torch.profiler import ProfilerActivity

    from sr3d_torch.utils import profiling

    unet = _served_unet("sr_sr3_VGGF2_16_128_model3.yml", True)
    x, t = _unet_inputs(unet, 8, 128, 0)

    def traced(fn):
        with torch.no_grad():
            ev = _profiled_events(fn, [ProfilerActivity.CUDA], tmp_path)
        return {"kernels": sum(e.get("ph") == "X" and e.get("cat") == "kernel"
                               and profiling.MARKER not in e["name"]
                               for e in ev),
                "launches": sum(
                    e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and ("LaunchKernel" in e["name"]
                         or "GraphLaunch" in e["name"]) for e in ev)}

    with torch.no_grad():
        unet(x, t, quant=True)              # eager: fills the caches
    eager = traced(lambda: _eager(unet, x, t, True))
    capture = traced(lambda: unet(x, t, quant=True))
    replay = traced(lambda: unet(x, t, quant=True))
    assert SR3UNet.graph_replays > 0 and unet._graphs.held() == 1
    # a kernel event of the eager forward may go missing from a trace, a
    # launch call does not
    assert replay["kernels"] == eager["launches"] >= 400, (eager, replay)
    # capture_begin's fills of the generator's graph state run besides
    assert capture["kernels"] >= replay["kernels"], (capture, replay)
    # the graph's launch and the span's two marker kernels
    assert replay["launches"] <= 4, replay


@pytest.mark.parametrize("config,B,res", [("sr3_16_128", 8, 128),
                                          ("sr3_8_32", 8, 32),
                                          ("sr3_64_512", 4, 512)])
def test_replay_holds_the_level_marks_its_levels_name(cuda, tmp_path,
                                                      config, B, res):
    """A device trace of one replay of a benchmark configuration's served
    UNet: its level marks are ``levels`` + 1 (4, around the two outer
    levels of the encoder and of the decoder), each segment between two
    holds kernels, every other kernel of the forward lies between the
    first and the last, and the replay is still one graph launch (with
    the span's two clock markers)."""
    import json
    from pathlib import Path

    from torch.profiler import ProfilerActivity

    from benchmark import spec
    from sr3d_torch.config import get_cfg_defaults
    from sr3d_torch.kernels.level_mark import LEVEL_MARK
    from sr3d_torch.models.layers import init_lecun_normal_
    from sr3d_torch.models.sr3_unet import level_labels, unet_from_config
    from sr3d_torch.utils import profiling

    conf = json.loads((Path(spec.HERE) / "configs"
                       / f"{config}.json").read_text())
    cfg = get_cfg_defaults()
    cfg.merge_from_other(spec.program_tree(
        conf, {"serve": {"steps": 25, "int8": None}}), strict=True)
    unet = unet_from_config(cfg.sr.model.unet, cfg.sr.model.diffusion)
    init_lecun_normal_(unet, torch.Generator().manual_seed(0))
    unet = unet.eval().cuda()
    x, t = _unet_inputs(unet, B, res, 0)
    with torch.no_grad():
        for _ in range(2):                  # eager, capture
            unet(x, t, quant=True)
        profiling.take_spans()
        ev = _profiled_events(lambda: unet(x, t, quant=True),
                              [ProfilerActivity.CUDA], tmp_path)
    spans = [s for s in profiling.take_spans() if s.name == "sr3d.unet"]
    assert [s.attrs["graph"] for s in spans] == ["replay"]
    levels = spans[0].attrs["levels"]
    assert levels == level_labels(unet.n_levels, res)
    assert len(levels) + 1 == 4
    kernels = sorted((e["ts"], e["name"]) for e in ev
                     if e.get("ph") == "X" and e.get("cat") == "kernel"
                     and profiling.MARKER not in e["name"])
    marks = [i for i, (_, n) in enumerate(kernels) if LEVEL_MARK in n]
    assert len(marks) == len(levels) + 1, len(marks)
    assert marks[0] == 0 and marks[-1] == len(kernels) - 1
    assert all(b - a > 1 for a, b in zip(marks, marks[1:])), marks
    launches = sum(e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and ("LaunchKernel" in e["name"]
                        or "GraphLaunch" in e["name"]) for e in ev)
    assert launches <= 4, launches
