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
    gn_plan,
    gn_stats_reference,
    gn_swish_reference,
)
from sr3d_torch.kernels.int8_conv import int8_conv_reference
from sr3d_torch.models.sr3_unet import SR3UNet

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
    (1, 257, 64),    # one key past the on-chip limit, a ragged tile
    (1, 300, 40),    # C not a multiple of the channel chunk
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
