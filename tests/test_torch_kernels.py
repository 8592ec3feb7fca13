"""The plain versions of the port's kernels held against the JAX package's
Pallas kernels, run in interpret mode on the CPU (the Pallas kernels'
own test recipe), on the same numpy inputs.  The CUDA kernels themselves
are held to these plain versions on the GPU by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sr3d_torch.kernels import gn_stats, gn_swish, spatial_attention
from sr3d_torch.kernels.attention import spatial_attention_backward
from sr3d_torch.kernels.conv3x3 import conv3x3
from sr3d_torch.kernels.fused_block import fused_gn_swish_conv3x3
from sr3d_tpu.kernels.attention import _attn_pallas, _attn_pallas_diff
from sr3d_tpu.kernels.groupnorm_swish import (
    _gn_stats_pallas,
    _gn_swish_pallas,
    groupnorm_swish_reference,
)

torch.set_num_threads(1)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape", [(2, 16, 8, 32), (1, 8, 8, 64)])
def test_gn_stats_matches_pallas(shape):
    """fp32 sums of the same values in another order: rtol 1e-4."""
    x = np.random.RandomState(3).randn(*shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        s_ref, q_ref = _gn_stats_pallas(jnp.asarray(x), row_tile=8)
    s, q = gn_stats(nchw(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_ref), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 32), 8),
                                          ((1, 16, 16, 64), 32)])
def test_gn_swish_matches_pallas(shape, groups):
    """fp32; the Pallas kernel's own tolerance against its reference."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    C = shape[-1]
    gamma = (rng.rand(C) + 0.5).astype(np.float32)
    beta = (rng.randn(C) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = _gn_swish_pallas(jnp.asarray(x), jnp.asarray(gamma),
                               jnp.asarray(beta), groups, 1e-5)
    out = gn_swish(nchw(x), torch.from_numpy(gamma), torch.from_numpy(beta),
                   groups)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=2e-5)


def test_gn_near_constant_large_mean_no_nan():
    """A constant bf16 map at large magnitude drives the one-pass group
    variance negative in fp32; the clamp keeps the output finite and equal
    to swish(β), as in the JAX reference."""
    C, G = 64, 32
    gamma = torch.ones(C)
    beta = torch.full((C,), 0.3)
    want = 0.3 / (1 + np.exp(-0.3))
    for c in (2285.4912, 1862.8314, 3861.9184):
        x = torch.full((1, C, 32, 32), c, dtype=torch.bfloat16)
        out = gn_swish(x, gamma, beta, G).float()
        assert torch.isfinite(out).all(), c
        ref = groupnorm_swish_reference(
            jnp.full((1, 32, 32, C), c, jnp.bfloat16),
            jnp.asarray(gamma.numpy()), jnp.asarray(beta.numpy()), G)
        np.testing.assert_allclose(float(out[0, 0, 0, 0]), want, atol=0.05)
        np.testing.assert_allclose(
            out.permute(0, 2, 3, 1).numpy(),
            np.asarray(ref.astype(jnp.float32)), atol=0.02)


def test_attention_matches_pallas():
    """HW=64, C=128 fp32, the Pallas kernel's own tolerance."""
    rng = np.random.RandomState(2)
    q, k, v = (rng.randn(2, 64, 128).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = _attn_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           1.0 / float(np.sqrt(128)))
    out = spatial_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_attention_scale_is_over_full_channels():
    """``channels`` sets the 1/sqrt(C) scale independently of the last
    dim (a single head spans all channels in the UNet)."""
    rng = np.random.RandomState(4)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, 8).astype(np.float32))
               for _ in range(3))
    a = spatial_attention(q, k, v, channels=32)
    b = torch.softmax(q @ k.transpose(1, 2) / np.sqrt(32), -1) @ v
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    x = torch.zeros(1, 8, 4, 4, device="meta")
    with pytest.raises(ValueError):
        gn_stats(x)
    with pytest.raises(ValueError):
        spatial_attention(*(torch.zeros(1, 4, 8, device="meta"),) * 3)
    xh, w = torch.zeros(1, 4, 4, 8, device="meta"), torch.zeros(3, 3, 8, 4)
    with pytest.raises(ValueError):
        conv3x3(xh, w)
    with pytest.raises(ValueError):
        fused_gn_swish_conv3x3(xh, torch.ones(8), torch.zeros(8), w,
                               torch.zeros(4), 4)


def test_attention_gradient_matches_pallas_vjp():
    """The backward the CUDA wrapper runs (``spatial_attention_backward``,
    the math of ``_attn_bwd``) and autograd of the CPU plain version,
    against ``jax.grad`` through ``_attn_pallas_diff`` in interpret mode:
    the shapes and tolerance (1e-4) of the JAX package's own test."""
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(2, 16, 32).astype(np.float32) for _ in range(3))
    scale = 1.0 / float(np.sqrt(32))

    def loss(q, k, v):
        return jnp.sum(_attn_pallas_diff(q, k, v, scale) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = spatial_attention(*ts)
    auto = torch.autograd.grad(out.square().sum(), ts)
    manual = spatial_attention_backward(*(t.detach() for t in ts),
                                        2 * out.detach(), scale)
    for r, a, m in zip(ref, auto, manual):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4)
        np.testing.assert_allclose(m.numpy(), np.asarray(r), atol=1e-4)


def test_gn_swish_gradient_matches_jax():
    """Autograd of the port's GN+Swish on the CPU (the plain version; the
    CUDA kernels' closed form is held to JAX in
    test_torch_gn_backward.py) against ``jax.grad`` of the JAX reference,
    fp32: x, γ, β within 1e-4 of each gradient's scale."""
    rng = np.random.RandomState(6)
    x = (rng.randn(2, 8, 8, 32) * 2 + 0.5).astype(np.float32)
    gamma = (rng.rand(32) + 0.5).astype(np.float32)
    beta = (rng.randn(32) * 0.1).astype(np.float32)
    gy = rng.randn(2, 8, 8, 32).astype(np.float32)

    def loss(x, g, b):
        return jnp.sum(groupnorm_swish_reference(x, g, b, 8) * gy)

    ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                 (x, gamma, beta)))
    ts = [nchw(x).requires_grad_(), torch.from_numpy(gamma).requires_grad_(),
          torch.from_numpy(beta).requires_grad_()]
    got = torch.autograd.grad(gn_swish(*ts, 8), ts, nchw(gy))
    got = (got[0].permute(0, 2, 3, 1), got[1], got[2])
    for r, g in zip(ref, got):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r,
                                   atol=1e-4 * np.abs(r).max())
