"""The plain versions of the port's conv kernels (TPU kernels 4 and 5) held
against the JAX package's Pallas kernels in interpret mode on the CPU, on
the same numpy inputs; the CUDA kernels are held to these plain versions on
the GPU by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sr3d_torch.kernels import conv3x3, fused_gn_swish_conv3x3, gn_stats
from sr3d_torch.kernels.conv3x3 import conv3x3_reference
from sr3d_torch.kernels.fused_block import (
    fused_block_reference,
    gn_affine_coeffs,
)
from sr3d_tpu.kernels import fused_block as jfb
from sr3d_tpu.kernels.conv3x3 import conv3x3_pallas
from sr3d_tpu.kernels.groupnorm_swish import _gn_stats_pallas

torch.set_num_threads(1)


def _block_inputs(B, H, W, C, O, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32),
            rng.uniform(0.5, 1.5, C).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32),
            (rng.randn(3, 3, C, O) * 0.05).astype(np.float32),
            (rng.randn(O) * 0.1).astype(np.float32))


@pytest.mark.parametrize("B,H,W,C,O,G", [(2, 16, 16, 64, 64, 8),
                                         (1, 8, 24, 32, 64, 8),
                                         (2, 16, 16, 128, 64, 32)])
def test_fused_block_matches_pallas(B, H, W, C, O, G):
    """fp32, the three shapes of the Pallas kernel's own test and its
    tolerance (1e-4): both sides sum 9·C products in their own order."""
    arrs = _block_inputs(B, H, W, C, O)
    ref = jfb.fused_gn_swish_conv3x3(*map(jnp.asarray, arrs), G,
                                     interpret=True)
    t = [torch.from_numpy(a) for a in arrs]
    np.testing.assert_allclose(fused_block_reference(*t, G).numpy(),
                               np.asarray(ref), atol=1e-4)
    # on a CPU tensor the public wrapper is the plain version
    np.testing.assert_array_equal(fused_gn_swish_conv3x3(*t, G).numpy(),
                                  fused_block_reference(*t, G).numpy())


def test_conv3x3_matches_pallas():
    """(2, 16, 8, 32) → 16, fp32, the Pallas kernel's test and tolerance."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 8, 32).astype(np.float32)
    w = (rng.randn(3, 3, 32, 16) * 0.1).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = conv3x3_pallas(jnp.asarray(x), jnp.asarray(w), row_tile=8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(conv3x3_reference(xt, wt).numpy(),
                               np.asarray(ref), atol=1e-4)
    np.testing.assert_array_equal(conv3x3(xt, wt).numpy(),
                                  conv3x3_reference(xt, wt).numpy())


def test_conv3x3_bias_and_bf16_rounding():
    """The bias is added in fp32 before the cast; bf16 inputs give a bf16
    output equal to the fp32 conv of the same (bf16) values, rounded."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 5, 7, 6).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 6, 40).astype(np.float32) * 0.2)
    b = torch.from_numpy(rng.randn(40).astype(np.float32))
    np.testing.assert_allclose(conv3x3_reference(x, w, b).numpy(),
                               (conv3x3_reference(x, w) + b).numpy(),
                               atol=1e-6)
    xb = x.to(torch.bfloat16)
    out = conv3x3_reference(xb, w, b)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 5, 7, 40)
    want = conv3x3_reference(xb.float(), w.to(torch.bfloat16).float(), b)
    np.testing.assert_array_equal(out.float().numpy(),
                                  want.to(torch.bfloat16).float().numpy())


def test_gn_affine_coeffs_match_jax():
    """The port's copy of the fold, from the NHWC statistics: fp32, 1e-6."""
    B, H, W, C, G = 2, 8, 8, 64, 8
    x, gamma, beta, _, _ = _block_inputs(B, H, W, C, 4, seed=2)
    x = x * 3 + 1.5
    with pltpu.force_tpu_interpret_mode():
        s_j, q_j = _gn_stats_pallas(jnp.asarray(x), row_tile=8)
    a_j, b_j = jfb.gn_affine_coeffs(s_j, q_j, jnp.asarray(gamma),
                                    jnp.asarray(beta), H * W * (C // G), G,
                                    1e-5)
    s, q = gn_stats(torch.from_numpy(x), channels_last=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=1e-5,
                               atol=1e-3)
    a, b = gn_affine_coeffs(s, q, torch.from_numpy(gamma),
                            torch.from_numpy(beta), float(H * W * (C // G)),
                            G, 1e-5)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_j), rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_j), rtol=1e-5,
                               atol=1e-6)
