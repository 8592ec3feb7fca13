"""The port's SR3 UNet and samplers held against the JAX package on the
CPU: the same weights (through the weight bridge), inputs and noise, made
with numpy from a seed or by replaying JAX's random streams."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.diffusion.schedules import make_schedule as t_make_schedule
from sr3d_torch.models.sr3_unet import SR3UNet as TorchUNet
from sr3d_torch.utils.bridge import flax_to_state_dict
from sr3d_tpu.diffusion import gaussian as jg

torch.set_num_threads(1)

# fp32 on both sides; the two frameworks sum convolutions and GroupNorm
# moments in different orders, ~1e-6 per layer through ~10 layers.
ATOL_UNET = 1e-4


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def unets(tiny_unet):
    """The conftest tiny UNet (attention at attn_res 8 and at the mid
    block) with its JAX weights bridged into the port."""
    unet, params = tiny_unet
    # perturb the GN/bias params away from their 1/0 init so the bridge's
    # handling of every leaf is exercised
    rng = np.random.RandomState(5)
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)
    port = TorchUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                     attn_res=(8,), res_blocks=1, image_size=16,
                     dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(params))
    attn = sorted(n for n, _ in port.named_modules() if n.endswith("attn"))
    assert attn == ["down_1_0.attn", "mid_0.attn", "up_1_0.attn",
                    "up_1_1.attn"]
    return unet, params, port.eval()


def test_unet_forward_matches_jax(unets):
    unet, params, port = unets
    rng = np.random.RandomState(0)
    x = rng.randn(2, 16, 16, 6).astype(np.float32)
    t = rng.rand(2, 1).astype(np.float32)
    ref = np.asarray(jax.jit(unet.apply)(params, jnp.asarray(x),
                                         jnp.asarray(t)))
    with torch.no_grad():
        out = nhwc(port(nchw(x), torch.from_numpy(t)))
    np.testing.assert_allclose(out, ref, atol=ATOL_UNET)


def test_unet_attention_above_256_tokens_matches_jax(monkeypatch):
    """An attention level past the 256 tokens ``attn_mma_kernel`` holds:
    the gate of ``image_size=16, attn_res=(16,)`` over 32² inputs attends
    over 32² = 1024 tokens at the first level (the plan's long path on the
    card) and over 256 at the mid block; fp32 against JAX."""
    from sr3d_tpu.models.sr3_unet import SR3UNet as JaxUNet

    kw = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
              attn_res=(16,), res_blocks=1, image_size=16)
    unet = JaxUNet(**kw, dropout=0.0, dtype=jnp.float32)
    rng = np.random.RandomState(11)
    x = rng.randn(1, 32, 32, 6).astype(np.float32)
    t = rng.rand(1, 1).astype(np.float32)
    params = unet.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(t))
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.randn(*a.shape).astype(np.float32)
        * 0.05, params)
    port = TorchUNet(**kw, dtype=torch.float32)
    port.load_state_dict(flax_to_state_dict(params))
    port.eval()
    attn = sorted(n for n, _ in port.named_modules() if n.endswith("attn"))
    assert attn == ["down_0_0.attn", "mid_0.attn", "up_0_0.attn",
                    "up_0_1.attn"]
    import sr3d_torch.models.sr3_unet as unet_mod

    tokens = []
    attend = unet_mod.spatial_attention

    def recorded(q, k, v, channels=None):
        tokens.append(q.shape[1])
        return attend(q, k, v, channels)

    monkeypatch.setattr(unet_mod, "spatial_attention", recorded)
    ref = np.asarray(jax.jit(unet.apply)(params, jnp.asarray(x),
                                         jnp.asarray(t)))
    with torch.no_grad():
        out = nhwc(port(nchw(x), torch.from_numpy(t)))
    assert sorted(tokens) == [256, 1024, 1024, 1024]
    np.testing.assert_allclose(out, ref, atol=ATOL_UNET)


def test_unet_rejects_int8_config(unets):
    """An int8 config (quant_min_res 1, resampling on) builds: the same
    parameters as the fp UNet, so its weights load unchanged; ``quant``
    is a call-time switch (False: the fp forward bit for bit; True: the
    int8 convs engage).  The int8 forward against JAX:
    tests/test_torch_quant.py."""
    _, params, port = unets
    q = TorchUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                  attn_res=(8,), res_blocks=1, image_size=16,
                  dtype=torch.float32, quant_min_res=1,
                  quant_resample=True)
    q.load_state_dict(flax_to_state_dict(params))
    q.eval()
    assert (q.quant_min_res, q.quant_resample) == (1, True)
    rng = np.random.RandomState(4)
    x = nchw(rng.randn(1, 16, 16, 6))
    t = torch.from_numpy(rng.rand(1, 1).astype(np.float32))
    with torch.no_grad():
        fp = port(x, t)
        assert torch.equal(q(x, t), fp)
        assert not torch.equal(q(x, t, quant=True), fp)


@pytest.mark.parametrize("T,S", [(20, 8), (600, 25), (1000, 50), (7, 7)])
def test_strided_taus_match_jax(T, S):
    np.testing.assert_array_equal(tg._strided_taus(T, S),
                                  np.asarray(jg._strided_taus(T, S)))


def _replayed_noise(rng_key, shape, order):
    """JAX's sampler noise: split(rng) → (k_init, k_loop); the initial draw
    from k_init, loop iteration k from fold_in(k_loop, order[k])."""
    k_init, k_loop = jax.random.split(rng_key)
    draws = [jax.random.normal(k_init, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(k_loop, int(i)), shape,
                                jnp.float32) for i in order]
    return [nchw(d) for d in draws]


# Sampler tolerance: the per-step UNet error (~1e-6) passes through the
# x̂₀ = √(1/ᾱ)x − √(1/ᾱ−1)ε̂ map, whose coefficients reach ~6 at t≈0 of
# this 20-step schedule, and accumulates over the loop.
ATOL_SAMPLE = 1e-4


@pytest.mark.parametrize("init", ["noise", "marginal"])
def test_p_sample_loop_matches_jax(unets, tiny_schedule, init):
    unet, params, port = unets
    T = tiny_schedule.num_timesteps
    cond = np.random.RandomState(1).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = jg.p_sample_loop(lambda x, t: unet.apply(params, x, t),
                           tiny_schedule, jnp.asarray(cond), key,
                           init=init).final
    out = tg.p_sample_loop(port, t_make_schedule("linear", T, 1e-4, 2e-2),
                           nchw(cond), init=init,
                           noise=_replayed_noise(key, cond.shape, range(T)))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL_SAMPLE)


def test_ddim_sample_loop_matches_jax(unets, tiny_schedule):
    """The serving recipe at small size: η=1, marginal init."""
    unet, params, port = unets
    S = 8
    cond = np.random.RandomState(2).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jg.ddim_sample_loop(lambda x, t: unet.apply(params, x, t),
                              tiny_schedule, jnp.asarray(cond), key,
                              num_steps=S, eta=1.0, init="marginal")
    noise = _replayed_noise(key, cond.shape, range(S - 1, -1, -1))
    out = tg.ddim_sample_loop(
        port, t_make_schedule("linear", 20, 1e-4, 2e-2), nchw(cond),
        num_steps=S, eta=1.0, init="marginal", noise=noise)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=ATOL_SAMPLE)


def test_sampler_needs_a_noise_source(unets):
    _, _, port = unets
    with pytest.raises(ValueError):
        tg.ddim_sample_loop(port, t_make_schedule("linear", 4),
                            torch.zeros(1, 3, 16, 16), num_steps=2)
    with pytest.raises(ValueError):
        tg.p_sample_loop(port, t_make_schedule("linear", 4),
                         torch.zeros(1, 3, 16, 16), init="bogus",
                         generator=torch.Generator().manual_seed(0))
