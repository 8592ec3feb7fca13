"""The port's DDPM (discrete-t) UNet family and its diffusion functions
held against the JAX package on the CPU, fp32, at a tiny width: the UNet
and its time embedding, ``q_sample_discrete`` / ``p_losses_discrete``
with JAX's draws replayed, the three samplers with ``time_input="t"``,
``p_sample_loop``'s intermediate frames, ``define_g`` and
``init_weights_variant``'s distributions, and the weight bridge both ways.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.diffusion.schedules import make_schedule as t_schedule
from sr3d_torch.models import ddpm_unet as tdu
from sr3d_torch.models.networks import define_g as t_define_g
from sr3d_torch.models.networks import init_weights_variant
from sr3d_torch.models.sr3_unet import SR3UNet as TSR3
from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import (
    export_jax_params,
    flax_to_state_dict,
    load_jax_params,
    state_dict_to_flax,
)
from sr3d_tpu.diffusion import gaussian as jg
from sr3d_tpu.diffusion.schedules import make_schedule as j_schedule
from sr3d_tpu.models import ddpm_unet as jdu

torch.set_num_threads(1)

KW = dict(inner_channel=32, norm_groups=8, channel_mults=(1, 2),
          attn_res=(8,), res_blocks=1, image_size=16)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def nets():
    """The JAX DDPM UNet with its init, and the port's with the same
    weights through the bridge; a jitted JAX apply."""
    junet = jdu.DDPMUNet(**KW, dropout=0.0, dtype=jnp.float32)
    params = jax.jit(junet.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, 16, 16, 6)),
                                 jnp.zeros((1,), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    port = tdu.DDPMUNet(**KW, dtype=torch.float32).eval()
    port.load_state_dict(flax_to_state_dict(params))
    return junet, params, jax.jit(junet.apply), port


def _inputs(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return rng.uniform(-1, 1, (b, 16, 16, 6)).astype(np.float32)


def test_ddpm_unet_matches_jax(nets):
    _, params, apply, port = nets
    x = _inputs()
    t = np.array([3, 37], np.int32)
    ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t))
    np.testing.assert_allclose(nhwc(got), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("t", [0, 1, 17, 599])
def test_time_embedding_matches_jax(t):
    emb = jdu.TimeEmbedding(dim=32, dtype=jnp.float32)
    p = jax.tree.map(np.asarray, emb.init(jax.random.PRNGKey(1),
                                          jnp.zeros((1,), jnp.int32)))
    ts = np.array([t, t + 5], np.int32)
    ref = np.asarray(emb.apply(p, jnp.asarray(ts)))
    port = tdu.TimeEmbedding(32, torch.float32)
    port.load_state_dict(flax_to_state_dict(p))
    with torch.no_grad():
        got = port(torch.from_numpy(ts)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    assert not np.allclose(got[0], got[1])


def test_q_sample_discrete_matches_jax():
    sched_j = j_schedule("linear", 600, 1e-6, 1e-2)
    sched_t = t_schedule("linear", 600, 1e-6, 1e-2)
    rng = np.random.RandomState(2)
    x0 = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    eps = rng.randn(3, 8, 8, 3).astype(np.float32)
    t = np.array([0, 299, 599])
    ref = np.asarray(jg.q_sample_discrete(jnp.asarray(x0), jnp.asarray(t),
                                          sched_j, jnp.asarray(eps)))
    got = tg.q_sample_discrete(nchw(x0), torch.from_numpy(t), sched_t,
                               nchw(eps))
    np.testing.assert_allclose(nhwc(got), ref, atol=1e-6)


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_discrete_matches_jax(nets, loss_type):
    """JAX's split draws (t ~ U{0..T−1} per element, then the noise)
    replayed into the port: the sum to rtol 1e-5."""
    _, params, apply, port = nets
    sched_j = j_schedule("linear", 50, 1e-4, 2e-2)
    sched_t = t_schedule("linear", 50, 1e-4, 2e-2)
    rng = np.random.RandomState(3)
    hr = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    cond = rng.uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ref = jax.jit(lambda p, h, c: jg.p_losses_discrete(
        lambda x, tt: apply(p, x, tt), sched_j, h, c, key,
        loss_type=loss_type))(params, jnp.asarray(hr), jnp.asarray(cond))
    k_t, k_n = jax.random.split(key)
    t = np.array(jax.random.randint(k_t, (2,), 0, 50))
    noise = nchw(jax.random.normal(k_n, hr.shape, jnp.float32))
    with torch.no_grad():
        got = tg.p_losses_discrete(port, sched_t, nchw(hr), nchw(cond),
                                   t=torch.from_numpy(t), noise=noise,
                                   loss_type=loss_type)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    # the generator path draws t in [0, T) and runs
    with torch.no_grad():
        g = tg.p_losses_discrete(port, sched_t, nchw(hr), nchw(cond),
                                 generator=torch.Generator().manual_seed(0))
    assert math.isfinite(float(g))


def _denoiser(apply, params):
    return lambda x, t: apply(params, x, t)


def _ddim_noise(key, shape, n):
    k_init, k_loop = jax.random.split(key)
    zs = [jax.random.normal(k_init, shape, jnp.float32)]
    zs += [jax.random.normal(jax.random.fold_in(k_loop, n - 1 - k), shape,
                             jnp.float32) for k in range(n)]
    return [nchw(z) for z in zs]


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpm++"])
def test_samplers_with_integer_t_match_jax(nets, sampler):
    """Each sampler with ``time_input="t"`` (the UNet sees the integer
    step) from the same noise: 1e-4."""
    _, params, apply, port = nets
    T, S = 10, 5
    sched_j = j_schedule("linear", T, 1e-4, 5e-2)
    sched_t = t_schedule("linear", T, 1e-4, 5e-2)
    cond = np.random.RandomState(5).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(6)
    den = _denoiser(apply, params)
    if sampler == "ddpm":
        fixed = jax.random.normal(key, (T + 1, 2, 16, 16, 3), jnp.float32)
        ref = jax.jit(lambda c: jg.p_sample_loop(
            den, sched_j, c, key, time_input="t",
            fixed_noise=fixed).final)(jnp.asarray(cond))
        got = tg.p_sample_loop(port, sched_t, nchw(cond), time_input="t",
                               noise=[nchw(z) for z in fixed])
    elif sampler == "ddim":
        ref = jax.jit(lambda c: jg.ddim_sample_loop(
            den, sched_j, c, key, num_steps=S, eta=1.0, time_input="t",
            init="marginal"))(jnp.asarray(cond))
        got = tg.ddim_sample_loop(port, sched_t, nchw(cond), num_steps=S,
                                  eta=1.0, time_input="t", init="marginal",
                                  noise=_ddim_noise(key, cond.shape, S))
    else:
        ref = jax.jit(lambda c: jg.dpmpp_sample_loop(
            den, sched_j, c, key, num_steps=S, time_input="t",
            init="marginal"))(jnp.asarray(cond))
        got = tg.dpmpp_sample_loop(port, sched_t, nchw(cond), num_steps=S,
                                   time_input="t", init="marginal",
                                   noise=_ddim_noise(key, cond.shape, 0))
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-4)


def test_p_sample_loop_intermediates_match_jax(nets):
    """T = 50: sample_inter = 1 | 5 = 5, ten frames, slot 0 the final
    image, each slot the state after step t = 5·slot; values against JAX's
    trajectory."""
    _, params, apply, port = nets
    T = 50
    sched_j = j_schedule("linear", T, 1e-4, 5e-2)
    sched_t = t_schedule("linear", T, 1e-4, 5e-2)
    cond = np.random.RandomState(7).uniform(-1, 1, (1, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(8)
    fixed = jax.random.normal(key, (T + 1, 1, 16, 16, 3), jnp.float32)
    ref = jax.jit(lambda c: jg.p_sample_loop(
        _denoiser(apply, params), sched_j, c, key,
        time_input="t", fixed_noise=fixed, return_intermediates=True))(
            jnp.asarray(cond))
    out = tg.p_sample_loop(port, sched_t, nchw(cond), time_input="t",
                           noise=[nchw(z) for z in fixed],
                           return_intermediates=True)
    assert isinstance(out, tg.SampleOutput)
    assert out.intermediates.shape == (10, 1, 3, 16, 16)
    assert torch.equal(out.intermediates[0], out.final)
    got = out.intermediates.permute(0, 1, 3, 4, 2).numpy()
    np.testing.assert_allclose(got, np.asarray(ref.intermediates),
                               atol=1e-4)
    np.testing.assert_allclose(nhwc(out.final), np.asarray(ref.final),
                               atol=1e-4)


def test_p_sample_loop_intermediates_at_t600():
    """T = 600: sample_inter = 1 | 60 = 61 (a bitwise or, not 60), so
    ceil(600 / 61) = 10 frames; a zero denoiser, against JAX's frames."""
    T = 600
    sched_j = j_schedule("linear", T, 1e-6, 1e-2)
    sched_t = t_schedule("linear", T, 1e-6, 1e-2)
    key = jax.random.PRNGKey(9)
    fixed = jax.random.normal(key, (T + 1, 1, 2, 2, 3), jnp.float32)
    x = np.zeros((1, 2, 2, 3), np.float32)
    ref = jax.jit(lambda c: jg.p_sample_loop(
        lambda a, t: jnp.zeros_like(a[..., 3:]), sched_j, c, key,
        time_input="t", fixed_noise=fixed, return_intermediates=True))(
            jnp.asarray(x))
    out = tg.p_sample_loop(lambda a, t: torch.zeros_like(a[:, 3:]), sched_t,
                           nchw(x), time_input="t",
                           noise=[nchw(z) for z in fixed],
                           return_intermediates=True)
    assert (1 | (T // 10)) == 61
    assert ref.intermediates.shape[0] == out.intermediates.shape[0] == 10
    np.testing.assert_allclose(
        out.intermediates.permute(0, 1, 3, 4, 2).numpy(),
        np.asarray(ref.intermediates), atol=1e-5)


def test_define_g_selects_family_and_raises():
    cfg = t_defaults().sr.model
    cfg.unet.inner_channel = 16
    cfg.unet.norm_groups = 8
    cfg.unet.channel_multiplier = [1, 2]
    cfg.unet.attn_res = [8]
    cfg.unet.res_blocks = 1
    cfg.diffusion.image_size = 16
    m, ti = t_define_g(cfg, dtype=torch.float32)
    assert type(m) is TSR3 and ti == "gamma"
    cfg.which_model_G = "ddpm"
    m, ti = t_define_g(cfg, dtype=torch.float32, remat=True)
    assert type(m) is tdu.DDPMUNet and ti == "t" and m.remat
    assert m.dropout == float(cfg.unet.dropout)
    cfg.which_model_G = "nope"
    with pytest.raises(NotImplementedError, match="nope"):
        t_define_g(cfg)


@pytest.mark.parametrize("init_type", ["orthogonal", "kaiming", "normal"])
def test_init_weights_variant_statistics(init_type):
    """JAX's draws cannot be replayed in torch: the distributions are
    held instead.  Orthogonal kernels (in flax's [fan_in, fan_out]
    layout) have orthonormal rows or columns; kaiming draws have variance
    2·scale/fan_in; normal std 0.02·scale; biases are 0; norms keep their
    values."""
    net = tdu.DDPMUNet(**KW, dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in net.named_parameters()}
    scale = 1.5
    init_weights_variant(net, torch.Generator().manual_seed(0), init_type,
                         scale)
    flax = state_dict_to_flax(dict(net.named_parameters()))
    ks = []
    for n, p in net.named_parameters():
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "bias":
            assert not p.any(), n
        elif leaf == "weight" and p.dim() >= 2:
            assert not torch.equal(p, before[n]), n
            node = flax
            for part in n.split(".")[:-1]:
                node = node[part]
            k = node["kernel"].reshape(-1, node["kernel"].shape[-1])
            ks.append((n, k))
        else:
            assert torch.equal(p, before[n]), n
    for n, k in ks:
        fan_in = k.shape[0]
        if init_type == "orthogonal":
            gram = k.T @ k if k.shape[0] >= k.shape[1] else k @ k.T
            np.testing.assert_allclose(gram, scale ** 2 * np.eye(len(gram)),
                                       atol=1e-4, err_msg=n)
        elif k.size >= 16384:
            want = (2 * scale / fan_in) ** 0.5 if init_type == "kaiming" \
                else 0.02 * scale
            assert abs(k.std() / want - 1) < 0.05, (n, k.std(), want)
            assert abs(k.mean()) < 0.05 * want, n
    with pytest.raises(NotImplementedError):
        init_weights_variant(net, torch.Generator(), "xavier")


def test_bridge_round_trip(nets):
    """JAX tree → port → JAX tree bit for bit, and port weights exported
    to JAX give JAX the port's output."""
    junet, params, apply, _ = nets
    port = tdu.DDPMUNet(**KW, dtype=torch.float32).eval()
    port.load_state_dict(flax_to_state_dict(params))
    back = {"params": state_dict_to_flax(dict(port.named_parameters()))}
    a, b = jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    init_weights_variant(port, torch.Generator().manual_seed(1), "normal")
    exported = {"params": state_dict_to_flax(dict(port.named_parameters()))}
    x, t = _inputs(1), np.array([5, 0], np.int32)
    ref = np.asarray(apply(exported, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = port(nchw(x), torch.from_numpy(t))
    np.testing.assert_allclose(nhwc(got), ref, atol=1e-5, rtol=1e-5)


def test_joint_modules_take_the_ddpm_family():
    """``which_model_G: ddpm`` reaches ``build_joint``: a DDPM UNet with
    the integer time input, whose weights go through the joint bridge and
    whose val step samples with ``time_input="t"``."""
    from sr3d_torch.config import update_cfg
    from pathlib import Path

    cfg = update_cfg(t_defaults(), str(Path(__file__).resolve().parents[1]
                                       / "configs" / "tiny_8_16_model2.yml"))
    cfg.sr.model.which_model_G = "ddpm"
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.mica.model.synthetic_flame_kind = "sphere"
    cfg.sr.model.diffusion.sampler = "ddim"
    cfg.sr.model.diffusion.ddim_steps = 2
    mods = tj.build_joint(cfg, device="cpu", init_seed=0)
    assert type(mods.unet) is tdu.DDPMUNet and mods.time_input == "t"
    tree = export_jax_params(mods)
    assert "time_mlp" in tree["sr"]["params"]
    assert "mlp" in tree["sr"]["params"]["down_0_0"]["res_block"]
    other = tj.build_joint(cfg, device="cpu", init_seed=1)
    load_jax_params(other, tree)
    for (n, p), (_, q) in zip(mods.unet.named_parameters(),
                              other.unet.named_parameters()):
        assert torch.equal(p, q), n
    seen = []
    hook = mods.unet.time_mlp.register_forward_pre_hook(
        lambda _m, args: seen.append(args[0]))
    out = tj.make_val_step()(
        mods, {"SR": torch.zeros(1, 16, 16, 3)},
        generator=torch.Generator().manual_seed(0))
    hook.remove()
    assert out["sr"].shape == (1, 16, 16, 3)
    assert [s.dtype for s in seen] == [torch.long] * 2
    assert [int(s[0]) for s in seen] == [19, 0]
