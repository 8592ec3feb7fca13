"""The port's model2 train step held against the JAX package on the CPU, at
the tiny config of ``tests/test_joint.py`` (copied here): the diffusion
loss and its draws, one whole train step for the ddpm and the ddim
hand-off (losses, every gradient leaf, the parameters after the step,
ArcFace's BatchNorm statistics; at the configs' dropout too, which the JAX
step does not draw), the optimizer across a StepLR transition, the EMA,
the vertex loss and its weights, and the UNet's train mode (remat;
dropout only with ``deterministic=False``).  Weights go through
``sr3d_torch/utils/bridge.py``; JAX's random draws are replayed into the
port."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.data.synthetic import synthetic_face_batch
from sr3d_torch.diffusion import ema as t_ema
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.diffusion.schedules import make_schedule as t_schedule
from sr3d_torch.models import masking as t_masking
from sr3d_torch.models.sr3_unet import SR3UNet, apply_dropout
from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import (
    export_jax_params,
    flax_to_state_dict,
    load_jax_ema,
    load_jax_params,
    state_dict_to_flax,
)
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.data.synthetic import synthetic_face_batch as j_faces
from sr3d_tpu.diffusion import ema as j_ema
from sr3d_tpu.diffusion import gaussian as jg
from sr3d_tpu.diffusion.schedules import make_schedule as j_schedule
from sr3d_tpu.models import masking as j_masking
from sr3d_tpu.train import joint as jj

torch.set_num_threads(1)


def tiny_cfg(cfg, sampler="ddpm"):
    """``tests/test_joint.py::tiny_cfg`` (model2) on either package's
    defaults, with the hand-off sampler chosen."""
    cfg.model = "model2"
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.sample_remat = False
    cfg.tpu.train_remat = False
    cfg.sr.model.unet.inner_channel = 16
    cfg.sr.model.unet.norm_groups = 8
    cfg.sr.model.unet.channel_multiplier = [1, 2]
    cfg.sr.model.unet.attn_res = [8]
    cfg.sr.model.unet.res_blocks = 1
    cfg.sr.model.unet.dropout = 0.0
    cfg.sr.model.diffusion.image_size = 16
    for ph in ("train", "val"):
        cfg.sr.model.beta_schedule[ph].n_timestep = 8
        cfg.sr.model.beta_schedule[ph].linear_start = 1e-4
        cfg.sr.model.beta_schedule[ph].linear_end = 5e-2
    cfg.mica.model.n_shape = 16
    cfg.mica.model.n_exp = 8
    cfg.mica.model.map_hidden_dim = 32
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.train_sampler = sampler
    cfg.sr.model.diffusion.train_ddim_steps = 4
    return cfg


EMA_CFG = {"ema_decay": 0.9999, "step_start_ema": 5000,
           "update_ema_every": 1}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def batch_of(n=2, hr=16, n_shape=16, seed=0):
    rng = np.random.RandomState(seed)
    return {"HR": rng.uniform(-1, 1, (n, hr, hr, 3)).astype(np.float32),
            "SR": rng.uniform(-1, 1, (n, hr, hr, 3)).astype(np.float32),
            "flame_shape": (rng.randn(n, n_shape) * 0.3).astype(np.float32)}


def replayed_draws(key, shape, T, order):
    """JAX's draws inside ``make_train_step``'s loss for ``key``: l_sr's
    (t, u, noise) and the hand-off sampler's noise list, in the port's
    NCHW layout."""
    k_loss, k_sample = jax.random.split(key)
    k_g, k_n = jax.random.split(k_loss)
    k_t, k_u = jax.random.split(k_g)
    t = int(jax.random.randint(k_t, (), 1, T + 1))
    u = np.array(jax.random.uniform(k_u, (shape[0],)))
    noise = nchw(jax.random.normal(k_n, shape, jnp.float32))
    k_init, k_loop = jax.random.split(k_sample)
    hand = [jax.random.normal(k_init, shape, jnp.float32)]
    hand += [jax.random.normal(jax.random.fold_in(k_loop, int(i)), shape,
                               jnp.float32) for i in order]
    return t, torch.from_numpy(u), noise, [nchw(h) for h in hand]


def assert_leaf_close(got, ref, rel, name):
    """Gradient leaf ``got`` within ``rel`` of ``ref``'s largest entry
    (floor 1e-6, for leaves whose true gradient is 0: bn2's bias sits ahead
    of fc and the batch-statistics "features" BatchNorm and holds rounding
    noise only).  Kinks make single elements jump where an input sits at
    the rounding level: a PReLU input at 0 (slope 1 or α), a vertex
    difference at 0 (L1's sign).  At most 1% of a leaf's elements may
    exceed the bound, and none by more than a tenth of the scale."""
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    bad = err > rel * scale + 1e-6
    assert float(bad.float().mean()) <= 0.01 and \
        float(err.max()) <= 0.1 * scale + 1e-6, (
            f"{name}: {int(bad.sum())}/{bad.numel()} beyond {rel} of "
            f"{scale:.3g}, max {float(err.max()):.3g}")


# --------------------------------------------------------------------------
# diffusion loss and draws
# --------------------------------------------------------------------------

def test_sample_continuous_gamma_replays_jax():
    sched_j = j_schedule("linear", 600, 1e-6, 1e-2)
    sched_t = t_schedule("linear", 600, 1e-6, 1e-2)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        t_ref, g_ref = jg.sample_continuous_gamma(key, sched_j, 4)
        k_t, k_u = jax.random.split(key)
        t, g = tg.sample_continuous_gamma(
            sched_t, 4, t=torch.tensor(int(jax.random.randint(k_t, (), 1,
                                                              601))),
            u=torch.from_numpy(np.array(jax.random.uniform(k_u, (4,)))))
        np.testing.assert_array_equal(t.numpy(), np.asarray(t_ref))
        np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), atol=1e-7)
    t, g = tg.sample_continuous_gamma(
        sched_t, 64, generator=torch.Generator().manual_seed(0))
    assert (t == t[0]).all() and 1 <= int(t[0]) <= 600
    lo = sched_t.sqrt_alphas_cumprod_prev[int(t[0]) - 1]
    hi = sched_t.sqrt_alphas_cumprod_prev[int(t[0])]
    assert ((g >= min(lo, hi)) & (g <= max(lo, hi))).all()


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
def test_p_losses_continuous_matches_jax(jax_params, loss_type):
    """The tiny model's UNet, fp32, JAX's split draws replayed: the sum
    over 1536 elements to rtol 1e-5."""
    unet = jj.build_joint(tiny_cfg(get_cfg_defaults())).unet
    params = jax_params.params["sr"]
    sched_j = j_schedule("linear", 20, 1e-4, 2e-2)
    sched_t = t_schedule("linear", 20, 1e-4, 2e-2)
    b = batch_of()
    key = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p, hr, cond: jg.p_losses_continuous(
        lambda x, t: unet.apply(p, x, t), sched_j, hr, cond, key,
        loss_type=loss_type))(params, jnp.asarray(b["HR"]),
                              jnp.asarray(b["SR"]))
    port = SR3UNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.float32).eval()
    port.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                         params)))
    k_g, k_n = jax.random.split(key)
    k_t, k_u = jax.random.split(k_g)
    _, gamma = tg.sample_continuous_gamma(
        sched_t, 2, t=torch.tensor(int(jax.random.randint(k_t, (), 1, 21))),
        u=torch.from_numpy(np.array(jax.random.uniform(k_u, (2,)))))
    with torch.no_grad():
        got = tg.p_losses_continuous(
            port, sched_t, nchw(b["HR"]), nchw(b["SR"]), gamma=gamma,
            noise=nchw(jax.random.normal(k_n, (2, 16, 16, 3))),
            loss_type=loss_type)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# --------------------------------------------------------------------------
# one whole model2 train step
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    """A JAX train state of the tiny model (``init_train_state``'s layout,
    with jitted initialisers), ArcFace's BatchNorm statistics moved off
    their 0/1 init."""
    mods = jj.build_joint(tiny_cfg(get_cfg_defaults()))
    k_sr, k_af, k_map = jax.random.split(jax.random.PRNGKey(0), 3)
    af = jax.jit(mods.arcface.init)(k_af, jnp.zeros((1, 112, 112, 3)))
    params = {
        "sr": jax.jit(mods.unet.init)(k_sr, jnp.zeros((1, 16, 16, 6)),
                                      jnp.zeros((1, 1))),
        "arcface": af["params"],
        "mapping": jax.jit(mods.mapping.init)(k_map, jnp.zeros((1, 512))),
    }
    rng = np.random.RandomState(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                      if p[-1].key == "var" else
                      np.asarray(a) + rng.randn(*a.shape) * 0.1
                      ).astype(np.float32), af["batch_stats"])
    return jj.JointTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              arcface_stats=stats, opt_state=None,
                              ema=j_ema.ema_init(params["sr"]))


def _port_modules(tcfg, state):
    """The port's modules with the JAX state's weights and statistics."""
    tmods = tj.build_joint(tcfg, device="cpu")
    load_jax_params(tmods, jax.tree.map(np.asarray, {
        "sr": state.params["sr"], "arcface": state.params["arcface"],
        "arcface_stats": state.arcface_stats,
        "mapping": state.params["mapping"]}))
    return tmods


def _grab_grads():
    """An optax transformation whose state is the last gradient and whose
    update is zero: the JAX train step then hands its gradients back."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@pytest.mark.parametrize("sampler,dropout", [
    pytest.param("ddpm", 0.0, id="ddpm"),
    pytest.param("ddim", 0.0, id="ddim"),
    # the configs' dropout: the JAX step's UNet is deterministic (flax's
    # default), so the port's step must draw no dropout mask either
    pytest.param("ddim", 0.2, id="ddim-0.2"),
])
def test_train_step_matches_jax(jax_params, sampler, dropout):
    cfg = tiny_cfg(get_cfg_defaults(), sampler)
    cfg.sr.model.unet.dropout = dropout
    jmods = jj.build_joint(cfg)
    state = jax_params
    # N = 4, the flagship's K×B: at N = 2 the batch-statistics "features"
    # BatchNorm sees two samples, and its one-pass variance turns the two
    # frameworks' last-ulp differences into 1e-3 gradient differences
    b = batch_of(n=4)
    key = jax.random.PRNGKey(11)
    grab = _grab_grads()
    new_j, met_j = jax.jit(jj.make_train_step(grab, EMA_CFG))(
        jmods, state._replace(opt_state=grab.init(state.params)),
        jax.tree.map(jnp.asarray, b), key)
    grads_j = new_j.opt_state
    opt = jj.make_optimizer(cfg)
    params_j = jax.jit(lambda g, p: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(grads_j, state.params)

    tcfg = tiny_cfg(t_defaults(), sampler)
    tcfg.sr.model.unet.dropout = dropout
    tmods = _port_modules(tcfg, state)
    assert tmods.unet.dropout == dropout
    tstate = tj.init_train_state(tmods, tcfg)
    T = tmods.sched_train.num_timesteps
    order = range(T) if sampler == "ddpm" else range(3, -1, -1)
    t, u, noise, hand = replayed_draws(key, (4, 16, 16, 3), T, order)
    _, gamma = tg.sample_continuous_gamma(tmods.sched_train, 4,
                                          t=torch.tensor(t), u=u)
    tstate, met = tj.make_train_step(EMA_CFG)(
        tmods, tstate, {k: torch.from_numpy(v) for k, v in b.items()},
        draws={"gamma": gamma, "noise": noise, "handoff": hand})

    assert tstate.step == 1 and tstate.ema.step == 1
    # l_sr: the fp32 UNet sums in another order (tests/test_torch_unet.py),
    # 1e-5; l_mica follows the hand-off sample through the uint8 image,
    # ArcFace and the mapping: 1e-4, the tolerance the serving test holds
    # the MICA outputs to (tests/test_torch_serve.py)
    np.testing.assert_allclose(float(met["l_sr"]), float(met_j["l_sr"]),
                               rtol=1e-5)
    for k in ("l_mica", "loss"):
        np.testing.assert_allclose(float(met[k]), float(met_j[k]),
                                   rtol=1e-4, err_msg=k)
    # UNet gradients (l_sr) within 1e-4 of each leaf's largest entry.  The
    # MICA branch sees the uint8 hand-off image, where ~0.2% of the values
    # sit on a rounding tie and land one level apart between the two
    # frameworks (the sums before the rounding differ in the last ulp);
    # that moves the embedding by ~4e-3, so its gradients are held to 5e-2
    # here and to 1e-4 on one shared image in
    # test_mica_branch_matches_jax.  The frozen ArcFace parameters have no
    # gradient in the port (requires_grad off).
    nets = {"sr": tmods.unet, "arcface": tmods.arcface,
            "mapping": tmods.mapping}
    trainable = tj.frozen_prefix_mask(tmods.arcface)
    for part, net in nets.items():
        named = dict(net.named_parameters())
        ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_j[part]))
        assert set(ref) == set(named), part
        for n, g_ref in ref.items():
            grad = named[n].grad
            if part == "arcface" and not trainable[n]:
                assert grad is None, n
                continue
            assert_leaf_close(grad, g_ref, 1e-4 if part == "sr" else 5e-2,
                              f"{part}.{n}")
    # parameters after the step: Adam's first update is ~lr·sign(g), so
    # an element whose gradient sits at the rounding level may move the
    # other way (by 2·lr at most; bn2's bias, whose gradient is noise,
    # moves at random); in each network 99% of the elements agree to 1e-6
    got = export_jax_params(tmods)
    lrs = {g["name"]: g["lr"] for g in tstate.opt.param_groups}
    for part in nets:
        ref = flax_to_state_dict(jax.tree.map(np.asarray, params_j[part]))
        mine = flax_to_state_dict(got[part])
        off = total = 0
        for n, p_ref in ref.items():
            d = (mine[n] - p_ref).abs()
            assert float(d.max()) <= 2 * lrs[part] + 1e-6, f"{part}.{n}"
            off, total = off + int((d > 1e-6).sum()), total + d.numel()
        assert off <= 0.01 * total, f"{part}: {off} of {total} moved apart"
    # ArcFace's running statistics after the step follow the hand-off
    # image, like the MICA gradients: 1e-2 (1e-5 on a shared image below)
    stats_ref = flax_to_state_dict(jax.tree.map(np.asarray,
                                                new_j.arcface_stats))
    stats = flax_to_state_dict(got["arcface_stats"])
    assert set(stats) == set(stats_ref)
    for n, s_ref in stats_ref.items():
        np.testing.assert_allclose(stats[n].numpy(), s_ref.numpy(),
                                   rtol=1e-2, atol=1e-4, err_msg=n)
    # the EMA is still in its warm-up: a copy of the new UNet parameters
    for n, p in tmods.unet.named_parameters():
        assert torch.equal(tstate.ema.params[n], p.detach()), n


def test_mica_branch_matches_jax(jax_params):
    """ArcFace in train mode (batch statistics, frozen prefix on running
    ones) → L2-normalise → mapping → FLAME → masked vertex L1, on one
    shared uint8-valued image, N = 4, fp32: l_mica to 1e-5, every gradient
    leaf to 1e-4 of its largest entry (``assert_leaf_close``), the new
    running statistics to 1e-5."""
    state = jax_params
    cfg = tiny_cfg(get_cfg_defaults())
    cfg.mica.train.use_mask = True
    jmods = jj.build_joint(cfg)
    rng = np.random.RandomState(3)
    blob = ((rng.randint(0, 256, (4, 112, 112, 3)) - 127.5) / 127.5
            ).astype(np.float32)
    shape = (rng.randn(4, 16) * 0.3).astype(np.float32)

    def loss(params):
        emb, stats = jj.encode_mica(jmods, params, state.arcface_stats,
                                    jnp.asarray(blob), train=True)
        pred, _ = jj.decode_mica(jmods, params, emb)
        gt = jj.gt_flame_vertices(jmods, jnp.asarray(shape))
        return j_masking.masked_vertex_l1(pred, gt,
                                          jmods.vertex_weights), stats

    (l_ref, stats_ref), g_ref = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(state.params)

    tcfg = tiny_cfg(t_defaults())
    tcfg.mica.train.use_mask = True
    tmods = _port_modules(tcfg, state)
    tj.init_train_state(tmods, tcfg)
    tmods.arcface.train()
    pred, _ = tj.decode_mica(tmods, tj.encode_mica(tmods,
                                                   torch.from_numpy(blob)))
    l_mica = t_masking.masked_vertex_l1(
        pred, tj.gt_flame_vertices(tmods, torch.from_numpy(shape)),
        tmods.vertex_weights)
    l_mica.backward()
    np.testing.assert_allclose(l_mica.item(), float(l_ref), rtol=1e-5)
    for part, net in (("arcface", tmods.arcface),
                      ("mapping", tmods.mapping)):
        ref = flax_to_state_dict(jax.tree.map(np.asarray, g_ref[part]))
        for n, p in net.named_parameters():
            if p.grad is None:
                assert not tj.frozen_prefix_mask(tmods.arcface)[n]
                continue
            assert_leaf_close(p.grad, ref[n], 1e-4, f"{part}.{n}")
    stats = flax_to_state_dict(export_jax_params(tmods)["arcface_stats"])
    for n, s_ref in flax_to_state_dict(jax.tree.map(
            np.asarray, stats_ref)).items():
        np.testing.assert_allclose(stats[n].numpy(), s_ref.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_scale_handoff_grad():
    x = torch.randn(3, 4, requires_grad=True)
    for s_ in (1.0, 0.25, 0.0):
        y = tj.scale_handoff_grad(x, s_)
        assert torch.equal(y, x)
        (g,) = torch.autograd.grad(y.sum(), x)
        np.testing.assert_allclose(g.numpy(), s_, rtol=1e-6)


def test_train_step_refuses_unported_paths():
    """The int8 hand-off (``train_handoff_int8``) refuses what the JAX
    package refuses, with its ValueErrors: a flow-through (model3)
    hand-off, in the train step, whatever quant_min_res; otherwise
    quant_min_res 0, in the train and eval steps.  An int8 UNet config
    builds."""
    b = {k: torch.from_numpy(v) for k, v in batch_of().items()}
    gen = torch.Generator().manual_seed(0)
    for variant in ("model2", "model3"):
        for qmr in (0, 1):
            cfg = tiny_cfg(t_defaults())
            cfg.model = variant
            cfg.sr.model.diffusion.train_handoff_int8 = True
            cfg.sr.model.unet.quant_min_res = qmr
            mods = tj.build_joint(cfg, device="cpu")
            assert mods.unet.quant_min_res == qmr
            if variant == "model3":
                with pytest.raises(ValueError, match="gradient-severed"):
                    tj.make_train_step()(mods, tj.init_train_state(mods, cfg),
                                         b, generator=gen)
            if qmr == 0:
                with pytest.raises(ValueError, match="quant_min_res is 0"):
                    tj.make_eval_step()(mods, b, generator=gen)
                if variant == "model2":
                    with pytest.raises(ValueError,
                                       match="quant_min_res is 0"):
                        tj.make_train_step()(
                            mods, tj.init_train_state(mods, cfg), b,
                            generator=gen)


def test_build_joint_fields_match_jax():
    cfg, tcfg = (tiny_cfg(c, "ddim") for c in (get_cfg_defaults(),
                                                t_defaults()))
    for c in (cfg, tcfg):
        c.mica.train.use_mask = True
        c.train.handoff_source = "cond"
        c.tpu.sample_remat, c.tpu.sample_remat_chunk = True, 5
        c.sr.model.diffusion.dpmpp_eta = 0.5
    j, t = jj.build_joint(cfg), tj.build_joint(tcfg, device="cpu")
    for f in ("variant", "sever_sr_grad", "loss_type", "train_sampler",
              "train_ddim_steps", "handoff_source", "handoff_grad_scale",
              "train_arcface_prefix", "train_handoff_int8", "sample_remat",
              "sample_remat_chunk", "dpmpp_eta", "val_sampler",
              "ddim_steps", "ddim_eta", "sampler_init"):
        assert getattr(t, f) == getattr(j, f), f
    np.testing.assert_array_equal(t.vertex_weights.numpy(),
                                  np.asarray(j.vertex_weights))
    assert len(np.unique(t.vertex_weights.numpy())) > 2
    np.testing.assert_array_equal(t.sched_train.alphas_cumprod,
                                  np.asarray(j.sched_train.alphas_cumprod))


def test_build_joint_weights_follow_init_seed_only():
    """``init_seed`` alone decides the random weights: not the global RNG's
    state (seeded anew in every process), which construction leaves as it
    was."""
    cfg = tiny_cfg(t_defaults())
    sds = []
    for global_seed in (1, 2):
        torch.manual_seed(global_seed)
        mods = tj.build_joint(cfg, device="cpu", init_seed=4)
        after = torch.rand(1)
        torch.manual_seed(global_seed)
        assert torch.equal(torch.rand(1), after)
        sds.append({f"{k}.{n}": v for k, net in (
            ("unet", mods.unet), ("arcface", mods.arcface),
            ("mapping", mods.mapping)) for n, v in net.state_dict().items()})
    assert all(torch.equal(v, sds[1][n]) for n, v in sds[0].items())
    other = tj.build_joint(cfg, device="cpu", init_seed=5).unet
    assert not torch.equal(other.conv_in.bias, mods.unet.conv_in.bias)


def test_train_step_control_arms_and_generator_draws():
    """handoff_source "hr" feeds the HR batch to MICA (no sampling); with a
    generator the step runs, and the same seed repeats it; the UNet's
    dropout draws no mask (the losses equal dropout 0's)."""
    cfg = tiny_cfg(t_defaults())
    cfg.train.handoff_source = "hr"
    b = {k: torch.from_numpy(v) for k, v in batch_of().items()}
    losses = []
    for dropout in (0.3, 0.3, 0.0):
        cfg.sr.model.unet.dropout = dropout
        mods = tj.build_joint(cfg, device="cpu", init_seed=2)
        st = tj.init_train_state(mods, cfg)
        st, met = tj.make_train_step()(
            mods, st, b, generator=torch.Generator().manual_seed(5))
        losses.append((float(met["l_sr"]), float(met["l_mica"])))
        assert not mods.unet.training and not mods.arcface.training
    assert losses[0] == losses[1] == losses[2]
    assert all(np.isfinite(losses[0]))


# --------------------------------------------------------------------------
# optimizer and EMA
# --------------------------------------------------------------------------

def test_optimizer_matches_optax_across_steplr(jax_params):
    """Three updates fed the same numpy gradients, lr_update_step 2 (the
    MICA groups' lr halves before the third), the frozen prefix left out:
    every parameter to 1e-6."""
    def cfgs(cfg):
        cfg = tiny_cfg(cfg)
        cfg.sr.train.optimizer.lr = 1e-2
        cfg.mica.train.lr = 3e-2
        cfg.mica.train.arcface_lr = 2e-2
        cfg.mica.train.weight_decay = 0.1
        cfg.mica.train.lr_update_step = 2
        cfg.mica.train.lr_gamma = 0.5
        return cfg

    cfg, tcfg = cfgs(get_cfg_defaults()), cfgs(t_defaults())
    params = jax_params.params
    opt = jj.make_optimizer(cfg)
    opt_state = opt.init(params)
    update = jax.jit(opt.update)
    tmods = _port_modules(tcfg, jax_params)
    tstate = tj.init_train_state(tmods, tcfg)
    nets = {"sr": tmods.unet, "arcface": tmods.arcface,
            "mapping": tmods.mapping}
    rng = np.random.RandomState(0)
    for step in range(3):
        grads = jax.tree.map(
            lambda a: rng.randn(*a.shape).astype(np.float32), params)
        upd, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, upd)
        for part, net in nets.items():
            g = flax_to_state_dict(grads[part])
            for n, p in net.named_parameters():
                p.grad = g[n].clone() if p.requires_grad else None
        tj.set_step_lr(tstate.opt, step)
        tstate.opt.step()
    lrs = {g["name"]: g["lr"] for g in tstate.opt.param_groups}
    assert lrs == {"sr": 1e-2, "arcface": 1e-2, "mapping": 1.5e-2}
    got = export_jax_params(tmods)
    for part in nets:
        ref = flax_to_state_dict(jax.tree.map(np.asarray, params[part]))
        mine = flax_to_state_dict(got[part])
        for n in ref:
            np.testing.assert_allclose(mine[n].numpy(), ref[n].numpy(),
                                       atol=1e-6, err_msg=f"{part}.{n}")
    mask = tj.frozen_prefix_mask(tmods.arcface)
    assert not mask["layer1.block0.conv2.weight"] and not mask["bn1.scale"]
    assert not mask["layer4.block0.bn1.scale"]   # the JAX mask's depth match
    assert mask["layer4.block0.conv2.weight"] and mask["fc.weight"]


def test_ema_update_matches_jax():
    """Across step_start_ema (3) with update_every 2: warm-up copies, a
    skipped step, then blends; 1e-7."""
    rng = np.random.RandomState(1)
    tree = {"a": {"kernel": rng.randn(3, 3, 4, 5).astype(np.float32)},
            "b": {"bias": rng.randn(5).astype(np.float32)}}
    js = j_ema.ema_init(jax.tree.map(jnp.asarray, tree))
    ts = load_jax_ema(tree, step=0)
    for _ in range(6):
        tree = jax.tree.map(
            lambda a: (a + rng.randn(*a.shape) * 0.1).astype(np.float32),
            tree)
        js = j_ema.ema_update(js, jax.tree.map(jnp.asarray, tree),
                              decay=0.9, step_start_ema=3, update_every=2)
        t_ema.ema_update(ts, flax_to_state_dict(tree), decay=0.9,
                         step_start_ema=3, update_every=2)
        assert ts.step == int(js.step)
        ref = flax_to_state_dict(jax.tree.map(np.asarray, js.params))
        for n, v in ref.items():
            np.testing.assert_allclose(ts.params[n].numpy(), v.numpy(),
                                       atol=1e-7, err_msg=n)
    assert state_dict_to_flax(ts.params)["a"]["kernel"].shape == (3, 3, 4, 5)


def test_val_step_with_ema_samples_with_its_weights():
    cfg = tiny_cfg(t_defaults())
    cfg.sr.model.diffusion.sampler = "ddim"
    cfg.sr.model.diffusion.ddim_steps = 4
    mods = tj.build_joint(cfg, device="cpu", init_seed=1)
    ema = t_ema.ema_init(dict(mods.unet.named_parameters()))
    cond = {"SR": torch.from_numpy(batch_of()["SR"])}

    def run(step, **kw):
        return step(mods, cond, generator=torch.Generator().manual_seed(0),
                    **kw)["sr"]

    plain = run(tj.make_val_step())
    assert torch.equal(run(tj.make_val_step(use_ema=True), ema=ema), plain)
    assert torch.equal(run(tj.make_val_step(use_ema=True)), plain)
    for v in ema.params.values():
        v.mul_(0.5)
    assert not torch.allclose(run(tj.make_val_step(use_ema=True), ema=ema),
                              plain)


# --------------------------------------------------------------------------
# vertex loss, masks, synthetic data
# --------------------------------------------------------------------------

def test_masks_weights_and_vertex_loss_match_jax():
    V = 5023
    jm, tm = j_masking.synthetic_masks(V, seed=3), \
        t_masking.synthetic_masks(V, seed=3)
    assert jm.keys() == tm.keys()
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k])
    mw = dict(t_defaults().mica.mask_weights)
    w_t = t_masking.weights_per_vertex(tm, mw, V)
    np.testing.assert_array_equal(w_t, j_masking.weights_per_vertex(jm, mw,
                                                                    V))
    assert w_t.shape == (V, 1) and w_t.dtype == np.float32
    rng = np.random.RandomState(0)
    pred, gt = (rng.randn(2, V, 3).astype(np.float32) for _ in range(2))
    ref = j_masking.masked_vertex_l1(jnp.asarray(pred), jnp.asarray(gt),
                                     jnp.asarray(w_t))
    got = t_masking.masked_vertex_l1(torch.from_numpy(pred),
                                     torch.from_numpy(gt),
                                     torch.from_numpy(w_t))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_synthetic_faces_match_jax():
    np.testing.assert_array_equal(synthetic_face_batch(3, 32, seed=4),
                                  j_faces(3, 32, seed=4))


# --------------------------------------------------------------------------
# the UNet's train mode
# --------------------------------------------------------------------------

def test_dropout_rate_scale_and_reproducibility():
    x = torch.ones(200, 300)
    y = apply_dropout(x, 0.2, torch.Generator().manual_seed(3))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.8, rtol=1e-6)
    assert torch.equal(apply_dropout(x, 0.2,
                                     torch.Generator().manual_seed(3)), y)
    assert not torch.equal(apply_dropout(
        x, 0.2, torch.Generator().manual_seed(4)), y)
    assert apply_dropout(x.to(torch.bfloat16), 0.2,
                         torch.Generator()).dtype == torch.bfloat16


def test_unet_train_mode_is_deterministic_by_default():
    """Train mode alone (flax's remat, not its ``deterministic=False``)
    gives the eval output: dropout is drawn only with
    ``deterministic=False``."""
    torch.manual_seed(0)
    unet = SR3UNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.float32, dropout=0.5)
    x, t = torch.randn(2, 6, 16, 16), torch.rand(2, 1)
    with torch.no_grad():
        ev = unet.eval()(x, t)
        unet.train()
        assert torch.equal(unet(x, t), ev)
        assert torch.equal(
            unet(x, t, generator=torch.Generator().manual_seed(9)), ev)
        drop = unet(x, t, generator=torch.Generator().manual_seed(9),
                    deterministic=False)
    assert not torch.allclose(drop, ev)


def test_unet_train_mode_dropout_and_remat():
    """With ``deterministic=False``, dropout acts in train mode only; remat
    on and off give the same gradients with dropout on, because the masks'
    seeds are drawn outside the checkpointed blocks."""
    torch.manual_seed(0)
    unet = SR3UNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.float32, dropout=0.5)
    x, t = torch.randn(2, 6, 16, 16), torch.rand(2, 1)
    with torch.no_grad():
        ev = unet.eval()(x, t)
        assert torch.equal(ev, unet(x, t, deterministic=False))
    unet.train()
    with pytest.raises(ValueError):
        unet(x, t, deterministic=False)
    res = []
    for remat in (False, True):
        unet.remat = remat
        unet.zero_grad()
        out = unet(x, t, generator=torch.Generator().manual_seed(9),
                   deterministic=False)
        out.square().mean().backward()
        res.append((out.detach(), {n: p.grad.clone()
                                   for n, p in unet.named_parameters()}))
    assert not torch.allclose(res[0][0], ev)
    torch.testing.assert_close(res[1][0], res[0][0], rtol=0, atol=0)
    for n, g in res[0][1].items():
        torch.testing.assert_close(res[1][1][n], g, rtol=1e-6, atol=1e-9,
                                   msg=n)


def test_arcface_train_keeps_frozen_prefix_in_eval():
    cfg = tiny_cfg(t_defaults())
    mods = tj.build_joint(cfg, device="cpu")
    net = mods.arcface.train()
    assert net.layer4.training and net.features.training
    assert not any(getattr(net, n).training for n in
                   ("conv1", "bn1", "prelu", "layer1", "layer2", "layer3"))
    net.train_frozen_prefix = True
    assert net.train().layer1.block0.bn1.training
    assert not net.eval().layer4.training
