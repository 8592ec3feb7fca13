"""The port's model3 slice held against the JAX package on the CPU, fp32, at
the tiny config of ``tests/test_torch_train.py``: the continuous hand-off
image ops and their VJP, the differentiable samplers' parameter gradients
(and remat, chunked remat: the same gradients), which parameters l_mica
reaches, gradient accumulation against the big-batch step, the eval step,
and DPM-Solver++ in the sampler and the val step.  The whole model3 train
step and ``optax.MultiSteps`` are in ``tests/test_torch_model3_step.py``.

The weights are the port's (``build_joint(init_seed=…)``), carried into the
JAX package by ``sr3d_torch/utils/bridge.py``; JAX's random draws are
replayed into the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import (
    _grab_grads,
    batch_of,
    nchw,
    replayed_draws,
    tiny_cfg,
)

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.ops import image as timg
from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import (
    export_jax_params,
    flax_to_state_dict,
    load_jax_params,
)
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.diffusion import ema as j_ema
from sr3d_tpu.diffusion import gaussian as jg
from sr3d_tpu.ops import image as jimg
from sr3d_tpu.train import joint as jj

torch.set_num_threads(1)

SHAPE = (4, 16, 16, 3)   # N = 4, the flagship's K×B (see test_torch_train)


def cfgs(sampler="ddim", variant="model3", **train):
    """The JAX and the port config: ``tiny_cfg`` at ``variant`` with
    ``cfg.train`` overrides.  The port also checkpoints every sampling step
    and every UNet block (the JAX side runs without: the same gradients)."""
    out = []
    for cfg in (get_cfg_defaults(), t_defaults()):
        cfg = tiny_cfg(cfg, sampler)
        cfg.model = variant
        for k, v in train.items():
            cfg.train[k] = v
        out.append(cfg)
    out[1].tpu.sample_remat = True
    out[1].tpu.train_remat = True
    return out


@pytest.fixture(scope="module")
def tree():
    """The port's random weights as the JAX joint tree (numpy), ArcFace's
    BatchNorm statistics moved off their 0/1 init."""
    _, tcfg = cfgs()
    mods = tj.build_joint(tcfg, device="cpu", init_seed=0)
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for n, b in mods.arcface.named_buffers():
            if n.endswith("var"):
                b.mul_(torch.rand(b.shape, generator=g) + 0.5)
            else:
                b.add_(torch.randn(b.shape, generator=g) * 0.1)
    return export_jax_params(mods)


def port_modules(tcfg, tree):
    mods = tj.build_joint(tcfg, device="cpu")
    load_jax_params(mods, tree)
    return mods


def jax_state(tree, opt):
    params = jax.tree.map(jnp.asarray, {k: tree[k] for k in
                                        ("sr", "arcface", "mapping")})
    return jj.JointTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        arcface_stats=jax.tree.map(jnp.asarray, tree["arcface_stats"]),
        opt_state=opt.init(params), ema=j_ema.ema_init(params["sr"]))


def torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def step_draws(key, mods, sampler):
    """JAX's draws of one train step for ``key`` in the port's form."""
    T = mods.sched_train.num_timesteps
    order = range(T) if sampler == "ddpm" else range(3, -1, -1)
    t, u, noise, hand = replayed_draws(key, SHAPE, T, order)
    _, gamma = tg.sample_continuous_gamma(mods.sched_train, SHAPE[0],
                                          t=torch.tensor(t), u=u)
    return {"gamma": gamma, "noise": noise, "handoff": hand}


def loop_noise(key, shape, order):
    """A sampler's noise list for JAX's ``key``: x_T from ``k_init``, then
    ``fold_in(k_loop, i)`` for each loop index ``i`` in ``order``."""
    k_init, k_loop = jax.random.split(key)
    keys = [k_init] + [jax.random.fold_in(k_loop, int(i)) for i in order]
    return [nchw(jax.random.normal(k, shape, jnp.float32)) for k in keys]


# --------------------------------------------------------------------------
# the continuous hand-off image ops
# --------------------------------------------------------------------------

@pytest.mark.parametrize("differentiable,quantize", [
    pytest.param(True, True, id="differentiable"),
    pytest.param(False, False, id="unquantised")])
def test_sr_to_mica_inputs_and_vjp_match_jax(differentiable, quantize):
    """Values and the VJP of a random cotangent, 1e-5; inputs beyond and
    exactly on the clip's bounds (``clip`` passes half the gradient there,
    as ``jnp.clip``).  The unquantised non-differentiable path is detached,
    as JAX's ``stop_gradient``."""
    rng = np.random.RandomState(0)
    sr = rng.uniform(-1.2, 1.2, (2, 16, 16, 3)).astype(np.float32)
    sr[0, 0, :4, 0] = [1.0, -1.0, 1.0, -1.0]
    c_img = rng.randn(2, 224, 224, 3).astype(np.float32)
    c_blob = rng.randn(2, 112, 112, 3).astype(np.float32)
    kw = dict(quantize=quantize, differentiable=differentiable)
    (img_j, blob_j), vjp = jax.vjp(
        lambda x: jimg.sr_to_mica_inputs(x, **kw), jnp.asarray(sr))
    (g_j,) = vjp((jnp.asarray(c_img), jnp.asarray(c_blob)))
    x = torch.from_numpy(sr).requires_grad_()
    img, blob = timg.sr_to_mica_inputs(x, **kw)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j),
                               atol=1e-5)
    np.testing.assert_allclose(blob.detach().numpy(), np.asarray(blob_j),
                               atol=1e-5)
    g_j = np.asarray(g_j)
    if not differentiable:
        assert not img.requires_grad and not blob.requires_grad
        assert not g_j.any()
        return
    (g,) = torch.autograd.grad(
        [img, blob], [x], [torch.from_numpy(c_img), torch.from_numpy(c_blob)])
    np.testing.assert_allclose(g.numpy(), g_j, rtol=1e-5,
                               atol=1e-5 * np.abs(g_j).max())
    assert g_j[0, 0, 0, 0] != 0 and g_j[0, 0, 1, 0] != 0   # on a bound


# --------------------------------------------------------------------------
# differentiable samplers
# --------------------------------------------------------------------------

SAMPLERS = ("ddpm", "ddim")


@pytest.fixture(scope="module")
def sampler_case(tree):
    """The tiny UNet in both frameworks, a conditioning batch, JAX's noise
    and ``jax.grad`` of ``Σ final²`` for the ancestral loop (T = 8) and
    DDIM-4 (η = 1, marginal init: the hand-off's call)."""
    jcfg, tcfg = cfgs()
    jmods = jj.build_joint(jcfg)
    sched = jmods.sched_train
    cond = np.random.RandomState(3).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(11)
    params = jax.tree.map(jnp.asarray, tree["sr"])

    def loss(p, sampler):
        denoise = lambda x, t: jmods.unet.apply(p, x, t)
        if sampler == "ddpm":
            out = jg.p_sample_loop(denoise, sched, jnp.asarray(cond), key,
                                   differentiable=True, remat=False).final
        else:
            out = jg.ddim_sample_loop(denoise, sched, jnp.asarray(cond), key,
                                      num_steps=4, eta=1.0, init="marginal",
                                      differentiable=True, remat=False)
        return jnp.sum(out ** 2)

    grads = {s: flax_to_state_dict(jax.tree.map(np.asarray, jax.jit(
        jax.grad(loss), static_argnums=1)(params, s))) for s in SAMPLERS}
    T = sched.num_timesteps
    noise = {"ddpm": loop_noise(key, cond.shape, range(T)),
             "ddim": loop_noise(key, cond.shape, range(3, -1, -1))}
    return port_modules(tcfg, tree), nchw(cond), noise, grads


def port_sampler_grads(mods, cond, noise, sampler, **kw):
    unet = mods.unet
    unet.requires_grad_(True).zero_grad()
    if sampler == "ddpm":
        out = tg.p_sample_loop(unet, mods.sched_train, cond, noise=noise,
                               differentiable=True, **kw)
    else:
        out = tg.ddim_sample_loop(unet, mods.sched_train, cond, noise=noise,
                                  num_steps=4, eta=1.0, init="marginal",
                                  differentiable=True, **kw)
    (out ** 2).sum().backward()
    return {n: p.grad.clone() for n, p in unet.named_parameters()}


@pytest.mark.parametrize("sampler", SAMPLERS)
def test_differentiable_sampler_gradients_match_jax(sampler_case, sampler):
    """Every UNet parameter's gradient within 1e-4 of its leaf's largest
    entry (remat per step, as the hand-off runs it)."""
    mods, cond, noise, grads = sampler_case
    got = port_sampler_grads(mods, cond, noise[sampler], sampler, remat=True)
    assert set(got) == set(grads[sampler])
    for n, g_ref in grads[sampler].items():
        scale = float(g_ref.abs().max())
        err = float((got[n] - g_ref).abs().max())
        assert err <= 1e-4 * scale + 1e-7, f"{n}: {err:.3g} of {scale:.3g}"


@pytest.mark.parametrize("sampler,chunk", [("ddpm", 4), ("ddim", 2)])
def test_remat_and_chunks_keep_the_gradients(sampler_case, sampler, chunk):
    """No remat, per-step remat and chunks of ``chunk`` steps: gradients
    within 1e-6 of each other; a chunk that does not divide the loop
    raises."""
    mods, cond, noise, _ = sampler_case
    runs = [port_sampler_grads(mods, cond, noise[sampler], sampler, **kw)
            for kw in (dict(remat=False), dict(remat=True),
                       dict(remat=True, remat_chunk=chunk))]
    for n, g in runs[0].items():
        for other in runs[1:]:
            torch.testing.assert_close(other[n], g, rtol=1e-6, atol=1e-9,
                                       msg=n)
    with pytest.raises(ValueError, match="must divide"):
        port_sampler_grads(mods, cond, noise[sampler], sampler, remat=True,
                           remat_chunk=3)


def test_ddim_handoff_falls_back_to_per_step_remat(sampler_case):
    """A ``sample_remat_chunk`` that does not divide ``train_ddim_steps``:
    the DDIM hand-off warns and checkpoints every step (the same sample and
    gradients as chunk 1)."""
    mods, cond, noise, _ = sampler_case
    outs = []
    for chunk in (1, 3):
        m = dataclasses.replace(mods, sample_remat_chunk=chunk,
                                train_sampler="ddim", train_ddim_steps=4)
        m.unet.zero_grad()
        if chunk == 3:
            with pytest.warns(UserWarning, match="falls back"):
                out = tj._handoff_sample(m, cond, None, noise["ddim"], True)
        else:
            out = tj._handoff_sample(m, cond, None, noise["ddim"], True)
        (out ** 2).sum().backward()
        outs.append((out.detach(), mods.unet.conv_in.weight.grad.clone()))
    assert torch.equal(outs[0][0], outs[1][0])
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------------------
# which parameters l_mica reaches
# --------------------------------------------------------------------------

@pytest.mark.parametrize("variant,sever,source,reaches_unet", [
    ("model2", False, "sampled", False),
    ("model3", False, "sampled", True),
    ("model3", True, "sampled", False),
    ("model3", False, "cond", False),
    ("model3", False, "hr", False),
])
def test_l_mica_reaches_the_unet_only_through_flow_through(
        tree, variant, sever, source, reaches_unet):
    """``tests/test_joint.py::test_loss_partition_semantics`` and
    ``test_handoff_source_control_arms`` on the port: l_mica alone gives
    UNet gradients iff model3 flows through a sampled hand-off; it always
    reaches the mapping network."""
    _, tcfg = cfgs(variant=variant, sever_sr_grad=sever,
                   handoff_source=source)
    mods = port_modules(tcfg, tree)
    tj.init_train_state(mods, tcfg)
    mods.unet.train()
    mods.arcface.train()
    key = jax.random.PRNGKey(2)
    out = tj.train_losses(mods, torch_batch(batch_of(n=4)),
                          draws=step_draws(key, mods, "ddim"))
    out["l_mica"].backward()
    g_unet = sum(float(p.grad.abs().sum()) for p in mods.unet.parameters()
                 if p.grad is not None)
    assert (g_unet > 0) == reaches_unet, g_unet
    assert all(p.grad is not None and p.grad.abs().sum() > 0
               for p in mods.mapping.parameters())


# --------------------------------------------------------------------------
# gradient accumulation
# --------------------------------------------------------------------------

def _accum_cfgs(k):
    """Model3 on the HR control arm: no sampling, and the continuous blob
    (no uint8 rounding ties to move the MICA gradients apart)."""
    jcfg, tcfg = cfgs(handoff_source="hr")
    for cfg in (jcfg, tcfg):
        cfg.tpu.grad_accum = k
        # small steps: Adam's first update is ~lr·sign(g), so a
        # rounding-level gradient that flips sign moves an element 2·lr
        # apart, and the next gradients differ with it
        cfg.sr.train.optimizer.lr = 1e-5
        cfg.mica.train.lr = 3e-5
        cfg.mica.train.arcface_lr = 2e-5
        cfg.mica.train.weight_decay = 0.1
        cfg.mica.train.lr_update_step = 1
        cfg.mica.train.lr_gamma = 0.5
    return jcfg, tcfg


def _params_close(got, ref, lrs, parts=("sr", "arcface", "mapping")):
    """Within 2·``lrs[part]`` everywhere (the sum of the updates' lrs),
    99% of each network's elements within 1e-6 (Adam's sign at
    rounding-level gradients, as above)."""
    for part in parts:
        r = flax_to_state_dict(jax.tree.map(np.asarray, ref[part]))
        m = flax_to_state_dict(got[part])
        off = total = 0
        for n, p_ref in r.items():
            d = (m[n] - p_ref).abs()
            assert float(d.max()) <= 2 * lrs[part] + 1e-6, f"{part}.{n}"
            off, total = off + int((d > 1e-6).sum()), total + d.numel()
        assert off <= 0.01 * total, f"{part}: {off} of {total} apart"


def test_grad_accumulation_averages_like_the_big_batch(tree):
    """Two micro-steps of batch b against one step of [b; b] (the same
    BatchNorm statistics and loss means, so the same gradient): the
    accumulated gradient is the mean, not the sum, and the update equal."""
    b = batch_of(n=4, seed=3)
    key = jax.random.PRNGKey(9)
    res = []
    for k, batch in ((2, b), (1, {n: np.concatenate([v, v])
                                  for n, v in b.items()})):
        _, tcfg = _accum_cfgs(k)
        mods = port_modules(tcfg, tree)
        st = tj.init_train_state(mods, tcfg)
        d = step_draws(key, mods, "ddim")
        if k == 1:
            d = {n: torch.cat([d[n], d[n]]) for n in ("gamma", "noise")}
        for _ in range(k):
            st, _ = tj.make_train_step()(mods, st, torch_batch(batch),
                                         draws=d)
        grads = {n: p.grad.clone() for n, p in mods.mapping.named_parameters()}
        res.append((grads, export_jax_params(mods),
                    {g["name"]: g["lr"] for g in st.opt.param_groups}))
    (g_acc, p_acc, lrs), (g_big, p_big, _) = res
    for n, g in g_big.items():
        torch.testing.assert_close(g_acc[n], g, rtol=0,
                                   atol=1e-4 * float(g.abs().max()), msg=n)
    _params_close(p_acc, p_big, lrs)


# --------------------------------------------------------------------------
# eval step, DPM-Solver++, the dpm++ val step
# --------------------------------------------------------------------------

def test_eval_step_matches_jax(tree):
    """l_sr, l_mica and their sum without gradient, model3, quantised
    DDIM-4 hand-off, ArcFace on its running statistics: 1e-5 / 1e-4."""
    jcfg, tcfg = cfgs()
    b = batch_of(n=4, seed=1)
    key = jax.random.PRNGKey(4)
    jmods = jj.build_joint(jcfg)
    ref = jax.jit(jj.make_eval_step())(jmods, jax_state(tree, _grab_grads()),
                                       jax.tree.map(jnp.asarray, b), key)
    mods = port_modules(tcfg, tree)
    got = tj.make_eval_step()(mods, torch_batch(b),
                              draws=step_draws(key, mods, "ddim"))
    np.testing.assert_allclose(float(got["l_sr"]), float(ref["l_sr"]),
                               rtol=1e-5)
    for k in ("l_mica", "combined"):
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4,
                                   err_msg=k)
    assert not got["l_mica"].requires_grad


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_dpmpp_sample_loop_matches_jax(sampler_case, tree, eta):
    """DPM-Solver++(2M) (η = 0) and the 2M SDE (η = 1), 5 steps over the
    T = 8 schedule, marginal init, the tiny UNet: 1e-5."""
    mods, cond, _, _ = sampler_case
    jmods = jj.build_joint(cfgs()[0])
    key = jax.random.PRNGKey(13)
    cond_j = jnp.asarray(cond.numpy().transpose(0, 2, 3, 1))
    ref = jax.jit(lambda p, c: jg.dpmpp_sample_loop(
        lambda x, t: jmods.unet.apply(p, x, t), jmods.sched_train, c, key,
        num_steps=5, init="marginal", eta=eta))(
        jax.tree.map(jnp.asarray, tree["sr"]), cond_j)
    noise = loop_noise(key, cond_j.shape, range(4, -1, -1) if eta else ())
    got = tg.dpmpp_sample_loop(mods.unet, mods.sched_train, cond,
                               num_steps=5, init="marginal", eta=eta,
                               noise=noise)
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1),
                               np.asarray(ref), atol=1e-5)


def test_val_step_dpmpp_matches_jax(tree):
    """``make_val_step`` with ``val_sampler: dpm++`` (8 steps over T = 8,
    marginal init, η = 0, the serving recipe's solver): the sample to 1e-5,
    the MICA outputs to 1e-4."""
    jcfg, tcfg = cfgs()
    for cfg in (jcfg, tcfg):
        d = cfg.sr.model.diffusion
        d.sampler, d.ddim_steps, d.sampler_init = "dpm++", 8, "marginal"
    jmods = jj.build_joint(jcfg)
    b = batch_of(n=2, seed=4)
    key = jax.random.PRNGKey(6)
    ref = jax.jit(jj.make_val_step(int8=False))(
        jmods, jax_state(tree, _grab_grads()),
        {"SR": jnp.asarray(b["SR"])}, key)
    mods = port_modules(tcfg, tree)
    assert (mods.val_sampler, mods.dpmpp_eta) == ("dpm++", 0.0)
    got = tj.make_val_step()(mods, {"SR": torch.from_numpy(b["SR"])},
                             noise=loop_noise(key, (2, 16, 16, 3), ()))
    np.testing.assert_allclose(got["sr"].numpy(), np.asarray(ref["sr"]),
                               atol=1e-5)
    for k in ("identity", "verts", "lmk68"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, err_msg=k)
