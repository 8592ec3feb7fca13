"""The port's model3 train step held against the JAX package's on the CPU,
fp32, N = 4, at the tiny config of ``tests/test_torch_train.py``:
flow-through at two gradient scales and severed, DDIM and ancestral
hand-offs (losses, every gradient leaf, the parameters and ArcFace's
statistics after the step, the ``vis`` outputs), and gradient accumulation
against ``optax.MultiSteps``.  Weights, draws and helpers as in
``tests/test_torch_model3.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_model3 import (
    _accum_cfgs,
    _params_close,
    cfgs,
    jax_state,
    port_modules,
    step_draws,
    torch_batch,
    tree,  # noqa: F401  (the module's fixture)
)
from test_torch_train import EMA_CFG, _grab_grads, assert_leaf_close, batch_of

from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import export_jax_params, flax_to_state_dict
from sr3d_tpu.train import joint as jj

torch.set_num_threads(1)


# --------------------------------------------------------------------------
# the model3 train step
# --------------------------------------------------------------------------

@pytest.mark.parametrize("sampler,scale,sever", [
    pytest.param("ddim", 1e-3, False, id="ddim-flow-1e-3"),
    pytest.param("ddim", 1.0, True, id="ddim-severed"),
    pytest.param("ddpm", 1.0, False, id="ddpm-flow"),
])
def test_model3_train_step_matches_jax(tree, sampler, scale, sever):
    """One model3 step, N = 4: the losses (l_sr 1e-5, l_mica 1e-4), every
    gradient leaf (``assert_leaf_close``: the MICA branch at 1e-4 of a
    leaf's largest entry, since the continuous blob has no rounding ties;
    the UNet below), the parameters and ArcFace's statistics after the
    step and the ``vis`` outputs."""
    jcfg, tcfg = cfgs(sampler, handoff_grad_scale=scale, sever_sr_grad=sever)
    jmods = jj.build_joint(jcfg)
    b = batch_of(n=4)
    key = jax.random.PRNGKey(5)
    grab = _grab_grads()
    new_j, met_j = jax.jit(jj.make_train_step(grab, EMA_CFG, with_vis=True))(
        jmods, jax_state(tree, grab), jax.tree.map(jnp.asarray, b), key)
    grads_j = new_j.opt_state
    opt = jj.make_optimizer(jcfg)
    params_j = jax.jit(lambda g, p: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(grads_j, new_j.params)

    tmods = port_modules(tcfg, tree)
    assert (tmods.handoff_grad_scale, tmods.sever_sr_grad) == (scale, sever)
    tstate = tj.init_train_state(tmods, tcfg)
    tstate, met = tj.make_train_step(EMA_CFG, with_vis=True)(
        tmods, tstate, torch_batch(b), draws=step_draws(key, tmods, sampler))

    np.testing.assert_allclose(float(met["l_sr"]), float(met_j["l_sr"]),
                               rtol=1e-5)
    for k in ("l_mica", "loss"):
        np.testing.assert_allclose(float(met[k]), float(met_j[k]),
                                   rtol=1e-4, err_msg=k)
    for k, v in met["vis"].items():
        assert not v.requires_grad
        np.testing.assert_allclose(v.numpy(), np.asarray(met_j["vis"][k]),
                                   atol=1e-5 if k == "img224" else 1e-4,
                                   err_msg=k)
    nets = {"sr": tmods.unet, "arcface": tmods.arcface,
            "mapping": tmods.mapping}
    trainable = tj.frozen_prefix_mask(tmods.arcface)
    for part, net in nets.items():
        ref = flax_to_state_dict(jax.tree.map(np.asarray, grads_j[part]))
        top = max(float(g.abs().max()) for g in ref.values())
        for n, p in net.named_parameters():
            if part == "arcface" and not trainable[n]:
                assert p.grad is None, n
                continue
            if part == "sr" and not sever:
                # Flow-through, the UNet's gradient also carries l_mica's
                # back through ArcFace and the sampling chain, where fp32
                # rounding grows: the port against itself, 1 CPU thread
                # against 8, moves UNet leaves by up to 4.7e-4 of the
                # UNet's largest entry (ancestral, scale 1), and small
                # leaves by 1e-3 of their own.  So each leaf within 1e-3 of
                # the UNet's largest entry; a wrong path would move a leaf
                # by its own size.
                err = float((p.grad - ref[n]).abs().max())
                assert err <= 1e-3 * top, f"sr.{n}: {err:.3g} of {top:.3g}"
            else:   # severed, l_sr alone reaches the UNet: as model2's
                assert_leaf_close(p.grad, ref[n], 1e-4, f"{part}.{n}")
    # Adam's first update is ~lr·sign(g): an element whose gradient sits at
    # the rounding level may move the other way (test_torch_train)
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
    stats_ref = flax_to_state_dict(jax.tree.map(np.asarray,
                                                new_j.arcface_stats))
    stats = flax_to_state_dict(got["arcface_stats"])
    for n, s_ref in stats_ref.items():
        np.testing.assert_allclose(stats[n].numpy(), s_ref.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_grad_accumulation_matches_multisteps(tree):
    """``tpu.grad_accum = 2`` over four micro-batches (two updates) against
    the JAX step under ``optax.MultiSteps``: no update on the odd
    micro-steps, the parameters after each update, and StepLR counting
    updates (``lr_update_step`` 1: the second update at γ·lr)."""
    jcfg, tcfg = _accum_cfgs(2)
    jmods = jj.build_joint(jcfg)
    opt = jj.make_optimizer(jcfg)
    step_j = jax.jit(jj.make_train_step(opt, EMA_CFG))
    st_j = jax_state(tree, opt)
    tmods = port_modules(tcfg, tree)
    st = tj.init_train_state(tmods, tcfg)
    assert st.grad_accum == 2
    step = tj.make_train_step(EMA_CFG)
    moves: dict = {}   # the lrs of the updates so far
    for i in range(4):
        b = batch_of(n=4, seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        st_j, _ = step_j(jmods, st_j, jax.tree.map(jnp.asarray, b), key)
        before = export_jax_params(tmods)
        st, _ = step(tmods, st, torch_batch(b),
                     draws=step_draws(key, tmods, "ddim"))
        after = export_jax_params(tmods)
        moved = any(not np.array_equal(a, b_) for a, b_ in zip(
            jax.tree.leaves(before["mapping"]),
            jax.tree.leaves(after["mapping"])))
        assert moved == (i % 2 == 1), i
        lrs = {g["name"]: g["lr"] for g in st.opt.param_groups}
        if i % 2:
            moves = {k: moves.get(k, 0.0) + v for k, v in lrs.items()}
            _params_close(after, st_j.params, moves)
    assert st.step == 4 and st.ema.step == 4 == int(st_j.ema.step)
    assert lrs == {"sr": 1e-5, "arcface": 1e-5, "mapping": 1.5e-5}
