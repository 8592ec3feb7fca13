"""The port's MICA-only trainer (``train/mica_only.py``) and ``Validator``
held against the JAX package on the CPU at the tiny config, fp32: one
train step at N = 4 (at N = 2 the batch-statistics BatchNorm of ArcFace's
``features`` sees two samples and turns last-ulp differences into 1e-3
gradient differences) with every gradient, the parameters after AdamW and
the statistics; ``make_mica_predict`` and ``Validator.run``;
``model_mica.npz`` both ways, optimizer included (plain and under
``grad_accum``'s ``MultiSteps``); ``MicaTrainer.fit`` with its cadences,
``BestModel``, resume and ``reset_optimizer``."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.data.pipeline import BatchLoader
from sr3d_torch.eval.validator import Validator as TValidator
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train import joint as tj
from sr3d_torch.train import mica_only as tm
from sr3d_torch.train.trainer import BestModel as TBest
from sr3d_torch.utils.bridge import export_jax_params, flax_to_state_dict
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.eval.validator import Validator as JValidator
from sr3d_tpu.train import checkpoint as jc
from sr3d_tpu.train import joint as jj
from sr3d_tpu.train import mica_only as jm
from sr3d_tpu.train.trainer import BestModel as JBest

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _free_disk(request):
    """A test's checkpoints run to hundreds of MiB (ArcFace's head alone is
    12.8M parameters, with its Adam moments): drop them when it ends."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def tiny_cfg(cfg, accum=1):
    """``tests/test_branch_trainers.py::tiny_cfg`` on either package's
    defaults, with the sphere FLAME (362 vertices: quick to render)."""
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.sample_remat = False
    cfg.tpu.train_remat = False
    cfg.tpu.grad_accum = accum
    u = cfg.sr.model.unet
    u.inner_channel, u.norm_groups = 16, 8
    u.channel_multiplier, u.attn_res = [1, 2], [8]
    u.res_blocks, u.dropout = 1, 0.0
    cfg.sr.model.diffusion.image_size = 16
    for split in ("train", "val"):
        cfg.sr.datasets[split].l_resolution = 8
        cfg.sr.datasets[split].r_resolution = 16
        cfg.sr.model.beta_schedule[split].n_timestep = 8
    cfg.mica.model.n_shape = 16
    cfg.mica.model.n_exp = 8
    cfg.mica.model.map_hidden_dim = 32
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.mica.model.synthetic_flame_kind = "sphere"
    return cfg


def mica_batch(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"arcface": rng.uniform(-1, 1, (n, 112, 112, 3))
            .astype(np.float32),
            "flame_shape": (rng.randn(n, 16) * .3).astype(np.float32)}


def load_mica(mods, params, stats):
    arc = flax_to_state_dict(jax.tree.map(np.asarray, params["arcface"]))
    arc.update(flax_to_state_dict(jax.tree.map(np.asarray, stats)))
    mods.arcface.load_state_dict(arc)
    mods.mapping.load_state_dict(flax_to_state_dict(
        jax.tree.map(np.asarray, params["mapping"])))


@pytest.fixture(scope="module")
def jax_side():
    """JAX modules and a MICA state, ArcFace's statistics moved off their
    0/1 init."""
    cfg = tiny_cfg(get_cfg_defaults())
    mods = jj.build_joint(cfg)
    opt = jm.make_mica_optimizer(cfg)
    st = jm.init_mica_state(mods, cfg, jax.random.PRNGKey(0), opt)
    rng = np.random.RandomState(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                      if p[-1].key == "var" else
                      np.asarray(a) + rng.randn(*a.shape) * 0.1
                      ).astype(np.float32), st.arcface_stats)
    return cfg, mods, opt, st._replace(arcface_stats=stats)


def port_side(state, accum=1):
    tcfg = tiny_cfg(t_defaults(), accum)
    mods = tj.build_joint(tcfg, device="cpu")
    load_mica(mods, state.params, state.arcface_stats)
    return tcfg, mods, tm.init_mica_state(mods, tcfg)


def _grab_grads():
    """An optax transformation whose state is the last gradient."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def assert_leaf_close(got, ref, rel, name):
    """Within ``rel`` of the leaf's largest entry (floor 1e-6); at most 1%
    of the elements beyond it (PReLU and L1 kinks), none by more than a
    tenth of the scale."""
    scale = float(ref.abs().max())
    err = (got - ref).abs()
    bad = err > rel * scale + 1e-6
    assert float(bad.float().mean()) <= 0.01 and \
        float(err.max()) <= 0.1 * scale + 1e-6, (
            f"{name}: {int(bad.sum())}/{bad.numel()} beyond {rel} of "
            f"{scale:.3g}, max {float(err.max()):.3g}")


def test_mica_train_step_matches_jax(jax_side):
    """l_mica to 1e-5; every gradient to 1e-4 of its leaf's largest entry
    (the frozen prefix has none in the port); the parameters after AdamW
    (first update ~lr·sign(g): 99% of each network's elements to 1e-6,
    none beyond 2·lr); the running statistics to 1e-5."""
    cfg, jmods, opt, st = jax_side
    b = mica_batch()
    grab = _grab_grads()
    new_j, met_j = jax.jit(jm.make_mica_train_step(grab))(
        jmods, st._replace(opt_state=grab.init(st.params)),
        jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(1))
    params_j = jax.jit(lambda g, p: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(new_j.opt_state, st.params)

    tcfg, mods, tst = port_side(st)
    tst, met = tm.make_mica_train_step()(
        mods, tst, {k: torch.from_numpy(v) for k, v in b.items()})
    assert tst.step == 1
    np.testing.assert_allclose(float(met["loss"]), float(met_j["loss"]),
                               rtol=1e-5)
    trainable = tj.frozen_prefix_mask(mods.arcface)
    nets = {"arcface": mods.arcface, "mapping": mods.mapping}
    got = export_jax_params(mods)
    lrs = {g["name"]: g["lr"] for g in tst.opt.param_groups}
    for part, net in nets.items():
        named = dict(net.named_parameters())
        ref = flax_to_state_dict(jax.tree.map(np.asarray,
                                              new_j.opt_state[part]))
        for n, g_ref in ref.items():
            if part == "arcface" and not trainable[n]:
                assert named[n].grad is None, n
                continue
            assert_leaf_close(named[n].grad, g_ref, 1e-4, f"{part}.{n}")
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


class _DS:
    def __init__(self, n, seed=0):
        self.n, self.seed = n, seed

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return mica_batch(n=2, seed=self.seed + i)


def test_predict_and_validator_match_jax(jax_side):
    """``make_mica_predict`` and ``Validator.run``: the total over all
    items (not a mean of per-dataset means), the per-dataset losses, the
    512-d ArcFace embeddings, the BestModel feed and the render grid."""
    cfg, jmods, _, st = jax_side
    _, mods, tst = port_side(st)
    blobs = mica_batch(n=2, seed=3)["arcface"]
    predict_j = jax.jit(jm.make_mica_predict())
    v_j, c_j, l_j = predict_j(jmods, st, jnp.asarray(blobs))
    v, c, l = tm.make_mica_predict()(mods, tst, blobs)
    for a, b, tol in ((v, v_j, 1e-5), (c, c_j, 1e-4), (l, l_j, 1e-5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    datasets = {"SYNTH": _DS(2), "TINY": _DS(1, seed=5)}
    ref = JValidator(jmods, predict_j, datasets,
                     best_model=JBest(3), render_n=0).run(st)
    val = TValidator(mods, tm.make_mica_predict(), datasets,
                     best_model=TBest(3), render_n=2)
    res = val.run(tst)
    np.testing.assert_allclose(res["loss"], ref["loss"], rtol=1e-5)
    for k in ("SYNTH", "TINY"):
        np.testing.assert_allclose(res["per_dataset"][k],
                                   ref["per_dataset"][k], rtol=1e-5)
    assert res["loss"] == pytest.approx(
        (2 * res["per_dataset"]["SYNTH"] + res["per_dataset"]["TINY"]) / 3,
        rel=1e-6)
    assert res["embeddings"].shape == ref["embeddings"].shape == (6, 512)
    np.testing.assert_allclose(res["embeddings"], ref["embeddings"],
                               atol=1e-5)
    assert res["improved"] is False and "render_grid" in res
    val.best_model.average += 1.0
    val.best_model.weighted_average += 1.0
    assert val.run(tst)["improved"] is True


def _filled_port_state(st, accum):
    """A port MICA state after real steps (one micro-step past the last
    update at ``accum`` 2, so ``acc_grads`` holds a gradient)."""
    tcfg, mods, tst = port_side(st, accum)
    step = tm.make_mica_train_step()
    for i in range(2 if accum == 1 else 3):
        tst, _ = step(mods, tst, {k: torch.from_numpy(v)
                                  for k, v in mica_batch(seed=i).items()})
    return tcfg, mods, tst


@pytest.mark.parametrize("accum", [1, 2])
def test_port_model_mica_loads_in_jax(jax_side, tmp_path, accum):
    cfg, jmods, _, st = jax_side
    tcfg, mods, tst = _filled_port_state(st, accum)
    path = tm.save_mica_state(tmp_path / "model_mica.npz", mods, tst,
                              {"epoch": 1, "global_step": tst.step})
    jcfg = tiny_cfg(get_cfg_defaults(), accum)
    opt = jm.make_mica_optimizer(jcfg)
    tmpl = jm.init_mica_state(jmods, jcfg, jax.random.PRNGKey(0), opt)
    got = jc.load_state_npz(path, tmpl, {"epoch": 0, "global_step": 0})
    assert {k: int(v) for k, v in got["meta"].items()} == \
        {"epoch": 1, "global_step": tst.step}
    mine = tc.jax_tree_flatten(tm.mica_state_tree(
        mods, tst, {"epoch": 1, "global_step": tst.step}))[0]
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(mine)
    for a, b in zip(leaves, mine):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    # the optimizer tree lands on JAX's own leaf names and shapes
    assert jax.tree_util.tree_structure(got["state"].opt_state) == \
        jax.tree_util.tree_structure(tmpl.opt_state)


@pytest.mark.parametrize("accum", [1, 2])
def test_jax_model_mica_loads_in_the_port(jax_side, tmp_path, accum):
    cfg, jmods, _, st = jax_side
    jcfg = tiny_cfg(get_cfg_defaults(), accum)
    opt = jm.make_mica_optimizer(jcfg)
    rng = np.random.default_rng(accum)
    full = opt.init(st.params)
    filled = jax.tree.map(
        lambda x: (np.abs(rng.standard_normal(np.shape(x))).astype(np.float32)
                   if np.ndim(x) else np.asarray(3 if accum == 1 else 1,
                                                 np.int32)), full)
    if accum == 2:
        # the port keeps no gradient for ArcFace's frozen prefix (its update
        # is zero either way) and writes its acc_grads as zeros: a JAX file
        # between micro-steps loses those on the way in
        from sr3d_tpu.models.arcface import frozen_prefix_mask

        acc = filled.acc_grads
        acc["arcface"] = jax.tree.map(
            lambda a, t: a if t else np.zeros_like(a), acc["arcface"],
            frozen_prefix_mask(st.params["arcface"]))
    js = st._replace(opt_state=filled, step=jnp.asarray(5, jnp.int32))
    path = tmp_path / "model_mica.npz"
    jc.save_state_npz(path, js, {"epoch": 2, "global_step": 5})
    _, mods, tst = port_side(st._replace(
        params=jax.tree.map(np.zeros_like, st.params)), accum)
    meta = tm.load_mica_state(path, mods, tst)
    assert meta == {"epoch": 2, "global_step": 5} and tst.step == 5
    mine = tc.jax_tree_flatten(tm.mica_state_tree(mods, tst, meta))[0]
    ref = jax.tree_util.tree_leaves(jc.load_state_npz(
        path, js, {"epoch": 0, "global_step": 0}))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if accum == 2:
        assert tst.mini_step == 1
    # the layout before the epoch counter: meta global_step alone
    jc.save_state_npz(path, js, {"global_step": 5})
    with pytest.raises(ValueError):
        tm.load_mica_state(path, mods, tst)
    assert tm.load_mica_state(path, mods, tst, ("global_step",)) == \
        {"global_step": 5}


def test_mica_trainer_fit_val_resume(jax_side, tmp_path):
    """``fit``: the cadences (log, vis, val feeding BestModel, the eval
    hook, checkpoints, snapshots), then a resume (bit for bit), an
    auto-resume inside ``fit`` that takes no step at the end, a
    pre-epoch-layout file, and ``reset_optimizer``."""
    _, _, _, st = jax_side
    tcfg, mods, _ = port_side(st)
    loader = BatchLoader(_DS(4), batch_size=2, shuffle=False, num_workers=0)
    val = TValidator(mods, tm.make_mica_predict(), {"SYNTH": _DS(2)},
                     render_n=0)
    tr = tm.MicaTrainer(tcfg, mods, validator=val,
                        output_dir=tmp_path / "mica")
    assert val.best_model is tr.best_model
    hooks = []
    tr.fit(loader, max_steps=4, val_steps=2, checkpoint_steps=2,
           log_steps=2, vis_steps=3, snapshot_steps=4,
           eval_hook=lambda s: hooks.append(tr.global_step), eval_steps=2)
    out = tmp_path / "mica"
    assert tr.global_step == 4 and tr.epoch == 2 and hooks == [2, 4]
    assert tr.best_model.counter == 2
    assert (out / "train_images" / "train_1.jpg").exists()
    assert (out / "model_mica.npz").exists()
    assert (out / "model_mica_4.npz").exists()
    saved = {n: p.detach().clone() for n, p in
             mods.mapping.named_parameters()}
    moments = [s["exp_avg"].clone() for s in tr.state.opt.state.values()]

    _, mods2, _ = port_side(st)
    tr2 = tm.MicaTrainer(tcfg, mods2, output_dir=out)
    tr2.fit(loader, max_steps=4, val_steps=0, checkpoint_steps=0,
            log_steps=0)
    assert (tr2.global_step, tr2.epoch, tr2.state.step) == (4, 2, 4)
    for n, p in mods2.mapping.named_parameters():
        assert torch.equal(p, saved[n]), n
    got = [s["exp_avg"] for s in tr2.state.opt.state.values()]
    assert len(got) == len(moments)
    assert all(torch.equal(a, b) for a, b in zip(got, moments))

    # a snapshot has meta global_step only: it loads with the epoch
    # re-derived from the loader
    (out / "model_mica.npz").write_bytes(
        (out / "model_mica_4.npz").read_bytes())
    tr3 = tm.MicaTrainer(tcfg, port_side(st)[1], output_dir=out)
    assert tr3.load_checkpoint() and tr3.epoch == -1
    tr3.fit(loader, max_steps=4, val_steps=0, checkpoint_steps=0,
            log_steps=0)
    assert (tr3.global_step, tr3.epoch) == (4, 2)

    tcfg.mica.train.reset_optimizer = True
    tr4 = tm.MicaTrainer(tcfg, port_side(st)[1], output_dir=out)
    assert tr4.load_checkpoint() and tr4.global_step == 4
    assert not tr4.state.opt.state
    for n, p in tr4.modules.mapping.named_parameters():
        assert torch.equal(p, saved[n]), n
