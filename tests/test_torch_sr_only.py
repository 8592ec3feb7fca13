"""The port's SR-only trainer (``train/sr_only.py``, ``--sr-only``) held
against the JAX package on the CPU at a tiny width, fp32: one train step
of the SR3 and of the DDPM family with JAX's draws replayed (the loss,
every parameter after Adam, the EMA), ``finetune_norm``, the sampler
dispatch, the checkpoint pair both ways (with and without
``finetune_norm``), the warm start of the joint Trainer from a port pair,
and the CLI end to end."""

import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sr3d_torch.cli import main as tcli
from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.data.synthetic import generate_synthetic_faces
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train.sr_only import SRModel as TSR
from sr3d_torch.train.sr_only import in_attn
from sr3d_torch.train.trainer import Trainer
from sr3d_torch.utils.bridge import flax_to_state_dict, state_dict_to_flax
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.train import checkpoint as jc
from sr3d_tpu.train import joint as jj
from sr3d_tpu.train.sr_only import SRModel as JSR

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "tiny_8_16_model2.yml"


@pytest.fixture(autouse=True)
def _free_disk(request):
    """A test's checkpoints run to hundreds of MiB (ArcFace's head alone is
    12.8M parameters, with its Adam moments): drop them when it ends."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def tiny_cfg(cfg, which="sr3", finetune=False):
    """``tests/test_branch_trainers.py::tiny_cfg`` on either package's
    defaults, an EMA that blends from step 1."""
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.sample_remat = False
    cfg.tpu.train_remat = False
    u = cfg.sr.model.unet
    u.inner_channel, u.norm_groups = 16, 8
    u.channel_multiplier, u.attn_res = [1, 2], [8]
    u.res_blocks, u.dropout = 1, 0.0
    cfg.sr.model.diffusion.image_size = 16
    cfg.sr.model.which_model_G = which
    cfg.sr.model.finetune_norm = finetune
    for split in ("train", "val"):
        cfg.sr.datasets[split].l_resolution = 8
        cfg.sr.datasets[split].r_resolution = 16
        cfg.sr.model.beta_schedule[split].n_timestep = 8
    cfg.sr.train.ema_scheduler.step_start_ema = 1
    cfg.sr.train.ema_scheduler.ema_decay = 0.9
    return cfg


def both(which="sr3", finetune=False):
    """(port SRModel, JAX SRModel, JAX state) of one tiny config, the
    port's UNet holding the JAX state's weights."""
    jm = JSR(tiny_cfg(get_cfg_defaults(), which, finetune),
             dtype=jnp.float32)
    js = jm.init_state(jax.random.PRNGKey(0))
    js = js._replace(params=jax.tree.map(np.asarray, js.params))
    tm = TSR(tiny_cfg(t_defaults(), which, finetune), device="cpu")
    tm.unet.load_state_dict(flax_to_state_dict(js.params))
    return tm, jm, js


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def batch(n=2, seed=0):
    rng = np.random.RandomState(seed)
    return {"HR": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
            "SR": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32)}


def replayed(key, tm, shape):
    """The draws inside JAX's ``p_losses_*`` for ``key``, as the port's
    ``draws``."""
    if tm.time_input == "t":
        k_t, k_n = jax.random.split(key)
        t = np.array(jax.random.randint(k_t, (shape[0],), 0, 8))
        return {"t": torch.from_numpy(t),
                "noise": nchw(jax.random.normal(k_n, shape, jnp.float32))}
    k_g, k_n = jax.random.split(key)
    k_t, k_u = jax.random.split(k_g)
    _, gamma = tg.sample_continuous_gamma(
        tm.sched_train, shape[0],
        t=torch.tensor(int(jax.random.randint(k_t, (), 1, 9))),
        u=torch.from_numpy(np.array(jax.random.uniform(k_u, (shape[0],)))))
    return {"gamma": gamma,
            "noise": nchw(jax.random.normal(k_n, shape, jnp.float32))}


def flax_params(tm):
    return {"params": state_dict_to_flax(dict(tm.unet.named_parameters()))}


def assert_tree_close(got, ref, rel, what):
    g, r = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(ref)
    assert len(g) == len(r)
    scale = max(float(np.abs(np.asarray(x)).max()) for x in r)
    for i, (a, b) in enumerate(zip(g, r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=rel * scale, err_msg=f"{what} {i}")


@pytest.mark.parametrize("which", ["sr3", "ddpm"])
def test_train_step_matches_jax(which):
    """Two steps (JAX's jitted step, the port's with the same draws): the
    loss, every parameter after Adam and the EMA within 1e-4 of the
    tree's largest entry."""
    tm, jm, js = both(which)
    st = tm.init_state()
    step_j = jax.jit(jm.make_train_step())
    step_t = tm.make_train_step()
    for i in range(2):
        b = batch(seed=i)
        key = jax.random.PRNGKey(10 + i)
        js, mj = step_j(js, {k: jnp.asarray(v) for k, v in b.items()}, key)
        st, mt = step_t(st, b, draws=replayed(key, tm, b["HR"].shape))
        np.testing.assert_allclose(float(mt["l_pix"]), float(mj["l_pix"]),
                                   rtol=1e-4)
    assert st.step == int(js.step) == 2
    assert_tree_close(flax_params(tm), js.params, 1e-4, "params")
    ema = {"params": state_dict_to_flax(st.ema.params)}
    assert_tree_close(ema, js.ema.params, 1e-4, "ema")
    assert st.ema.step == int(js.ema.step) == 2
    assert_tree_close(tc.optimizer_tree(tm.layout, st)[0][1],
                      js.opt_state[0].mu, 1e-4, "mu")


def test_finetune_norm_trains_attention_only():
    """Under ``finetune_norm`` every parameter outside an ``attn`` scope
    stays bit for bit and holds no Adam state; the attention moves."""
    tm, _, _ = both(finetune=True)
    st = tm.init_state()
    before = {n: p.detach().clone() for n, p in tm.unet.named_parameters()}
    st, m = tm.make_train_step()(st, batch(),
                                 generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["l_pix"]))
    moved = []
    for n, p in tm.unet.named_parameters():
        if in_attn(n):
            moved.append(not torch.equal(p, before[n]))
            assert p in st.opt.state
        else:
            assert torch.equal(p, before[n]), n
            assert p not in st.opt.state and p.grad is None
    assert moved and all(moved)
    assert tm.layout.labels == {"train": "sr"} and tm.layout.multi


def test_sampler_dispatch(caplog):
    tm, _, _ = both("ddpm")
    st = tm.init_state()
    cond = np.zeros((1, 16, 16, 3), np.float32)
    g = torch.Generator().manual_seed(0)
    for name in ("ddpm", "ddim", "dpm++"):
        out = tm.make_sampler(sampler=name)(st, cond, generator=g)
        assert out.shape == (1, 16, 16, 3) and torch.isfinite(out).all()
    ema_out = tm.make_sampler(use_ema=True, sampler="ddim")(
        st, cond, generator=torch.Generator().manual_seed(1))
    assert ema_out.shape == (1, 16, 16, 3)
    with pytest.raises(ValueError, match="dpmpp"):
        tm.make_sampler(sampler="dpmpp")
    # T = 8: sample_inter = 1 | 0 = 1, 8 frames; a strided sampler warns
    # and runs the ancestral loop
    with caplog.at_level("WARNING", logger="sr3d_torch"):
        traj = tm.make_sampler(continuous=True, sampler="ddim")(
            st, cond, generator=g)
    assert "falling back to the ancestral" in caplog.text
    assert traj.shape == (8, 1, 16, 16, 3)


def _random_opt(opt_state, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.abs(rng.standard_normal(np.shape(x))).astype(np.float32)
                   if np.ndim(x) else np.asarray(3, np.int32)), opt_state)


@pytest.mark.parametrize("finetune", [False, True])
def test_jax_pair_loads_in_the_port(tmp_path, finetune):
    tm, jm, js = both(finetune=finetune)
    rng = np.random.default_rng(1)
    js = js._replace(
        params=jax.tree.map(lambda a: a + rng.standard_normal(a.shape)
                            .astype(np.float32), js.params),
        opt_state=_random_opt(js.opt_state, 2))
    prefix = jm.save_network(tmp_path, js, epoch=2, iter_step=7)
    st = tm.init_state()
    st, step, epoch = tm.load_network(st, prefix)
    assert (step, epoch, st.step) == (7, 2, 7)
    for a, b in zip(jax.tree_util.tree_leaves(flax_params(tm)),
                    jax.tree_util.tree_leaves(js.params), strict=True):
        np.testing.assert_array_equal(a, b)
    mine = tc.jax_tree_flatten(tc.optimizer_tree(tm.layout, st))[0]
    ref = jax.tree_util.tree_leaves(js.opt_state)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    # the EMA restarts from the loaded weights
    for n, p in tm.unet.named_parameters():
        assert torch.equal(st.ema.params[n], p.detach())
    # outside the train phase: the weights only
    st2 = tm.init_state()
    _, step, _ = tm.load_network(st2, tmp_path, phase="val")
    assert step == 0 and st2.step == 0 and not st2.opt.state


@pytest.mark.parametrize("finetune", [False, True])
def test_port_pair_loads_in_jax(tmp_path, finetune):
    tm, jm, js = both(finetune=finetune)
    st = tm.init_state()
    step = tm.make_train_step()
    for i in range(2):
        st, _ = step(st, batch(seed=i),
                     generator=torch.Generator().manual_seed(i))
    prefix = tm.save_network(tmp_path, st, epoch=1, iter_step=12)
    assert prefix.endswith("I12_E1")
    got, begin, epoch = jm.load_network(js, prefix)
    assert (begin, epoch, int(got.step)) == (12, 1, 12)
    for a, b in zip(jax.tree_util.tree_leaves(got.params),
                    jax.tree_util.tree_leaves(flax_params(tm)), strict=True):
        np.testing.assert_array_equal(np.asarray(a), b)
    ref = tc.jax_tree_flatten(tc.optimizer_tree(tm.layout, st))[0]
    leaves = jax.tree_util.tree_leaves(got.opt_state)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    assert int(leaves[0]) == 2


def test_latest_prefix_takes_the_highest_iter(tmp_path):
    for it in (9, 10, 2):
        (tmp_path / f"I{it}_E0_gen.npz").write_bytes(b"")
    assert TSR.latest_prefix(tmp_path) == str(tmp_path / "I10_E0")
    assert TSR.latest_prefix(tmp_path / "none") is None


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    """The joint Trainer's metrics sink would import TensorFlow (~10 s);
    the import is made to fail (the sink then writes no events)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def test_port_pair_warm_starts_the_joint_trainer(tmp_path):
    """A port-written pair warm-starts the port's joint Trainer (UNet
    weights equal, counters, Adam moments in the ``sr`` group), and JAX's
    ``transfer_sr_adam_moments`` takes the same ``_opt.npz`` into the
    same leaves."""
    from sr3d_torch.config import update_cfg as t_update
    from sr3d_tpu.config.defaults import update_cfg

    over = {"mica": {"model": {"arcface_layers": [1, 1, 1, 1],
                               "synthetic_flame_kind": "sphere"}},
            "tpu": {"compute_dtype": "float32"}}
    tcfg = t_update(t_defaults(), str(TINY))
    tcfg.merge_from_other(over, strict=True)
    jcfg = update_cfg(get_cfg_defaults(), str(TINY))
    jcfg.merge_from_other(over, strict=True)
    tcfg.output_dir = str(tmp_path / "out")
    tm = TSR(tcfg, device="cpu", init_seed=5)
    st = tm.init_state()
    st, _ = tm.make_train_step()(st, batch(),
                                 generator=torch.Generator().manual_seed(0))
    prefix = tm.save_network(tmp_path / "sr", st, epoch=1, iter_step=3)
    tr = Trainer(tcfg, device="cpu")
    assert tr.load_sr_pretrained(prefix)
    assert (tr.global_step, tr.epoch) == (3, 1)
    for (n, p), (_, q) in zip(tr.modules.unet.named_parameters(),
                              tm.unet.named_parameters(), strict=True):
        assert torch.equal(p, q), n
    for p, q in zip(tr.modules.unet.parameters(), tm.unet.parameters()):
        assert torch.equal(tr.state.opt.state[p]["exp_avg"],
                           st.opt.state[q]["exp_avg"])
    sr = flax_params(tm)
    jparams = {"sr": sr, **{k: v for k, v in
                            tc.export_jax_params(tr.modules).items()
                            if k in ("arcface", "mapping")}}
    fresh = jax.tree.map(np.asarray, jj.make_optimizer(jcfg).init(jparams))
    ref = jc.transfer_sr_adam_moments(fresh, sr, f"{prefix}_opt.npz")
    mine = tc.jax_tree_flatten(tc.optimizer_tree(
        tc.joint_layout(tr.modules), tr.state))[0]
    ref = jax.tree_util.tree_leaves(ref)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a, b)


def test_cli_sr_only_end_to_end(tmp_path):
    """``--sr-only`` on an LR/HR image root: 4 steps with pairs every 2,
    a resume to 6 from ``checkpoint_sr/``, ``-ckt`` of an older pair
    (counters from it, not the newest), a ``-ckt`` that does not exist
    raises, and ``train/l_pix`` finite in ``logs/metrics.jsonl``."""
    import json

    root = generate_synthetic_faces(tmp_path / "faces", n=4, l_res=8,
                                    r_res=16, seed=0)
    with open(TINY) as f:
        cfg = yaml.safe_load(f)
    cfg["output_dir"] = str(tmp_path / "out")
    cfg["name"] = "sr_only"
    cfg["sr"]["datasets"]["train"]["dataroot"] = str(root)
    cfg["train"].update(checkpoint_steps=2, log_steps=1)
    cfg["tpu"]["compute_dtype"] = "float32"
    overlay = tmp_path / "overlay.yml"
    overlay.write_text(yaml.safe_dump(cfg))
    argv = ["--sr-only", "-c", str(overlay)]
    assert tcli.main(argv + ["--max-steps", "4"], device="cpu") == 0
    out = tmp_path / "out" / "sr_only"
    ck = out / "checkpoint_sr"
    names = sorted(p.name for p in ck.glob("*.npz"))
    assert names == ["I2_E1_gen.npz", "I2_E1_opt.npz", "I4_E2_gen.npz",
                     "I4_E2_opt.npz"]
    assert tcli.main(argv + ["--max-steps", "2"], device="cpu") == 0
    with np.load(ck / "I6_E3_opt.npz") as d:
        assert (int(d["iter"]), int(d["epoch"]), int(d["leaf_0"])) == \
            (3 * 2, 3, 6)
    rows = [json.loads(x) for x in
            (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    l_pix = [(r["step"], r["value"]) for r in rows
             if r["tag"] == "train/l_pix"]
    assert [s for s, _ in l_pix] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(v) for _, v in l_pix)
    assert [r["step"] for r in rows if r["tag"] == "perf/ckpt_read_s"] == [4]
    assert tcli.main(argv + ["--max-steps", "1", "-ckt", str(ck / "I2_E1")],
                     device="cpu") == 0
    with np.load(ck / "I3_E1_opt.npz") as d:
        assert int(d["iter"]) == 3
    with pytest.raises(FileNotFoundError):
        tcli.main(argv + ["-ckt", str(ck / "I99_E0")], device="cpu")
