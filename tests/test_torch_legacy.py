"""The port's alternating trainer (``train/legacy.py``, ``--legacy``) held
against the JAX package's on the CPU at the tiny config, fp32: one
``training_step`` with JAX's draws replayed (the SR update at 1e-4, the
sample it hands off, the MICA update through the uint8 hand-off, and on
JAX's own blob at 1e-4), ``validate_sr`` on actor-K batches, the
checkpoint layout read by both packages, and ``--legacy`` through the
CLI."""

import json
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
from sr3d_torch.data.synthetic import generate_synthetic_joint_root
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.diffusion.schedules import make_schedule
from sr3d_torch.train import joint as tj
from sr3d_torch.train import mica_only as tm
from sr3d_torch.train.legacy import AlternatingTrainer as TAlt
from sr3d_torch.utils.bridge import (
    export_jax_params,
    flax_to_state_dict,
    load_jax_params,
)
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.ops.image import sr_to_mica_inputs as j_handoff
from sr3d_tpu.train import joint as jj
from sr3d_tpu.train.legacy import AlternatingTrainer as JAlt

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "tiny_8_16_model2.yml"
T = 8


@pytest.fixture(autouse=True)
def _free_disk(request):
    """A test's checkpoints run to hundreds of MiB (ArcFace's head alone is
    12.8M parameters, with its Adam moments): drop them when it ends."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def tiny_cfg(cfg, out):
    """``tests/test_branch_trainers.py::tiny_cfg`` on either package's
    defaults (the sphere FLAME), output under ``out``."""
    cfg.tpu.compute_dtype = "float32"
    cfg.tpu.sample_remat = False
    cfg.tpu.train_remat = False
    u = cfg.sr.model.unet
    u.inner_channel, u.norm_groups = 16, 8
    u.channel_multiplier, u.attn_res = [1, 2], [8]
    u.res_blocks, u.dropout = 1, 0.0
    cfg.sr.model.diffusion.image_size = 16
    for split in ("train", "val"):
        cfg.sr.datasets[split].l_resolution = 8
        cfg.sr.datasets[split].r_resolution = 16
        cfg.sr.model.beta_schedule[split].n_timestep = T
    cfg.mica.model.n_shape = 16
    cfg.mica.model.n_exp = 8
    cfg.mica.model.map_hidden_dim = 32
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.mica.model.synthetic_flame_kind = "sphere"
    cfg.output_dir = str(out)
    cfg.name = "legacy"
    return cfg


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def batch(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return {"HR": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
            "SR": rng.uniform(-1, 1, (n, 16, 16, 3)).astype(np.float32),
            "flame_shape": (rng.randn(n, 16) * .3).astype(np.float32)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def port_of(jt, out):
    """A port trainer holding the JAX trainer's weights and statistics."""
    tcfg = tiny_cfg(t_defaults(), out)
    mods = tj.build_joint(tcfg, device="cpu")
    load_jax_params(mods, {"sr": _np(jt.sr_state.params),
                           "arcface": _np(jt.mica_state.params["arcface"]),
                           "arcface_stats": _np(jt.mica_state.arcface_stats),
                           "mapping": _np(jt.mica_state.params["mapping"])})
    return TAlt(tcfg, mods)


def replayed(cfg):
    """The keys JAX's ``training_step`` takes from its chain (``PRNGKey(
    seed + 7)`` split per use) as the port's ``draws``: the SR loss's
    (t, γ, noise), the ancestral sampler's noise; and the sampler's key."""
    r, k_sr = jax.random.split(jax.random.PRNGKey(int(cfg.seed) + 7))
    _, k_sample = jax.random.split(r)
    shape = (4, 16, 16, 3)
    k_g, k_n = jax.random.split(k_sr)
    k_t, k_u = jax.random.split(k_g)
    bs = cfg.sr.model.beta_schedule.train
    s = make_schedule("linear", T, float(bs.linear_start),
                      float(bs.linear_end))
    _, gamma = tg.sample_continuous_gamma(
        s, 4, t=torch.tensor(int(jax.random.randint(k_t, (), 1, T + 1))),
        u=torch.from_numpy(np.array(jax.random.uniform(k_u, (4,)))))
    k_init, k_loop = jax.random.split(k_sample)
    zs = [jax.random.normal(k_init, shape, jnp.float32)]
    zs += [jax.random.normal(jax.random.fold_in(k_loop, i), shape,
                             jnp.float32) for i in range(T)]
    return ({"sr": {"gamma": gamma, "noise": nchw(jax.random.normal(
        k_n, shape, jnp.float32))}, "sample": [nchw(z) for z in zs]},
        k_sample)


@pytest.fixture(scope="module")
def stepped(tmp_path_factory):
    """The JAX trainer and the port's after one ``training_step`` on the
    same batch and draws, with the pre-step MICA weights kept."""
    out = tmp_path_factory.mktemp("legacy")
    jcfg = tiny_cfg(get_cfg_defaults(), out / "jax")
    jt = JAlt(jcfg, jj.build_joint(jcfg), dtype=jnp.float32)
    tt = port_of(jt, out / "port")
    pre = _np(jt.mica_state)
    draws, k_sample = replayed(jcfg)
    b = batch()
    mj = jt.training_step(b)
    mt = tt.training_step(b, draws=draws)
    yield jt, tt, pre, b, mj, mt, k_sample, out
    shutil.rmtree(out, ignore_errors=True)


def test_training_step_matches_jax(stepped):
    """l_pix and every UNet parameter after Adam to 1e-4 (of the tree's
    largest entry); the sample handed off to 1e-4; l_mica to 1e-4.  The
    MICA parameters after AdamW at the uint8 hand-off's tie tolerance:
    ~0.2% of the hand-off's uint8 values sit on rounding ties and land one
    level apart between the frameworks, which moves the MICA gradients by
    up to 5e-2 of their scale, so 99% of each network's elements agree to
    5e-2 of the update's size (lr; Adam's first update is ~lr·sign(g)) and
    none is more than 2·lr apart."""
    jt, tt, _, b, mj, mt, k_sample, _ = stepped
    assert jt.step == tt.step == 1
    np.testing.assert_allclose(mt["l_pix"], mj["l_pix"], rtol=1e-4)
    got = export_jax_params(tt.modules)
    ref = _np(jt.sr_state.params)
    scale = max(float(np.abs(x).max()) for x in
                jax.tree_util.tree_leaves(ref))
    for a, r in zip(jax.tree_util.tree_leaves(got["sr"]),
                    jax.tree_util.tree_leaves(ref), strict=True):
        np.testing.assert_allclose(a, r, atol=1e-4 * scale)
    img_j = jt._sr_sample(jt.sr_state, b["SR"], k_sample)
    replay = replayed(jt.cfg)[0]["sample"]
    img_t = tt._sr_sample(tt.sr_state, b["SR"], noise=replay)
    np.testing.assert_allclose(img_t.numpy(), np.asarray(img_j), atol=1e-4)
    np.testing.assert_allclose(mt["l_mica"], mj["l_mica"], rtol=1e-4)
    lrs = {g["name"]: g["lr"] for g in tt.mica_state.opt.param_groups}
    for part in ("arcface", "mapping"):
        r = flax_to_state_dict(_np(jt.mica_state.params[part]))
        m = flax_to_state_dict(got[part])
        off = total = 0
        for n, p_ref in r.items():
            d = (m[n] - p_ref).abs()
            assert float(d.max()) <= 2 * lrs[part] + 1e-6, f"{part}.{n}"
            off += int((d > 5e-2 * lrs[part]).sum())
            total += d.numel()
        assert off <= 0.01 * total, f"{part}: {off} of {total} moved apart"


def test_mica_update_on_a_shared_blob(stepped):
    """The MICA half of the step on JAX's own hand-off blob, from the
    pre-step weights: the loss to 1e-4 and the updated mapping network
    within 2·lr (99% to 1e-6)."""
    jt, tt, pre, b, mj, _, k_sample, out = stepped
    img_j = jt._sr_sample(jt.sr_state, b["SR"], k_sample)
    _, blobs = j_handoff(img_j, image_size=224, blob_size=112)
    np.testing.assert_allclose(
        float(jt._mica_step(jt.modules, jax.tree.map(jnp.asarray, pre),
                            {"arcface": blobs,
                             "flame_shape": jnp.asarray(b["flame_shape"])},
                            jax.random.PRNGKey(0))[1]["loss"]),
        mj["l_mica"], rtol=1e-6)
    tcfg = tiny_cfg(t_defaults(), out / "shared")
    mods = tj.build_joint(tcfg, device="cpu")
    mods.unet.load_state_dict(tt.modules.unet.state_dict())
    load_jax_params(mods, {"sr": export_jax_params(mods)["sr"],
                           "arcface": pre.params["arcface"],
                           "arcface_stats": pre.arcface_stats,
                           "mapping": pre.params["mapping"]})
    st = tm.init_mica_state(mods, tcfg)
    st, m = tm.make_mica_train_step()(
        mods, st, {"arcface": torch.from_numpy(np.array(blobs)),
                   "flame_shape": torch.from_numpy(b["flame_shape"])})
    np.testing.assert_allclose(float(m["loss"]), mj["l_mica"], rtol=1e-4)
    r = flax_to_state_dict(_np(jt.mica_state.params["mapping"]))
    got = flax_to_state_dict(export_jax_params(mods)["mapping"])
    lr = float(tcfg.mica.train.lr)
    for n, p_ref in r.items():
        d = (got[n] - p_ref).abs()
        assert float(d.max()) <= 2 * lr + 1e-6, n
        assert int((d > 1e-6).sum()) <= 0.01 * d.numel(), n


def test_validate_sr_takes_actor_k_batches(stepped):
    """``[B, K, …]`` batches flatten to ``[B·K, …]``: the same PSNR as the
    flattened batch (the sampler's seeds follow the step and the batch
    index, not the layout)."""
    _, tt, _, _, _, _, _, _ = stepped
    rng = np.random.RandomState(0)
    joint = {"HR": rng.uniform(-1, 1, (2, 2, 16, 16, 3)).astype(np.float32),
             "SR": rng.uniform(-1, 1, (2, 2, 16, 16, 3)).astype(np.float32)}
    flat = {k: v.reshape((4, 16, 16, 3)) for k, v in joint.items()}
    psnr = tt.validate_sr([joint])
    assert np.isfinite(psnr) and psnr > 0
    assert tt.validate_sr([flat]) == psnr


def test_checkpoints_resume_in_both_packages(stepped):
    """The port's SR pair and ``model_mica.npz`` (meta ``global_step``):
    a fresh port trainer and the JAX trainer both resume from them, bit
    for bit."""
    jt, tt, _, _, _, _, _, out = stepped
    tt.save_checkpoint()
    root = out / "port" / "legacy"
    assert sorted(p.name for p in (root / "checkpoint_sr").iterdir()) == \
        ["I1_E0_gen.npz", "I1_E0_opt.npz"]
    assert (root / "model_mica.npz").exists()
    want = export_jax_params(tt.modules)

    t2 = port_of(jt, out / "port")
    assert t2.load_checkpoint() and t2.step == 1
    assert t2.sr_state.step == 1
    got = export_jax_params(t2.modules)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want), strict=True):
        np.testing.assert_array_equal(a, b)

    jcfg = tiny_cfg(get_cfg_defaults(), out / "port")
    j2 = JAlt(jcfg, jj.build_joint(jcfg), dtype=jnp.float32)
    assert j2.load_checkpoint() and j2.step == 1
    for part, tree in (("sr", j2.sr_state.params),
                       ("arcface", j2.mica_state.params["arcface"]),
                       ("mapping", j2.mica_state.params["mapping"]),
                       ("arcface_stats", j2.mica_state.arcface_stats)):
        for a, b in zip(jax.tree_util.tree_leaves(_np(tree)),
                        jax.tree_util.tree_leaves(want[part]), strict=True):
            np.testing.assert_array_equal(a, b, err_msg=part)
    assert int(j2.sr_state.step) == 1


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def test_cli_legacy_end_to_end(tmp_path):
    """``--legacy`` over a joint root: 3 steps with a checkpoint at step
    2 and at the end, then a resumed call of one step; the files and the
    losses."""
    generate_synthetic_joint_root(
        tmp_path / "joint", name="SYNTH", n_actors=3, imgs_per_actor=2,
        img_res=32, lr_res=8, hr_res=16, n_shape=16, n_exp=8)
    with open(TINY) as f:
        cfg = yaml.safe_load(f)
    cfg.update(name="legacy_cli", output_dir=str(tmp_path / "out"))
    cfg["mica"]["datasets"]["root"] = str(tmp_path / "joint")
    cfg["mica"]["model"]["arcface_layers"] = [1, 1, 1, 1]
    cfg["mica"]["model"]["synthetic_flame_kind"] = "sphere"
    cfg["train"].update(checkpoint_steps=2, log_steps=1)
    cfg["tpu"]["compute_dtype"] = "float32"
    cfg["sr"]["model"]["diffusion"].update(sampler="ddim", ddim_steps=2)
    overlay = tmp_path / "overlay.yml"
    overlay.write_text(yaml.safe_dump(cfg))
    argv = ["--legacy", "-c", str(overlay)]
    assert tcli.main(argv + ["--max-steps", "3"], device="cpu") == 0
    out = tmp_path / "out" / "legacy_cli"
    assert sorted(p.name for p in (out / "checkpoint_sr").glob("*")) == [
        "I2_E0_gen.npz", "I2_E0_opt.npz", "I3_E0_gen.npz", "I3_E0_opt.npz"]
    assert tcli.main(argv + ["--max-steps", "1"], device="cpu") == 0
    assert (out / "checkpoint_sr" / "I4_E0_gen.npz").exists()
    with np.load(out / "model_mica.npz") as d:
        assert int(d["leaf_0"]) == 4   # meta global_step comes first
    rows = [json.loads(x) for x in
            (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    for tag in ("train/l_pix", "train/l_mica"):
        got = [(r["step"], r["value"]) for r in rows if r["tag"] == tag]
        assert [s for s, _ in got] == [1, 2, 3, 4], tag
        assert all(np.isfinite(v) for _, v in got), tag
