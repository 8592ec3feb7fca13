"""The JAX package's checkpoints read by the port without JAX, on the CPU:
``save_state_npz`` train states (with and without EMA, at grad_accum 1
and 2), a converted reference UNet ``.npz``, the numpy
``CheckpointManager``'s ``ckpt_*.npz`` auto-resume, and the errors; then
``Predictor.from_config(checkpoint=…)`` held against the JAX Predictor's
val step on replayed noise; and the ported converters held leaf for leaf
against ``sr3d_tpu/utils/convert.py``."""

import shutil
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.serve import Predictor as TorchPredictor
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train.joint import build_joint as t_build
from sr3d_torch.utils import convert as t_convert
from sr3d_torch.utils.bridge import export_jax_params
from sr3d_tpu.config.defaults import get_cfg_defaults, update_cfg
from sr3d_tpu.serve import Predictor
from sr3d_tpu.train import checkpoint as jc
from sr3d_tpu.train.joint import build_joint, init_train_state, make_optimizer
from sr3d_tpu.utils import convert as j_convert

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "tiny_8_16_model2.yml")
META = {"global_step": 7, "epoch": 3}


def _tune(cfg, ema=True, accum=1):
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    d = cfg.sr.model.diffusion
    d.sampler, d.ddim_steps, d.sampler_init = "ddim", 4, "marginal"
    if not ema:
        cfg.sr.train.ema_scheduler = None
    cfg.tpu.grad_accum = accum
    return cfg


def _jcfg(**kw):
    return _tune(update_cfg(get_cfg_defaults(), CONFIG), **kw)


def _tcfg(**kw):
    return _tune(t_update(t_defaults(), CONFIG), **kw)


@pytest.fixture(autouse=True)
def _free_disk(request):
    """A test's train states run to hundreds of MiB, and pytest keeps its
    last runs' temp dirs: drop them when it ends."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_state():
    """One jitted JAX ``init_train_state`` of the tiny config, its ArcFace
    statistics and EMA moved off their init so that every block of the
    file holds its own values."""
    cfg = _jcfg()
    mods = build_joint(cfg)
    state = jax.jit(lambda k: init_train_state(mods, cfg, k, 16))(
        jax.random.PRNGKey(0))
    state = jax.tree.map(np.asarray, state)
    rng = np.random.RandomState(1)
    bump = lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(a.dtype)
    state = state._replace(
        arcface_stats=jax.tree.map(bump, state.arcface_stats),
        ema=state.ema._replace(params=jax.tree.map(bump, state.ema.params),
                               step=np.int32(4)),
        step=np.int32(9))
    return cfg, mods, state


def _variant(cfg, state, ema, accum):
    """The state as a config with(out) EMA at grad_accum ``accum`` holds
    it: the EMA dropped, or the optimizer's state rebuilt (MultiSteps)."""
    if not ema:
        state = state._replace(ema=None)
    if accum > 1:
        c = _jcfg(ema=ema, accum=accum)
        state = state._replace(opt_state=jax.tree.map(
            np.asarray, make_optimizer(c).init(state.params)))
    return state


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("ema,accum", [(True, 1), (False, 1), (True, 2)])
def test_load_state_npz_reads_every_leaf(jax_state, tmp_path, ema, accum):
    cfg, _, state = jax_state
    state = _variant(cfg, state, ema, accum)
    path = tmp_path / "best_model.npz"
    jc.save_state_npz(path, state, META)
    tmods = t_build(_tcfg(ema=ema, accum=accum), device="cpu")
    got = tc.load_state_npz(path, tmods, _tcfg(ema=ema, accum=accum))
    assert got["meta"] == META and got["step"] == 9
    for name, want in (("params", state.params),
                       ("arcface_stats", state.arcface_stats)):
        ref = _leaves(want)
        out = _leaves(got[name])
        assert len(out) == len(ref), name
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
    if ema:
        assert got["ema"]["step"] == 4
        for a, b in zip(_leaves(got["ema"]["params"]),
                        _leaves(state.ema.params), strict=True):
            np.testing.assert_array_equal(a, b)
    else:
        assert got["ema"] is None
    # the JAX loader reads the same file into the same leaves
    back = jc.load_state_npz(path, state, {"global_step": 0, "epoch": 0})
    assert int(back["meta"]["global_step"]) == 7


def test_load_state_npz_refuses_another_config(jax_state, tmp_path):
    """A state of another width, a file with too few leaves, and an EMA
    the file lacks raise ValueError, as the JAX loader does."""
    cfg, _, state = jax_state
    path = tmp_path / "s.npz"
    jc.save_state_npz(path, state._replace(ema=None), META)
    wide = _tcfg(ema=False)
    wide.sr.model.unet.inner_channel = 32
    with pytest.raises(ValueError, match="shape"):
        tc.load_state_npz(path, t_build(wide, device="cpu"), wide)
    with pytest.raises(ValueError):      # the config's EMA is not there
        tc.load_state_npz(path, t_build(_tcfg(), device="cpu"), _tcfg())
    short = tmp_path / "short.npz"
    np.savez(short, leaf_0=np.zeros(()), leaf_1=np.zeros(()))
    with pytest.raises(ValueError, match="fewer"):
        tc.load_state_npz(short, t_build(_tcfg(), device="cpu"), _tcfg())


def _replayed_noise(key, shape, steps):
    k_init, k_loop = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(k_loop, int(i)), shape,
                                jnp.float32) for i in range(steps - 1, -1, -1)]
    return [torch.from_numpy(np.asarray(d).transpose(0, 3, 1, 2).copy())
            for d in draws]


def _hold(out, ref):
    """The serving tolerances of tests/test_torch_serve.py."""
    np.testing.assert_allclose(out["sr"], ref["sr"], atol=1e-4)
    for k in ("identity", "verts", "lmk68"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def served(jax_state, tmp_path_factory):
    """The tiny state saved once; the JAX Predictor's val step on one
    conditioning batch, with and without the EMA."""
    cfg, mods, state = jax_state
    path = tmp_path_factory.mktemp("ckpt") / "best_model.npz"
    jc.save_state_npz(path, state, META)
    cond = np.random.RandomState(8).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    key = jax.random.PRNGKey(12)
    refs = {}
    for use_ema in (False, True):
        p = Predictor(cfg, mods, state, batch_size=2, use_ema=use_ema)
        refs[use_ema] = jax.tree.map(np.asarray, p._step(
            p.modules, p.state, {"SR": jnp.asarray(cond)}, key))
    yield path, cond, _replayed_noise(key, cond.shape, 4), refs
    shutil.rmtree(path.parent, ignore_errors=True)


@pytest.mark.parametrize("use_ema", [False, True])
def test_predictor_from_checkpoint_matches_jax(served, use_ema):
    path, cond, noise, refs = served
    p = TorchPredictor.from_config(_tcfg(), checkpoint=str(path),
                                   use_ema=use_ema, batch_size=2,
                                   device="cpu")
    assert (p.ema is not None) == use_ema
    out = p._step(p.modules, {"SR": torch.from_numpy(cond)}, noise=noise,
                  ema=p.ema)
    _hold({k: v.numpy() for k, v in out.items()}, refs[use_ema])
    # the EMA differs from the parameters, so the two samples do
    assert np.abs(refs[True]["sr"] - refs[False]["sr"]).max() > 1e-3


def test_converted_npz_serves_the_sr_branch(jax_state, served, tmp_path):
    """A converted reference UNet (the SR leaves alone) loads into the
    UNet bit for bit and serves JAX's SR output; ArcFace and the mapping
    keep their random init from cfg.seed, and there is no EMA."""
    _, _, state = jax_state
    _, cond, noise, refs = served
    leaves = _leaves(state.params["sr"])
    npz = tmp_path / "conv.npz"
    np.savez(npz, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    p = TorchPredictor.from_config(_tcfg(), checkpoint=str(npz),
                                   use_ema=True, batch_size=2, device="cpu")
    assert p.ema is None
    for a, b in zip(_leaves(export_jax_params(p.modules)["sr"]), leaves,
                    strict=True):
        np.testing.assert_array_equal(a, b)
    fresh = t_build(_tcfg(), device="cpu", init_seed=0)
    assert torch.equal(p.modules.mapping.output.weight,
                       fresh.mapping.output.weight)
    out = p._step(p.modules, {"SR": torch.from_numpy(cond)}, noise=noise)
    np.testing.assert_allclose(out["sr"].numpy(), refs[False]["sr"],
                               atol=1e-4)


def test_auto_resume_and_bad_checkpoints(jax_state, tmp_path, monkeypatch):
    """``checkpoint=None`` resumes the newest ``ckpt_*.npz`` of the JAX
    numpy CheckpointManager under {output_dir}/{name}/{path.checkpoint};
    nothing to resume, a path that is no ``.npz``, a missing file and an
    orbax-only directory raise."""
    cfg, _, state = jax_state
    tcfg = _tcfg()
    tcfg.output_dir = str(tmp_path)
    ckpt_dir = tmp_path / tcfg.name / tcfg.path.checkpoint
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        TorchPredictor.from_config(tcfg, device="cpu")
    with pytest.raises(FileNotFoundError):
        TorchPredictor.from_config(tcfg, checkpoint="/nope/dir",
                                   device="cpu")
    with pytest.raises(FileNotFoundError):
        TorchPredictor.from_config(tcfg, checkpoint=str(tmp_path / "x.npz"),
                                   device="cpu")
    (ckpt_dir / "120").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        TorchPredictor.from_config(tcfg, device="cpu")
    monkeypatch.setattr(jc, "_HAS_ORBAX", False)
    mgr = jc.CheckpointManager(ckpt_dir)
    mgr.save(3, state, META)
    newer = state._replace(params=jax.tree.map(lambda a: a + 1.0,
                                               state.params))
    mgr.save(11, newer, META)
    assert tc.latest_npz_step(ckpt_dir) == mgr.latest_step() == 11
    p = TorchPredictor.from_config(tcfg, device="cpu")
    for a, b in zip(_leaves(export_jax_params(p.modules)["sr"]),
                    _leaves(newer.params["sr"]), strict=True):
        np.testing.assert_array_equal(a, b)


class _Pair(NamedTuple):
    first: object
    second: object


def test_jax_tree_flatten_matches_jax():
    """Leaf order and round trip on dicts (unsorted keys), tuples, lists,
    NamedTuples and None, against ``jax.tree_util``."""
    tree = {"b": (np.ones(2), None, [np.zeros(3), 5]),
            "a": _Pair({"z": 1, "y": np.arange(4)}, None),
            "c": {}}
    leaves, treedef = tc.jax_tree_flatten(tree)
    ref = jax.tree_util.tree_leaves(tree)
    assert len(leaves) == len(ref)
    for a, b in zip(leaves, ref):
        assert a is b
    back = tc.jax_tree_unflatten(treedef, leaves)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)


def _fake_unet_state_dict(rng, mults=(1, 2), res_blocks=1, inner=16,
                          attn_at=("downs.3", "mid.0", "ups.0", "ups.1")):
    """A reference-layout SR3 UNet state_dict (``downs.N`` / ``mid.N`` /
    ``ups.N``, ``module.`` prefixed), random values."""
    sd = {}

    def w(*shape):
        return rng.randn(*shape).astype(np.float32)

    def resblock(pfx, cin, cout, with_attn):
        sd[f"{pfx}.res_block.block1.block.0.weight"] = w(cin)
        sd[f"{pfx}.res_block.block1.block.0.bias"] = w(cin)
        sd[f"{pfx}.res_block.block1.block.3.weight"] = w(cout, cin, 3, 3)
        sd[f"{pfx}.res_block.block1.block.3.bias"] = w(cout)
        sd[f"{pfx}.res_block.block2.block.0.weight"] = w(cout)
        sd[f"{pfx}.res_block.block2.block.0.bias"] = w(cout)
        sd[f"{pfx}.res_block.block2.block.3.weight"] = w(cout, cout, 3, 3)
        sd[f"{pfx}.res_block.block2.block.3.bias"] = w(cout)
        sd[f"{pfx}.res_block.noise_func.noise_func.0.weight"] = w(cout,
                                                                   inner)
        sd[f"{pfx}.res_block.noise_func.noise_func.0.bias"] = w(cout)
        if cin != cout:
            sd[f"{pfx}.res_block.res_conv.weight"] = w(cout, cin, 1, 1)
            sd[f"{pfx}.res_block.res_conv.bias"] = w(cout)
        if with_attn:
            sd[f"{pfx}.attn.norm.weight"] = w(cout)
            sd[f"{pfx}.attn.norm.bias"] = w(cout)
            sd[f"{pfx}.attn.qkv.weight"] = w(3 * cout, cout, 1, 1)
            sd[f"{pfx}.attn.out.weight"] = w(cout, cout, 1, 1)
            sd[f"{pfx}.attn.out.bias"] = w(cout)

    sd["noise_level_mlp.1.weight"] = w(4 * inner, inner)
    sd["noise_level_mlp.1.bias"] = w(4 * inner)
    sd["noise_level_mlp.3.weight"] = w(inner, 4 * inner)
    sd["noise_level_mlp.3.bias"] = w(inner)
    sd["downs.0.weight"], sd["downs.0.bias"] = w(inner, 6, 3, 3), w(inner)
    chans, ch, idx = [inner], inner, 1
    for i, m in enumerate(mults):
        for _ in range(res_blocks):
            resblock(f"downs.{idx}", ch, inner * m, f"downs.{idx}" in attn_at)
            ch = inner * m
            chans.append(ch)
            idx += 1
        if i != len(mults) - 1:
            sd[f"downs.{idx}.conv.weight"] = w(ch, ch, 3, 3)
            sd[f"downs.{idx}.conv.bias"] = w(ch)
            chans.append(ch)
            idx += 1
    resblock("mid.0", ch, ch, True)
    resblock("mid.1", ch, ch, False)
    idx = 0
    for i in reversed(range(len(mults))):
        for _ in range(res_blocks + 1):
            resblock(f"ups.{idx}", ch + chans.pop(), inner * mults[i],
                     f"ups.{idx}" in attn_at)
            ch = inner * mults[i]
            idx += 1
        if i:
            sd[f"ups.{idx}.conv.weight"] = w(ch, ch, 3, 3)
            sd[f"ups.{idx}.conv.bias"] = w(ch)
            idx += 1
    sd["final_conv.block.0.weight"], sd["final_conv.block.0.bias"] = \
        w(ch), w(ch)
    sd["final_conv.block.3.weight"] = w(3, ch, 3, 3)
    sd["final_conv.block.3.bias"] = w(3)
    return {f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}


def _fake_arcface_state_dict(rng, layers=(1, 1, 1, 1)):
    sd = {}

    def bn(pfx, c):
        sd[f"{pfx}.weight"], sd[f"{pfx}.bias"] = rng.randn(c), rng.randn(c)
        sd[f"{pfx}.running_mean"] = rng.randn(c)
        sd[f"{pfx}.running_var"] = rng.rand(c) + 0.5

    sd["conv1.weight"] = rng.randn(64, 3, 3, 3)
    bn("bn1", 64)
    sd["prelu.weight"] = rng.randn(64)
    cin = 64
    for li, (n, c) in enumerate(zip(layers, (64, 128, 256, 512)), start=1):
        for bi in range(n):
            t = f"layer{li}.{bi}"
            bn(f"{t}.bn1", cin)
            sd[f"{t}.conv1.weight"] = rng.randn(c, cin, 3, 3)
            bn(f"{t}.bn2", c)
            sd[f"{t}.prelu.weight"] = rng.randn(c)
            sd[f"{t}.conv2.weight"] = rng.randn(c, c, 3, 3)
            bn(f"{t}.bn3", c)
            if bi == 0:
                sd[f"{t}.downsample.0.weight"] = rng.randn(c, cin, 1, 1)
                bn(f"{t}.downsample.1", c)
            cin = c
    bn("bn2", 512)
    sd["fc.weight"], sd["fc.bias"] = rng.randn(8, 512 * 49), rng.randn(8)
    bn("features", 8)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def test_converters_match_jax_leaf_for_leaf(tmp_path):
    """``convert_sr3_unet`` / ``convert_arcface`` / ``convert_mapping`` on
    reference-layout state_dicts (fabricated: no download) give the JAX
    converters' trees bit for bit; the CLI writes the same ``leaf_i``
    arrays as the JAX CLI."""
    rng = np.random.RandomState(0)
    unet_sd = _fake_unet_state_dict(rng)
    mapping_sd = {f"network.{i}.weight": rng.randn(32, 512 if i == 0
                                                     else 32)
                  for i in range(4)}
    mapping_sd.update({f"network.{i}.bias": rng.randn(32)
                       for i in range(4)})
    mapping_sd["output.weight"], mapping_sd["output.bias"] = \
        rng.randn(16, 32), rng.randn(16)
    arc_sd = _fake_arcface_state_dict(rng)
    cases = ((t_convert.convert_sr3_unet(unet_sd, channel_mults=(1, 2),
                                         res_blocks=1),
              j_convert.convert_sr3_unet(unet_sd, channel_mults=(1, 2),
                                         res_blocks=1)),
             (t_convert.convert_arcface(arc_sd, layers=(1, 1, 1, 1)),
              j_convert.convert_arcface(arc_sd, layers=(1, 1, 1, 1))),
             (t_convert.convert_mapping(mapping_sd),
              j_convert.convert_mapping(mapping_sd)))
    for got, want in cases:
        g_leaves, _ = tc.jax_tree_flatten(got)
        w_leaves, w_def = jax.tree_util.tree_flatten(want)
        assert jax.tree_util.tree_structure(got) == w_def
        for a, b in zip(g_leaves, w_leaves, strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    pth = tmp_path / "gen.pth"
    torch.save(unet_sd, pth)
    outs = {}
    for name, mod in (("torch", t_convert), ("jax", j_convert)):
        out = tmp_path / f"{name}.npz"
        mod.main(["--kind", "sr3_unet", "--in", str(pth), "--out", str(out),
                  "--channel-mults", "1,2", "--res-blocks", "1"])
        outs[name] = tc.npz_leaves(out)
    for a, b in zip(outs["torch"], outs["jax"], strict=True):
        np.testing.assert_array_equal(a, b)
    # the converted file serves: it loads into the tiny UNet's SR branch
    tmods = t_build(_tcfg(), device="cpu")
    sr = tc.load_leaves_into(tmp_path / "torch.npz",
                             export_jax_params(tmods)["sr"])
    assert len(_leaves(sr)) == len(outs["torch"])
