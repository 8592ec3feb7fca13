"""The port's serving slice held against the JAX package as a whole, on the
CPU: ``make_val_step`` on ``configs/tiny_8_16_model2.yml`` (fp32, ArcFace
cut to one block per stage) with the JAX weights bridged in and JAX's noise
replayed, for DDIM and for the ancestral loop; then ``Predictor``'s
padding, un-padding, empty request and export."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.serve import Predictor as TorchPredictor
from sr3d_torch.train.joint import build_joint as t_build
from sr3d_torch.train.joint import make_val_step as t_val_step
from sr3d_torch.utils.bridge import load_jax_params
from sr3d_tpu.config.defaults import get_cfg_defaults, update_cfg
from sr3d_tpu.ops.image import tensor_to_uint8
from sr3d_tpu.serve import Predictor
from sr3d_tpu.train.joint import JointTrainState, build_joint, make_val_step

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "tiny_8_16_model2.yml")


def _tune(cfg, sampler):
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.sampler = sampler
    cfg.sr.model.diffusion.ddim_steps = 8
    cfg.sr.model.diffusion.sampler_init = \
        "marginal" if sampler == "ddim" else "noise"
    return cfg


@pytest.fixture(scope="module")
def jax_side():
    """JAX modules and a state whose BatchNorm statistics are moved off
    their 0/1 init; the numpy tree the bridge takes."""
    cfg = _tune(update_cfg(get_cfg_defaults(), CONFIG), "ddim")
    modules = build_joint(cfg)
    k_sr, k_af, k_map = jax.random.split(jax.random.PRNGKey(0), 3)
    af = jax.jit(modules.arcface.init)(k_af, jnp.zeros((1, 112, 112, 3)))
    params = {
        "sr": jax.jit(modules.unet.init)(k_sr, jnp.zeros((1, 16, 16, 6)),
                                         jnp.zeros((1, 1))),
        "arcface": af["params"],
        "mapping": jax.jit(modules.mapping.init)(k_map, jnp.zeros((1, 512))),
    }
    state = JointTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            arcface_stats=af["batch_stats"], opt_state=None,
                            ema=None)
    rng = np.random.RandomState(7)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) * rng.uniform(0.5, 1.5, a.shape)
                      if p[-1].key == "var" else
                      np.asarray(a) + rng.randn(*a.shape) * 0.1
                      ).astype(np.float32), state.arcface_stats)
    state = state._replace(arcface_stats=stats)
    tree = jax.tree.map(np.asarray, {
        "sr": state.params["sr"], "arcface": state.params["arcface"],
        "arcface_stats": state.arcface_stats,
        "mapping": state.params["mapping"]})
    return state, tree


def _replayed_noise(key, shape, order):
    k_init, k_loop = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(k_loop, int(i)), shape,
                                jnp.float32) for i in order]
    return [torch.from_numpy(np.asarray(d).transpose(0, 3, 1, 2).copy())
            for d in draws]


@pytest.mark.parametrize("sampler", ["ddim", "ddpm"])
def test_val_step_matches_jax(jax_side, sampler):
    state, tree = jax_side
    cfg = _tune(update_cfg(get_cfg_defaults(), CONFIG), sampler)
    jmods = build_joint(cfg)
    cond = np.random.RandomState(8).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    shape = np.random.RandomState(10).randn(2, 16).astype(np.float32) * 0.3
    key = jax.random.PRNGKey(11)
    ref = jax.jit(make_val_step())(jmods, state, {
        "SR": jnp.asarray(cond), "flame_shape": jnp.asarray(shape)}, key)
    ref = jax.tree.map(np.asarray, ref)

    tcfg = _tune(t_update(t_defaults(), CONFIG), sampler)
    tmods = t_build(tcfg, device="cpu")
    load_jax_params(tmods, tree)
    steps = (range(7, -1, -1) if sampler == "ddim"
             else range(tmods.sched_val.num_timesteps))
    out = t_val_step()(tmods, {"SR": torch.from_numpy(cond),
                               "flame_shape": torch.from_numpy(shape)},
                       noise=_replayed_noise(key, cond.shape, steps))
    out = {k: v.numpy() for k, v in out.items()}

    # sr: fp32 UNet sums in other orders through the sampler (see
    # tests/test_torch_unet.py), 1e-4.
    np.testing.assert_allclose(out["sr"], ref["sr"], atol=1e-4)
    # sr_u8: a value that sits on a rounding tie may land one level off.
    d = np.abs(tensor_to_uint8(out["sr"]) - np.asarray(
        tensor_to_uint8(ref["sr"])))
    assert d.max() <= 1 and np.mean(d > 0) < 0.005
    # The MICA outputs (and l_mica, the masked vertex L1 against the
    # batch's FLAME shapes) follow the uint8 image, identical but for such
    # ties; ArcFace and the mapping sum in other orders: 1e-4.
    for k in ("identity", "verts", "lmk68", "l_mica"):
        np.testing.assert_allclose(out[k], ref[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(out["img224"], ref["img224"],
                               atol=1.0 / 255 + 1e-6)


def test_val_step_refuses_unported_sampler():
    """Any val sampler name other than ddim and dpm++ runs the ancestral
    loop, as the JAX package's ``make_val_step`` does: an unknown name
    gives the ``ddpm`` step's outputs on the same noise, with or without
    the EMA."""
    cond = torch.from_numpy(np.random.RandomState(3).uniform(
        -1, 1, (1, 16, 16, 3)).astype(np.float32))
    outs = {}
    for sampler in ("unipc", "ddpm"):
        mods = t_build(_tune(t_update(t_defaults(), CONFIG), sampler),
                       device="cpu")
        T = mods.sched_val.num_timesteps
        noise = [torch.randn(1, 3, 16, 16, generator=torch.Generator()
                             .manual_seed(i)) for i in range(T + 1)]
        outs[sampler] = [step(mods, {"SR": cond}, noise=noise)
                         for step in (t_val_step(), t_val_step(True))]
    for got, want in zip(outs["unipc"], outs["ddpm"]):
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_predictor_padding_and_empty_request(jax_side, tmp_path):
    """N=5 at batch_size=2 (two full chunks and a padded tail) gives the
    JAX Predictor's shapes and dtypes; padding rows do not leak into real
    rows; the empty request returns the JAX empties."""
    state, tree = jax_side
    cfg = _tune(update_cfg(get_cfg_defaults(), CONFIG), "ddim")
    jp = Predictor(cfg, build_joint(cfg), state, batch_size=2)
    tcfg = _tune(t_update(t_defaults(), CONFIG), "ddim")
    tp = TorchPredictor.from_config(tcfg, params=tree, batch_size=2,
                                    device="cpu")
    lr = np.random.RandomState(9).randint(0, 255, (5, 8, 8, 3), np.uint8)
    ref = jp.predict(lr)
    out = tp.predict(lr)
    for k in ("sr_u8", "verts", "lmk68", "identity"):
        assert out[k].shape == ref[k].shape, k
        assert out[k].dtype == ref[k].dtype, k
        assert np.isfinite(out[k].astype(np.float32)).all(), k
    # chunk 0 draws the same seed in both calls; its padded row is zeros
    # in one and lr[1] in the other — row 0 must not notice
    one = tp.predict(lr[:1])
    for k in ("sr_u8", "verts", "identity"):
        np.testing.assert_array_equal(one[k][0], out[k][0], err_msg=k)
    again = tp.predict(lr)
    np.testing.assert_array_equal(again["sr_u8"], out["sr_u8"])

    empty, empty_ref = tp.predict(lr[:0]), jp.predict(lr[:0])
    for k in empty_ref:
        assert empty[k].shape == empty_ref[k].shape, k
        assert empty[k].dtype == empty_ref[k].dtype, k

    assert tp.export(lr[:2], str(tmp_path), names=["a", "b"]) == 2
    for f in ("mesh.ply", "mesh.obj", "kpt7.npy", "kpt68.npy",
              "identity.npy", "a_sr.png"):
        assert (tmp_path / "a" / f).exists(), f


def test_from_config_refuses_unasked_random_weights(tmp_path):
    """With no checkpoint, params or init_seed, ``from_config`` looks for
    a checkpoint to resume, as the JAX package's does, and raises
    FileNotFoundError where there is none; it never falls back to random
    weights.  A checkpoint and explicit weights together are refused."""
    cfg = _tune(t_update(t_defaults(), CONFIG), "ddim")
    cfg.output_dir = str(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        TorchPredictor.from_config(cfg, device="cpu")
    with pytest.raises(ValueError):
        TorchPredictor.from_config(cfg, str(tmp_path / "c.npz"),
                                   init_seed=0, device="cpu")
