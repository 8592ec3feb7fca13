"""The port's tensor-parallel and spatial layer on a world of 4 ``gloo``
processes on the CPU: the wide tiny UNet at dp2×tp2 against the one-device
and the JAX forward, which weights ``state_shardings`` splits against
JAX's rule, a tiny joint train step at dp2×tp2 with its checkpoint both
ways, spatial sampling over 2 and 4 ranks against the one-device and the
JAX loop, and the flagship's 5-level topology at a thin width split over
2 and 4 ranks (the JAX package compiles that geometry only).

One world runs every scenario once (``tests/test_torch_parallel_worker.py``);
each test reads its results.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.diffusion.schedules import make_schedule as t_schedule
from sr3d_torch.models.layers import init_lecun_normal_
from sr3d_torch.parallel import Mesh, state_shardings, tp_param_sharding
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import flax_to_state_dict, load_jax_params
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.diffusion import gaussian as jg
from sr3d_tpu.diffusion.schedules import make_schedule
from sr3d_tpu.models.sr3_unet import SR3UNet as JUNet
from sr3d_tpu.parallel import steps as jsteps
from sr3d_tpu.parallel.mesh import make_mesh
from sr3d_tpu.train import joint as jj
from tests import test_torch_parallel_worker as worker
from tests.test_torch_parallel import _ckpt_close, _noise
from tests.test_torch_train import (EMA_CFG, batch_of, nchw,
                                    replayed_draws, tiny_cfg)

torch.set_num_threads(1)

SCENARIOS = ("tp_forward", "tp_step", "spatial_sample", "flagship_geometry",
             "ddpm_spatial")


def _jax_unet(inner):
    unet = JUNet(inner_channel=inner, norm_groups=8, channel_mults=(1, 2),
                 attn_res=(8,), res_blocks=1, dropout=0.0, image_size=16,
                 dtype=jnp.float32)
    params = unet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)),
                       jnp.zeros((1, 1)))
    return unet, params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel4")
    inputs, ref = {}, {}

    # the wide tiny UNet of test_tp_sharded_unet_matches_replicated
    wide, wparams = _jax_unet(64)
    x = np.random.RandomState(0).randn(4, 16, 16, 6).astype(np.float32)
    t = np.full((4, 1), 0.5, np.float32)
    ref["wide_jax"] = np.asarray(jax.jit(wide.apply)(wparams, x, t))
    inputs["wide_sd"] = flax_to_state_dict(jax.tree.map(np.asarray,
                                                        wparams))
    inputs["wide_x"], inputs["wide_t"] = nchw(x), torch.from_numpy(t)
    ref["wide_params"] = wparams

    # the tiny joint step, dp2×tp2 with tp_min_channels 16
    jcfg = tiny_cfg(get_cfg_defaults(), "ddim")
    jmods = jj.build_joint(jcfg)
    state = jj.init_train_state(jmods, jcfg, jax.random.PRNGKey(0), 16)
    ref["jax_state"] = state
    params = jax.tree.map(np.asarray, {
        "sr": state.params["sr"], "arcface": state.params["arcface"],
        "arcface_stats": state.arcface_stats,
        "mapping": state.params["mapping"]})
    tcfg = tiny_cfg(t_defaults(), "ddim")
    T = tcfg.sr.model.beta_schedule.train.n_timestep
    tt, u, noise, hand = replayed_draws(jax.random.PRNGKey(3),
                                        (4, 16, 16, 3), T, range(3, -1, -1))
    _, gamma = tg.sample_continuous_gamma(t_schedule("linear", T, 1e-4,
                                                     5e-2),
                                          4, t=torch.tensor(tt), u=u)
    inputs.update(joint_cfg=tcfg, joint_params=params, ema_cfg=EMA_CFG,
                  joint_batch={k: torch.from_numpy(np.asarray(v))
                               for k, v in batch_of(n=4).items()},
                  joint_draws={"gamma": gamma, "noise": noise,
                               "handoff": hand})
    mods = tj.build_joint(tcfg, device="cpu")
    load_jax_params(mods, params)
    st = tj.init_train_state(mods, tcfg)
    st, met = tj.make_train_step(EMA_CFG)(mods, st, inputs["joint_batch"],
                                          draws=inputs["joint_draws"])
    ref["one_joint"] = {k: float(v) for k, v in met.items()}
    tc.save_train_state(root / "one.npz", mods, st,
                        {"global_step": 1, "epoch": 0})
    ref["joint_modules"] = mods

    # spatial sampling: test_spatial_sharded_sampling_matches_replicated
    unet, uparams = _jax_unet(16)
    sched = make_schedule("linear", 20, 1e-4, 2e-2)
    cond = np.asarray(jax.random.uniform(jax.random.PRNGKey(1),
                                         (2, 16, 16, 3), jnp.float32, -1, 1))
    ref["spatial_jax"] = np.asarray(jax.jit(
        lambda p, c, k: jg.p_sample_loop(
            lambda x, t: unet.apply(p, x, t), sched, c, k).final)(
        uparams, cond, jax.random.PRNGKey(2)))
    inputs["unet_sd"] = flax_to_state_dict(jax.tree.map(np.asarray,
                                                        uparams))
    inputs["cond2"] = nchw(cond)
    inputs["noise2"] = _noise(jax.random.PRNGKey(2), cond.shape, range(20))

    # the flagship topology at a thin width, random weights from a seed
    thin = worker.tiny_unet(channel_mults=(1, 2, 4, 8, 8), attn_res=(16,),
                            image_size=128)
    init_lecun_normal_(thin, torch.Generator().manual_seed(0))
    inputs["thin_sd"] = thin.state_dict()
    g = torch.Generator().manual_seed(1)
    inputs["thin_x"] = torch.randn(1, 6, 128, 128, generator=g)
    inputs["thin_t"] = torch.full((1, 1), 0.5)
    with torch.no_grad():
        ref["thin"] = thin(inputs["thin_x"], inputs["thin_t"])

    # the DDPM UNet (integer t), random weights from a seed
    from sr3d_torch.models.ddpm_unet import DDPMUNet
    ddpm = DDPMUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                    attn_res=(8,), res_blocks=1, image_size=16,
                    dtype=torch.float32).eval()
    init_lecun_normal_(ddpm, torch.Generator().manual_seed(2))
    inputs["ddpm_sd"] = ddpm.state_dict()
    inputs["ddpm_x"] = torch.randn(2, 6, 16, 16,
                                   generator=torch.Generator().manual_seed(3))
    inputs["ddpm_t"] = torch.tensor([3, 17])
    with torch.no_grad():
        ref["ddpm"] = ddpm(inputs["ddpm_x"], inputs["ddpm_t"])

    torch.save(inputs, root / "inputs.pt")
    worker.run_world(4, root, SCENARIOS)
    yield root, inputs, ref
    shutil.rmtree(root, ignore_errors=True)


def _all(root, name):
    return [worker.load(root, name, r) for r in range(4)]


def test_tp_sharded_unet_matches_replicated(world):
    """dp2×tp2: the wide tiny UNet with its ≥ 128-channel weights split
    over the model axis equals the one-device forward and JAX's
    (2e-4)."""
    root, inputs, ref = world
    unet = worker.tiny_unet(inner=64)
    unet.load_state_dict(inputs["wide_sd"])
    with torch.no_grad():
        one = unet(inputs["wide_x"], inputs["wide_t"])
    for out in _all(root, "tp_forward"):
        assert out["split"], "no weight split over the model axis"
        np.testing.assert_allclose(out["out"].numpy(), one.numpy(),
                                   atol=2e-4)
        np.testing.assert_allclose(out["out"].permute(0, 2, 3, 1).numpy(),
                                   ref["wide_jax"], atol=2e-4)


def _jax_split(shardings) -> set:
    """The port names (``utils/bridge.py``'s) of the leaves a JAX sharding
    tree splits over the model axis."""
    out = set()
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        if "model" in str(s.spec):
            keys = [k.key for k in path]
            keys = keys[1:] if keys[0] == "params" else keys
            keys[-1] = {"kernel": "weight"}.get(keys[-1], keys[-1])
            out.add(".".join(keys))
    return out


def test_state_shardings_pick_jax_leaves(world):
    """For the same model-axis size and ``min_channels``, the port splits
    the weights JAX's ``tp_param_sharding`` / ``state_shardings`` split,
    named through ``utils/bridge.py``, and the world's modules split those
    weights."""
    root, _, ref = world
    jmesh = make_mesh((4, 2))
    mesh = Mesh((2, 2), ("data", "model"))
    unet = worker.tiny_unet(inner=64)
    port = {n for n, a in tp_param_sharding(mesh, unet).items() if a}
    wp = ref["wide_params"]
    assert port == _jax_split(jsteps.tp_param_sharding(jmesh, wp))
    assert port == set(_all(root, "tp_forward")[0]["split"])
    js = ref["jax_state"].params
    jsh = jsteps.state_shardings(jmesh, js, min_channels=16)
    specs = state_shardings(mesh, ref["joint_modules"], min_channels=16)
    for part in ("sr", "arcface", "mapping"):
        mine = {n for n, a in specs[part].items() if a}
        assert mine, part
        assert mine == _jax_split(jsh[part]), part
        for out in _all(root, "tp_step"):
            assert set(out["split"].get(part, [])) == mine, part


def test_tp_joint_step_matches_one_device(world):
    """The tiny joint step at dp2×tp2 (weights of ≥ 16 output channels
    split): the losses equal the one-device step's (2e-5), and its
    checkpoint, written from the gathered shards by rank 0, equals the
    one-device step's leaf for leaf (``_ckpt_close``)."""
    root, _, ref = world
    for out in _all(root, "tp_step"):
        for k in ("l_sr", "l_mica", "loss"):
            np.testing.assert_allclose(float(out["metrics"][k]),
                                       ref["one_joint"][k], rtol=2e-5,
                                       err_msg=k)
    _ckpt_close(root / "tp.npz", root / "one.npz", steps=1)


def test_tp_background_checkpoint_is_the_state_at_save(world):
    """Rank 0's background checkpoint, its copy taken inside
    ``unsharded`` and its write held until one more step ran on the
    shards, equals the synchronous save of the same state leaf for
    leaf."""
    root, _, _ = world
    assert all(out["held"] for out in _all(root, "tp_step"))
    a = tc.npz_leaves(root / "tp.npz")
    b = tc.npz_leaves(root / "tp_async" / "ckpt_0000000001.npz")
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    # the control: the state one step on differs (the step changed it)
    assert any(not np.array_equal(x, y) for x, y in zip(a, tc.npz_leaves(
        root / "tp_next.npz")))


def test_one_device_checkpoint_resharded_under_tp(world):
    """The reverse: a one-device checkpoint read under dp2×tp2 is split
    (every split weight keeps its shard's shape) and written back from
    the shards bit for bit."""
    root, _, _ = world
    assert all(out["reshard"] for out in _all(root, "tp_step"))
    a, b = tc.npz_leaves(root / "one.npz"), \
        tc.npz_leaves(root / "one_again.npz")
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")


def test_spatial_sharded_sampling_matches_replicated(world):
    """The image height split over 2 (a 2×2 mesh, the data ranks
    replicating) and 4 ranks: the sampled images equal the one-device loop
    on the same draws (1e-5) and JAX's loop (1e-4, the sampler tolerance
    of ``tests/test_torch_unet.py``)."""
    root, inputs, ref = world
    unet = worker.tiny_unet()
    unet.load_state_dict(inputs["unet_sd"])
    one = tg.p_sample_loop(unet, t_schedule("linear", 20, 1e-4, 2e-2),
                           inputs["cond2"], noise=inputs["noise2"])
    for out in _all(root, "spatial_sample"):
        for tag in ("model2", "model4"):
            np.testing.assert_allclose(out[tag].numpy(), one.numpy(),
                                       atol=1e-5, err_msg=tag)
            np.testing.assert_allclose(out[tag].permute(0, 2, 3, 1).numpy(),
                                       ref["spatial_jax"], atol=1e-4,
                                       err_msg=tag)


@pytest.mark.parametrize("tag", ["model2", "model4"])
def test_flagship_geometry_spatial(world, tag):
    """The flagship's topology (mults 1, 2, 4, 8, 8, attention at 16²;
    128 → 8 rows over the levels) at inner width 16, one face: its height
    split over 2 ranks (down to 8 rows as 4 + 4) and over 4 (8 rows as 2 ×
    4): every level's halo and band, the stride-2 convs, the Upsample and
    the mid-block attention over gathered rows equal the one-device
    forward (1e-4)."""
    root, _, ref = world
    for out in _all(root, "flagship_geometry"):
        np.testing.assert_allclose(out[tag].numpy(), ref["thin"].numpy(),
                                   atol=1e-4)


def test_ddpm_unet_spatial_matches_one_device(world):
    """The DDPM family (integer timesteps; ``define_g`` builds it for the
    joint path too) runs the same hooks: split over 2 and 4 ranks it equals
    the one-device forward (1e-5)."""
    root, _, ref = world
    for out in _all(root, "ddpm_spatial"):
        for tag in ("model2", "model4"):
            np.testing.assert_allclose(out[tag].numpy(), ref["ddpm"].numpy(),
                                       atol=1e-5, err_msg=tag)
