"""The port's data-parallel and spatial layer on a world of 2 ``gloo``
processes on the CPU, against the JAX package's mesh results (8 virtual
CPU devices, ``tests/conftest.py``) and the port's one-device results:
``tests/test_parallel.py`` case by case, the ``Predictor``'s mesh modes,
the Trainer over ``tpu.mesh_shape`` [2, 1], and one test for each
statistic that must be the global tensor's (the draws, BatchNorm, the
int8 scale, GroupNorm over bands, the loss means), each built so that a
per-rank version fails it.

One world runs every scenario once (``tests/test_torch_parallel_worker.py``,
no JAX), from inputs this module writes; each test reads its results.
"""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import NamedSharding, PartitionSpec as P

from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.diffusion import gaussian as tg
from sr3d_torch.diffusion.schedules import make_schedule as t_schedule
from sr3d_torch.kernels.groupnorm_swish import gn_swish_apply
from sr3d_torch.models.arcface import BatchNorm
from sr3d_torch.models.sr3_unet import GroupNorm, GroupNormSwish
from sr3d_torch.ops.quant import Int8Conv
from sr3d_torch.serve import Predictor, apply_serving_flags
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train import joint as tj
from sr3d_torch.train.trainer import Trainer
from sr3d_torch.utils.bridge import (export_jax_params, flax_to_state_dict,
                                     load_jax_params)
from sr3d_tpu.config.defaults import get_cfg_defaults
from sr3d_tpu.diffusion import gaussian as jg
from sr3d_tpu.parallel.mesh import batch_sharding, make_mesh
from sr3d_tpu.train import joint as jj
from tests import test_torch_parallel_worker as worker
from tests.test_torch_train import (EMA_CFG, batch_of, nchw,
                                    replayed_draws, tiny_cfg)
from tests.test_torch_trainer import TINY, _overlay, _workspace

torch.set_num_threads(1)

SCENARIOS = ("mesh", "toy", "dp_sample", "joint", "predictor", "trainer",
             "noise", "batchnorm", "int8", "groupnorm", "failed_write")


def _noise(key, shape, order):
    k_init, k_loop = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape, jnp.float32)]
    draws += [jax.random.normal(jax.random.fold_in(k_loop, int(i)), shape,
                                jnp.float32) for i in order]
    return [nchw(d) for d in draws]


def _jax_joint(n):
    """JAX's tiny model2 step (DDIM-4 hand-off) on an 8-way data mesh: its
    initial state, metrics and new parameters."""
    cfg = tiny_cfg(get_cfg_defaults(), "ddim")
    mods = jj.build_joint(cfg)
    opt = jj.make_optimizer(cfg)
    state = jj.init_train_state(mods, cfg, jax.random.PRNGKey(0), 16)
    b = batch_of(n=n)
    mesh = make_mesh((8, 1))
    repl = NamedSharding(mesh, P())
    step = jax.jit(jj.make_train_step(opt, EMA_CFG))
    new, met = step(
        jax.tree_util.tree_map(lambda a: jax.device_put(a, repl), mods),
        jax.device_put(state, repl),
        {k: jax.device_put(v, batch_sharding(mesh, ndim=v.ndim))
         for k, v in b.items()},
        jax.device_put(jax.random.PRNGKey(3), repl))
    params = jax.tree.map(np.asarray, {
        "sr": state.params["sr"], "arcface": state.params["arcface"],
        "arcface_stats": state.arcface_stats,
        "mapping": state.params["mapping"]})
    return params, {k: float(met[k]) for k in ("l_sr", "l_mica", "loss")}, \
        jax.tree.map(np.asarray, new.params), b


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel2")
    rng = np.random.RandomState(0)
    inputs, ref = {}, {}

    # toy step
    inputs["toy"] = {"x": rng.randn(16, 3).astype(np.float32),
                     "y": rng.randn(16, 3).astype(np.float32)}

    # DP sampling: the conftest tiny UNet's geometry, JAX weights and noise
    from sr3d_tpu.diffusion.schedules import make_schedule
    from sr3d_tpu.models.sr3_unet import SR3UNet as JUNet
    junet = JUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                  attn_res=(8,), res_blocks=1, dropout=0.0, image_size=16,
                  dtype=jnp.float32)
    jparams = junet.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 6)),
                         jnp.zeros((1, 1)))
    inputs["unet_sd"] = flax_to_state_dict(jax.tree.map(np.asarray,
                                                        jparams))
    cond = np.random.RandomState(0).uniform(-1, 1, (8, 16, 16, 3)) \
        .astype(np.float32)
    jsched = make_schedule("linear", 20, 1e-4, 2e-2)
    ref["jax_sample"] = np.asarray(jax.jit(
        lambda p, c, k: jg.p_sample_loop(
            lambda x, t: junet.apply(p, x, t), jsched, c, k).final)(
        jparams, cond, jax.random.PRNGKey(3)))
    inputs["cond8"] = nchw(cond)
    inputs["noise8"] = _noise(jax.random.PRNGKey(3), cond.shape, range(20))

    # the joint step: JAX on its 8-way mesh, the port on one device
    params, ref["jax_joint"], ref["jax_joint_params"], b = _jax_joint(8)
    tcfg = tiny_cfg(t_defaults(), "ddim")
    T = tcfg.sr.model.beta_schedule.train.n_timestep
    t, u, noise, hand = replayed_draws(jax.random.PRNGKey(3),
                                       (8, 16, 16, 3), T, range(3, -1, -1))
    sched = t_schedule("linear", T, 1e-4, 5e-2)
    _, gamma = tg.sample_continuous_gamma(sched, 8, t=torch.tensor(t), u=u)
    inputs.update(joint_cfg=tcfg, joint_params=params, ema_cfg=EMA_CFG,
                  joint_batch={k: torch.from_numpy(np.asarray(v))
                               for k, v in b.items()},
                  joint_draws={"gamma": gamma, "noise": noise,
                               "handoff": hand})
    mods = tj.build_joint(tcfg, device="cpu")
    load_jax_params(mods, params)
    st = tj.init_train_state(mods, tcfg)
    st, met = tj.make_train_step(EMA_CFG)(mods, st, inputs["joint_batch"],
                                          draws=inputs["joint_draws"])
    ref["one_joint"] = {k: float(v) for k, v in met.items()}
    ref["one_joint_params"] = export_jax_params(mods)
    ref["lrs"] = {g["name"]: g["lr"] for g in st.opt.param_groups}

    # the Predictor at the tiny config in fp32 (in bf16 a band's conv
    # rounds unlike the whole image's); a 4-block ArcFace keeps it quick
    scfg = t_update(t_defaults(), str(TINY))
    scfg.mica.model.arcface_layers = [1, 1, 1, 1]
    scfg.tpu.compute_dtype = "float32"
    inputs["serve_cfg"] = scfg
    inputs["serve_lr"] = rng.randint(0, 256, (3, 8, 8, 3)).astype(np.uint8)
    for tag, c in (("fp", scfg), ("int8", apply_serving_flags(scfg.clone()))):
        ref["predict_" + tag] = Predictor.from_config(
            c, init_seed=0, batch_size=2, device="cpu").predict(
            inputs["serve_lr"])

    # the Trainer: one device, 3 steps, checkpoints at 2 and 3
    ws = _workspace(root / "ws")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        one = t_update(t_defaults(), str(_overlay(ws, "one",
                                                  cadenced=False,
                                                  checkpoint_steps=1)))
        tr = Trainer(one, device="cpu")
        tr.prepare_data()
        tr.training_step(max_steps=3)
    for name in ("mesh", "resume"):
        path = _overlay(ws, name, cadenced=False)
        tree = yaml.safe_load(path.read_text())
        tree["tpu"]["mesh_shape"] = [2, 1]
        path.write_text(yaml.safe_dump(tree))
    inputs["trainer_ws"] = str(ws)

    # the statistics of the global tensor
    x = rng.randn(8, 4, 3, 3).astype(np.float32)
    x[4:] += 3.0          # the second rank's rows: another mean
    inputs["bn_x"] = torch.from_numpy(x)
    x = rng.randn(4, 4, 6, 6).astype(np.float32)
    x[2:] *= 10.0         # the second rank's rows: another abs-max
    x[:, :, 3:] *= 3.0    # the lower band: another abs-max
    inputs["int8_x"] = torch.from_numpy(x)
    conv = Int8Conv(4, 8, 3, padding=1)
    inputs["int8_sd"] = conv.state_dict()
    x = rng.randn(2, 8, 8, 4).astype(np.float32)
    x[:, :, 4:] += 2.0    # the lower band: another mean
    inputs["gn_x"] = torch.from_numpy(x)
    inputs["gn_sd"] = {"scale": torch.from_numpy(
        rng.uniform(0.5, 1.5, 8).astype(np.float32)),
        "bias": torch.from_numpy(rng.randn(8).astype(np.float32) * 0.1)}

    torch.save(inputs, root / "inputs.pt")
    worker.run_world(2, root, SCENARIOS)
    yield root, inputs, ref
    shutil.rmtree(root, ignore_errors=True)


def _both(root, name):
    return [worker.load(root, name, r) for r in range(2)]


def test_mesh_construction(world):
    root, _, _ = world
    for r, out in enumerate(_both(root, "mesh")):
        assert out["shapes"]["(2, 1)"] == ({"data": 2, "model": 1}, r, 0)
        assert out["shapes"]["(-1, 1)"][0] == {"data": 2, "model": 1}
        assert out["shapes"]["(-1, 2)"] == ({"data": 1, "model": 2}, 0, r)
        assert out["shapes"]["(1, 2)"][0] == {"data": 1, "model": 2}
        assert torch.equal(out["replicated"], torch.zeros(2, 3))
        np.testing.assert_array_equal(out["local_rows"]["x"],
                                      np.arange(8).reshape(4, 2)[2 * r:
                                                                 2 * r + 2])
        assert out["local_rows"]["n"] == "keep"
        assert "not divisible by the data axis (2)" in out["odd"]


def test_mesh_too_big_raises(world):
    root, _, _ = world
    for out in _both(root, "mesh"):
        assert "needs 4 devices, have 2" in out["(4, 1)"]
        assert "covers 1 of the world's 2 ranks" in out["(1, 1)"]


def test_dp_train_step_matches_single_device(world):
    """``tests/test_parallel.py``'s toy step, 2-way DP == one device, and
    == the JAX step."""
    root, inputs, _ = world
    x, y = (torch.from_numpy(inputs["toy"][k]) for k in "xy")
    w = torch.full((3,), 0.5, requires_grad=True)
    loss = ((x * w - y) ** 2).mean()
    loss.backward()
    w1 = (w - 0.1 * w.grad).detach()

    def jstep(w):
        loss, g = jax.value_and_grad(
            lambda w: jnp.mean((inputs["toy"]["x"] * w
                                - inputs["toy"]["y"]) ** 2))(w)
        return w - 0.1 * g, loss

    wj, lj = jax.jit(jstep)(jnp.full((3,), 0.5))
    for out in _both(root, "toy"):
        np.testing.assert_allclose(out["w"].numpy(), w1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(out["w"].numpy(), np.asarray(wj),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(out["loss"]), float(loss.detach()),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(out["loss"]), float(lj), rtol=1e-6)


def test_sharded_sampling_matches_replicated(world):
    """DP sampling (4 + 4 rows) == the one-device loop on the same draws
    (1e-5), and == JAX's loop (the sampler tolerance of
    ``tests/test_torch_unet.py``, 1e-4)."""
    root, inputs, ref = world
    unet = worker.tiny_unet()
    unet.load_state_dict(inputs["unet_sd"])
    one = tg.p_sample_loop(unet, t_schedule("linear", 20, 1e-4, 2e-2),
                           inputs["cond8"], noise=inputs["noise8"])
    for out in _both(root, "dp_sample"):
        assert out["out"].shape == (8, 3, 16, 16)
        np.testing.assert_allclose(out["out"].numpy(), one.numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(out["out"].permute(0, 2, 3, 1).numpy(),
                                   ref["jax_sample"], atol=1e-4)


def test_ddim_handoff_joint_step_dp_matches_single(world):
    """The tiny model2 step with the DDIM hand-off, 2-way DP: the losses
    equal the port's one-device step (2e-5) and JAX's 8-way mesh step
    (``tests/test_torch_train.py``'s tolerances: through the uint8
    hand-off ~0.2% of values sit on rounding ties between the
    frameworks); the new parameters equal the one-device step's within
    1e-5 of each leaf's largest entry but for Adam's first update on
    elements whose gradient is rounding noise (at most 2·lr off, in at
    most 1% of a network's elements), and JAX's the same way."""
    root, _, ref = world
    for out in _both(root, "joint"):
        met = out["metrics"]
        for k in ("l_sr", "l_mica", "loss"):
            np.testing.assert_allclose(float(met[k]), ref["one_joint"][k],
                                       rtol=2e-5, err_msg=k)
        np.testing.assert_allclose(float(met["l_sr"]),
                                   ref["jax_joint"]["l_sr"], rtol=1e-5)
        for k in ("l_mica", "loss"):
            np.testing.assert_allclose(float(met[k]), ref["jax_joint"][k],
                                       rtol=1e-4, err_msg=k)
        for against, lr_bound in ((ref["one_joint_params"], 1e-5),
                                  (ref["jax_joint_params"], 1e-6)):
            for part in ("sr", "arcface", "mapping"):
                mine = flax_to_state_dict(out["params"][part])
                theirs = flax_to_state_dict(against[part])
                off = total = 0
                for n, p in theirs.items():
                    d = (mine[n] - p).abs()
                    tol = lr_bound * max(float(p.abs().max()), 1.0)
                    assert float(d.max()) <= 2 * ref["lrs"][part] + tol, \
                        f"{part}.{n}"
                    off += int((d > tol).sum())
                    total += d.numel()
                assert off <= 0.01 * total, f"{part}: {off} of {total}"


def _predict_close(got, want, int8):
    """One sharded request against the one-device one.  fp32: the sample
    differs in the last bits at most (a band's or a row's conv sums in
    another blocking), so at most 0.1% of the uint8 values move, by one
    level, and the MICA outputs hold to 1e-5.  int8: the same last-bit
    differences move an activation across a quantization step now and
    then, and the 20 sampling steps carry that on: the uint8 image holds
    to 4 levels (under 1 on average), the vertices and landmarks to 1e-4,
    the shape code to 1e-3 (the one-device int8 request against the fp
    one differs by far more)."""
    d = np.abs(got["sr_u8"].astype(int) - want["sr_u8"].astype(int))
    if int8:
        assert d.max() <= 4 and d.mean() < 1.0, (d.max(), d.mean())
        tol = {"verts": 1e-4, "lmk68": 1e-4, "identity": 1e-3}
    else:
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), d.mean())
        tol = dict.fromkeys(("verts", "lmk68", "identity"), 1e-5)
    for k, t in tol.items():
        np.testing.assert_allclose(got[k], want[k], atol=t, err_msg=k)


def test_dp_predictor_matches_one_device(world):
    """``Predictor(mesh=)`` (2-way DP, a request of 3 in chunks of 2, the
    draws the one-device run's), fp32 and int8: every rank returns the
    whole request, equal to the one-device request (``_predict_close``)."""
    root, _, ref = world
    for out in _both(root, "predictor"):
        _predict_close(out["dp"], ref["predict_fp"], int8=False)
        _predict_close(out["dp_int8"], ref["predict_int8"], int8=True)


def test_spatial_predictor_matches_one_device(world):
    """``Predictor(mesh=, spatial=True)``: 16 rows split 8 + 8 (4 + 4 at
    the lower level), fp32 and int8, equal to the one-device request."""
    root, _, ref = world
    for out in _both(root, "predictor"):
        _predict_close(out["spatial"], ref["predict_fp"], int8=False)
        _predict_close(out["spatial_int8"], ref["predict_int8"], int8=True)


def test_predictor_mesh_value_errors(world):
    root, _, _ = world
    for out in _both(root, "predictor"):
        assert "batch_size 3 not divisible by the data axis (2)" \
            in out["errors"]["batch"]
        assert "image height 17 not divisible by the model axis (2)" \
            in out["errors"]["height"]


def _ckpt_close(a_path, b_path, steps, rel=1e-5, lr=1e-3):
    """Two train-state files leaf for leaf: the integer leaves equal; 99%
    of all float elements within ``rel`` of their leaf's largest entry,
    and none further than Adam can move an element in ``steps`` updates
    at the largest learning rate ``lr`` from runs whose gradients differ
    in their rounding (an element whose gradient is rounding noise, as
    ArcFace's ``bn2`` bias's, moves by ~lr either way)."""
    a, b = tc.npz_leaves(a_path), tc.npz_leaves(b_path)
    assert len(a) == len(b)
    off = total = 0
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape, i
        if x.dtype.kind != "f":
            np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
            continue
        d = np.abs(x - y)
        tol = rel * float(np.abs(y).max())
        assert float(d.max()) <= 2 * lr * steps + tol, \
            f"leaf {i}: max {float(d.max())}"
        off += int((d > tol + 1e-12).sum())
        total += d.size
    assert off <= 0.01 * total, f"{off} of {total} elements apart"


def test_trainer_mesh_matches_one_device(world):
    """``cli.main`` under ``tpu.mesh_shape`` [2, 1] for 2 steps: rank 0
    alone writes the checkpoint, which one process loads and which equals
    the one-device run's; a one-device checkpoint resumed under the mesh
    for a step equals the one-device run's third step."""
    root, inputs, _ = world
    out = worker.load(root, "trainer")
    assert out == worker.load(root, "trainer", 1)
    assert "mesh/checkpoint/ckpt_0000000002.npz" in out["files"]
    assert "resume/checkpoint/ckpt_0000000003.npz" in out["files"]
    ws = root / "ws" / "out"
    _ckpt_close(ws / "mesh/checkpoint/ckpt_0000000002.npz",
                ws / "one/checkpoint/ckpt_0000000002.npz", steps=2)
    _ckpt_close(ws / "resume/checkpoint/ckpt_0000000003.npz",
                ws / "one/checkpoint/ckpt_0000000003.npz", steps=1)
    one = t_update(t_defaults(), str(root / "ws" / "one.yml"))
    tr = Trainer(one, device="cpu")
    assert tr.load_checkpoint(str(ws / "mesh/checkpoint/"
                                  "ckpt_0000000002.npz"))
    assert tr.global_step == 2


def test_trainer_failed_write_keeps_ranks_together(world):
    """A write that raises on rank 0 and is caught, as the Trainer's
    visualisation is, still brings every rank to the barrier after it, so
    the next collective pairs up on both ranks."""
    root, _, _ = world
    a, b = _both(root, "failed_write")
    assert a == {"raised": True, "sum": 3.0}, a
    assert b == {"sum": 3.0}, b


def test_semantics_noise_is_the_global_draw(world):
    """Item 1: under the data and the spatial layout a rank's draw is its
    rows or band of the global draw from the shared generator; a per-rank
    draw of the local shape is not."""
    root, _, _ = world
    full = torch.randn(8, 3, 16, 8, generator=torch.Generator()
                       .manual_seed(5))
    for r, out in enumerate(_both(root, "noise")):
        rows = torch.randn(8, 3, 8, 8,
                           generator=torch.Generator().manual_seed(5))
        assert torch.equal(out["dp"], rows[4 * r:4 * r + 4])
        assert torch.equal(out["spatial"], full[:, :, 8 * r:8 * r + 8])
        if r == 1:
            assert not torch.equal(out["dp"], out["dp_per_rank"])
            assert not torch.equal(out["spatial"], out["spatial_per_rank"])


def test_semantics_batchnorm_is_over_the_global_batch(world):
    """Item 2: ArcFace's train-mode BatchNorm over 4 + 4 rows whose means
    differ: the output and the running statistics are the 8-row batch's;
    per-rank statistics give another output."""
    root, inputs, _ = world
    bn = BatchNorm(4).train()
    y = bn(inputs["bn_x"]).detach()
    for r, out in enumerate(_both(root, "batchnorm")):
        np.testing.assert_allclose(out["y"].numpy(), y[4 * r:4 * r + 4]
                                   .numpy(), atol=1e-5)
        np.testing.assert_allclose(out["mean"].numpy(), bn.mean.numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(out["var"].numpy(), bn.var.numpy(),
                                   atol=1e-5)
        per_rank = BatchNorm(4).train()(inputs["bn_x"][4 * r:4 * r + 4]).detach()
        assert float((per_rank - y[4 * r:4 * r + 4]).abs().max()) > 0.5


def test_semantics_int8_scale_is_over_the_whole_tensor(world):
    """Item 3: the dynamic int8 scale under DP (rows whose abs-max differ
    10×) and under spatial (bands whose abs-max differ 3×) is the whole
    tensor's: the outputs equal the one-device conv's bit for bit; a
    per-rank scale gives others."""
    root, inputs, _ = world
    conv = Int8Conv(4, 8, 3, padding=1)
    conv.load_state_dict(inputs["int8_sd"])
    x = inputs["int8_x"]
    y = conv(x, quant=True)
    for r, out in enumerate(_both(root, "int8")):
        assert torch.equal(out["dp"], y[2 * r:2 * r + 2])
        assert torch.equal(out["spatial"], y[:, :, 3 * r:3 * r + 3])
        per_rank = conv(x[2 * r:2 * r + 2], quant=True)
        if r == 0:
            assert not torch.equal(per_rank, y[:2])


def test_semantics_groupnorm_is_over_the_whole_image(world):
    """Item 4: GroupNorm+Swish (``gn_stats`` per band, the moments summed,
    the apply with the whole image's count) and attention's GroupNorm over
    bands of 4 + 4 rows whose means differ equal the whole image's; the
    band's own statistics, or the band's count, give others."""
    root, inputs, _ = world
    gns, gn = GroupNormSwish(8, 4), GroupNorm(8, 4)
    gns.load_state_dict(inputs["gn_sd"])
    gn.load_state_dict(inputs["gn_sd"])
    x = inputs["gn_x"]
    with torch.no_grad():
        want_s, want = gns(x), gn(x)
    for r, out in enumerate(_both(root, "groupnorm")):
        np.testing.assert_allclose(out["gn_swish"].numpy(),
                                   want_s[:, :, 4 * r:4 * r + 4].numpy(),
                                   atol=1e-5)
        np.testing.assert_allclose(out["gn"].numpy(),
                                   want[:, :, 4 * r:4 * r + 4].numpy(),
                                   atol=1e-5)
        band = x[:, :, 4 * r:4 * r + 4]
        with torch.no_grad():
            own = gns(band)
        assert float((own - want_s[:, :, 4 * r:4 * r + 4])
                     .abs().max()) > 0.1
        s = band.sum((2, 3)) * 2      # the moments of a band, doubled ...
        q = (band * band).sum((2, 3)) * 2
        with torch.no_grad():
            wrong = gn_swish_apply(band, s, q, gns.scale, gns.bias, 4,
                                   count=32)   # ... over the band's count
        assert float((wrong - want_s[:, :, 4 * r:4 * r + 4])
                     .abs().max()) > 0.1


def test_semantics_loss_means_are_the_global_batch(world):
    """Item 5: every loss of the joint step is a mean over the batch
    (``sr_loss`` divides by the elements, ``masked_vertex_l1`` is a plain
    mean), so the DP step's metrics are the ranks' means averaged — the
    one-device values — while each rank's own mean is not."""
    root, _, ref = world
    outs = _both(root, "joint")
    for k in ("l_sr", "l_mica", "loss"):
        mean = (float(outs[0]["local"][k]) + float(outs[1]["local"][k])) / 2
        np.testing.assert_allclose(mean, ref["one_joint"][k], rtol=2e-5)
        assert abs(float(outs[0]["local"][k]) - ref["one_joint"][k]) \
            > 1e-4 * abs(ref["one_joint"][k]), k
