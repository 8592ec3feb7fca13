"""The ranks of the port's parallel tests: a world of ``gloo`` processes on
the CPU that runs named scenarios and saves each rank's results.

It imports no JAX (each rank is a fresh process); the JAX references are
computed by the test modules (``tests/test_torch_parallel*.py``) in the
parent, which writes the inputs (``inputs.pt``) and reads the results
(``{scenario}.r{rank}.pt``) from a temporary directory.  This file holds
no tests.
"""

from __future__ import annotations

import functools
import socket
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sr3d_torch import parallel as par
from sr3d_torch.parallel import layout as lay

SCENARIOS: dict = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank(rank: int, world: int, port: int, root: str, names: list) -> None:
    torch.set_num_threads(1)
    # the Trainer's metrics sink would import TensorFlow for TensorBoard
    sys.modules["torch.utils.tensorboard"] = None
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        root_p = Path(root)
        inputs = torch.load(root_p / "inputs.pt", weights_only=False)
        seconds = {}
        for name in names:
            t0 = time.perf_counter()
            out = SCENARIOS[name](inputs, root_p)
            torch.save(out, root_p / f"{name}.r{rank}.pt")
            dist.barrier()
            seconds[name] = time.perf_counter() - t0
        torch.save(seconds, root_p / f"seconds.r{rank}.pt")
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()


def run_world(world: int, root: Path, names: list, timeout: float = 600.0
              ) -> None:
    """Spawn ``world`` ranks that run ``names``; raises with a rank's error
    text where one fails, and kills them all where they outlast
    ``timeout`` seconds."""
    ctx = mp.start_processes(_rank, args=(world, _free_port(), str(root),
                                          list(names)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=2):
            if time.monotonic() > deadline:
                raise TimeoutError(f"a world of {world} ranks ran past "
                                   f"{timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def load(root: Path, name: str, rank: int = 0):
    return torch.load(root / f"{name}.r{rank}.pt", weights_only=False)


def _mesh(shape):
    return par.make_mesh(shape)


def tiny_unet(inner: int = 16, **kw):
    from sr3d_torch.models.sr3_unet import SR3UNet

    args = dict(inner_channel=inner, norm_groups=8, channel_mults=(1, 2),
                attn_res=(8,), res_blocks=1, dropout=0.0, image_size=16,
                dtype=torch.float32)
    args.update(kw)
    return SR3UNet(**args).eval()


# --------------------------------------------------------------------------
# world of 2
# --------------------------------------------------------------------------

@scenario
def mesh(inputs, root):
    out = {"shapes": {}}
    for shape in ((2, 1), (-1, 1), (-1, 2), (1, 2)):
        m = _mesh(shape)
        out["shapes"][str(shape)] = (m.shape, m.axis("data").index,
                                     m.axis("model").index)
    for shape in ((4, 1), (1, 1)):
        try:
            _mesh(shape)
            out[str(shape)] = None
        except ValueError as e:
            out[str(shape)] = str(e)
    # replicated: rank 1's differing weights become rank 0's
    lin = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(lin.weight, float(dist.get_rank()))
    par.replicated(_mesh((2, 1)), lin)
    out["replicated"] = lin.weight.detach().clone()
    out["local_rows"] = par.local_rows(
        {"x": np.arange(8).reshape(4, 2), "n": "keep"},
        _mesh((2, 1)).axis("data"))
    try:
        par.local_rows({"x": np.zeros((3, 2))}, _mesh((2, 1)).axis("data"))
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    return out


def toy_step(state, batch):
    """``tests/test_parallel.py``'s toy step: MSE of ``x·w`` against
    ``y``, SGD 0.1."""
    w, opt = state
    opt.zero_grad()
    loss = ((batch["x"] * w - batch["y"]) ** 2).mean()
    loss.backward()
    lay.average_gradients([w])
    opt.step()
    return state, {"loss": loss.detach()}


@scenario
def toy(inputs, root):
    w = torch.full((3,), 0.5, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.1)
    step = par.pjit_train_step(toy_step, _mesh((2, 1)))
    (_, _), m = step((w, opt), {k: torch.from_numpy(v)
                                for k, v in inputs["toy"].items()})
    return {"w": w.detach().clone(), "loss": m["loss"]}


def _sample(unet, sched, cond, noise):
    from sr3d_torch.diffusion import gaussian as tg

    return tg.p_sample_loop(unet, sched, cond, noise=noise)


@scenario
def dp_sample(inputs, root):
    from sr3d_torch.diffusion.schedules import make_schedule

    unet = tiny_unet()
    unet.load_state_dict(inputs["unet_sd"])
    sched = make_schedule("linear", 20, 1e-4, 2e-2)
    fn = par.pjit_sample(functools.partial(_sample, unet, sched),
                         _mesh((2, 1)))
    return {"out": fn(inputs["cond8"], noise=inputs["noise8"])}


def joint_modules(inputs):
    """The tiny joint model on the CPU with the parent's JAX weights."""
    from sr3d_torch.train import joint as tj
    from sr3d_torch.utils.bridge import load_jax_params

    mods = tj.build_joint(inputs["joint_cfg"], device="cpu")
    load_jax_params(mods, inputs["joint_params"])
    return mods


@scenario
def joint(inputs, root):
    from sr3d_torch.train import joint as tj
    from sr3d_torch.utils.bridge import export_jax_params

    mods = joint_modules(inputs)
    state = tj.init_train_state(mods, inputs["joint_cfg"])
    inner = tj.make_train_step(inputs["ema_cfg"])
    local = {}

    def spy(modules, state, batch, **kw):
        st, m = inner(modules, state, batch, **kw)
        local.update({k: v.clone() for k, v in m.items()})
        return st, m

    step = par.pjit_train_step(spy, _mesh((2, 1)), batch_argnum=2)
    state, met = step(mods, state, inputs["joint_batch"],
                      draws=inputs["joint_draws"])
    return {"metrics": met, "local": local,
            "params": export_jax_params(mods)}


@scenario
def predictor(inputs, root):
    from sr3d_torch.serve import Predictor, apply_serving_flags

    out = {}
    cfg = inputs["serve_cfg"]
    lr = inputs["serve_lr"]
    for tag, shape, spatial in (("dp", (2, 1), False),
                                ("spatial", (1, 2), True)):
        p = Predictor.from_config(cfg, init_seed=0, batch_size=2,
                                  device="cpu", mesh=_mesh(shape),
                                  spatial=spatial)
        out[tag] = p.predict(lr)
    int8 = apply_serving_flags(cfg.clone())
    for tag, shape, spatial in (("dp_int8", (2, 1), False),
                                ("spatial_int8", (1, 2), True)):
        p = Predictor.from_config(int8, init_seed=0, batch_size=2,
                                  device="cpu", mesh=_mesh(shape),
                                  spatial=spatial)
        out[tag] = p.predict(lr)
    errors = {}
    for tag, kw in (("batch", dict(batch_size=3, mesh=_mesh((2, 1)))),
                    ("height", dict(mesh=_mesh((1, 2)), spatial=True))):
        c = cfg.clone()
        if tag == "height":
            c.sr.datasets.val.r_resolution = 17
        try:
            Predictor(c, p.modules, **kw)
            errors[tag] = None
        except ValueError as e:
            errors[tag] = str(e)
    out["errors"] = errors
    return out


@scenario
def trainer(inputs, root):
    from sr3d_torch.cli import main as tcli

    ws = Path(inputs["trainer_ws"])
    assert tcli.main(["-p", "train", "-c", str(ws / "mesh.yml"),
                      "--max-steps", "2"], device="cpu") == 0
    # a one-device checkpoint resumed under the mesh, one more step
    assert tcli.main(["-p", "train", "-c", str(ws / "resume.yml"), "-ckt",
                      str(ws / "out" / "one" / "checkpoint"
                          / "ckpt_0000000002.npz"),
                      "--max-steps", "1"], device="cpu") == 0
    return {"files": sorted(str(p.relative_to(ws / "out"))
                            for p in (ws / "out").rglob("*.npz"))}


@scenario
def failed_write(inputs, root):
    """A write that raises on rank 0 inside ``Trainer._written`` and is
    caught there, as the Trainer catches a failed visualisation: every
    rank must still meet at the barrier, so that the next collective pairs
    up.  The barrier and the collective run on a group with a 10 s
    timeout, so that a rank left behind shows as an error, not a hang."""
    import datetime
    import types

    from sr3d_torch.train import trainer as tt

    group = dist.new_group(timeout=datetime.timedelta(seconds=10))
    saved = tt.barrier
    tt.barrier = lambda: dist.barrier(group=group)
    host = types.SimpleNamespace(_main=dist.get_rank() == 0)

    def write():
        raise OSError("no space left on device")

    out = {}
    try:
        try:
            tt.Trainer._written(host, write)
        except OSError:
            out["raised"] = True
        t = torch.tensor([float(dist.get_rank() + 1)])
        dist.all_reduce(t, group=group)
        out["sum"] = float(t)
    except RuntimeError as e:
        out["error"] = str(e)
    finally:
        tt.barrier = saved
    return out


@scenario
def noise(inputs, root):
    """The draws under the data and the spatial layout."""
    out = {}
    shape = (4, 3, 8, 8)   # global [8, 3, 16, 8] split both ways
    for tag, layout in (("dp", par.data_layout(_mesh((2, 1)))),
                        ("spatial", par.spatial_layout(_mesh((1, 2))))):
        g = torch.Generator().manual_seed(5)
        local = shape if tag == "dp" else (8, 3, 8, 8)
        with lay.use(layout):
            out[tag] = lay.randn(local, generator=g, device="cpu",
                                 row_dim=2)
        out[tag + "_per_rank"] = torch.randn(
            local, generator=torch.Generator().manual_seed(5))
    return out


@scenario
def batchnorm(inputs, root):
    from sr3d_torch.models.arcface import BatchNorm

    bn = BatchNorm(4).train()
    x = lay_local_rows(inputs["bn_x"])
    with lay.use(par.data_layout(_mesh((2, 1)))):
        y = bn(x)
    return {"y": y.detach(), "mean": bn.mean.clone(), "var": bn.var.clone()}


def lay_local_rows(t):
    r = dist.get_rank()
    n = t.shape[0] // dist.get_world_size()
    return t[r * n:(r + 1) * n]


@scenario
def int8(inputs, root):
    from sr3d_torch.ops.quant import Int8Conv

    conv = Int8Conv(4, 8, 3, padding=1)
    conv.load_state_dict(inputs["int8_sd"])
    out = {}
    with lay.use(par.data_layout(_mesh((2, 1)))):
        out["dp"] = conv(lay_local_rows(inputs["int8_x"]), quant=True)
    # spatial: a band of rows of each image, the halo exchanged
    with lay.use(par.spatial_layout(_mesh((1, 2)))):
        out["spatial"] = conv(lay.local(inputs["int8_x"], row_dim=2),
                              quant=True)
    return out


@scenario
def groupnorm(inputs, root):
    from sr3d_torch.models.sr3_unet import GroupNorm, GroupNormSwish

    gns, gn = GroupNormSwish(8, 4), GroupNorm(8, 4)
    gns.load_state_dict(inputs["gn_sd"])
    gn.load_state_dict(inputs["gn_sd"])
    with lay.use(par.spatial_layout(_mesh((1, 2)))), torch.no_grad():
        x = lay.local(inputs["gn_x"], row_dim=2)
        return {"gn_swish": gns(x), "gn": gn(x)}


# --------------------------------------------------------------------------
# world of 4
# --------------------------------------------------------------------------

@scenario
def tp_forward(inputs, root):
    unet = tiny_unet(inner=64)
    unet.load_state_dict(inputs["wide_sd"])
    mesh = _mesh((2, 2))
    par.shard_module_tp(mesh, unet, min_channels=128)
    split = sorted(n for n, p in unet.named_parameters()
                   if p.shape != inputs["wide_sd"][n].shape)
    with lay.use(par.data_layout(mesh)):
        y = unet(lay.local(inputs["wide_x"]), lay.local(inputs["wide_t"]))
        y = lay.gather(y)
    return {"out": y.detach(), "split": split}


@scenario
def tp_step(inputs, root):
    from sr3d_torch.train import checkpoint as tc
    from sr3d_torch.train import joint as tj

    cfg = inputs["joint_cfg"]
    mods = joint_modules(inputs)
    state = tj.init_train_state(mods, cfg)
    mesh = _mesh((2, 2))
    nets = {"sr": mods.unet, "arcface": mods.arcface,
            "mapping": mods.mapping}
    whole = {part: {n: p.shape for n, p in net.named_parameters()}
             for part, net in nets.items()}
    par.shard_state_dp_tp(mesh, mods, state, min_channels=16)
    # the parameters split, per network
    split = {part: [n for n, p in net.named_parameters()
                    if p.shape != whole[part][n]]
             for part, net in nets.items()}
    step = par.pjit_train_step(tj.make_train_step(inputs["ema_cfg"]), mesh,
                               batch_argnum=2)
    state, met = step(mods, state, inputs["joint_batch"],
                      draws=inputs["joint_draws"])
    with par.unsharded(mods, state):
        if dist.get_rank() == 0:
            tc.save_train_state(root / "tp.npz", mods, state,
                                {"global_step": 1, "epoch": 0})
    dist.barrier()
    # the same state written in the background by rank 0, as the Trainer
    # saves: the copy is taken inside the block (the split after it
    # reassigns the weights), the writer held until one more step has run
    # in place on the shards
    import threading

    gate, write = threading.Event(), tc.save_leaves
    tc.save_leaves = lambda *a, **k: gate.wait(60) and write(*a, **k)
    try:
        mgr = tc.CheckpointManager(root / "tp_async")
        with par.unsharded(mods, state):
            if dist.get_rank() == 0:
                path = mgr.save(1, mods, state,
                                {"global_step": 1, "epoch": 0})
        held = dist.get_rank() != 0 or not path.exists()
        dist.barrier()
        state, _ = step(mods, state, inputs["joint_batch"],
                        draws=inputs["joint_draws"])
        gate.set()
        mgr.wait()
    finally:
        tc.save_leaves = write
    with par.unsharded(mods, state):
        if dist.get_rank() == 0:
            tc.save_train_state(root / "tp_next.npz", mods, state,
                                {"global_step": 1, "epoch": 0})
    dist.barrier()
    # the reverse: a one-device file read under the mesh, then written
    # back from the shards
    fresh = joint_modules(inputs)
    st2 = tj.init_train_state(fresh, cfg)
    par.shard_state_dp_tp(mesh, fresh, st2, min_channels=16)
    shard_shapes = {n: tuple(p.shape)
                    for n, p in fresh.unet.named_parameters()}
    with par.unsharded(fresh, st2):
        tc.load_train_state(root / "one.npz", fresh, st2)
    after = {n: tuple(p.shape) for n, p in fresh.unet.named_parameters()}
    with par.unsharded(fresh, st2):
        if dist.get_rank() == 0:
            tc.save_train_state(root / "one_again.npz", fresh, st2,
                                {"global_step": 1, "epoch": 0})
    dist.barrier()
    return {"metrics": met, "split": split,
            "reshard": shard_shapes == after, "held": held}


@scenario
def spatial_sample(inputs, root):
    from sr3d_torch.diffusion.schedules import make_schedule

    unet = tiny_unet()
    unet.load_state_dict(inputs["unet_sd"])
    sched = make_schedule("linear", 20, 1e-4, 2e-2)
    out = {}
    for tag, shape in (("model2", (2, 2)), ("model4", (1, 4))):
        fn = par.pjit_sample_spatial(functools.partial(_sample, unet, sched),
                                     _mesh(shape))
        out[tag] = fn(inputs["cond2"], noise=inputs["noise2"])
    return out


@scenario
def flagship_geometry(inputs, root):
    unet = tiny_unet(channel_mults=(1, 2, 4, 8, 8), attn_res=(16,),
                     image_size=128)
    unet.load_state_dict(inputs["thin_sd"])
    out = {}
    for tag, shape in (("model2", (2, 2)), ("model4", (1, 4))):
        with lay.use(par.spatial_layout(_mesh(shape))), torch.no_grad():
            y = unet(lay.local(inputs["thin_x"], row_dim=2),
                     inputs["thin_t"])
            out[tag] = lay.gather(y, row_dim=2)
    return out


@scenario
def ddpm_spatial(inputs, root):
    """The DDPM family (``define_g``'s other UNet) over row bands."""
    from sr3d_torch.models.ddpm_unet import DDPMUNet

    unet = DDPMUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                    attn_res=(8,), res_blocks=1, image_size=16,
                    dtype=torch.float32).eval()
    unet.load_state_dict(inputs["ddpm_sd"])
    out = {}
    for tag, shape in (("model2", (2, 2)), ("model4", (1, 4))):
        with lay.use(par.spatial_layout(_mesh(shape))), torch.no_grad():
            y = unet(lay.local(inputs["ddpm_x"], row_dim=2),
                     inputs["ddpm_t"])
            out[tag] = lay.gather(y, row_dim=2)
    return out
