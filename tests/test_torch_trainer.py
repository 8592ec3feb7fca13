"""The port's checkpoint writer and joint Trainer against the JAX package,
on the CPU at the tiny config:

* a port train state (grad_accum 1 and 2, one file between micro-steps,
  EMA on and off) loads through JAX's ``load_state_npz`` into a JAX
  ``init_train_state`` template, no mismatch in leaf count, shape or dtype,
  and every leaf — parameters, statistics, EMA, Adam μ/ν, counts, the
  accumulated gradients — equals the port's at the path JAX gives it;
* a JAX-written state resumes the port's Trainer and is written back bit
  for bit;
* ``cli.main.main`` trains 4 steps, resumes to 6 and validates: the same
  state, bit for bit, as an unbroken 6-step run, and the JAX Trainer's
  file names;
* ``BestModel``, ``-ckt`` (a step, a train state, a converted UNet),
  ``reset_optimizer``, the SR-only warm start with its Adam moments, the
  pretrained MICA files, the branch trainers' flags."""

import functools
import shutil
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
import yaml
from jax.tree_util import DictKey, GetAttrKey, SequenceKey

from sr3d_torch.cli import main as tcli
from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.data.synthetic import (
    generate_synthetic_faces,
    generate_synthetic_joint_root,
    synthetic_face_batch,
)
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train import joint as tj
from sr3d_torch.train.trainer import BestModel as TBest
from sr3d_torch.train.trainer import Trainer
from sr3d_torch.utils.bridge import export_jax_params
from sr3d_tpu.config.defaults import get_cfg_defaults, update_cfg
from sr3d_tpu.train import checkpoint as jc
from sr3d_tpu.train import joint as jj
from sr3d_tpu.train.trainer import BestModel as JBest

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = REPO / "configs" / "tiny_8_16_model2.yml"
META = {"epoch": 1, "global_step": 3}
OVERLAY = {
    "mica": {"model": {"arcface_layers": [1, 1, 1, 1],
                       "synthetic_flame_kind": "sphere"}},
    "sr": {"model": {"diffusion": {"train_sampler": "ddim",
                                   "train_ddim_steps": 2, "sampler": "ddim",
                                   "ddim_steps": 2,
                                   "sampler_init": "marginal"}},
           "train": {"ema_scheduler": {"step_start_ema": 1,
                                       "update_ema_every": 1,
                                       "ema_decay": 0.9}}},
    "tpu": {"compute_dtype": "float32"},
}


@pytest.fixture(autouse=True)
def _free_disk(request):
    """A test's checkpoints and workspaces run to hundreds of MiB, and
    pytest keeps its last runs' temp dirs: drop them when it ends."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(autouse=True, scope="module")
def _no_tensorboard():
    """The metrics sink's TensorBoard writer imports TensorFlow (~10 s);
    these tests read its JSON lines and images, so the import is made to
    fail (the sink then writes no TensorBoard events)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def _merge(base: dict, over: dict) -> dict:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def _cfgs(accum=1, ema=True):
    """The tiny config with ``OVERLAY`` as (port, JAX) config trees."""
    out = []
    for defaults, update in ((t_defaults, t_update),
                             (get_cfg_defaults, update_cfg)):
        c = update(defaults(), str(TINY))
        c.merge_from_other(OVERLAY, strict=True)
        c.tpu.grad_accum = accum
        if not ema:
            c.sr.train.ema_scheduler = None
        out.append(c)
    return out


def _batch(seed=0):
    hr = synthetic_face_batch(4, 16, seed=seed)
    return {"HR": torch.from_numpy(hr),
            "SR": torch.from_numpy(np.ascontiguousarray(hr[:, :, ::-1])),
            "flame_shape": torch.from_numpy(
                np.random.RandomState(seed).randn(4, 16).astype(np.float32))}


def _trained(tcfg, steps):
    mods = tj.build_joint(tcfg, device="cpu", init_seed=0)
    st = tj.init_train_state(mods, tcfg)
    ema_cfg = (tcfg.sr.train.ema_scheduler.to_dict()
               if tcfg.sr.train.ema_scheduler else None)
    step = tj.make_train_step(ema_cfg)
    for i in range(steps):
        st, _ = step(mods, st, _batch(i),
                     generator=torch.Generator().manual_seed(i))
    return mods, st


@functools.lru_cache(maxsize=None)
def _jax_template_of(accum: int, ema: bool):
    jcfg = _cfgs(accum, ema)[1]
    mods = jj.build_joint(jcfg)
    return jax.eval_shape(lambda k: jj.init_train_state(mods, jcfg, k, 16),
                          jax.random.PRNGKey(0))


def _jax_template(jcfg):
    """A JAX ``init_train_state`` of ``jcfg`` (shapes and dtypes)."""
    return _jax_template_of(int(jcfg.tpu.grad_accum),
                            bool(jcfg.sr.train.ema_scheduler))


def _keys(path) -> list:
    out = []
    for k in path:
        if isinstance(k, DictKey):
            out.append(k.key)
        elif isinstance(k, GetAttrKey):
            out.append(k.name)
        else:
            assert isinstance(k, SequenceKey)
            out.append(k.idx)
    return out


def _jax_layout(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().float().numpy()
    if name == "kernel":
        a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
    return a


def _port_value(keys: list, mods, st) -> np.ndarray:
    """What the port holds at the JAX state path ``keys`` (under
    ``state``), found by name: the flax path → the module's parameter
    name (``kernel`` → ``weight``), then the tensor the optimizer, the
    EMA or the module keeps for it."""
    nets = {"sr": mods.unet, "arcface": mods.arcface,
            "mapping": mods.mapping}

    def param(net_key, rest):
        rest = [k for k in rest if k != "params"]
        name = ".".join(rest[:-1] + ["weight" if rest[-1] == "kernel"
                                     else rest[-1]])
        return dict(nets[net_key].named_parameters())[name], rest[-1]

    head = keys[0]
    if head == "step":
        return np.asarray(st.step)
    if head == "params":
        p, leaf = param(keys[1], keys[2:])
        return _jax_layout(leaf, p)
    if head == "arcface_stats":
        name = ".".join(keys[1:])
        return dict(mods.arcface.named_buffers())[name].numpy()
    if head == "ema":
        if keys[1] == "step":
            return np.asarray(st.ema.step)
        rest = [k for k in keys[2:] if k != "params"]
        leaf = rest[-1]
        name = ".".join(rest[:-1] + ["weight" if leaf == "kernel" else leaf])
        return _jax_layout(leaf, st.ema.params[name])
    assert head == "opt_state", keys
    rest = keys[1:]
    if rest[0] == "mini_step":
        return np.asarray(st.mini_step)
    groups = {g["name"]: g for g in st.opt.param_groups}
    if rest[0] == "gradient_step":
        return np.asarray(tj.group_update_count(st.opt, groups["mapping"]))
    if rest[0] == "acc_grads":
        p, leaf = param(rest[1], rest[2:])
        g = p.grad if st.mini_step and p.grad is not None \
            else torch.zeros_like(p)
        return _jax_layout(leaf, g)
    if rest[0] == "inner_opt_state":
        rest = rest[1:]
    assert rest[0] == "inner_states" and rest[2] == "inner_state", rest
    group = groups[rest[1]]
    tail = rest[4:]           # after inner_states, label, inner_state, i
    if tail[0] == "count":    # Adam's, and the schedule's (index 2)
        return np.asarray(tj.group_update_count(st.opt, group))
    kind = {"mu": "exp_avg", "nu": "exp_avg_sq"}[tail[0]]
    p, leaf = param(tail[1], tail[2:])
    return _jax_layout(leaf, st.opt.state[p][kind])


@pytest.mark.parametrize("accum,ema,steps", [(1, True, 2), (2, True, 3),
                                             (2, False, 2)])
def test_port_state_loads_in_jax(tmp_path, accum, ema, steps):
    tcfg, jcfg = _cfgs(accum, ema)
    mods, st = _trained(tcfg, steps)
    assert st.mini_step == steps % accum
    path = tmp_path / "ckpt.npz"
    tc.save_train_state(path, mods, st, META)
    tmpl = _jax_template(jcfg)
    meta_like = {"epoch": 0, "global_step": 0}
    got = jc.load_state_npz(path, tmpl, meta_like)
    ref_leaves = jax.tree_util.tree_leaves({"meta": meta_like,
                                            "state": tmpl})
    file_leaves = tc.npz_leaves(path)
    assert len(file_leaves) == len(ref_leaves)
    for a, b in zip(file_leaves, ref_leaves):
        assert a.shape == np.shape(b)
        assert a.dtype == (b.dtype if hasattr(b, "dtype")
                           else np.asarray(b).dtype)
    assert {k: int(v) for k, v in got["meta"].items()} == META
    n = 0
    for path_, leaf in jax.tree_util.tree_flatten_with_path(
            got["state"])[0]:
        np.testing.assert_array_equal(
            leaf, _port_value(_keys(path_), mods, st),
            err_msg=jax.tree_util.keystr(path_))
        n += 1
    assert n == len(ref_leaves) - 2
    # the JAX CheckpointManager's numpy layout reads it too
    mgr = jc.CheckpointManager.__new__(jc.CheckpointManager)
    mgr.directory = tmp_path
    (tmp_path / "ckpt_0000000003.npz").write_bytes(path.read_bytes())
    back = mgr._restore_np(3, {"state": tmpl, "meta": meta_like})
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(a, b)


def _jax_written(jcfg, path, accum, rng):
    """A JAX ``save_state_npz`` file of the JAX template with random values
    (moments and variances ≥ 0, counts 3, one micro-step in), the frozen
    prefix's accumulated gradients zero (the port has no gradient
    there)."""
    from sr3d_tpu.models.arcface import frozen_prefix_mask

    def fill(path_, s):
        keys = _keys(path_)
        if s.dtype == np.int32:
            return np.asarray(1 if keys[-1] == "mini_step" else 3, np.int32)
        a = 0.1 * rng.standard_normal(s.shape).astype(s.dtype)
        if "nu" in keys or keys[-1] == "var":
            a = np.abs(a) + np.float32(0.5) * (keys[-1] == "var")
        return a

    state = jax.tree_util.tree_map_with_path(fill, _jax_template(jcfg))
    if accum > 1:
        mask = frozen_prefix_mask(state.params["arcface"])
        acc = state.opt_state.acc_grads
        acc = dict(acc, arcface=jax.tree.map(
            lambda g, m: g if m else np.zeros_like(g), acc["arcface"], mask))
        state = state._replace(opt_state=state.opt_state._replace(
            acc_grads=acc))
    jc.save_state_npz(path, state, META)


@pytest.mark.parametrize("accum", [1, 2])
def test_jax_state_resumes_the_port_bit_equal(tmp_path, accum):
    tcfg, jcfg = _cfgs(accum)
    tcfg.output_dir = str(tmp_path / "out")
    src = tmp_path / "jax_state.npz"
    _jax_written(jcfg, src, accum, np.random.default_rng(accum))
    tr = Trainer(tcfg, device="cpu")
    assert tr.load_checkpoint(str(src))
    assert (tr.global_step, tr.epoch) == (3, 1)
    assert tr.state.mini_step == (1 if accum > 1 else 0)
    back = tmp_path / "port_state.npz"
    tc.save_train_state(back, tr.modules, tr.state, META)
    a, b = tc.npz_leaves(src), tc.npz_leaves(back)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype, i
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    # the moments are in the optimizer: a step runs from them
    tr.state, m = tr._train_step(tr.modules, tr.state, _batch(),
                                 generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(m["loss"])


def _workspace(tmp_path: Path) -> Path:
    generate_synthetic_joint_root(
        tmp_path / "joint", name="SYNTH", n_actors=5, imgs_per_actor=3,
        img_res=32, lr_res=8, hr_res=16, n_shape=16, n_exp=8)
    generate_synthetic_faces(tmp_path / "eval", n=2, l_res=8, r_res=16)
    return tmp_path


def _overlay(ws: Path, name: str, cadenced: bool = True, **train) -> Path:
    """The tiny config with ``OVERLAY`` on the workspace's data; with
    ``cadenced`` checkpoints and ``evaluate_MICA`` every 2 steps,
    ``evaluate`` and the train visualisation every 4, else only the final
    checkpoint."""
    with open(TINY) as f:
        base = yaml.safe_load(f)
    every = (2, 2, 4, 4) if cadenced else (0, 0, 0, 0)
    over = _merge(_merge({}, OVERLAY), {
        "name": name, "output_dir": str(ws / "out"),
        "mica": {"datasets": {"root": str(ws / "joint")},
                 "train": {"eval_steps": every[1]}},
        "sr": {"datasets": {"val": {"dataroot": str(ws / "eval")}}},
        "train": dict({"checkpoint_steps": every[0], "log_steps": 2,
                       "eval_steps": every[2], "vis_steps": every[3],
                       "val_n_img": 1, "checkpoint_max_keep": 10}, **train)})
    path = ws / f"{name}.yml"
    path.write_text(yaml.safe_dump(_merge(base, over)))
    return path


def test_cli_resume_is_bit_equal_to_an_unbroken_run(tmp_path):
    """``main -p train --max-steps 4``, then ``--max-steps 2`` (a resume
    at 4 that ends at 6), then ``-p val -ckt``: the step-6 state equals an
    unbroken 6-step run's leaf for leaf (which writes only its final
    checkpoint: the checkpoints, evals and visualisations of the split run
    change nothing), and the files are the JAX Trainer's."""
    ws = _workspace(tmp_path)
    split = _overlay(ws, "split")
    whole = _overlay(ws, "whole", cadenced=False)
    assert tcli.main(["-p", "train", "-c", str(split), "--max-steps", "4"],
                     device="cpu") == 0
    assert tcli.main(["-p", "train", "-c", str(split), "--max-steps", "2"],
                     device="cpu") == 0
    assert tcli.main(["-p", "train", "-c", str(whole), "--max-steps", "6"],
                     device="cpu") == 0
    out = ws / "out"
    a = tc.npz_leaves(out / "split" / "checkpoint" / "ckpt_0000000006.npz")
    b = tc.npz_leaves(out / "whole" / "checkpoint" / "ckpt_0000000006.npz")
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x, y, err_msg=f"leaf {i}")
    assert int(a[1]) == 6 and int(a[0]) == 3     # global_step, epoch
    ckpt = out / "split" / "checkpoint" / "ckpt_0000000006.npz"
    assert tcli.main(["-p", "val", "-c", str(split), "-ckt", str(ckpt)],
                     device="cpu") == 0
    run = out / "split"
    files = sorted(str(p.relative_to(run)) for p in run.rglob("*")
                   if p.is_file() and "tb" not in p.parts)
    want = {"best_model.npz", "best_model.txt",
            "best_models/best_model_3.npz",
            "checkpoint/ckpt_0000000002.npz",
            "checkpoint/ckpt_0000000004.npz",
            "checkpoint/ckpt_0000000006.npz", "logs/config.yml",
            "logs/full_config.yaml", "logs/metrics.jsonl",
            "train_images/2_4/train_3d.jpg", "val_metrics.jsonl"}
    for step in (4, 6):
        d = f"results/step_{step}/00000"
        want |= {f"{d}/{n}" for n in (
            "mesh.ply", "mesh.obj", "identity.npy", "kpt7.npy", "kpt68.npy",
            "00000_sr.png", "00000_hr.png", "00000_inf.png",
            "00000_lr.png")}
    assert want <= set(files), sorted(want - set(files))
    # the other best_models/ depend on whether the losses improved
    extra = {f for f in set(files) - want if not f.startswith("logs/images")}
    assert extra <= {"best_models/best_model_0.npz",
                     "best_models/best_model_1.npz"}, extra
    steps = [int(x.split('"step": ')[1].split("}")[0]) for x in
             (run / "val_metrics.jsonl").read_text().splitlines()]
    assert steps == [4, 6]


def test_best_model_matches_jax():
    """The reference sequence of the JAX package's test, on both."""
    seq = [(5.0, 4.0), (6.0, 3.0), (4.0, 3.6), (4.5, 2.0), (1.0, None)]
    saved = {"t": [], "j": []}
    bms = {"t": TBest(n=2, save_fn=saved["t"].append),
           "j": JBest(n=2, save_fn=saved["j"].append)}
    for w, a in seq:
        assert bms["t"](w, a) == bms["j"](w, a)
    for med, mean in ((1.0, 1.0), (0.5, 0.9), (0.4, 1.2)):
        assert bms["t"].now(med, mean, 0.0) == bms["j"].now(med, mean, 0.0)
    assert saved["t"] == saved["j"] and "best_model_now" in saved["t"]
    assert bms["t"].state_dict() == bms["j"].state_dict()
    again = TBest(n=2)
    again.load_state_dict(bms["j"].state_dict())
    assert again.state_dict() == bms["t"].state_dict()


def _trainer(ws: Path, name: str, **cfg_train) -> Trainer:
    cfg = t_update(t_defaults(), str(_overlay(ws, name, cadenced=False)))
    for k, v in cfg_train.items():
        cfg.train[k] = v
    return Trainer(cfg, device="cpu")


@pytest.fixture(scope="module")
def two_steps(tmp_path_factory):
    """A workspace whose run ``run`` trained 2 steps (its final checkpoint
    at step 2), and that Trainer."""
    ws = _workspace(tmp_path_factory.mktemp("two_steps"))
    tr = _trainer(ws, "run")
    tr.prepare_data()
    tr.training_step(max_steps=2)
    yield ws, tr
    shutil.rmtree(ws, ignore_errors=True)


def test_ckt_takes_a_step_a_state_or_a_converted_unet(two_steps, tmp_path):
    ws, tr = two_steps
    ref = export_jax_params(tr.modules)
    fresh = _trainer(ws, "run")
    assert fresh.load_checkpoint("2") and fresh.global_step == 2
    same = _trainer(ws, "other")
    assert same.load_checkpoint(str(tr.ckpt_dir / "ckpt_0000000002.npz"))
    assert same.global_step == 2
    for t in (fresh, same):
        for a, b in zip(tc.jax_tree_flatten(export_jax_params(t.modules))[0],
                        tc.jax_tree_flatten(ref)[0], strict=True):
            np.testing.assert_array_equal(a, b)
    conv = tmp_path / "unet.npz"
    np.savez(conv, **{f"leaf_{i}": x for i, x in
                      enumerate(tc.jax_tree_flatten(ref["sr"])[0])})
    other = _trainer(ws, "other")
    assert other.load_checkpoint(str(conv)) and other.global_step == 0
    for k, p in other.modules.unet.named_parameters():
        assert torch.equal(p, dict(tr.modules.unet.named_parameters())[k])
        assert torch.equal(other.state.ema.params[k], p.detach())
    with pytest.raises(FileNotFoundError, match="not a step number"):
        other.load_checkpoint("latest")
    with pytest.raises(FileNotFoundError, match="does not exist"):
        other.load_checkpoint(str(tmp_path / "nope.npz"))
    assert not other.load_checkpoint("7")         # no such step


def test_reset_optimizer_after_resume(two_steps):
    ws, tr = two_steps
    again = _trainer(ws, "run", reset_optimizer=True)
    assert again.load_checkpoint()
    assert again.global_step == 2 and not again.state.opt.state
    assert again.state.mini_step == 0
    kept = _trainer(ws, "run")
    assert kept.load_checkpoint() and kept.state.opt.state
    for a, b in zip(again.modules.unet.parameters(),
                    tr.modules.unet.parameters()):
        assert torch.equal(a, b)


def test_sr_warm_start_transfers_adam_moments_as_jax(tmp_path):
    """An SR-only ``I*_E*`` pair (the JAX SR trainer's layout: the UNet's
    leaves; ``optax.adam``'s state with epoch/iter) warm-starts the SR
    branch: weights, counters, the moments in the ``sr`` group as JAX's
    ``transfer_sr_adam_moments`` puts them, and the EMA re-seeded."""
    tcfg, jcfg = _cfgs()
    tcfg.output_dir = str(tmp_path / "out")
    tr = Trainer(tcfg, device="cpu")
    rng = np.random.default_rng(0)
    donor = tj.build_joint(tcfg, device="cpu", init_seed=3)
    sr = export_jax_params(donor)["sr"]
    opt = optax.adam(1e-4).init(sr)
    opt = jax.tree.map(lambda x: np.abs(rng.standard_normal(np.shape(x)))
                       .astype(np.float32) if np.ndim(x) else
                       np.asarray(2, np.int32), opt)
    prefix = tmp_path / "I2_E1"
    jc.save_state_npz(f"{prefix}_gen.npz", sr)
    leaves = jax.tree_util.tree_leaves(opt)
    np.savez(f"{prefix}_opt.npz", epoch=1, iter=2,
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})
    assert tr.load_sr_pretrained(str(prefix))
    assert (tr.global_step, tr.epoch) == (2, 1)
    got = export_jax_params(tr.modules)["sr"]
    for a, b in zip(tc.jax_tree_flatten(got)[0], tc.jax_tree_flatten(sr)[0],
                    strict=True):
        np.testing.assert_array_equal(a, b)
    assert tr.state.ema.params.keys() == dict(
        tr.modules.unet.named_parameters()).keys()
    for k, p in tr.modules.unet.named_parameters():
        assert torch.equal(tr.state.ema.params[k], p.detach())
    # the JAX transfer into the JAX joint optimizer's fresh state
    jparams = {k: v for k, v in export_jax_params(tr.modules).items()
               if k != "arcface_stats"}
    fresh = jax.tree.map(np.asarray, jj.make_optimizer(jcfg).init(jparams))
    ref = jc.transfer_sr_adam_moments(fresh, sr, f"{prefix}_opt.npz")
    mine = tc.optimizer_tree(tc.joint_layout(tr.modules), tr.state)
    a, b = tc.jax_tree_flatten(mine)[0], jax.tree_util.tree_leaves(ref)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_pretrained_mica_files_load(tmp_path):
    """``mica.model.arcface_pretrained_model`` and
    ``mica.pretrained_model_path`` (converted ``.npz`` files) load at
    construction, as the JAX Trainer's ``_load_mica_pretrained``."""
    tcfg, _ = _cfgs()
    donor = export_jax_params(tj.build_joint(tcfg, device="cpu",
                                             init_seed=7))
    af = tc.jax_tree_flatten({"batch_stats": donor["arcface_stats"],
                              "params": donor["arcface"]})[0]
    np.savez(tmp_path / "arcface.npz",
             **{f"leaf_{i}": x for i, x in enumerate(af)})
    np.savez(tmp_path / "mapping.npz", **{
        f"leaf_{i}": x for i, x in enumerate(
            tc.jax_tree_flatten(donor["mapping"])[0])})
    tcfg.output_dir = str(tmp_path / "out")
    tcfg.mica.model.arcface_pretrained_model = str(tmp_path / "arcface.npz")
    tcfg.mica.pretrained_model_path = str(tmp_path / "mapping.npz")
    tr = Trainer(tcfg, device="cpu")
    got = export_jax_params(tr.modules)
    for k in ("arcface", "arcface_stats", "mapping"):
        for a, b in zip(tc.jax_tree_flatten(got[k])[0],
                        tc.jax_tree_flatten(donor[k])[0], strict=True):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("flag", ["--sr-only", "--legacy"])
def test_unported_trainers_raise(flag, monkeypatch):
    """The branch trainers are ported: each flag now reaches its runner
    (``tests/test_torch_sr_only.py`` and ``test_torch_legacy.py`` drive
    them), with the device and the step cap, and not the joint Trainer;
    without a device the entry point still raises where there is no
    GPU."""
    calls = []
    for name in ("run_sr_only", "run_legacy"):
        monkeypatch.setattr(tcli, name, lambda cfg, max_steps=None, *,
                            device=None, name=name: calls.append(
                                (name, max_steps, str(device))))
    monkeypatch.setattr("sr3d_torch.train.trainer.Trainer", None)
    assert tcli.main(["-p", "train", "-c", str(TINY), flag,
                      "--max-steps", "3"], device="cpu") == 0
    want = "run_sr_only" if flag == "--sr-only" else "run_legacy"
    assert calls == [(want, 3, "cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["-c", str(TINY), flag])


def test_more_than_one_device_raises(tmp_path):
    """A mesh larger than the world (one process, no group) raises
    ``ValueError``, as JAX's ``make_mesh`` does."""
    tcfg, _ = _cfgs()
    tcfg.output_dir = str(tmp_path)
    tcfg.tpu.mesh_shape = [2, 1]
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        Trainer(tcfg, device="cpu")


def test_cli_debug_and_name_rules_match_jax():
    from sr3d_tpu.cli import main as jcli

    for argv in (["-c", str(TINY), "--debug", "-s", "2", "-m", "model3"],
                 ["-c", str(TINY), "-p", "val", "-ckt", "x.npz"]):
        t, _ = tcli.parse_args(argv)
        j, _ = jcli.parse_args(argv)
        t, j = t.to_dict(), j.to_dict()
        t.pop("sr3d_dir"), j.pop("sr3d_dir")
        assert t == j


def test_profile_trace_and_metrics_sink(tmp_path):
    """``--profile DIR``'s trace writes a Chrome trace and a table; the
    metrics sink writes the JAX package's JSON lines."""
    import json

    from sr3d_torch.utils.logging import MetricsWriter as TWriter
    from sr3d_torch.utils.profiling import annotate, trace
    from sr3d_tpu.utils.logging import MetricsWriter as JWriter

    with trace(str(tmp_path / "trace")):
        with annotate("matmul"):
            torch.randn(32, 32) @ torch.randn(32, 32)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(e.get("name") == "matmul"
               for e in events["traceEvents"])
    assert (tmp_path / "trace" / "key_averages.txt").read_text()
    rows = {}
    for name, cls in (("t", TWriter), ("j", JWriter)):
        w = cls(tmp_path / name, enable_tensorboard=False)
        w.add_scalars({"loss": 1.5, "l_sr": 0.25}, 7, prefix="train/")
        w.log_checkpoint(["a.npz"], 7)
        w.close()
        rows[name] = [{k: v for k, v in json.loads(x).items() if k != "ts"}
                      for x in (tmp_path / name / "metrics.jsonl")
                      .read_text().splitlines()]
    assert rows["t"] == rows["j"] and len(rows["t"]) == 3
