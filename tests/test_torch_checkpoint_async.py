"""The joint Trainer's checkpoints written in the background, on the CPU at
the tiny config (``grad_accum`` 2, EMA on), as the JAX ``CheckpointManager``
writes them through orbax:

* ``save`` returns before the file exists (its writer held on an event),
  and the file equals a synchronous save of the state as it was at
  ``save`` although an optimizer update and a micro-step ran in place
  before ``wait()``; a snapshot taken after the steps, and one that
  copies nothing, fail that check;
* back-to-back saves rotate to the newest ``max_to_keep``, no temporary
  file left;
* a failed write raises from ``wait()``, from the next ``save`` and from
  ``cli.main``;
* ``latest_step`` and ``restore`` wait for the write in flight;
* a temporary file left by a killed write is no checkpoint to
  ``latest_npz_step``, the rotation or ``Predictor.from_config``;
* the JAX package's numpy ``CheckpointManager`` reads the background file
  into the same leaves as the synchronous one."""

import shutil
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from sr3d_torch.cli import main as tcli
from sr3d_torch.serve import Predictor
from sr3d_torch.train import checkpoint as tc
from sr3d_torch.train import joint as tj
from sr3d_torch.utils.bridge import export_jax_params
from sr3d_tpu.train import checkpoint as jc
from tests.test_torch_trainer import (_batch, _cfgs, _jax_template,
                                      _overlay, _workspace)

torch.set_num_threads(1)

META = {"epoch": 1, "global_step": 3}


@pytest.fixture(autouse=True)
def _free_disk(request):
    """A tiny train state is ~270 MB: drop a test's files when it ends."""
    path = (request.getfixturevalue("tmp_path")
            if "tmp_path" in request.fixturenames else None)
    yield
    if path is not None:
        shutil.rmtree(path, ignore_errors=True)


def _trained(steps=3):
    """Modules, their state after ``steps`` steps (at 3: one update, one
    micro-step in), the config and the step function."""
    tcfg, _ = _cfgs(accum=2)
    mods = tj.build_joint(tcfg, device="cpu", init_seed=0)
    st = tj.init_train_state(mods, tcfg)
    step = tj.make_train_step(tcfg.sr.train.ema_scheduler.to_dict())
    for i in range(steps):
        st, _ = step(mods, st, _batch(i),
                     generator=torch.Generator().manual_seed(i))
    return mods, st, tcfg, step


def _hold(monkeypatch) -> threading.Event:
    """Hold every write until the returned event is set."""
    gate = threading.Event()
    write = tc.save_leaves

    def held(*args, **kwargs):
        assert gate.wait(60), "the test never released the writer"
        return write(*args, **kwargs)

    monkeypatch.setattr(tc, "save_leaves", held)
    return gate


def _blocks(mods, st) -> dict[str, range]:
    """The leaf indices of the parameters, the Adam state, the
    accumulated gradients and the EMA in a train-state file."""
    tree = tc.train_state_tree(mods, st, META)
    step, params, stats, (mini, updates, inner, acc, _), ema = \
        tree["state"]
    out, at = {}, 0
    for name, part in (("meta", tree["meta"]), ("step", step),
                       ("params", params), ("stats", stats),
                       ("counts", (mini, updates)), ("adam", inner),
                       ("acc_grads", acc), ("ema", ema)):
        n = len(tc.jax_tree_flatten(part)[0])
        out[name], at = range(at, at + n), at + n
    assert at == len(tc.jax_tree_flatten(tree)[0])
    return out


def _differing(a, b) -> set[int]:
    la, lb = tc.npz_leaves(a), tc.npz_leaves(b)
    assert len(la) == len(lb)
    return {i for i, (x, y) in enumerate(zip(la, lb))
            if x.dtype != y.dtype or not np.array_equal(x, y)}


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """One background save held while two steps run in place, and a
    synchronous save of the state as it was at ``save``."""
    root = tmp_path_factory.mktemp("async")
    mods, st, _, step = _trained()
    before = root / "sync" / "ckpt_0000000003.npz"
    tc.save_train_state(before, mods, st, META)
    mp = pytest.MonkeyPatch()
    gate = _hold(mp)
    mgr = tc.CheckpointManager(root / "async")
    path = mgr.save(3, mods, st, META)
    returned_before_file = not path.exists()
    # an update (parameters, moments, EMA), then a micro-step (acc_grads)
    for i in (3, 4):
        st, _ = step(mods, st, _batch(i),
                     generator=torch.Generator().manual_seed(i))
    assert st.mini_step == 1
    gate.set()
    mgr.wait()
    mp.undo()
    yield {"root": root, "mods": mods, "st": st, "step": step,
           "before": before, "path": path, "mgr": mgr,
           "returned_before_file": returned_before_file}
    shutil.rmtree(root, ignore_errors=True)


def test_save_returns_before_the_file_exists(written):
    assert written["returned_before_file"]
    assert written["path"].exists()
    (w,) = written["mgr"].poll()
    assert (w.step, w.path) == (3, written["path"])
    assert w.nbytes == written["path"].stat().st_size


def test_background_file_is_the_state_at_save(written, monkeypatch):
    """Equal leaf for leaf to the synchronous save taken before the steps;
    the controls — the state after the steps, and a snapshot that keeps
    the live tensors instead of copies — differ in every block the steps
    changed."""
    root, mods, st = written["root"], written["mods"], written["st"]
    assert _differing(written["path"], written["before"]) == set()
    blocks = _blocks(mods, st)
    after = root / "after.npz"
    tc.save_train_state(after, mods, st, META)
    late = _differing(after, written["before"])
    for name in ("params", "adam", "acc_grads", "ema"):
        assert late & set(blocks[name]), name
    # no copy: the writer reads the live tensors after one more step
    monkeypatch.setattr(tc.HostSnapshot, "copy",
                        lambda self, tree: (tree, None))
    gate = _hold(monkeypatch)
    mgr = tc.CheckpointManager(root / "nocopy")
    path = mgr.save(5, mods, st, META)
    st, _ = written["step"](mods, st, _batch(5),
                            generator=torch.Generator().manual_seed(5))
    gate.set()
    mgr.wait()
    live = _differing(path, after)
    for name in ("params", "adam", "ema"):
        assert live & set(blocks[name]), name
    assert _differing(path, written["before"])


def test_jax_reads_the_background_file_as_the_synchronous_one(written):
    _, jcfg = _cfgs(accum=2)
    like = {"state": _jax_template(jcfg),
            "meta": {"epoch": 0, "global_step": 0}}
    got = []
    for path in (written["path"], written["before"]):
        mgr = jc.CheckpointManager.__new__(jc.CheckpointManager)
        mgr.directory = path.parent
        got.append(jax.tree_util.tree_leaves(mgr._restore_np(3, like)))
    assert len(got[0]) == len(got[1]) > 0
    for a, b in zip(*got):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def fresh():
    """Untrained modules, their state and config, shared by the tests
    below (each sets ``state.step`` itself)."""
    return _trained(steps=0)[:3]


def test_back_to_back_saves_rotate(tmp_path, fresh):
    mods, st, _ = fresh
    mgr = tc.CheckpointManager(tmp_path, max_to_keep=2)
    for s in (2, 4, 6):
        st.step = s
        mgr.save(s, mods, st, {"epoch": 0, "global_step": s})
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt_0000000004.npz", "ckpt_0000000006.npz"]
    for s in (4, 6):
        leaves = tc.npz_leaves(tc.npz_step_path(tmp_path, s))
        assert int(leaves[1]) == int(leaves[2]) == s
    assert [w.step for w in mgr.poll()] == [2, 4, 6]


def test_failed_write_is_raised(tmp_path, monkeypatch, fresh):
    mods, st, _ = fresh

    def full(path, tree, **named):
        raise OSError(f"no space left on device: {path.name}")

    monkeypatch.setattr(tc, "save_leaves", full)
    mgr = tc.CheckpointManager(tmp_path)
    mgr.save(1, mods, st, META)
    with pytest.raises(OSError, match="ckpt_0000000001"):
        mgr.wait()
    mgr.wait()          # raised once, nothing in flight
    mgr.save(2, mods, st, META)
    with pytest.raises(OSError, match="ckpt_0000000002"):
        mgr.save(3, mods, st, META)
    with pytest.raises(OSError, match="ckpt_0000000004"):
        mgr.save(4, mods, st, META, wait=True)
    assert list(tmp_path.iterdir()) == []


def test_failed_write_fails_the_train_cli(tmp_path, monkeypatch):
    """A background write that fails ends ``cli.main -p train`` with its
    exception (a nonzero exit), raised from ``fit``'s final drain; the
    best-model files, written synchronously, are not touched."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    write = tc.save_leaves

    def full(path, tree, **named):
        if path.name.startswith("ckpt_"):
            raise OSError(f"no space left on device: {path.name}")
        return write(path, tree, **named)

    monkeypatch.setattr(tc, "save_leaves", full)
    ws = _workspace(tmp_path)
    cfg = _overlay(ws, "fail", cadenced=False)
    with pytest.raises(OSError, match="ckpt_0000000001"):
        tcli.main(["-p", "train", "-c", str(cfg), "--max-steps", "1"],
                  device="cpu")
    assert not list((ws / "out" / "fail" / "checkpoint").iterdir())


def test_latest_step_and_restore_wait_for_the_write(tmp_path, monkeypatch,
                                                    fresh):
    mods, st, _ = fresh
    gate = _hold(monkeypatch)
    mgr = tc.CheckpointManager(tmp_path)
    st.step = 2
    path = mgr.save(2, mods, st, {"epoch": 0, "global_step": 2})
    assert not path.exists()
    threading.Timer(0.3, gate.set).start()
    assert mgr.latest_step() == 2
    assert int(tc.npz_leaves(path)[2]) == 2          # complete
    gate.clear()
    st.step = 4
    saved = tc.jax_tree_flatten(export_jax_params(mods))[0]
    mgr.save(4, mods, st, {"epoch": 0, "global_step": 4})
    threading.Timer(0.3, gate.set).start()
    # moved off what was saved: the restore must bring it back
    with torch.no_grad():
        for p in mods.unet.parameters():
            p.add_(1.0)
    st.step = 0
    assert mgr.restore(None, mods, st) == {"epoch": 0, "global_step": 4}
    assert st.step == 4
    for a, b in zip(tc.jax_tree_flatten(export_jax_params(mods))[0], saved,
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_killed_write_leaves_the_newest_complete_step(tmp_path, fresh):
    """Partial files under this writer's temporary name and the earlier
    one (``ckpt_….npz.tmp.npz``, which the ``ckpt_*.npz`` glob took and
    whose step ``int`` could not parse) are ignored by the auto-resume,
    the rotation and ``Predictor.from_config(checkpoint=None)``."""
    mods, st, tcfg = fresh
    tcfg.output_dir = str(tmp_path)
    ckpt_dir = tmp_path / tcfg.name / tcfg.path.checkpoint
    mgr = tc.CheckpointManager(ckpt_dir, max_to_keep=1)
    mgr.save(4, mods, st, META, wait=True)
    partial = [ckpt_dir / "ckpt_0000000006.npz.tmp",
               ckpt_dir / "ckpt_0000000006.npz.tmp.npz"]
    for p in partial:
        p.write_bytes(b"PK\x03\x04 a write killed part-way")
    assert tc.latest_npz_step(ckpt_dir) == 4
    p = Predictor.from_config(tcfg, device="cpu")
    for a, b in zip(tc.jax_tree_flatten(export_jax_params(p.modules))[0],
                    tc.jax_tree_flatten(export_jax_params(mods))[0]):
        np.testing.assert_array_equal(a, b)
    del p
    mgr.save(5, mods, st, META, wait=True)
    assert tc.npz_steps(ckpt_dir) == [(5, ckpt_dir / "ckpt_0000000005.npz")]
    assert all(p.exists() for p in partial)
