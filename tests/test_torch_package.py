"""The port's package boundary: its config and schedules equal the JAX
package's, it imports no JAX, and its entry points never fall back to the
CPU on their own."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import sr3d_torch
from sr3d_torch.config import get_cfg_defaults as t_defaults
from sr3d_torch.config import update_cfg as t_update
from sr3d_torch.diffusion import schedules as ts
from sr3d_tpu.config.defaults import get_cfg_defaults, update_cfg
from sr3d_tpu.diffusion import schedules as js

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("kind", ["linear", "quad", "warmup10", "warmup50",
                                  "const", "jsd", "cosine"])
def test_beta_schedules_equal_at_fp64(kind):
    np.testing.assert_array_equal(ts.make_beta_schedule(kind, 600, 1e-6, 1e-2),
                                  js.make_beta_schedule(kind, 600, 1e-6, 1e-2))


def test_schedule_buffers_equal():
    """Both packages round the same fp64 numpy math to fp32: bit-equal."""
    a = js.make_schedule("linear", 600, 1e-6, 1e-2)
    b = ts.make_schedule("linear", 600, 1e-6, 1e-2)
    assert b.num_timesteps == a.num_timesteps == 600
    for field in a.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(b, field),
                                      np.asarray(getattr(a, field)),
                                      err_msg=field)
    with pytest.raises(NotImplementedError):
        ts.make_schedule("sigmoid", 10)


@pytest.mark.parametrize("name", ["sr_sr3_VGGF2_16_128_model2.yml",
                                  "tiny_8_16_model2.yml",
                                  "sr_sr3_VGGF2_8_32_model3.yml"])
def test_config_merges_like_jax(name):
    path = str(REPO / "configs" / name)
    ref = update_cfg(get_cfg_defaults(), path).to_dict()
    got = t_update(t_defaults(), path).to_dict()
    ref.pop("sr3d_dir"), got.pop("sr3d_dir")
    assert got == ref
    assert ts.schedule_from_config(
        t_update(t_defaults(), path).sr.model.beta_schedule.val
    ).num_timesteps == ref["sr"]["model"]["beta_schedule"]["val"][
        "n_timestep"]


def test_import_leaves_jax_out():
    """Importing every module of the port pulls in no jax, flax, optax or
    sr3d_tpu (a fresh interpreter, so this file's imports don't count)."""
    mods = [m.name for m in pkgutil.walk_packages(sr3d_torch.__path__,
                                                   "sr3d_torch.")]
    assert "sr3d_torch.serve" in mods and len(mods) > 15
    assert {"sr3d_torch.kernels.conv3x3", "sr3d_torch.diffusion.ema",
            "sr3d_torch.models.masking",
            "sr3d_torch.data.synthetic", "sr3d_torch.data.joint",
            "sr3d_torch.data.lrhr", "sr3d_torch.data.pipeline",
            "sr3d_torch.data.lmdb_reader", "sr3d_torch.data.srpk",
            "sr3d_torch.eval.metrics", "sr3d_torch.eval.renderer",
            "sr3d_torch.train.trainer", "sr3d_torch.utils.logging",
            "sr3d_torch.utils.profiling",
            "sr3d_torch.cli.main", "sr3d_torch.models.ddpm_unet",
            "sr3d_torch.models.networks", "sr3d_torch.train.sr_only",
            "sr3d_torch.train.mica_only", "sr3d_torch.train.legacy",
            "sr3d_torch.eval.validator", "sr3d_torch.eval.tester",
            "sr3d_torch.eval.now_protocol", "sr3d_torch.data.creation",
            "sr3d_torch.data.prepare", "sr3d_torch.utils.landmarks",
            "sr3d_torch.utils.bootstrap"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'sr3d_tpu'))\n"
            "print('LEAKED', bad) if bad else print('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "CLEAN", out.stdout


def test_entry_points_without_device_raise_where_no_gpu(tmp_path):
    """No device given means the GPU; without one they raise instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU path cannot be shown")
    from sr3d_torch.serve import Predictor
    from sr3d_torch.train.joint import build_joint

    cfg = t_update(t_defaults(), str(REPO / "configs" /
                                     "tiny_8_16_model2.yml"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_joint(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor.from_config(cfg, init_seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sr3d_torch.resolve_device(None)
    from sr3d_torch.cli.main import main
    from sr3d_torch.data.pipeline import prefetch_to_device

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["-c", str(REPO / "configs" / "tiny_8_16_model2.yml")])
    with pytest.raises(RuntimeError, match="CUDA"):
        next(prefetch_to_device(iter([{"x": np.zeros(2)}])))
    from sr3d_torch.eval.now_protocol import main as now_main

    with pytest.raises(RuntimeError, match="CUDA"):
        now_main(["--out", str(tmp_path), "-c",
                  str(REPO / "configs" / "tiny_8_16_model2.yml")])
    assert sr3d_torch.resolve_device("cpu") == torch.device("cpu")
