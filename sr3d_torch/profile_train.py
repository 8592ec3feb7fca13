"""Where a model3 train step's time goes on the GPU.

    python -m sr3d_torch.profile_train [--steps]

Builds the model3 joint step at the full width of
``configs/sr_sr3_VGGF2_16_128_model3.yml`` (bf16, random weights from seed
0, synthetic FLAME at the real size, N = K×B = 4 synthetic faces 16→128,
the DDIM-25 flow-through hand-off checkpointed per step, block remat, Adam /
AdamW, EMA), takes one step to warm up, then prints:

* the host time (synchronised) of one whole step, and of its parts run
  alone: the hand-off's forward and its backward (the checkpoints'
  recompute and the backward of a scalar of the sample), l_sr's forward +
  backward, and the MICA branch's forward + backward (ArcFace in train
  mode, mapping, FLAME, the vertex loss) on the hand-off's blob;
* a ``torch.profiler`` trace of one whole step: device time by kernel
  group, the device's busy share of the step's wall time, and the share of
  the step in GN+Swish's backward (the ``gn_swish_backward`` kernels,
  profiler range ``gn_swish.backward``) and in attention's backward (range
  ``spatial_attention.backward``), as device time and as host time.

``--steps`` instead times the three training steps whose time the GN+Swish
backward shares, at the flagship's full width in bf16: the SR-only step
(``SRModel``, B = 2, remat), the model2 joint step (the Trainer's bare
step: N = 4, DDIM-25 hand-off) and the model3 flow-through step (DDIM-25);
each warmed up twice, the median of three synchronised steps, then one
under ``torch.profiler`` for the ``gn_swish.backward`` range's calls, host
and device time and the device's busy share; a JSON line last.  It uses
only modules that every slice of the port since the parallel layer has, so
the same file run inside an older checkout times that checkout's
backward.

Needs a GPU.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
RANGES = ("gn_swish.backward", "spatial_attention.backward")
GROUPS = (("gn_swish one-pass (port)", ("gn_swish_onepass_kernel",)),
          ("gn_stats (port)", ("gn_stats_kernel",)),
          ("gn_swish apply (port)", ("gn_swish_apply_kernel",)),
          ("attention (port)", ("attn_mma_kernel", "attn_tiled_kernel")),
          ("cuDNN NCHW<->NHWC transposes", ("nchwtonhwc", "nhwctonchw")),
          ("convolution (cuDNN)", ("conv", "xmma", "implicit", "cutlass",
                                   "sm90", "gemm", "winograd")),
          ("fp32->bf16 casts", ("bfloat16_copy",)),
          ("elementwise / copy", ("elementwise", "copy", "cat", "fill",
                                  "reduce", "index", "upsample")))


def _device_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


def _kernels(prof) -> list:
    """The device-side entries of ``prof.key_averages()`` that are device
    work: the device-side shadows of named ranges (``RANGES`` and the
    program's ``sr3d.*`` spans) left out."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in RANGES and not e.key.startswith("sr3d.")]


def _summarise(prof, wall_s: float, label: str) -> None:
    """Device time by kernel group over ``wall_s``."""
    kernels = _kernels(prof)
    total_us = sum(_device_us(e) for e in kernels)
    by_group = {name: 0.0 for name, _ in GROUPS}
    by_group["other"] = 0.0
    for e in kernels:
        key = e.key.lower()
        for name, pats in GROUPS:
            if any(p in key for p in pats):
                by_group[name] += _device_us(e)
                break
        else:
            by_group["other"] += _device_us(e)
    # wall_s is measured without the profiler, whose own overhead would
    # stretch the host side
    busy = total_us / 1e3 / (wall_s * 1e3)
    print(f"  {label}: wall {wall_s * 1e3:.2f} ms, device busy "
          f"{total_us / 1e3:.2f} ms ({100 * busy:.1f}% of wall), "
          f"{sum(e.count for e in kernels)} kernel launches")
    for name, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"    {name:24s} {us / 1e3:8.3f} ms "
              f"({100 * us / max(total_us, 1e-9):5.1f}% of device time)")
    top = sorted(kernels, key=lambda e: -_device_us(e))[:8]
    for e in top:
        print(f"      {_device_us(e) / 1e3:8.3f} ms x{e.count:5d}  "
              f"{e.key[:90]}")


def _timed(fn) -> tuple[float, object]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def main() -> None:
    from .config import get_cfg_defaults, update_cfg
    from .data.synthetic import synthetic_face_batch
    from .diffusion.gaussian import ddim_sample_loop, p_losses_continuous
    from .models.flame import synthetic_flame
    from .models.masking import masked_vertex_l1
    from .ops.image import degrade_pair, sr_to_mica_inputs
    from .train.joint import (
        build_joint,
        decode_mica,
        encode_mica,
        gt_flame_vertices,
        init_train_state,
        make_train_step,
    )

    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs an NVIDIA GPU")
    cfg = update_cfg(get_cfg_defaults(), str(
        ROOT / "configs" / "sr_sr3_VGGF2_16_128_model3.yml"))
    cfg.tpu.compute_dtype = "bfloat16"
    cfg.sr.model.diffusion.train_sampler = "ddim"
    cfg.sr.model.diffusion.train_ddim_steps = 25
    dev = torch.device("cuda")
    n = int(cfg.mica.datasets.K) * int(cfg.mica.datasets.batch_size)
    lo, hi = (int(cfg.sr.datasets.train.l_resolution),
              int(cfg.sr.datasets.train.r_resolution))
    hr = torch.from_numpy(synthetic_face_batch(n, hi, seed=0))
    g = torch.Generator().manual_seed(0)
    batch = {"HR": hr, "SR": degrade_pair(hr, lo, hi)[1],
             "flame_shape": torch.randn(n, int(cfg.mica.model.n_shape),
                                        generator=g) * 0.3}
    flame = synthetic_flame(n_vertices=5023, n_shape=300, n_exp=100,
                            n_faces=9976, seed=0, device=dev)
    mods = build_joint(cfg, flame=flame, init_seed=0, device=dev)
    state = init_train_state(mods, cfg)
    step = make_train_step(cfg.sr.train.ema_scheduler)
    gen = torch.Generator(device=dev).manual_seed(0)

    def one_step():
        return step(mods, state, batch, generator=gen)[1]["loss"].item()

    one_step()   # warm-up: cuDNN plans, kernel builds
    t_step, _ = _timed(one_step)
    print(f"model3 step, N={n}, DDIM-25 flow-through hand-off: "
          f"{t_step:.3f} s host wall (synchronised)")

    # the parts, each alone
    hr_d = batch["HR"].to(dev).permute(0, 3, 1, 2).contiguous()
    cond = batch["SR"].to(dev).permute(0, 3, 1, 2).contiguous()
    t_fwd, final = _timed(lambda: ddim_sample_loop(
        functools.partial(mods.unet, remat=False), mods.sched_train, cond,
        num_steps=25, eta=1.0, init="marginal", generator=gen,
        differentiable=True, remat=True))
    t_bwd, _ = _timed(lambda: final.square().sum().backward())
    _, blob = sr_to_mica_inputs(final.detach().permute(0, 2, 3, 1),
                                differentiable=True)
    del final
    mods.unet.train()
    mods.arcface.train()
    try:
        t_sr, _ = _timed(lambda: (p_losses_continuous(
            mods.unet, mods.sched_train, hr_d, cond, generator=gen)
            / hr_d.numel()).backward())
        gt = gt_flame_vertices(mods, batch["flame_shape"].to(dev))
        blob.requires_grad_(True)
        t_mica, _ = _timed(lambda: masked_vertex_l1(
            decode_mica(mods, encode_mica(mods, blob))[0], gt,
            mods.vertex_weights).backward())
    finally:
        mods.unet.eval()
        mods.arcface.eval()
    state.opt.zero_grad(set_to_none=True)
    for name, t in (("hand-off forward (25 steps, on the tape)", t_fwd),
                    ("hand-off backward (recompute + backward)", t_bwd),
                    ("l_sr forward + backward", t_sr),
                    ("MICA branch forward + backward", t_mica)):
        print(f"  {name:42s} {t:8.3f} s ({100 * t / t_step:5.1f}% of a "
              f"step)")

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t_prof, _ = _timed(one_step)
    # busy share against the wall without the profiler, which slows the
    # host; the ranges' host shares against the profiled wall
    _summarise(prof, t_step, "one model3 step")
    print(f"  the profiled step: {t_prof:.3f} s host wall")
    cpu_side = torch.autograd.DeviceType.CPU
    events = prof.key_averages()
    total_us = sum(_device_us(e) for e in _kernels(prof))
    for name in RANGES:
        hits = [e for e in events
                if e.key == name and e.device_type == cpu_side]
        if not hits:
            print(f"  {name}: no range recorded")
            continue
        e = hits[0]
        dev_us = float(getattr(e, "device_time_total", None)
                       or e.cuda_time_total)
        cpu_us = float(e.cpu_time_total)
        print(f"  {name}: {e.count} calls, device {dev_us / 1e3:.3f} ms "
              f"({100 * dev_us / max(total_us, 1e-9):.1f}% of the step's "
              f"kernel time), host {cpu_us / 1e3:.3f} ms "
              f"({100 * cpu_us / 1e6 / t_prof:.1f}% of the profiled step)")


def _profiled(fn) -> dict:
    """One ``fn()`` under ``torch.profiler``: the ``gn_swish.backward``
    range's calls, host and device ms, their shares, and the device's busy
    share of the profiled wall."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = _timed(fn)
    events = prof.key_averages()
    kernel_us = sum(_device_us(e) for e in _kernels(prof))
    hits = [e for e in events if e.key == "gn_swish.backward"
            and e.device_type == torch.autograd.DeviceType.CPU]
    out = {"profiled_s": wall, "busy_pct": 100 * kernel_us / 1e6 / wall,
           "gn_bwd_calls": 0, "gn_bwd_host_ms": 0.0,
           "gn_bwd_host_pct": 0.0, "gn_bwd_device_ms": 0.0,
           "gn_bwd_device_pct": 0.0}
    if hits:
        e = hits[0]
        dev_us = float(getattr(e, "device_time_total", None)
                       or e.cuda_time_total)
        out.update(gn_bwd_calls=e.count,
                   gn_bwd_host_ms=e.cpu_time_total / 1e3,
                   gn_bwd_host_pct=100 * e.cpu_time_total / 1e6 / wall,
                   gn_bwd_device_ms=dev_us / 1e3,
                   gn_bwd_device_pct=100 * dev_us / max(kernel_us, 1e-9))
    return out


def steps() -> dict:
    """The SR-only, model2 and model3 steps' times and GN+Swish backward
    shares (see the module docstring); prints a line each and returns
    them."""
    from .config import get_cfg_defaults, update_cfg
    from .data.synthetic import synthetic_face_batch
    from .kernels import launch_counts, reset_launch_counts
    from .models.flame import synthetic_flame
    from .ops.image import degrade_pair
    from .train.joint import build_joint, init_train_state, make_train_step
    from .train.sr_only import SRModel

    dev = torch.device("cuda")
    flame = synthetic_flame(n_vertices=5023, n_shape=300, n_exp=100,
                            n_faces=9976, seed=0, device=dev)

    def config(name: str):
        cfg = update_cfg(get_cfg_defaults(), str(ROOT / "configs" / name))
        cfg.tpu.compute_dtype = "bfloat16"
        cfg.sr.model.diffusion.train_sampler = "ddim"
        cfg.sr.model.diffusion.train_ddim_steps = 25
        return cfg

    def measure(name: str, fn) -> dict:
        for _ in range(2):
            _timed(fn)
        walls = [_timed(fn)[0] for _ in range(3)]
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        bwd = launch_counts().get("gn_swish_backward", 0)
        r = {"step": name, "median_s": statistics.median(walls),
             "steps_s": walls, "gn_swish_backward_launches": bwd,
             **_profiled(fn)}
        print(f"{name}: median {r['median_s']:.3f} s of "
              f"{', '.join(f'{w:.3f}' for w in walls)}; under the profiler "
              f"{r['profiled_s']:.3f} s, device busy {r['busy_pct']:.1f}%; "
              f"gn_swish.backward {r['gn_bwd_calls']} calls, host "
              f"{r['gn_bwd_host_ms']:.1f} ms ({r['gn_bwd_host_pct']:.1f}%), "
              f"device {r['gn_bwd_device_ms']:.2f} ms "
              f"({r['gn_bwd_device_pct']:.1f}% of kernel time); "
              f"gn_swish_backward launches {bwd}")
        return r

    out = []
    cfg = config("sr_sr3_VGGF2_16_128_model2.yml")
    hi = int(cfg.sr.datasets.train.r_resolution)
    m = SRModel(cfg, device=dev, init_seed=0)
    st = m.init_state()
    sr_step = m.make_train_step()
    rng = np.random.RandomState(5)
    b = {k: torch.from_numpy(rng.uniform(-1, 1, (2, hi, hi, 3))
                             .astype(np.float32)).to(dev)
         for k in ("HR", "SR")}
    g = torch.Generator(device=dev).manual_seed(0)
    out.append(measure("SR-only step (B = 2)",
                       lambda: sr_step(st, b, generator=g)))
    del m, st, sr_step
    for name, label in (("sr_sr3_VGGF2_16_128_model2.yml",
                         "model2 joint step (N = 4, DDIM-25 hand-off)"),
                        ("sr_sr3_VGGF2_16_128_model3.yml",
                         "model3 flow-through step (N = 4, DDIM-25)")):
        cfg = config(name)
        n = int(cfg.mica.datasets.K) * int(cfg.mica.datasets.batch_size)
        lo = int(cfg.sr.datasets.train.l_resolution)
        hr = torch.from_numpy(synthetic_face_batch(n, hi, seed=0))
        gen = torch.Generator().manual_seed(0)
        batch = {"HR": hr, "SR": degrade_pair(hr, lo, hi)[1],
                 "flame_shape": torch.randn(
                     n, int(cfg.mica.model.n_shape), generator=gen) * 0.3}
        mods = build_joint(cfg, flame=flame, init_seed=0, device=dev)
        state = init_train_state(mods, cfg)
        step = make_train_step(cfg.sr.train.ema_scheduler)
        g = torch.Generator(device=dev).manual_seed(0)
        out.append(measure(label, lambda: step(mods, state, batch,
                                               generator=g)))
        del mods, state, step
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"device": smi, "root": str(ROOT), "steps": out}))
    return {"device": smi, "steps": out}


if __name__ == "__main__":
    if "--steps" in sys.argv[1:]:
        if not torch.cuda.is_available():
            raise SystemExit("profile_train needs an NVIDIA GPU")
        steps()
    else:
        main()
