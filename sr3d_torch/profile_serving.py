"""Where a served face's time goes on the GPU.

    python -m sr3d_torch.profile_serving

Builds the serving ``Predictor`` as ``chip_smoke.py`` does (the 16→128
flagship config, DDIM-25, bf16, random weights from seed 0, synthetic FLAME
at the real size), then for batch 8 and batch 1:

* the host time of one UNet forward (the sampler's step), synchronised;
* a ``torch.profiler`` trace of three UNet forwards: device time by kernel,
  grouped (the port's GN+Swish and attention kernels, convolutions,
  elementwise ops, other) and the device's busy share of the wall time;
* the same over one whole request (25 steps + hand-off + MICA).

Prints a summary.  Needs a GPU.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
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


def _summarise(prof, wall_s: float, label: str,
               ranges: tuple[str, ...] = ()) -> None:
    """Device time by kernel group over ``wall_s``; ``ranges`` are
    profiler ranges, whose device-side spans are not kernels."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in ranges]
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


def main() -> None:
    from .config import get_cfg_defaults, update_cfg
    from .models.flame import synthetic_flame
    from .serve import Predictor

    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs an NVIDIA GPU")
    cfg = update_cfg(get_cfg_defaults(),
                     str(ROOT / "configs" / "sr_sr3_VGGF2_16_128_model2.yml"))
    d = cfg.sr.model.diffusion
    d.sampler, d.ddim_steps, d.ddim_eta, d.sampler_init = \
        "ddim", 25, 1.0, "marginal"
    cfg.tpu.compute_dtype = "bfloat16"
    dev = torch.device("cuda")
    flame = synthetic_flame(n_vertices=5023, n_shape=300, n_exp=100,
                            n_faces=9976, seed=0, device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for batch in (8, 1):
        p = Predictor.from_config(cfg, init_seed=0, batch_size=batch,
                                  flame=flame)
        p.warmup()
        unet = p.modules.unet
        x = torch.randn(batch, 6, 128, 128, device=dev)
        t = torch.full((batch, 1), 0.5, device=dev)
        with torch.no_grad():
            for _ in range(3):
                unet(x, t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                unet(x, t)
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / 10
            print(f"batch {batch}: UNet forward {step_s * 1e3:.2f} ms host "
                  f"wall (synchronised, mean of 10)")
            with profile(activities=acts) as prof:
                for _ in range(3):
                    unet(x, t)
                torch.cuda.synchronize()
        _summarise(prof, 3 * step_s, f"batch {batch} 3 UNet forwards")
        lr = np.random.RandomState(0).randint(0, 256, (batch, 16, 16, 3),
                                              np.uint8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.predict(lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with profile(activities=acts) as prof:
            p.predict(lr)
            torch.cuda.synchronize()
        _summarise(prof, wall, f"batch {batch} one request")
        del p, unet


if __name__ == "__main__":
    main()
