"""Where the conv kernels' time goes on the GPU.

    python -m sr3d_torch.profile_conv

For the fused GN→Swish→conv3×3 block at the flagship UNet's bf16 shapes,
the device time (CUDA-graph replay between CUDA events, inputs rotated
over more than the 50 MB L2) of:

* the whole ``fused_gn_swish_conv3x3`` call;
* its statistics pass alone (``gn_stats`` on NHWC) and with the torch
  epilogue that folds the moments into per-(B, C) mean and scale;
* ``conv3x3`` on the same x and w: the tensor-core core without the
  prologue;

and what is left, the prologue's activation inside the kernel.  Prints the
plan of each shape.  Needs a GPU.
"""

from __future__ import annotations

import math

import torch

from .kernels import conv3x3, fused_gn_swish_conv3x3, gn_stats
from .kernels.conv3x3 import conv_plan
from .kernels.groupnorm_swish import gn_mean_scale

SHAPES = (((8, 128, 128, 64), 64), ((8, 128, 128, 192), 64),
          ((8, 8, 8, 1024), 512), ((8, 128, 128, 128), 128))
G = 32


def device_ms(fn, reps: int = 5) -> float:
    """Device time of one ``fn()``: ``reps`` calls in a CUDA graph,
    replayed five times between CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def _inputs(shape, O, dev):
    """Enough input sets to exceed the L2, and a function cycling them."""
    B, H, W, C = shape
    n = max(2, min(64, math.ceil(128e6 / (B * H * W * C * 2))))
    sets = []
    for i in range(n):
        g = torch.Generator().manual_seed(i)
        sets.append(((torch.randn(shape, generator=g) * 2 + 0.5)
                     .to(torch.bfloat16).to(dev),
                     (torch.randn(3, 3, C, O, generator=g) * (9 * C) ** -0.5)
                     .to(torch.bfloat16).to(dev),
                     (torch.randn(O, generator=g) * 0.1).to(dev),
                     (torch.rand(C, generator=g) + 0.5).to(dev),
                     (torch.randn(C, generator=g) * 0.1).to(dev)))
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return sets[state["i"]]

    return nxt


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_conv: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}, {sms} SMs; device ms")
    for shape, O in SHAPES:
        B, H, W, C = shape
        nxt = _inputs(shape, O, dev)

        def stats(a):
            s, q = gn_stats(a[0], channels_last=True)
            return gn_mean_scale(s, q, a[3], float(H * W * (C // G)), G,
                                 1e-5)

        t = {"fused": device_ms(lambda: (lambda a: fused_gn_swish_conv3x3(
                 a[0], a[3], a[4], a[1], a[2], G))(nxt())),
             "stats": device_ms(lambda: gn_stats(nxt()[0],
                                                 channels_last=True)),
             "stats+epilogue": device_ms(lambda: stats(nxt())),
             "conv3x3": device_ms(lambda: (lambda a: conv3x3(
                 a[0], a[1], a[2]))(nxt()))}
        rest = t["fused"] - t["stats+epilogue"] - t["conv3x3"]
        plan = conv_plan(B, H, W, C, O, torch.bfloat16, sms)
        tf = 2 * B * H * W * C * O * 9 / 1e9
        print(f"{list(shape)}->{O} ({plan.path}, splits {plan.splits}): "
              f"fused {t['fused']:.4f} = stats {t['stats']:.4f} + torch "
              f"epilogue {t['stats+epilogue'] - t['stats']:.4f} + conv core "
              f"{t['conv3x3']:.4f} ({tf / t['conv3x3']:.0f} TF/s) + "
              f"activation {rest:.4f}")


if __name__ == "__main__":
    main()
