"""The int8 conv's short-row path against the paths it replaces, on the GPU.

    python -m sr3d_torch.profile_int8 [--out FILE]

At the 8 distinct int8 convs of one 8→32 UNet forward whose rows of x are
too short for a TMA box (the 4² and 2² levels, B = 8, bf16), with weights
quantized beforehand as ``Int8Conv`` keeps them: checks the kernel
``int8_plan`` picks (``deep``) and the first version (``mma``) bit for bit
against the plain version, then times (CUDA-graph replay between CUDA
events, weights and inputs rotated over more than the 50 MB L2, as a
forward's 64 MB of weights leave them) the kernel, the first version on
the same shape, the plain version, and the library route (im2col +
``torch._int_mm``, which the port never calls), beside the least time the
card could take (bytes at 3.35 TB/s or operations at 1979 TOP/s).  Prints
one JSON line a shape and, with ``--out``, writes them all.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import math

import torch
import torch.nn.functional as F

from .kernels.int8_conv import (
    Int8Plan,
    _launch,
    dynamic_scale,
    int8_conv_quantized,
    int8_conv_quantized_reference,
    int8_plan,
    prepare_weight,
    quantize_weight,
)
from .profile_conv import device_ms

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
# (B, Cin, H, W, O, stride, scale, count a forward) of the 8→32 UNet at
# the serving CLI's default (quant_min_res 1, resampling on)
SHAPES = ((8, 512, 2, 2, 512, 1, "static", 7),
          (8, 1024, 2, 2, 512, 1, "static", 3),
          (8, 256, 4, 4, 512, 1, "static", 1),
          (8, 512, 4, 4, 512, 1, "static", 6),
          (8, 512, 4, 4, 512, 1, "dynamic", 1),
          (8, 512, 4, 4, 512, 2, "dynamic", 1),
          (8, 1024, 4, 4, 512, 1, "static", 2),
          (8, 768, 4, 4, 512, 1, "static", 1))


def _library(x, wq, w_scale, bias, stride, a):
    """im2col + ``torch._int_mm`` on the same quantized weights (``wq``:
    int8 [O, Cin · 9], OIHW flattened)."""
    B, C, H, W = x.shape
    O = wq.shape[0]
    xq = torch.round(x.float() / a).clamp_(-127, 127)
    cols = F.unfold(xq.to(torch.bfloat16), 3, padding=1, stride=stride)
    L = cols.shape[-1]
    cols = cols.transpose(1, 2).reshape(B * L, -1).to(torch.int8)
    y = torch._int_mm(cols, wq.t())
    out = y.float() * (a * w_scale) + bias
    Ho = (H - 1) // stride + 1
    return (out.reshape(B, L, O).transpose(1, 2)
            .reshape(B, O, Ho, L // Ho).to(x.dtype))


def profile_shape(B, C, H, W, O, stride, scale, dev) -> dict:
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = int8_plan(B, C, H, W, O, stride, sm_count)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    dtype = torch.bfloat16
    static = scale == "static"
    nbytes = 9 * C * O + B * C * H * W * 2
    n = max(2, min(64, math.ceil(128e6 / nbytes)))
    sets = []
    for i in range(n):
        g = torch.Generator(device=dev).manual_seed(500 + i)
        w = (torch.randn(O, C, 3, 3, generator=g, device=dev)
             * (9 * C) ** -0.5)
        x = (torch.randn(B, C, H, W, generator=g, device=dev) * 2).to(dtype)
        b = torch.randn(O, generator=g, device=dev) * 0.1
        # the static step as a GroupNorm's affine gives it (gn_static_scale
        # over γ = 1 + 0.05·n): not a round number, or x / a would land on
        # exact half-integers far more often than a served model's does
        gamma = 1 + 0.05 * torch.randn(C, generator=g, device=dev)
        a = 6.0 * gamma.abs().amax() / 127.0
        sets.append((x, *prepare_weight(w), b, a,
                     quantize_weight(w)[0].reshape(O, -1)))
    state = {"i": 0}

    def nxt():
        state["i"] = (state["i"] + 1) % n
        return sets[state["i"]]

    def run(s):
        x, wk, ws, b, a, wq = s
        return int8_conv_quantized(x, wk, ws, b, stride=stride,
                                   a_scale=a if static else None)

    def first_version(s):
        x, wk, ws, b, a, wq = s
        a = a if static else dynamic_scale(x)
        out = torch.empty(B, O, Ho, Wo, dtype=dtype, device=dev)
        _launch(x, wk, ws, a.reshape(()), b, out, stride,
                plan=Int8Plan("mma", "the first version, for comparison"))
        return out

    def plain(s):
        x, wk, ws, b, a, wq = s
        return int8_conv_quantized_reference(x, wk, ws, b, stride=stride,
                                             a_scale=a if static else None)

    def library(s):
        x, wk, ws, b, a, wq = s
        a = a if static else dynamic_scale(x)
        return _library(x, wq, ws, b, stride, a)

    ref = plain(sets[0])
    out, again, old = run(sets[0]), run(sets[0]), first_version(sets[0])
    lib = library(sets[0])
    torch.cuda.synchronize()
    ops = 2 * B * Ho * Wo * O * 9 * C
    io = 9 * C * O + 2 * O * 4 + (B * C * H * W + B * O * Ho * Wo) * 2
    t_bytes, t_ops = io / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    row = {"shape": [B, C, H, W, O], "stride": stride, "scale": scale,
           "path": plan.path, "ctas": plan.ctas, "splits": plan.splits,
           "bit_equal": bool(torch.equal(out, ref)),
           "repeat_equal": bool(torch.equal(again, out)),
           "mma_bit_equal": bool(torch.equal(old, ref)),
           "library_equal": bool(torch.equal(lib, ref)),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    if not (row["bit_equal"] and row["repeat_equal"]):
        return row
    row["ms"] = device_ms(lambda: run(nxt()), reps=20)
    row["mma_ms"] = device_ms(lambda: first_version(nxt()), reps=5)
    row["plain_ms"] = device_ms(lambda: plain(nxt()), reps=2)
    row["library_ms"] = device_ms(lambda: library(nxt()), reps=5)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args()
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    rows = []
    for B, C, H, W, O, stride, scale, count in SHAPES:
        row = profile_shape(B, C, H, W, O, stride, scale, dev)
        row["count"] = count
        print(json.dumps(row), flush=True)
        rows.append(row)
    timed = [r for r in rows if "ms" in r]
    total = {k: sum(r[k] * r["count"] for r in timed)
             for k in ("ms", "mma_ms", "bound_ms")} if timed else {}
    summary = {"device": props.name, "forward_short_row_ms": total,
               "all_bit_equal": all(r["bit_equal"] and r["repeat_equal"]
                                    for r in rows)}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, **summary}, f, indent=1)
    if not summary["all_bit_equal"]:
        raise SystemExit("the short-row kernel differs from its plain "
                         "version")


if __name__ == "__main__":
    main()
