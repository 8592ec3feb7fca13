"""The work a served face needs, counted from the benchmark's own reference,
and the card's published peaks.

``serve_flops_per_face`` runs the plain reference on the ``meta`` device (no
memory, no arithmetic) with a tally: 2 FLOPs a multiply-add of every conv,
dense layer and attention product, and FLAME's blend, each under the
precision the configuration states for it (``reference/ops.py``).  The
count is the same whatever implements the work.  The image resizes (about
60 MFLOP a face in fp32) are left out, so the least time below is a lower
bound.

``PEAK_OPS``, ``HBM_BYTES_PER_S`` and ``bound`` are copied from
``chip_smoke.py`` at commit b9e9277 (NVIDIA's data sheet, H100 SXM, dense
rates at the full 700 W power limit), keyed by precision name.
"""

from __future__ import annotations

import torch

from .reference import mica, unet
from .reference.ops import Arith
from .weights import specs

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
PEAK_OPS = {"bf16": 989e12,         # dense bf16 tensor-core rate
            "fp32": 67e12,          # fp32 outside the tensor cores
            "int8": 1979e12}        # dense int8 tensor-core rate


def bound(nbytes: float, ops: float, precision: str) -> tuple[float, str]:
    """The least milliseconds of an op: the larger of its bytes over the
    HBM bandwidth and its operations over the precision's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[precision] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _meta_params(leaves) -> dict:
    return {n: torch.empty(s, device="meta") for n, s, _ in leaves}


def unet_flops(spec: dict, res: int, quant: bool) -> dict[str, float]:
    """One face's UNet forward at ``res``², by stated precision."""
    tally: dict[str, float] = {}
    p = _meta_params(specs(spec)["unet"])
    x = torch.empty(1, int(spec["unet"]["in_channel"]), res, res,
                    device="meta")
    unet.unet_forward(p, spec["unet"], spec["image_size"], x,
                      torch.empty(1, 1, device="meta"), Arith(tally=tally),
                      quant)
    return tally


def mica_flops(spec: dict, blob: int = 112) -> dict[str, float]:
    """One face's ArcFace, mapping and FLAME decode, by stated precision."""
    tally: dict[str, float] = {}
    ar = Arith(tally=tally)
    s = specs(spec)
    m = spec["mica"]
    emb = mica.arcface_forward(_meta_params(s["arcface"]),
                               m["arcface_layers"],
                               torch.empty(1, 3, blob, blob, device="meta"),
                               ar)
    mica.mapping_forward(_meta_params(s["mapping"]),
                         int(m["mapping_layers"]), emb, ar)
    ar.einsum_flops("fp32", 2.0 * int(m["n_vertices"]) * 3 * int(m["n_shape"]))
    return tally


def serve_flops_per_face(spec: dict) -> dict[str, float]:
    """A served face: ``steps`` UNet forwards at the SR size and the MICA
    branch, by stated precision."""
    quant = int(spec["unet"].get("quant_min_res", 0) or 0) > 0
    out = {k: v * int(spec["sampler"]["steps"])
           for k, v in unet_flops(spec, int(spec["hr"]), quant).items()}
    for k, v in mica_flops(spec).items():
        out[k] = out.get(k, 0.0) + v
    return out


def least_seconds(flops: dict[str, float]) -> float:
    """The least time of ``flops`` at the peaks of their precisions."""
    return sum(v / PEAK_OPS[k] for k, v in flops.items())
