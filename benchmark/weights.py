"""Seeded random weights for the reference's parameter specs, made on the
device in one draw.

One N(0, 1) draw from a ``torch.Generator`` on the device covers every
parameter; each leaf is a view of it, scaled in place by its kind: conv and
dense weights by 1/sqrt(fan_in) (LeCun normal), norm scales 1 + 0.05·n,
biases and running means 0.05·n, PReLU slopes 0.25 + 0.05·n, running
variances 1 + 0.05·|n|.  The same seed gives the same weights on the same
device type.
"""

from __future__ import annotations

import math

import torch

from .inputs import seed32
from .reference import mica, unet


def specs(spec: dict) -> dict[str, list]:
    """``{"unet", "arcface", "mapping"}`` → ``[(name, shape, kind)]``."""
    m = spec["mica"]
    return {
        "unet": unet.unet_specs(spec["unet"], spec["image_size"]),
        "arcface": mica.arcface_specs(m["arcface_layers"]),
        "mapping": mica.mapping_specs(512, int(m["map_hidden_dim"]),
                                      int(m["n_shape"]),
                                      int(m["mapping_layers"])),
    }


def make(spec: dict, seed: int, device) -> dict[str, dict]:
    """Every network's parameters as fp32 tensors on ``device``."""
    groups = specs(spec)
    total = sum(math.prod(s) for g in groups.values() for _, s, _ in g)
    gen = torch.Generator(device).manual_seed(seed32(seed, "weights"))
    buf = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    with torch.no_grad():
        for net, leaves in groups.items():
            out[net] = {}
            for name, shape, kind in leaves:
                n = math.prod(shape)
                t = buf[off:off + n].view(shape)
                off += n
                if kind == "w":
                    t.mul_(1.0 / math.sqrt(n // shape[0]))
                elif kind == "one":
                    t.mul_(0.05).add_(1.0)
                elif kind == "zero":
                    t.mul_(0.05)
                elif kind == "alpha":
                    t.mul_(0.05).add_(0.25)
                elif kind == "var":
                    t.abs_().mul_(0.05).add_(1.0)
                else:
                    raise ValueError(f"unknown parameter kind {kind!r}")
                out[net][name] = t
    return out
