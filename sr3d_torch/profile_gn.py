"""The one-pass GN+Swish kernel under other plans than ``gn_plan``'s.

    python -m sr3d_torch.profile_gn

For each GN+Swish shape of the flagship UNet's main path (bf16, G = 32),
the device time (CUDA-graph replay between CUDA events, inputs rotated over
more than the 50 MB L2) of ``gn_swish`` with ``gn_plan``'s plan, of the
one-pass kernel at every other cluster size (1, 2, 4, 8) and CTA width
(128, 256 threads) whose share fits its shared memory, of the stats +
apply pair, and of ``F.silu(F.group_norm)``, beside the bound (one read
and one write of x at 3.35 TB/s).  Needs a GPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .kernels.groupnorm_swish import (
    GN_CTA_BYTES,
    GnPlan,
    _launch_gn_swish,
    gn_plan,
)
from .profile_conv import device_ms

SHAPES = ((8, 192, 128, 128), (8, 64, 128, 128), (8, 384, 64, 64),
          (8, 768, 32, 32), (8, 1024, 16, 16), (8, 1024, 8, 8),
          (8, 512, 8, 8), (1, 64, 128, 128))
G = 32


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_gn needs an NVIDIA GPU")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, C, H, W in SHAPES:
        nbytes = B * C * H * W * 2
        n_sets = max(2, min(64, math.ceil(128e6 / nbytes)))
        g = torch.Generator(device=dev).manual_seed(0)
        sets = [((torch.randn(B, C, H, W, generator=g, device=dev) * 2
                  + 0.5).bfloat16(),
                 torch.rand(C, generator=g, device=dev) + 0.5,
                 torch.randn(C, generator=g, device=dev) * 0.1)
                for _ in range(n_sets)]
        state = {"i": 0}

        def nxt():
            state["i"] = (state["i"] + 1) % n_sets
            return sets[state["i"]]

        def library():
            x, gamma, beta = nxt()
            return F.silu(F.group_norm(x, G, gamma.bfloat16(),
                                       beta.bfloat16(), 1e-5))

        two_pass = GnPlan("two_pass", "")
        best = gn_plan(B, C, G, H * W, torch.bfloat16, sms)
        n = best.group_vectors
        print(f"x={[B, C, H, W]} bf16: bound "
              f"{2 * nbytes / 3.35e12 * 1e3:.4f} ms; library "
              f"{device_ms(library):.4f}; stats + apply "
              f"{device_ms(lambda: _launch_gn_swish(*nxt(), G, 1e-5,
                                                    two_pass)):.4f}")
        for S in (1, 2, 4, 8):
            if 16 * -(-n // S) > GN_CTA_BYTES:
                continue
            for T in (128, 256):
                plan = GnPlan("onepass", "", S, T, n)
                ms = device_ms(
                    lambda: _launch_gn_swish(*nxt(), G, 1e-5, plan))
                mark = " <- gn_plan" if (S, T) == (best.cluster,
                                                   best.threads) else ""
                print(f"  one-pass, clusters of {S}, {T} threads: "
                      f"{ms:.4f} ms{mark}")
        del sets


if __name__ == "__main__":
    main()
