"""Post-training w8a8 int8 convolution for serving.

Counterpart of ``sr3d_tpu/ops/quant.py``: ``int8_conv`` (the wrapper of
``kernels/int8_conv.py``: the plain version on the CPU, the hand-written
CUDA kernel on the GPU) and ``Int8Conv``, a ``Conv2d`` with the same
parameters (``weight`` OIHW and ``bias``, fp32) whose forward runs the int8
conv when asked to at call time.  A checkpoint of the fp UNet loads into it
unchanged, and one module serves fp training and int8 sampling.

Inference only: rounding has no gradient, so a train step never asks for it
(model3's differentiable hand-off included).
"""

from __future__ import annotations

import torch

from ..kernels.int8_conv import int8_conv
from ..models.layers import Conv2d

__all__ = ["Int8Conv", "gn_static_scale", "int8_conv"]


def gn_static_scale(gamma: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """The static activation step of a conv fed by GroupNorm → swish with
    affine (γ, β): ``max(6·max|γ| + max|β|, 1e-3) / 127``.  GN's output is
    zero-mean unit-variance per group, so ±6σ is covered and outliers clip
    (``sr3d_tpu/models/sr3_unet.py::ConvBlock``).  fp32, 0-d, on γ's
    device: no host round trip."""
    bound = (6.0 * gamma.abs().amax() + beta.abs().amax()).clamp_min(1e-3)
    return bound / 127.0


class Int8Conv(Conv2d):
    """``Conv2d`` whose forward, with ``quant=True``, is the w8a8 int8 conv
    (a static ``a_scale``, or the dynamic per-tensor one), returning
    ``compute_dtype``; with ``quant=False`` it is ``Conv2d``'s."""

    def forward(self, x: torch.Tensor, quant: bool = False,
                a_scale: torch.Tensor | None = None) -> torch.Tensor:
        if not quant:
            return super().forward(x)
        return int8_conv(x.contiguous(), self.weight, self.bias,
                         stride=self.stride[0], padding=self.padding[0],
                         out_dtype=self.compute_dtype, a_scale=a_scale)
