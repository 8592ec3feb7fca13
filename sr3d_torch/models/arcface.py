"""ArcFace identity encoder: iResNet (NCHW), eval and train mode.

Counterpart of ``sr3d_tpu/models/arcface.py`` (the insightface
``iresnet100`` topology): 3×3 stem, per-channel PReLU, four stages of
IBasicBlocks ([3, 13, 30, 3] for iresnet100), each stride 2, BN → flatten
→ FC to a 512-d embedding, and a final BatchNorm1d ("features") whose scale
is pinned to 1.  Convolutions run in ``dtype``; BatchNorm and the FC in
fp32, as the JAX module does.

BatchNorm follows flax's ``nn.BatchNorm`` (momentum 0.9), not
``nn.BatchNorm2d``: eval mode normalises with the running statistics;
train mode with the batch's mean and biased variance (one-pass, clamped at
0) and updates ``running = 0.9·running + 0.1·batch`` with that biased
variance too (``nn.BatchNorm2d`` would store the unbiased one).  Under
the parallel layer's data layout each rank holds its rows of the batch,
and the train-mode moments are summed over the data axis: the global
batch's, as flax's are under GSPMD.

The frozen prefix (``FROZEN_PREFIX_SCOPES``: stem and stages 1–3) stays in
eval mode under ``.train()`` unless ``train_frozen_prefix`` is set, as the
JAX module's ``train_frozen_prefix`` flag has it; the optimizer leaves the
parameters that ``frozen_prefix_mask`` names frozen out.

The flatten before ``fc`` is taken in NHWC order (h, w, c), as flax
flattens, so the JAX ``fc`` kernel loads unchanged.  Input: the ArcFace
blob, NCHW ``[B, 3, 112, 112]``, BGR in [−1, 1].

On the card an eval-mode, no-grad forward (serving, validation) is a CUDA
graph, as the UNet's is (``models/forward_graph.py``): iresnet100's some
two thousand operator calls, most of them the fp32 BatchNorm and PReLU
arithmetic of its 100 layers, are one launch.  The BatchNorm statistics
are buffers the graph reads in place, so an update of them shows in the
next replay.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..parallel import layout
from ..parallel.collectives import all_reduce_sum
from .forward_graph import ForwardGraphs
from .layers import Conv2d, Linear


class PReLU(nn.Module):
    """Per-channel PReLU with flax's parameter name ``alpha``."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.alpha.to(x.dtype)
        a = a[None, :, None, None] if x.dim() == 4 else a[None, :]
        return torch.where(x >= 0, x, a * x)


class BatchNorm(nn.Module):
    """BatchNorm over dim 1 in fp32 with flax's names (``scale``, ``bias``;
    statistics ``mean``, ``var``) and flax's arithmetic:
    ``(x − mean) · (scale · rsqrt(var + eps)) + bias``, from the running
    statistics in eval mode and from the batch's in train mode (see the
    module docstring)."""

    def __init__(self, channels: int, use_scale: bool = True,
                 eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = (nn.Parameter(torch.ones(channels)) if use_scale
                      else None)
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = [d for d in range(x.dim()) if d != 1]
            batch = layout.current().batch
            if batch is None or batch.size == 1:
                mean = xf.mean(dims)
                mean_sq = (xf * xf).mean(dims)
            else:
                # this rank holds its rows of the batch: the statistics
                # of the global batch, as flax's under GSPMD
                n = xf.numel() // xf.shape[1] * batch.size
                s, q = all_reduce_sum(torch.stack(
                    (xf.sum(dims), (xf * xf).sum(dims))), batch)
                mean, mean_sq = s / n, q / n
            var = (mean_sq - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1.0 - m) * mean)
                self.var.copy_(m * self.var + (1.0 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps)
        if self.scale is not None:
            mul = mul * self.scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class IBasicBlock(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int,
                 downsample: bool, dtype: torch.dtype):
        super().__init__()
        self.bn1 = BatchNorm(inplanes)
        self.conv1 = Conv2d(inplanes, planes, 3, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn2 = BatchNorm(planes)
        self.prelu = PReLU(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1,
                            bias=False, compute_dtype=dtype)
        self.bn3 = BatchNorm(planes)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, planes, 1, stride=stride,
                                          bias=False, compute_dtype=dtype)
            self.downsample_bn = BatchNorm(planes)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn3(self.conv2(self.prelu(self.bn2(self.conv1(
            self.bn1(x))))))
        identity = x
        if self.downsample_conv is not None:
            identity = self.downsample_bn(self.downsample_conv(x))
        return (out + identity).float()


class _Stage(nn.Sequential):
    def __init__(self, inplanes: int, planes: int, blocks: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.add_module("block0", IBasicBlock(inplanes, planes, stride, True,
                                              dtype))
        for i in range(1, blocks):
            self.add_module(f"block{i}",
                            IBasicBlock(planes, planes, 1, False, dtype))


class IResNet(nn.Module):
    """``layers=(3, 13, 30, 3)`` is iresnet100.  ``forward(x)``:
    ``[B, 3, 112, 112]`` → ``[B, num_features]`` fp32 embeddings."""

    def __init__(self, layers: Sequence[int] = (3, 13, 30, 3),
                 num_features: int = 512, dtype: torch.dtype = torch.bfloat16,
                 fc_scale: int = 7 * 7, train_frozen_prefix: bool = False):
        super().__init__()
        self.train_frozen_prefix = train_frozen_prefix
        self.conv1 = Conv2d(3, 64, 3, padding=1, bias=False,
                            compute_dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.prelu = PReLU(64)
        self.layer1 = _Stage(64, 64, layers[0], 2, dtype)
        self.layer2 = _Stage(64, 128, layers[1], 2, dtype)
        self.layer3 = _Stage(128, 256, layers[2], 2, dtype)
        self.layer4 = _Stage(256, 512, layers[3], 2, dtype)
        self.bn2 = BatchNorm(512)
        self.fc = Linear(512 * fc_scale, num_features)
        self.features = BatchNorm(num_features, use_scale=False)
        self._submodules = tuple(self.modules())
        self._graphs = ForwardGraphs(self)

    def train(self, mode: bool = True) -> "IResNet":
        """Train mode for stage 4 and the head; the frozen prefix stays in
        eval mode unless ``train_frozen_prefix``."""
        super().train(mode)
        if mode and not self.train_frozen_prefix:
            for name in FROZEN_PREFIX_SCOPES:
                getattr(self, name).train(False)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Runs through ``ForwardGraphs.run``: eagerly where any submodule
        is in train mode (BatchNorm would normalise with the batch's
        statistics and update its running ones)."""
        return self._graphs.run(
            self._forward, (x,), span="sr3d.arcface",
            eager=any(m.training for m in self._submodules))

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.prelu(self.bn1(self.conv1(x)))
        h = self.layer4(self.layer3(self.layer2(self.layer1(h))))
        h = self.bn2(h)
        h = h.permute(0, 2, 3, 1).flatten(1)   # flax's (h, w, c) order
        return self.features(self.fc(h))


FROZEN_PREFIX_SCOPES = ("conv1", "bn1", "prelu", "layer1", "layer2", "layer3")


def frozen_prefix_mask(net: IResNet) -> dict[str, bool]:
    """Parameter name → trainable, as the JAX package's mask labels the
    tree: a parameter is frozen when any scope on its path is one of
    ``FROZEN_PREFIX_SCOPES``.  That freezes the stem and stages 1–3, and
    also the ``conv1``/``bn1``/``prelu`` of every stage-4 block, whose
    scope names match at depth."""
    return {name: not any(part in FROZEN_PREFIX_SCOPES
                          for part in name.split(".")[:-1])
            for name, _ in net.named_parameters()}
