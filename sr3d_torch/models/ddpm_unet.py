"""DDPM UNet family (integer timesteps), NCHW.

Counterpart of ``sr3d_tpu/models/ddpm_unet.py``, the reference's second
UNet family, selected by ``which_model_G: ddpm``: a sinusoidal
``TimeEmbedding`` of the integer timestep t (cast to fp32) → Dense → Swish
→ Dense, added in every ResnetBlock as ``h += mlp(swish(t_emb))`` between
its two conv blocks (the SR3 family applies a ``FeatureWiseAffine`` of the
continuous noise level there instead).

Everything else is the SR3 UNet's (``models/sr3_unet.py``): the topology
with its ``image_size`` attention track and ``mid_0`` attention, the
GN+Swish ``ConvBlock``s and the self-attention on the port's CUDA kernels,
the per-block checkpoints under ``remat``, dropout in ``block2``, and the
int8 gates of ``forward(..., quant=True)``.  Parameters carry the flax
scope names (``time_mlp.dense0``, ``down_0_0.res_block.mlp``, ...), so
``utils/bridge.py`` carries them both ways.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .layers import Conv2d, Linear
from .sr3_unet import ConvBlock, SR3UNet, swish


class TimeEmbedding(nn.Module):
    """Integer t ``[B]`` → ``[sin(t·f), cos(t·f)]``, ``f = exp(−ln(10⁴)·k /
    (dim/2))``, → ``dense0`` (4·dim) → Swish → ``dense1`` (dim)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dim = dim
        self.dense0 = Linear(dim, dim * 4, compute_dtype=dtype)
        self.dense1 = Linear(dim * 4, dim, compute_dtype=dtype)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        t = t.reshape(-1).float()
        half = self.dim // 2
        freqs = torch.exp(-math.log(1e4) * torch.arange(
            half, dtype=torch.float32, device=t.device) / half)
        ang = t[:, None] * freqs[None]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.dense1(swish(self.dense0(emb)))


class DDPMResnetBlock(nn.Module):
    """``block1`` (no dropout) → ``+ mlp(swish(t_emb))`` → ``block2``
    (dropout) → ``+`` the input, through a 1×1 ``res_conv`` where the width
    changes."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int,
                 dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        self.block1 = ConvBlock(dim_in, dim_out, groups, dtype)
        self.mlp = Linear(time_dim, dim_out, compute_dtype=dtype)
        self.block2 = ConvBlock(dim_out, dim_out, groups, dtype, dropout)
        self.res_conv = (Conv2d(dim_in, dim_out, 1, compute_dtype=dtype)
                         if dim_in != dim_out else None)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                generator: torch.Generator | None = None,
                quant: bool = False) -> torch.Tensor:
        h = self.block1(x, quant=quant)
        h = h + self.mlp(swish(time_emb))[:, :, None, None]
        h = self.block2(h, generator, quant)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class DDPMUNet(SR3UNet):
    """``forward(x, t)`` with integer timesteps ``t`` of shape [B]; the
    rest as :class:`SR3UNet`."""

    time_name = "time_mlp"
    resnet = DDPMResnetBlock

    @staticmethod
    def time_embedding(dim: int, dtype: torch.dtype) -> nn.Module:
        return TimeEmbedding(dim, dtype)
