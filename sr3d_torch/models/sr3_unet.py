"""SR3 denoising UNet (NCHW), for sampling, serving and training.

Counterpart of ``sr3d_tpu/models/sr3_unet.py``, the topology of the
reference UNet:

* γ-conditioning: ``PositionalEncoding`` of the continuous noise level →
  MLP (Linear→Swish→Linear);
* ``FeatureWiseAffine`` time injection between the two conv blocks of every
  ResnetBlock;
* GroupNorm→Swish→Conv3×3 blocks (GroupNorm+Swish on the port's CUDA
  kernel), 1×1 residual projection;
* full-spatial single-head self-attention (the port's CUDA kernel) scaled by
  ``1/sqrt(C)`` over the full channel count, at the resolutions where the
  ``image_size``-seeded resolution track meets ``attn_res`` — the reference
  configs set ``image_size: 224`` over 128² data, which leaves attention at
  the mid block only;
* encoder/mid/decoder with the reference's skip-concat order.

Submodules carry the flax scope names (``down_0_0.res_block.block1.norm``,
``mid_0.attn.qkv``, ...), so ``utils/bridge.py`` maps a JAX parameter tree
onto this module by transposing, not renaming.  Parameters are fp32 and
activations run in ``dtype`` (bf16 by default).

The w8a8 int8 serving path (``ops/quant.py``) is a call-time switch,
``forward(..., quant=True)``, as in the JAX package: the ResnetBlocks'
convs quantize at levels whose actual activation resolution (the NCHW
``shape[2]``, not the ``image_size`` track) is at least ``quant_min_res``
(0: never), each with the static activation scale of its GN affine;
with ``quant_resample`` the Downsample and Upsample convs too (the
Upsample gated on its resolution after the 2× resize), with the dynamic
scale.  The mid blocks, ``conv_in``, ``res_conv`` and ``final_conv``
never quantize.  The convs that can are ``Int8Conv``s, ``Conv2d``s with
the same parameters, so checkpoints load unchanged and ``quant=False``
is the fp forward bit for bit.

Train mode (``.train()``) adds what flax's ``remat=True`` adds: with
``remat``, each ``ResnetBlocWithAttn`` runs under
``torch.utils.checkpoint`` (non-reentrant).  ``forward(...,
deterministic=False)`` in train mode adds what flax's
``deterministic=False`` adds: dropout at ``dropout`` in ``block2`` of every
ResnetBlock only (after GN+Swish, before the conv), inverted-scaled by
1/(1−p) as flax's ``nn.Dropout``.  Its masks come from an explicit
``torch.Generator`` passed to ``forward``: one seed per
``ResnetBlocWithAttn`` is drawn from it before the block runs, and the
block draws its mask from a generator seeded with it.  The checkpoint
restores only the global RNG state on recompute, which is why the seed is
drawn outside the checkpointed call: the recompute draws the same mask.
``deterministic`` defaults to True, as flax's ``SR3UNet.__call__`` does.

``eval()`` is the serving forward: no dropout, no checkpoint.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import spatial_attention
from ..kernels.groupnorm_swish import gn_swish
from ..ops.quant import Int8Conv, gn_static_scale
from .layers import Conv2d, Linear


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def positional_encoding(noise_level: torch.Tensor, dim: int) -> torch.Tensor:
    """γ [B, 1] → [sin(γ·10⁴^{-k/c}), cos(·)], dim = 2c, fp32."""
    count = dim // 2
    step = torch.arange(count, dtype=torch.float32,
                        device=noise_level.device) / count
    enc = noise_level.float() * torch.exp(-math.log(1e4) * step)[None, :]
    return torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)


class NoiseLevelMLP(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dim = dim
        self.dense0 = Linear(dim, dim * 4, compute_dtype=dtype)
        self.dense1 = Linear(dim * 4, dim, compute_dtype=dtype)

    def forward(self, noise_level: torch.Tensor) -> torch.Tensor:
        x = positional_encoding(noise_level, self.dim)
        return self.dense1(swish(self.dense0(x)))


class FeatureWiseAffine(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dtype: torch.dtype):
        super().__init__()
        self.noise_func = Linear(dim_in, dim_out, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, noise_embed: torch.Tensor
                ) -> torch.Tensor:
        return x + self.noise_func(noise_embed)[:, :, None, None]


class GroupNormSwish(nn.Module):
    """GroupNorm + Swish on the CUDA kernel (plain version on the CPU),
    output in the input's dtype; parameters ``scale``/``bias`` as flax's
    ``nn.GroupNorm``."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gn_swish(x.contiguous(), self.scale, self.bias, self.groups,
                        self.eps)


class GroupNorm(nn.Module):
    """Plain GroupNorm computed and returned in fp32 (flax
    ``nn.GroupNorm(dtype=float32)``), as attention's pre-norm uses it."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.groups, self.scale, self.bias,
                            self.eps)


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 − rate, kept values
    scaled by 1/(1 − rate), in ``x.dtype``; the mask is drawn from
    ``generator`` (on ``x``'s device)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ConvBlock(nn.Module):
    """GroupNorm → Swish → (Dropout) → Conv3×3 (the reference ``Block``);
    ``quant`` runs the conv in int8 with the static scale of the GN
    affine."""

    def __init__(self, dim_in: int, dim_out: int, groups: int,
                 dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm = GroupNormSwish(dim_in, groups)
        self.conv = Int8Conv(dim_in, dim_out, 3, padding=1,
                             compute_dtype=dtype)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                quant: bool = False) -> torch.Tensor:
        h = self.norm(x)
        if generator is not None and self.dropout > 0.0:
            h = apply_dropout(h, self.dropout, generator)
        if quant:
            return self.conv(h, quant=True, a_scale=gn_static_scale(
                self.norm.scale, self.norm.bias))
        return self.conv(h)


class ResnetBlock(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int,
                 dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        self.block1 = ConvBlock(dim_in, dim_out, groups, dtype)
        self.noise_func = FeatureWiseAffine(time_dim, dim_out, dtype)
        self.block2 = ConvBlock(dim_out, dim_out, groups, dtype, dropout)
        self.res_conv = (Conv2d(dim_in, dim_out, 1, compute_dtype=dtype)
                         if dim_in != dim_out else None)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                generator: torch.Generator | None = None,
                quant: bool = False) -> torch.Tensor:
        h = self.block1(x, quant=quant)
        h = self.noise_func(h, time_emb)
        h = self.block2(h, generator, quant)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class SelfAttention(nn.Module):
    """Dense spatial self-attention over all H·W tokens (single head)."""

    def __init__(self, channels: int, groups: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = GroupNorm(channels, groups)
        self.qkv = Conv2d(channels, channels * 3, 1, bias=False,
                          compute_dtype=dtype)
        self.out = Conv2d(channels, channels, 1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        qkv = self.qkv(self.norm(x).to(self.dtype))            # [B, 3C, H, W]
        qkv = qkv.flatten(2).transpose(1, 2)                   # [B, HW, 3C]
        q, k, v = (t.contiguous() for t in qkv.split(C, dim=-1))
        out = spatial_attention(q, k, v, channels=C)           # [B, HW, C]
        out = out.transpose(1, 2).reshape(B, C, H, W).to(self.dtype)
        return self.out(out) + x


class ResnetBlocWithAttn(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int,
                 with_attn: bool, dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        self.res_block = ResnetBlock(dim_in, dim_out, time_dim, groups, dtype,
                                     dropout)
        self.attn = (SelfAttention(dim_out, groups, dtype) if with_attn
                     else None)

    def forward(self, x: torch.Tensor, time_emb: torch.Tensor,
                seed: int | None = None, quant: bool = False
                ) -> torch.Tensor:
        """``seed`` seeds this call's dropout masks (train mode);
        ``quant`` runs the ResnetBlock's convs in int8."""
        gen = None
        if seed is not None:
            gen = torch.Generator(device=x.device).manual_seed(seed)
        x = self.res_block(x, time_emb, gen, quant)
        return x if self.attn is None else self.attn(x)


class Downsample(nn.Module):
    """Strided 3×3 conv; ``quant``: int8 with the dynamic scale (a
    residual sum has no GN affine to bound it)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Int8Conv(dim, dim, 3, stride=2, padding=1,
                             compute_dtype=dtype)

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        return self.conv(x, quant=quant)


class Upsample(nn.Module):
    """Nearest 2× resize + 3×3 conv; ``quant`` as ``Downsample``'s, its
    scale taken after the resize."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.conv = Int8Conv(dim, dim, 3, padding=1, compute_dtype=dtype)

    def forward(self, x: torch.Tensor, quant: bool = False) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"),
                         quant=quant)


class SR3UNet(nn.Module):
    """``forward(x, time)``: ``x`` is NCHW with ``in_channel`` channels (the
    conditional concat [upsampled LR, x_t]), ``time`` the continuous noise
    level γ of shape [B, 1].  Returns NCHW noise in ``x``'s dtype."""

    def __init__(self, in_channel: int = 6, out_channel: int = 3,
                 inner_channel: int = 64, norm_groups: int = 32,
                 channel_mults: Sequence[int] = (1, 2, 4, 8, 8),
                 attn_res: Sequence[int] = (16,), res_blocks: int = 2,
                 image_size: int = 128, dtype: torch.dtype = torch.bfloat16,
                 quant_min_res: int = 0, quant_resample: bool = False,
                 dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.quant_min_res = int(quant_min_res)
        self.quant_resample = bool(quant_resample)
        self.in_channel = in_channel
        self.dtype = dtype
        self.dropout, self.remat = dropout, remat
        g, inner = norm_groups, inner_channel
        self.noise_level_mlp = NoiseLevelMLP(inner, dtype)
        self.conv_in = Conv2d(in_channel, inner, 3, padding=1,
                              compute_dtype=dtype)

        # The forward walks self.plan; the channel bookkeeping mirrors the
        # flax module's trace-time shapes.
        self.plan: list[tuple[str, str]] = []
        attn_res = set(attn_res)
        now_res = image_size
        feats = [inner]
        ch = inner
        n = len(channel_mults)
        for ind in range(n):
            use_attn = now_res in attn_res
            out = inner * channel_mults[ind]
            for b in range(res_blocks):
                self._add("down", f"down_{ind}_{b}", ResnetBlocWithAttn(
                    ch, out, inner, g, use_attn, dtype, dropout))
                ch = out
                feats.append(ch)
            if ind != n - 1:
                self._add("downsample", f"downsample_{ind}",
                          Downsample(ch, dtype))
                feats.append(ch)
                now_res //= 2
        self._add("mid", "mid_0",
                  ResnetBlocWithAttn(ch, ch, inner, g, True, dtype, dropout))
        self._add("mid", "mid_1",
                  ResnetBlocWithAttn(ch, ch, inner, g, False, dtype, dropout))
        for ind in reversed(range(n)):
            use_attn = now_res in attn_res
            out = inner * channel_mults[ind]
            for b in range(res_blocks + 1):
                self._add("up", f"up_{ind}_{b}", ResnetBlocWithAttn(
                    ch + feats.pop(), out, inner, g, use_attn, dtype,
                    dropout))
                ch = out
            if ind != 0:
                self._add("upsample", f"upsample_{ind}", Upsample(ch, dtype))
                now_res *= 2
        self.final_conv = ConvBlock(ch, out_channel, g, dtype)

    def _add(self, kind: str, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.plan.append((kind, name))

    def _quant_gate(self, kind: str, res: int) -> bool:
        """Whether a ``kind`` step whose input is ``res`` pixels high
        quantizes (under ``forward(quant=True)``)."""
        if kind == "upsample":
            res *= 2     # the conv runs after the 2× resize
        if kind in ("downsample", "upsample") and not self.quant_resample:
            return False
        return kind != "mid" and 0 < self.quant_min_res <= res

    def forward(self, x: torch.Tensor, time: torch.Tensor, *,
                generator: torch.Generator | None = None,
                deterministic: bool = True,
                remat: bool | None = None,
                quant: bool = False) -> torch.Tensor:
        """Dropout is drawn only in train mode with ``deterministic=False``
        and dropout > 0; then ``generator`` (on ``x``'s device) is
        required: it seeds every block's dropout masks.  ``remat``
        (default: train mode and ``self.remat``) checkpoints the blocks
        where grad is enabled; a caller that checkpoints the whole forward
        fixes it, so that the recompute runs as the forward did whatever
        the mode is by then.  ``quant`` runs the convs that
        ``quant_min_res`` / ``quant_resample`` select in int8 (serving
        only: rounding has no gradient)."""
        in_dtype = x.dtype
        drop = self.training and not deterministic and self.dropout > 0.0
        if drop and generator is None:
            raise ValueError("SR3UNet: train-mode dropout needs an explicit "
                             "torch.Generator")
        if remat is None:
            remat = self.training and self.remat
        remat = remat and torch.is_grad_enabled()
        blocks = [n for k, n in self.plan if k in ("down", "mid", "up")]
        seeds = dict.fromkeys(blocks)
        if drop:
            seeds = dict(zip(blocks, torch.randint(
                0, 2 ** 62, (len(blocks),), generator=generator,
                device=generator.device).tolist()))
        t = self.noise_level_mlp(time)
        h = self.conv_in(x.to(self.dtype))
        feats = [h]
        for kind, name in self.plan:
            mod = getattr(self, name)
            q = quant and self._quant_gate(kind, h.shape[2])
            if kind in ("down", "mid", "up"):
                if kind == "up":
                    h = torch.cat([h, feats.pop()], dim=1)
                if remat:
                    h = checkpoint(mod, h, t, seeds[name], q,
                                   use_reentrant=False)
                else:
                    h = mod(h, t, seeds[name], q)
            else:
                h = mod(h, q)
            if kind in ("down", "downsample"):
                feats.append(h)
        return self.final_conv(h).to(in_dtype)


def unet_from_config(unet_cfg, diffusion_cfg, *,
                     dtype: torch.dtype = torch.bfloat16,
                     remat: bool = False) -> SR3UNet:
    """Build from ``cfg.sr.model.unet`` + ``cfg.sr.model.diffusion``;
    ``remat`` is ``cfg.tpu.train_remat``."""
    return SR3UNet(
        in_channel=int(unet_cfg["in_channel"]),
        out_channel=int(unet_cfg["out_channel"]),
        inner_channel=int(unet_cfg["inner_channel"]),
        norm_groups=int(unet_cfg.get("norm_groups", 32)),
        channel_mults=tuple(unet_cfg["channel_multiplier"]),
        attn_res=tuple(unet_cfg["attn_res"]),
        res_blocks=int(unet_cfg["res_blocks"]),
        image_size=int(diffusion_cfg["image_size"]),
        dtype=dtype,
        quant_min_res=int(unet_cfg.get("quant_min_res", 0) or 0),
        quant_resample=bool(unet_cfg.get("quant_resample", False)),
        dropout=float(unet_cfg.get("dropout", 0.0)),
        remat=remat,
    )
