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

Level marks.  Where a forward is captured into a CUDA graph, and in an
eager forward on CUDA while spans record (``utils/profiling.py``), the
forward launches a level mark (``kernels/level_mark.py``, a one-thread
kernel that does nothing) at four boundaries: at its start, after the
encoder's ``OUTER_LEVELS`` highest-resolution levels (their ResnetBlocks
and Downsamples), before the decoder's (after the Upsample that enters
them), and at its end.  A device trace of a replayed forward, one
launch, is cut into the outer levels and the inner ones (the mid block
with them) by those marks; the ``sr3d.unet`` span's ``levels``
attribute names the three segments in order (``level_labels``:
``e512-e256, e128-d128, d256-d512`` on 512² inputs).  A mark at every
level boundary (12 at 5 levels) cost 1.0% of the 8→32 serving cell's
faces a second on an H100; these four keep the split the benchmark
reads.  Off CUDA a mark is nothing.

Under the parallel layer's spatial layout (``parallel.pjit_sample_spatial``,
``Predictor(spatial=True)``) each rank runs the UNet on a band of the image's
rows: the 3×3 convs exchange halo rows (``models/layers.py``), GroupNorm sums
its moments over the bands (``gn_stats``, an all-reduce, then the apply
kernel with the whole image's count), attention gathers q, k and v, and the
int8 gates read the whole image's height.  Tensor parallelism lives in the
convs and dense layers (``models/layers.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import spatial_attention
from ..kernels.groupnorm_swish import (gn_mean_scale, gn_stats, gn_swish,
                                       gn_swish_apply)
from ..kernels.level_mark import level_mark
from ..ops.quant import Int8Conv, Versioned, gn_static_scale
from ..parallel import layout
from ..parallel.collectives import all_gather, all_reduce_sum
from ..utils.profiling import recording
from .forward_graph import ForwardGraphs
from .layers import Conv2d, Linear


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


OUTER_LEVELS = 2   # the highest-resolution levels the marks set apart


@functools.lru_cache(maxsize=None)
def level_labels(n_levels: int, res: int) -> tuple[str, ...]:
    """The segments between a forward's level marks, in order, for a UNet
    of ``n_levels`` resolution levels on ``res``² inputs: the encoder's
    outer levels (``e{res}-e{res/2}``), the inner levels with the mid
    block between them (``e{res/4}-d{res/4}``, or ``mid``), the decoder's
    outer levels (``d{res/2}-d{res}``)."""
    sizes = [res >> i for i in range(n_levels)]
    k = min(OUTER_LEVELS, n_levels)

    def span(a: str, b: str) -> str:
        return a if a == b else f"{a}-{b}"

    inner = span(f"e{sizes[k]}", f"d{sizes[k]}") if k < n_levels else "mid"
    return (span(f"e{sizes[0]}", f"e{sizes[k - 1]}"), inner,
            span(f"d{sizes[k - 1]}", f"d{sizes[0]}"))


def marks_recorded(x: torch.Tensor) -> bool:
    """Whether a forward on ``x`` launches its level marks: on CUDA, into
    a graph being captured or while spans record."""
    return x.is_cuda and (torch.cuda.is_current_stream_capturing()
                          or recording())


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
        rows = layout.current().rows
        if rows is None or rows.size == 1:
            return gn_swish(x.contiguous(), self.scale, self.bias,
                            self.groups, self.eps)
        # a band of the image's rows: the kernel's moments of the band,
        # summed over the bands, then the apply kernel over the whole
        # image's count
        x = x.contiguous()
        s, q = all_reduce_sum(torch.stack(gn_stats(x)), rows)
        return gn_swish_apply(x, s, q, self.scale, self.bias, self.groups,
                              self.eps, x.shape[2] * rows.size * x.shape[3])


class GroupNorm(nn.Module):
    """Plain GroupNorm computed and returned in fp32 (flax
    ``nn.GroupNorm(dtype=float32)``), as attention's pre-norm uses it."""

    def __init__(self, channels: int, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = layout.current().rows
        if rows is None or rows.size == 1:
            return F.group_norm(x.float(), self.groups, self.scale,
                                self.bias, self.eps)
        # a band of rows: one-pass moments summed over the bands
        xf = x.float()
        s, q = all_reduce_sum(torch.stack(
            (xf.sum((2, 3)), (xf * xf).sum((2, 3)))), rows)
        mean_c, a = gn_mean_scale(
            s, q, self.scale, float(x.shape[2] * rows.size * x.shape[3]
                                    * (x.shape[1] // self.groups)),
            self.groups, self.eps)
        return ((xf - mean_c[:, :, None, None]) * a[:, :, None, None]
                + self.bias[None, :, None, None])


def apply_dropout(x: torch.Tensor, rate: float,
                  generator: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 − rate, kept values
    scaled by 1/(1 − rate), in ``x.dtype``; the mask is drawn from
    ``generator`` (on ``x``'s device)."""
    keep = layout.rand(x.shape, generator=generator, device=x.device,
                       row_dim=2) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class ConvBlock(nn.Module):
    """GroupNorm → Swish → (Dropout) → Conv3×3 (the reference ``Block``);
    ``quant`` runs the conv in int8 with the static scale of the GN
    affine, made once per version of γ and β."""

    def __init__(self, dim_in: int, dim_out: int, groups: int,
                 dtype: torch.dtype, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.norm = GroupNormSwish(dim_in, groups)
        self.conv = Int8Conv(dim_in, dim_out, 3, padding=1,
                             compute_dtype=dtype)
        self._static_scale = Versioned(gn_static_scale)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None,
                quant: bool = False) -> torch.Tensor:
        h = self.norm(x)
        if generator is not None and self.dropout > 0.0:
            h = apply_dropout(h, self.dropout, generator)
        if quant:
            return self.conv(h, quant=True, a_scale=self._static_scale(
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
        """Over a band of the image's rows (spatial sharding), q, k and v
        of every row are gathered, attention runs over all tokens and the
        band's rows of the result are kept."""
        B, C, h, W = x.shape
        rows = layout.current().rows
        qkv = self.qkv(self.norm(x).to(self.dtype))            # [B, 3C, h, W]
        qkv = all_gather(qkv, 2, rows)                         # [B, 3C, H, W]
        H = qkv.shape[2]
        qkv = qkv.flatten(2).transpose(1, 2)                   # [B, HW, 3C]
        q, k, v = (t.contiguous() for t in qkv.split(C, dim=-1))
        out = spatial_attention(q, k, v, channels=C)           # [B, HW, C]
        out = out.transpose(1, 2).reshape(B, C, H, W).to(self.dtype)
        if H != h:
            out = out.narrow(2, rows.index * h, h)
        return self.out(out) + x


class ResnetBlocWithAttn(nn.Module):
    """A ResnetBlock (``resnet``: the SR3 family's, or the DDPM family's
    ``DDPMResnetBlock``) and, ``with_attn``, self-attention after it."""

    def __init__(self, dim_in: int, dim_out: int, time_dim: int, groups: int,
                 with_attn: bool, dtype: torch.dtype, dropout: float = 0.0,
                 resnet: type[nn.Module] = ResnetBlock):
        super().__init__()
        self.res_block = resnet(dim_in, dim_out, time_dim, groups, dtype,
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
    level γ of shape [B, 1].  Returns NCHW noise in ``x``'s dtype.

    The DDPM family (``models/ddpm_unet.py``) is this topology with another
    time embedding (``time_name``, ``time_embedding``) and another
    ResnetBlock (``resnet``)."""

    time_name = "noise_level_mlp"
    resnet: type[nn.Module] = ResnetBlock

    @staticmethod
    def time_embedding(dim: int, dtype: torch.dtype) -> nn.Module:
        return NoiseLevelMLP(dim, dtype)

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
        self.add_module(self.time_name, self.time_embedding(inner, dtype))
        block = functools.partial(ResnetBlocWithAttn, dtype=dtype,
                                  dropout=dropout, resnet=self.resnet)
        self.conv_in = Conv2d(in_channel, inner, 3, padding=1,
                              compute_dtype=dtype)

        # The forward walks self.plan; the channel bookkeeping mirrors the
        # flax module's trace-time shapes.  A level mark follows the plan
        # steps in _level_ends, and the final block.
        self.plan: list[tuple[str, str]] = []
        self.n_levels = len(channel_mults)
        outer = min(OUTER_LEVELS, self.n_levels)
        level_ends = []
        attn_res = set(attn_res)
        now_res = image_size
        feats = [inner]
        ch = inner
        n = len(channel_mults)
        for ind in range(n):
            use_attn = now_res in attn_res
            out = inner * channel_mults[ind]
            for b in range(res_blocks):
                self._add("down", f"down_{ind}_{b}",
                          block(ch, out, inner, g, use_attn))
                ch = out
                feats.append(ch)
            if ind != n - 1:
                self._add("downsample", f"downsample_{ind}",
                          Downsample(ch, dtype))
                feats.append(ch)
                now_res //= 2
            if ind == outer - 1:
                level_ends.append(len(self.plan) - 1)
        self._add("mid", "mid_0", block(ch, ch, inner, g, True))
        self._add("mid", "mid_1", block(ch, ch, inner, g, False))
        if outer == n:
            level_ends.append(len(self.plan) - 1)
        for ind in reversed(range(n)):
            use_attn = now_res in attn_res
            out = inner * channel_mults[ind]
            for b in range(res_blocks + 1):
                self._add("up", f"up_{ind}_{b}",
                          block(ch + feats.pop(), out, inner, g, use_attn))
                ch = out
            if ind != 0:
                self._add("upsample", f"upsample_{ind}", Upsample(ch, dtype))
                now_res *= 2
                if ind == outer:
                    level_ends.append(len(self.plan) - 1)
        self._level_ends = frozenset(level_ends)
        self.final_conv = ConvBlock(ch, out_channel, g, dtype)
        self._graphs = ForwardGraphs(self)

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
        only: rounding has no gradient).

        Runs through ``ForwardGraphs.run`` (``models/forward_graph.py``):
        eagerly where dropout is drawn, its ``sr3d.unet`` span's
        ``levels`` naming the segments between the forward's level
        marks."""
        rows = layout.current().rows
        res = x.shape[2] * (1 if rows is None else rows.size)
        return self._graphs.run(
            lambda x, t: self._forward(x, t, generator, deterministic,
                                       remat, quant),
            (x, time), statics=(quant,),
            eager=self.training and not deterministic and self.dropout > 0.0,
            span="sr3d.unet", levels=level_labels(self.n_levels, res))

    def _forward(self, x: torch.Tensor, time: torch.Tensor,
                 generator: torch.Generator | None, deterministic: bool,
                 remat: bool | None, quant: bool) -> torch.Tensor:
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
        mark = marks_recorded(x)
        if mark:
            level_mark(x.device)
        t = getattr(self, self.time_name)(time)
        h = self.conv_in(x.to(self.dtype))
        feats = [h]
        rows = layout.current().rows
        split = 1 if rows is None else rows.size   # h holds a band of rows
        for i, (kind, name) in enumerate(self.plan):
            mod = getattr(self, name)
            q = quant and self._quant_gate(kind, h.shape[2] * split)
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
            if mark and i in self._level_ends:
                level_mark(x.device)
        out = self.final_conv(h).to(in_dtype)
        if mark:
            level_mark(x.device)
        return out


def unet_from_config(unet_cfg, diffusion_cfg, *,
                     dtype: torch.dtype = torch.bfloat16,
                     remat: bool = False,
                     cls: type[SR3UNet] = SR3UNet) -> SR3UNet:
    """Build ``cls`` (the SR3 UNet, or the DDPM one: ``models/networks.py::
    define_g`` picks it from ``which_model_G``) from ``cfg.sr.model.unet``
    + ``cfg.sr.model.diffusion``; ``remat`` is ``cfg.tpu.train_remat``."""
    return cls(
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
