"""The SR3 denoising UNet in plain PyTorch, fp32, NCHW.

The published SR3 topology (Saharia et al., "Image Super-Resolution via
Iterative Refinement"; the reference repository's ``sr3_modules/unet.py``):
a sinusoidal encoding of the noise level γ through Linear → Swish → Linear;
ResnetBlocks of two GroupNorm → Swish → Conv3×3 blocks with the noise
embedding added between them and a 1×1 projection on the skip where the
width changes; single-head self-attention over all H·W positions, scaled by
1/sqrt(C), where the resolution track that starts at ``image_size`` meets
``attn_res``; strided-conv down- and nearest+conv up-sampling; the decoder
takes the encoder's features in reverse order.

Parameters are a flat dict under the names ``param_specs`` gives (the names
the program's modules load by, a format and no value of the program's).

``quant`` runs the convs the configuration quantizes for serving in
``Arith.qconv``: both convs of every ResnetBlock outside the mid block at
levels whose input is at least ``quant_min_res`` pixels high, with the
static step of their GroupNorm's affine, ``max(6·max|γ| + max|β|, 1e-3)``
over the levels; with ``quant_resample`` the Downsample and Upsample convs
too (the Upsample gated on its resolution after the resize), with the
tensor's own step.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import Arith


def unet_plan(u: dict, image_size: int) -> list[tuple]:
    """``(kind, name, c_in, c_out, with_attn)`` in forward order, and the
    final block; the channel bookkeeping of the published module."""
    inner, mults = int(u["inner_channel"]), list(u["channel_multiplier"])
    res_blocks, attn_res = int(u["res_blocks"]), set(u["attn_res"])
    plan, feats, ch, now = [], [inner], inner, image_size
    n = len(mults)
    for ind in range(n):
        out = inner * mults[ind]
        for b in range(res_blocks):
            plan.append(("down", f"down_{ind}_{b}", ch, out, now in attn_res))
            ch = out
            feats.append(ch)
        if ind != n - 1:
            plan.append(("downsample", f"downsample_{ind}", ch, ch, False))
            feats.append(ch)
            now //= 2
    plan.append(("mid", "mid_0", ch, ch, True))
    plan.append(("mid", "mid_1", ch, ch, False))
    for ind in reversed(range(n)):
        out = inner * mults[ind]
        for b in range(res_blocks + 1):
            plan.append(("up", f"up_{ind}_{b}", ch + feats.pop(), out,
                         now in attn_res))
            ch = out
        if ind != 0:
            plan.append(("upsample", f"upsample_{ind}", ch, ch, False))
            now *= 2
    plan.append(("final", "final_conv", ch, int(u["out_channel"]), False))
    return plan


def unet_specs(u: dict, image_size: int) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)`` of every parameter; ``kind`` is ``"w"`` (a
    conv or dense weight, fan-in scaled), ``"one"`` (a norm's scale) or
    ``"zero"`` (a bias)."""
    inner = int(u["inner_channel"])
    specs = []

    def dense(name, d_in, d_out, bias=True):
        specs.append((f"{name}.weight", (d_out, d_in), "w"))
        if bias:
            specs.append((f"{name}.bias", (d_out,), "zero"))

    def conv(name, c_in, c_out, k, bias=True):
        specs.append((f"{name}.weight", (c_out, c_in, k, k), "w"))
        if bias:
            specs.append((f"{name}.bias", (c_out,), "zero"))

    def norm(name, c):
        specs.append((f"{name}.scale", (c,), "one"))
        specs.append((f"{name}.bias", (c,), "zero"))

    def block(name, c_in, c_out):
        norm(f"{name}.norm", c_in)
        conv(f"{name}.conv", c_in, c_out, 3)

    dense("noise_level_mlp.dense0", inner, inner * 4)
    dense("noise_level_mlp.dense1", inner * 4, inner)
    conv("conv_in", int(u["in_channel"]), inner, 3)
    for kind, name, c_in, c_out, attn in unet_plan(u, image_size):
        if kind in ("down", "mid", "up"):
            r = f"{name}.res_block"
            block(f"{r}.block1", c_in, c_out)
            dense(f"{r}.noise_func.noise_func", inner, c_out)
            block(f"{r}.block2", c_out, c_out)
            if c_in != c_out:
                conv(f"{r}.res_conv", c_in, c_out, 1)
            if attn:
                norm(f"{name}.attn.norm", c_out)
                conv(f"{name}.attn.qkv", c_out, 3 * c_out, 1, bias=False)
                conv(f"{name}.attn.out", c_out, c_out, 1)
        elif kind in ("downsample", "upsample"):
            conv(f"{name}.conv", c_in, c_out, 3)
        else:
            block(name, c_in, c_out)
    return specs


def _swish(x):
    return x * torch.sigmoid(x)


def _gn(x, p, name, groups):
    return F.group_norm(x, groups, p[f"{name}.scale"], p[f"{name}.bias"],
                        1e-5)


def _block(ar: Arith, p, name, x, groups, quant):
    h = _swish(_gn(x, p, f"{name}.norm", groups))
    w, b = p[f"{name}.conv.weight"], p[f"{name}.conv.bias"]
    if quant:
        g, be = p[f"{name}.norm.scale"], p[f"{name}.norm.bias"]
        bound = (6.0 * g.abs().amax() + be.abs().amax()).clamp_min(1e-3)
        return ar.qconv(h, w, b, 1, 1, bound)
    return ar.conv(h, w, b, 1, 1)


def _attn(ar: Arith, p, name, x, groups):
    B, C, H, W = x.shape
    h = _gn(x, p, f"{name}.norm", groups)
    qkv = ar.conv(h, p[f"{name}.qkv.weight"], None)
    qkv = qkv.flatten(2).transpose(1, 2)                    # [B, HW, 3C]
    q, k, v = qkv.split(C, dim=-1)
    s = ar.bmm(q, k.transpose(1, 2)) / math.sqrt(C)
    o = ar.bmm(torch.softmax(s, dim=-1), v)                 # [B, HW, C]
    o = o.transpose(1, 2).reshape(B, C, H, W)
    return ar.conv(o, p[f"{name}.out.weight"], p[f"{name}.out.bias"]) + x


def unet_forward(p: dict, u: dict, image_size: int, x: torch.Tensor,
                 gamma: torch.Tensor, ar: Arith, quant: bool = False
                 ) -> torch.Tensor:
    """``x`` [B, in_channel, H, W] (the concat [condition, x_t]), ``gamma``
    [B, 1] → the predicted noise [B, out_channel, H, W]."""
    groups = int(u.get("norm_groups", 32))
    qmin = int(u.get("quant_min_res", 0) or 0)
    q_resample = bool(u.get("quant_resample", False))
    inner = int(u["inner_channel"])
    count = inner // 2
    step = torch.arange(count, dtype=torch.float32, device=x.device) / count
    enc = gamma.float() * torch.exp(-math.log(1e4) * step)[None, :]
    t = torch.cat([torch.sin(enc), torch.cos(enc)], dim=-1)
    t = ar.linear(t, p["noise_level_mlp.dense0.weight"],
                  p["noise_level_mlp.dense0.bias"])
    t = ar.linear(_swish(t), p["noise_level_mlp.dense1.weight"],
                  p["noise_level_mlp.dense1.bias"])
    h = ar.conv(x, p["conv_in.weight"], p["conv_in.bias"], 1, 1)
    feats = [h]
    for kind, name, c_in, c_out, attn in unet_plan(u, image_size):
        res = h.shape[2] * (2 if kind == "upsample" else 1)
        q = (quant and kind != "mid" and 0 < qmin <= res
             and (kind in ("down", "up") or q_resample))
        if kind in ("down", "mid", "up"):
            if kind == "up":
                h = torch.cat([h, feats.pop()], dim=1)
            r = f"{name}.res_block"
            y = _block(ar, p, f"{r}.block1", h, groups, q)
            y = y + ar.linear(t, p[f"{r}.noise_func.noise_func.weight"],
                              p[f"{r}.noise_func.noise_func.bias"]
                              )[:, :, None, None]
            y = _block(ar, p, f"{r}.block2", y, groups, q)
            if c_in != c_out:
                h = ar.conv(h, p[f"{r}.res_conv.weight"],
                            p[f"{r}.res_conv.bias"])
            h = y + h
            if attn:
                h = _attn(ar, p, f"{name}.attn", h, groups)
        elif kind == "downsample":
            w, b = p[f"{name}.conv.weight"], p[f"{name}.conv.bias"]
            h = ar.qconv(h, w, b, 2, 1) if q else ar.conv(h, w, b, 2, 1)
        elif kind == "upsample":
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            w, b = p[f"{name}.conv.weight"], p[f"{name}.conv.bias"]
            h = ar.qconv(h, w, b, 1, 1) if q else ar.conv(h, w, b, 1, 1)
        else:
            return _block(ar, p, name, h, groups, False)
        if kind in ("down", "downsample"):
            feats.append(h)
    raise AssertionError("the plan ends with the final block")
