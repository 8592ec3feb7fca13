"""The MICA branch in plain PyTorch, fp32: the iResNet ArcFace encoder
(insightface's ``iresnet100`` topology, as MICA uses it), the mapping
network to FLAME shape coefficients, and the FLAME decode with its 68
landmarks.

* ArcFace, inference mode: 3×3 stem → BatchNorm → PReLU, four stages of
  IBasicBlocks (BN → conv3×3 → BN → PReLU → conv3×3 (stride on the first
  block) → BN, plus a 1×1 conv → BN projection on the first block's skip),
  BN → flatten in (h, w, c) order → dense to 512 → BatchNorm without scale.
  BatchNorm normalises with its running statistics.
* The embedding is L2-normalised (norm clipped at 1e-12).
* Mapping: ``mapping_layers + 1`` dense layers of ``map_hidden_dim`` with
  leaky ReLU 0.2 (a skip concat of the input after layer ``hidden // 2``
  where ``hidden > 5``), then a dense output layer.
* FLAME: v = v_template + shapedirs · [shape, 0 expression].  MICA decodes
  the neutral pose, where linear blend skinning is the identity (zero
  axis-angles give identity rotations and no pose offsets), so this
  reference leaves the skinning out; the program runs it and rounds a
  little on the way.  Landmarks: barycentric points of the full 68-point
  embedding's faces.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import Arith

STAGE_WIDTHS = (64, 128, 256, 512)


def arcface_specs(layers, num_features: int = 512, fc_scale: int = 49
                  ) -> list[tuple[str, tuple, str]]:
    """``(name, shape, kind)``; kinds as ``unet.unet_specs``, and
    ``"alpha"`` (PReLU's slope), ``"var"`` (a running variance)."""
    specs = []

    def bn(name, c, scale=True):
        if scale:
            specs.append((f"{name}.scale", (c,), "one"))
        specs.append((f"{name}.bias", (c,), "zero"))
        specs.append((f"{name}.mean", (c,), "zero"))
        specs.append((f"{name}.var", (c,), "var"))

    specs.append(("conv1.weight", (64, 3, 3, 3), "w"))
    bn("bn1", 64)
    specs.append(("prelu.alpha", (64,), "alpha"))
    inplanes = 64
    for s, (planes, blocks) in enumerate(zip(STAGE_WIDTHS, layers)):
        for i in range(blocks):
            n = f"layer{s + 1}.block{i}"
            c_in = inplanes if i == 0 else planes
            bn(f"{n}.bn1", c_in)
            specs.append((f"{n}.conv1.weight", (planes, c_in, 3, 3), "w"))
            bn(f"{n}.bn2", planes)
            specs.append((f"{n}.prelu.alpha", (planes,), "alpha"))
            specs.append((f"{n}.conv2.weight", (planes, planes, 3, 3), "w"))
            bn(f"{n}.bn3", planes)
            if i == 0:
                specs.append((f"{n}.downsample_conv.weight",
                              (planes, c_in, 1, 1), "w"))
                bn(f"{n}.downsample_bn", planes)
        inplanes = planes
    bn("bn2", 512)
    specs.append(("fc.weight", (num_features, 512 * fc_scale), "w"))
    specs.append(("fc.bias", (num_features,), "zero"))
    bn("features", num_features, scale=False)
    return specs


def mapping_specs(z_dim: int, hidden_dim: int, out_dim: int, hidden: int
                  ) -> list[tuple[str, tuple, str]]:
    skips = [hidden // 2] if hidden > 5 else []
    specs, d = [], z_dim
    for i in range(hidden + 1):
        specs += [(f"dense{i}.weight", (hidden_dim, d), "w"),
                  (f"dense{i}.bias", (hidden_dim,), "zero")]
        d = hidden_dim + (z_dim if i in skips else 0)
    specs += [("output.weight", (out_dim, d), "w"),
              ("output.bias", (out_dim,), "zero")]
    return specs


def _bn(p, name, x):
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(p[f"{name}.var"] + 1e-5)
    if f"{name}.scale" in p:
        mul = mul * p[f"{name}.scale"]
    return ((x - p[f"{name}.mean"].view(shape)) * mul.view(shape)
            + p[f"{name}.bias"].view(shape))


def _prelu(p, name, x):
    a = p[f"{name}.alpha"][None, :, None, None]
    return torch.where(x >= 0, x, a * x)


def arcface_forward(p: dict, layers, x: torch.Tensor, ar: Arith
                    ) -> torch.Tensor:
    """NCHW blobs [B, 3, 112, 112] (BGR, [−1, 1]) → embeddings [B, 512]."""
    h = _prelu(p, "prelu", _bn(p, "bn1", ar.conv(x, p["conv1.weight"], None,
                                                 1, 1)))
    for s, blocks in enumerate(layers):
        for i in range(blocks):
            n = f"layer{s + 1}.block{i}"
            stride = 2 if i == 0 else 1
            out = ar.conv(_bn(p, f"{n}.bn1", h), p[f"{n}.conv1.weight"],
                          None, 1, 1)
            out = _prelu(p, f"{n}.prelu", _bn(p, f"{n}.bn2", out))
            out = _bn(p, f"{n}.bn3", ar.conv(out, p[f"{n}.conv2.weight"],
                                             None, stride, 1))
            skip = h
            if i == 0:
                skip = _bn(p, f"{n}.downsample_bn",
                           ar.conv(h, p[f"{n}.downsample_conv.weight"], None,
                                   stride, 0))
            h = out + skip
    h = _bn(p, "bn2", h).permute(0, 2, 3, 1).flatten(1)
    return _bn(p, "features", ar.linear(h, p["fc.weight"], p["fc.bias"],
                                        "fp32"))


def mapping_forward(p: dict, hidden: int, z: torch.Tensor, ar: Arith
                    ) -> torch.Tensor:
    skips = [hidden // 2] if hidden > 5 else []
    h = z
    for i in range(hidden + 1):
        h = F.leaky_relu(ar.linear(h, p[f"dense{i}.weight"],
                                   p[f"dense{i}.bias"], "fp32"), 0.2)
        if i in skips:
            h = torch.cat([z, h], dim=1)
    return ar.linear(h, p["output.weight"], p["output.bias"], "fp32")


def flame_decode(flame: dict, code: torch.Tensor, ar: Arith
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shape code [B, n_shape] → (vertices [B, V, 3], lmk68 [B, 68, 3])."""
    sd = flame["shapedirs"][:, :, :code.shape[1]]           # [V, 3, n_shape]
    V = sd.shape[0]
    ar.einsum_flops("fp32", 2.0 * code.shape[0] * V * 3 * code.shape[1])
    verts = flame["v_template"][None] + torch.einsum(
        "bl,vkl->bvk", ar.round(code, "fp32"), ar.round(sd, "fp32"))
    tri = flame["faces"][flame["full_lmk_faces_idx"].long()].long()
    corners = verts[:, tri]                                  # [B, 68, 3, 3]
    lmk = torch.einsum("blfi,lf->bli", corners, flame["full_lmk_bary_coords"])
    return verts, lmk


def mica_forward(params: dict, mica_cfg: dict, flame: dict,
                 blob: torch.Tensor, ar: Arith) -> dict:
    """NHWC ArcFace blobs → ``identity`` (the shape code), ``verts`` and
    ``lmk68``."""
    emb = arcface_forward(params["arcface"], mica_cfg["arcface_layers"],
                          blob.permute(0, 3, 1, 2), ar)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True).clamp_min(1e-12)
    code = mapping_forward(params["mapping"], int(mica_cfg["mapping_layers"]),
                           emb, ar)
    verts, lmk = flame_decode(flame, code, ar)
    return {"identity": code, "verts": verts, "lmk68": lmk}
