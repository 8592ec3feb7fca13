"""The generator factory: ``define_g`` and ``init_weights_variant``.

Counterpart of ``sr3d_tpu/models/networks.py`` (the reference's
``define_G``): ``which_model_G`` picks the UNet family, ``sr3`` (continuous
noise level γ) or ``ddpm`` (integer timestep t), and the time input the
diffusion functions must give it (``diffusion/gaussian.py``'s
``time_input``).

``init_weights_variant`` re-draws the conv and dense kernels with the
reference's init families from an explicit ``torch.Generator``.  JAX's
draws cannot be reproduced in torch, so the port holds the same
distributions, not the same values.
"""

from __future__ import annotations

import torch
from torch import nn

from .ddpm_unet import DDPMUNet
from .sr3_unet import SR3UNet, unet_from_config

FAMILIES = {"sr3": (SR3UNet, "gamma"), "ddpm": (DDPMUNet, "t")}


def define_g(sr_model_cfg, *, dtype: torch.dtype = torch.bfloat16,
             remat: bool = False) -> tuple[SR3UNet, str]:
    """The UNet of ``cfg.sr.model`` and its time input, ``(module,
    "gamma" | "t")``; an unknown ``which_model_G`` raises
    NotImplementedError."""
    which = str(sr_model_cfg.get("which_model_G", "sr3"))
    if which not in FAMILIES:
        raise NotImplementedError(f"which_model_G: {which}")
    cls, time_input = FAMILIES[which]
    return unet_from_config(sr_model_cfg["unet"], sr_model_cfg["diffusion"],
                            dtype=dtype, remat=remat, cls=cls), time_input


@torch.no_grad()
def init_weights_variant(module: nn.Module, generator: torch.Generator,
                         init_type: str = "orthogonal",
                         scale: float = 1.0) -> nn.Module:
    """Re-initialise ``module`` in place: every conv and dense kernel
    (``weight`` of rank ≥ 2) orthogonal (gain ``scale``), kaiming normal
    (variance 2·scale / fan_in) or normal (std 0.02·scale), every ``bias``
    zero, other parameters kept.  Orthogonality is over the flax kernel's
    layout (``[..., fan_in, fan_out]`` flattened to ``[fan_in·…,
    fan_out]``), as ``jax.nn.initializers.orthogonal`` draws it."""
    if init_type not in ("orthogonal", "kaiming", "normal"):
        raise NotImplementedError(init_type)
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "weight" and p.dim() >= 2:
            fan_out, fan_in = p.shape[0], p[0].numel()
            if init_type == "orthogonal":
                # flax's kernel flattened to [fan_in, fan_out] (rows =
                # everything but the output axis); QR of a Gaussian
                rows, cols = fan_in, fan_out
                a = torch.randn(max(rows, cols), min(rows, cols),
                                generator=generator)
                q, r = torch.linalg.qr(a)
                q = q * torch.sign(torch.diagonal(r))[None]
                if rows < cols:
                    q = q.t()
                w = scale * q                         # [fan_in, fan_out]
                if p.dim() == 4:    # OIHW from HWIO-flattened rows
                    O, I, H, W = p.shape
                    w = w.reshape(H, W, I, O).permute(3, 2, 0, 1)
                else:
                    w = w.t()
                p.copy_(w)
            elif init_type == "kaiming":
                p.normal_(0.0, (2.0 * scale / fan_in) ** 0.5,
                          generator=generator)
            else:
                p.normal_(0.0, 0.02 * scale, generator=generator)
    return module
