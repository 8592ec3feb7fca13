"""GroupNorm → Swish → 3×3 conv fused into the conv's prologue: the wrapper
of the CUDA kernel and its plain version.

Counterpart of ``sr3d_tpu/kernels/fused_block.py``
(``fused_gn_swish_conv3x3``, ``gn_affine_coeffs``,
``fused_block_reference``), in the JAX package's layout: x ``[B, H, W, C]``
NHWC, w ``[3, 3, C, O]`` HWIO, bias ``[O]`` → ``[B, H, W, O]`` in
``x.dtype``.  On CUDA:

1. the port's GN statistics kernel (``gn_stats`` on NHWC) gives the
   per-channel Σx and Σx²;
2. a tiny torch epilogue folds them into per-(B, C) ``mean`` and
   ``a = rstd·γ`` (the JAX package's "tiny XLA epilogue");
3. ``csrc/conv3x3.cu``'s conv kernel (the path ``conv3x3.conv_plan``
   picks) applies ``swish((x − mean)·a + β)`` to the input as it enters
   shared memory (on the tensor-core path once per row band, not per tap),
   zeroes the out-of-image halo after the activation, rounds the
   activation to ``x.dtype`` and accumulates the conv in fp32, plus the
   bias.

The prologue keeps ``(x − mean)·a + β`` rather than ``gn_affine_coeffs``'
``a·x + (β − mean·a)``, as the port's GN kernel does: the folded form
cancels on near-constant maps with a large mean.

Like the TPU kernel it is a public function that no model path calls (the
JAX package left it unwired after measured regressions), forward-only.
The wrapper counts its conv launches in ``fused_gn_swish_conv3x3.launches``
(its statistics pass counts as a ``gn_stats`` launch).
"""

from __future__ import annotations

import torch

from .conv3x3 import check_conv_inputs, conv3x3_reference, launch_conv
from .groupnorm_swish import gn_mean_scale, gn_stats, gn_swish_reference


def gn_affine_coeffs(sum_c: torch.Tensor, sq_c: torch.Tensor,
                     gamma: torch.Tensor, beta: torch.Tensor,
                     n_per_group: float, num_groups: int, eps: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) ``a``, ``b`` with ``y = a·x + b`` ≡ ``(x − mean)·rstd·γ
    + β``, fp32 ``[B, C]`` — the JAX package's folded form (the kernel
    itself keeps the mean apart; see the module docstring)."""
    mean_c, a = gn_mean_scale(sum_c, sq_c, gamma, n_per_group, num_groups,
                              eps)
    return a, beta.float()[None, :] - mean_c * a


def fused_block_reference(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, num_groups: int,
                          eps: float = 1e-5) -> torch.Tensor:
    """``gn_swish_reference`` (in ``x.dtype``) → ``conv3x3_reference``
    with the fp32 bias, NHWC."""
    h = gn_swish_reference(x.permute(0, 3, 1, 2), gamma, beta, num_groups,
                           eps).permute(0, 2, 3, 1)
    return conv3x3_reference(h, w, bias)


def fused_gn_swish_conv3x3(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, w: torch.Tensor,
                           bias: torch.Tensor, num_groups: int,
                           eps: float = 1e-5) -> torch.Tensor:
    """x ``[B, H, W, C]`` → GroupNorm(γ, β over C, ``num_groups``) → swish
    → conv3×3 SAME (w ``[3, 3, C, O]`` cast to ``x.dtype``, fp32 bias
    ``[O]``) → ``[B, H, W, O]`` in ``x.dtype``."""
    if x.device.type == "cpu":
        return fused_block_reference(x, gamma, beta, w, bias, num_groups,
                                     eps)
    w = w.to(x.dtype).contiguous()
    bias = bias.float().contiguous()
    check_conv_inputs("fused_gn_swish_conv3x3", x, w, bias)
    B, H, W, C = x.shape
    if C % num_groups:
        raise ValueError(f"fused_gn_swish_conv3x3: {C} channels do not "
                         f"split into {num_groups} groups")
    for name, p in (("gamma", gamma), ("beta", beta)):
        if tuple(p.shape) != (C,) or p.device != x.device:
            raise ValueError(f"fused_gn_swish_conv3x3: {name} must be a "
                             f"[{C}] tensor on {x.device}")
    s, q = gn_stats(x, channels_last=True)
    mean_c, a = gn_mean_scale(s, q, gamma, float(H * W * (C // num_groups)),
                              num_groups, eps)
    out = launch_conv("fused_gn_swish_conv3x3", x, w, bias,
                      (mean_c.contiguous(), a.contiguous(),
                       beta.float().contiguous()))
    fused_gn_swish_conv3x3.launches += 1
    return out


fused_gn_swish_conv3x3.launches = 0
