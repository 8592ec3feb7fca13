"""The noise schedule and the strided DDIM sampler (Song et al., "Denoising
Diffusion Implicit Models", with η) of SR3's continuous-noise-level
parameterisation, in plain PyTorch.

The schedule is computed in float64 and rounded to float32, as the
configuration's ``linear`` schedule is published.  The UNet is conditioned
on γ = √ᾱ of the shifted table (``[1, ᾱ_0, …]``, index t + 1).  Serving
starts from the forward marginal of the condition, √ᾱ_T·cond + √(1−ᾱ_T)·ε
(``marginal``), or from pure noise.

The draws: one N(0, 1) tensor of the image's shape for the start, then one
before each of the ``num_steps`` steps (the last one unused), all from one
``torch.Generator``, so the same seed gives the same trajectory as any
sampler that draws in this order.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def linear_schedule(n: int, start: float, end: float) -> dict:
    betas = np.linspace(start, end, n, dtype=np.float64)
    ac = np.cumprod(1.0 - betas)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return {"alphas_cumprod": f32(ac),
            "sqrt_recip": f32(np.sqrt(1.0 / ac)),
            "sqrt_recipm1": f32(np.sqrt(1.0 / ac - 1.0)),
            "gamma": f32(np.sqrt(np.append(1.0, ac)))}


def strided_taus(T: int, steps: int) -> np.ndarray:
    return np.linspace(0, T - 1, steps, dtype=np.float32).round() \
        .astype(np.int64)


def ddim_sample(denoise: Callable, sched: dict, cond: torch.Tensor,
                generator: torch.Generator, steps: int, eta: float,
                init: str) -> torch.Tensor:
    """``denoise(x, gamma)`` predicts the noise of ``x`` = [cond, x_t];
    ``cond`` is NCHW in [−1, 1].  Returns x̂_0, NCHW fp32."""
    ac = sched["alphas_cumprod"]
    T = ac.shape[0]
    steps = min(steps, T)
    taus = strided_taus(T, steps)
    one, eta32 = np.float32(1.0), np.float32(eta)

    def draw():
        return torch.randn(cond.shape, generator=generator,
                           device=cond.device, dtype=torch.float32)

    z = draw()
    if init == "marginal":
        img = (float(np.sqrt(ac[-1])) * cond
               + float(np.sqrt(one - ac[-1])) * z)
    else:
        img = z
    for k in range(steps):
        z = draw()
        i = steps - 1 - k
        t = int(taus[i])
        t_prev = int(taus[i - 1]) if i > 0 else -1
        gamma = torch.full((cond.shape[0], 1), float(sched["gamma"][t + 1]),
                           device=cond.device)
        eps = denoise(torch.cat([cond, img], dim=1), gamma).float()
        x0 = (float(sched["sqrt_recip"][t]) * img
              - float(sched["sqrt_recipm1"][t]) * eps).clamp(-1.0, 1.0)
        a_t = ac[t]
        a_prev = ac[t_prev] if t_prev >= 0 else one
        sigma = (eta32 * np.sqrt((one - a_prev) / (one - a_t))
                 * np.sqrt(one - a_t / a_prev))
        dir_coef = np.sqrt(np.maximum(one - a_prev - sigma * sigma,
                                      np.float32(0.0)))
        img = float(np.sqrt(a_prev)) * x0 + float(dir_coef) * eps
        if t_prev >= 0:
            img = img + float(sigma) * z
    return img
