"""Gaussian diffusion: the SR3 and DDPM training losses and the samplers
(ancestral, DDIM, DPM-Solver++), NCHW.

Counterpart of ``sr3d_tpu/diffusion/gaussian.py``: ``q_sample_gamma``,
``sample_continuous_gamma`` and ``p_losses_continuous`` for the SR3 family
(continuous noise level γ), ``q_sample_discrete`` and ``p_losses_discrete``
for the DDPM family (integer timestep t), and the samplers.  The training
draws (t, γ, noise) come from a ``torch.Generator`` or are passed in, so a
test can replay the JAX package's ``split`` draws.

The loops are plain Python loops that call the UNet once per step; every
step shares one timestep across the batch, so the schedule scalars are read
on the host (``np.float32`` arithmetic, as the JAX package computes them in
float32).  They run under ``torch.no_grad()`` unless ``differentiable``
(the ancestral loop and DDIM, for model3's hand-off), where each step, or
each chunk of steps, is a non-reentrant checkpoint when ``remat``.

Noise comes either from a ``torch.Generator`` or from an explicit sequence
``noise``: ``noise[0]`` is the initial N(0, 1) draw (the state x_T for
``init="noise"``), ``noise[1 + k]`` the draw of the k-th loop iteration.  A
test replays the JAX package's noise through the second form.

``denoise(x, time)`` takes the channel concat ``[condition, x_t]`` and
returns the predicted noise; ``time`` is the continuous noise level γ
``[B, 1]`` (``time_input="gamma"``, the SR3 UNet) or the integer timestep
``[B]`` (``time_input="t"``, the DDPM UNet).

Under the parallel layer's layout (``parallel/layout.py``) a rank holds its
rows of the batch or its band of the image's rows: every draw is then the
global one from the shared generator, this rank's part kept, and replayed
draws (``noise``, ``gamma``, ``t``, ``u``) are global too, so a sharded run
draws what the one-device run draws.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.image import clip
from ..parallel import layout
from ..utils.profiling import annotate
from .schedules import DiffusionSchedule

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def q_sample_gamma(x_start: torch.Tensor, gamma: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """Continuous-noise-level forward diffusion (SR3):
    ``x_t = γ·x₀ + sqrt(1 − γ²)·ε``; ``gamma`` is ``[B]`` (or any shape
    with B elements) and broadcasts over the other dims."""
    gamma = gamma.reshape(gamma.shape[0], *([1] * (x_start.dim() - 1)))
    return gamma * x_start + torch.sqrt(1.0 - gamma ** 2) * noise


def q_sample_discrete(x_start: torch.Tensor, t: torch.Tensor,
                      sched: DiffusionSchedule, noise: torch.Tensor
                      ) -> torch.Tensor:
    """Discrete-t forward diffusion (DDPM):
    ``x_t = √ᾱ_t·x₀ + √(1 − ᾱ_t)·ε``, ``t`` an integer ``[B]``."""
    shape = (t.shape[0],) + (1,) * (x_start.dim() - 1)
    idx = t.to(torch.long).cpu()
    sa = torch.from_numpy(sched.sqrt_alphas_cumprod)[idx]
    soma = torch.from_numpy(sched.sqrt_one_minus_alphas_cumprod)[idx]
    return (sa.to(x_start.device).reshape(shape) * x_start
            + soma.to(x_start.device).reshape(shape) * noise)


def sample_continuous_gamma(sched: DiffusionSchedule, batch: int, *,
                            generator: torch.Generator | None = None,
                            device: torch.device | str = "cpu",
                            per_sample_t: bool = False,
                            t: torch.Tensor | None = None,
                            u: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SR3 training noise level: ``t ~ U{1..T}`` (one t for the whole
    batch, or one per element with ``per_sample_t``), then
    ``γ ~ U[√ᾱ_{t−1}, √ᾱ_t]`` per element.  ``t`` (``[]`` or ``[batch]``,
    integer) and ``u`` (``[batch]`` uniforms in [0, 1)) replace the draws
    from ``generator``.  Returns ``(t [batch], gamma [batch])``, fp32 γ."""
    T = sched.num_timesteps
    if t is None:
        t = torch.randint(1, T + 1, tuple(layout.global_shape([batch]))
                          if per_sample_t else (),
                          generator=generator, device=device)
    t = layout.local(t) if t.dim() else t
    u = (layout.rand([batch], generator=generator, device=device)
         if u is None else layout.local(u))
    t = t.to(device=device, dtype=torch.long).expand(batch)
    table = torch.from_numpy(sched.sqrt_alphas_cumprod_prev).to(device)
    lo, hi = table[t - 1], table[t]
    return t, lo + u.to(device, torch.float32) * (hi - lo)


def p_losses_continuous(denoise: DenoiseFn, sched: DiffusionSchedule,
                        hr: torch.Tensor, cond: torch.Tensor | None, *,
                        generator: torch.Generator | None = None,
                        gamma: torch.Tensor | None = None,
                        noise: torch.Tensor | None = None,
                        loss_type: str = "l1",
                        per_sample_t: bool = False) -> torch.Tensor:
    """SR3 continuous-noise-level training loss, summed (``reduction
    ='sum'``; the caller divides by ``hr.numel()``).  ``hr`` and ``cond``
    are NCHW; the UNet sees ``[cond, x_noisy]`` with cond first.  ``gamma``
    ``[B]`` and ``noise`` (``hr``'s shape) replace the draws from
    ``generator``."""
    b = hr.shape[0]
    if gamma is None:
        _, gamma = sample_continuous_gamma(
            sched, b, generator=generator, device=hr.device,
            per_sample_t=per_sample_t)
    else:
        gamma = layout.local(gamma)
    noise = _draw_like(hr, generator, noise)
    gamma = gamma.to(hr.device, torch.float32)
    x_noisy = q_sample_gamma(hr.float(), gamma, noise)
    net_in = x_noisy if cond is None else torch.cat([cond.float(), x_noisy],
                                                    dim=1)
    eps = denoise(net_in, gamma[:, None]).float()
    if loss_type == "l1":
        return (noise - eps).abs().sum()
    if loss_type == "l2":
        return ((noise - eps) ** 2).sum()
    raise ValueError(f"unknown loss_type {loss_type!r} (l1 | l2)")


def p_losses_discrete(denoise: DenoiseFn, sched: DiffusionSchedule,
                      hr: torch.Tensor, cond: torch.Tensor | None, *,
                      generator: torch.Generator | None = None,
                      t: torch.Tensor | None = None,
                      noise: torch.Tensor | None = None,
                      loss_type: str = "l1") -> torch.Tensor:
    """DDPM discrete-t training loss, summed: ``t ~ U{0..T−1}`` per element,
    then the noise; the UNet sees ``[cond, x_noisy]`` and the integer
    ``t``.  ``t`` (``[B]``) and ``noise`` (``hr``'s shape) replace the
    draws from ``generator``."""
    b = hr.shape[0]
    t = (torch.randint(0, sched.num_timesteps,
                       tuple(layout.global_shape([b])), generator=generator,
                       device=hr.device) if t is None else t)
    t = layout.local(t).to(hr.device, torch.long)
    noise = _draw_like(hr, generator, noise)
    x_noisy = q_sample_discrete(hr.float(), t, sched, noise)
    net_in = x_noisy if cond is None else torch.cat([cond.float(), x_noisy],
                                                    dim=1)
    eps = denoise(net_in, t).float()
    if loss_type == "l1":
        return (noise - eps).abs().sum()
    if loss_type == "l2":
        return ((noise - eps) ** 2).sum()
    raise ValueError(f"unknown loss_type {loss_type!r} (l1 | l2)")


def _draw_like(x: torch.Tensor, generator: torch.Generator | None,
               noise: torch.Tensor | None) -> torch.Tensor:
    """N(0, 1) of ``x``'s (local) shape, fp32 on its device: drawn, or this
    rank's part of a replayed global draw."""
    if noise is None:
        return layout.randn(x.shape, generator=generator, device=x.device,
                            row_dim=2)
    return layout.local(noise, row_dim=2).to(x.device, torch.float32)


def predict_start_from_noise(sched: DiffusionSchedule, x_t: torch.Tensor,
                             t: int, noise: torch.Tensor) -> torch.Tensor:
    """x̂₀ = √(1/ᾱ_t)·x_t − √(1/ᾱ_t − 1)·ε̂."""
    return (float(sched.sqrt_recip_alphas_cumprod[t]) * x_t
            - float(sched.sqrt_recipm1_alphas_cumprod[t]) * noise)


def q_posterior(sched: DiffusionSchedule, x_start: torch.Tensor,
                x_t: torch.Tensor, t: int) -> tuple[torch.Tensor, np.float32]:
    """Posterior mean and clipped log-variance of q(x_{t-1} | x_t, x₀)."""
    mean = (float(sched.posterior_mean_coef1[t]) * x_start
            + float(sched.posterior_mean_coef2[t]) * x_t)
    return mean, sched.posterior_log_variance_clipped[t]


def _time(sched: DiffusionSchedule, x: torch.Tensor, t: int,
          time_input: str) -> torch.Tensor:
    """The UNet's time input at timestep ``t``: γ = √ᾱ_{t} of the shifted
    table, ``[B, 1]`` (``"gamma"``), or ``t`` itself, ``[B]``
    (``"t"``)."""
    if time_input == "gamma":
        gamma = float(sched.sqrt_alphas_cumprod_prev[t + 1])
        return torch.full((x.shape[0], 1), gamma, dtype=x.dtype,
                          device=x.device)
    if time_input == "t":
        return torch.full((x.shape[0],), t, dtype=torch.long,
                          device=x.device)
    raise ValueError(f"unknown time_input {time_input!r} (gamma | t)")


def p_mean_variance(denoise: DenoiseFn, sched: DiffusionSchedule,
                    x: torch.Tensor, t: int, condition: torch.Tensor | None,
                    clip_denoised: bool = True, time_input: str = "gamma"
                    ) -> tuple[torch.Tensor, np.float32]:
    """One reverse step's mean and log-variance."""
    net_in = x if condition is None else torch.cat([condition, x], dim=1)
    eps = denoise(net_in, _time(sched, x, t, time_input))
    x_recon = predict_start_from_noise(sched, x, t, eps.float())
    if clip_denoised:
        x_recon = clip(x_recon, -1.0, 1.0)
    return q_posterior(sched, x_recon, x, t)


def _noise_stream(shape: torch.Size, device: torch.device,
                  generator: torch.Generator | None,
                  noise: Sequence[torch.Tensor] | None
                  ) -> Callable[[], torch.Tensor]:
    if noise is not None:
        it: Iterator[torch.Tensor] = iter(noise)
        return lambda: layout.local(next(it), row_dim=2).to(
            device=device, dtype=torch.float32)
    if generator is None:
        raise ValueError("pass a torch.Generator or an explicit noise "
                         "sequence")
    return lambda: layout.randn(shape, generator=generator, device=device,
                                row_dim=2)


def _sampler_init(sched: DiffusionSchedule, noise: torch.Tensor, init: str,
                  condition: torch.Tensor | None) -> torch.Tensor:
    """Initial state x_T: pure noise (``"noise"``, the reference) or the
    forward marginal of the conditioning, √ᾱ_T·cond + √(1−ᾱ_T)·ε
    (``"marginal"``: the schedules here keep non-zero terminal SNR)."""
    if init not in ("noise", "marginal"):
        raise ValueError(f"unknown sampler init {init!r}; "
                         f"expected noise | marginal")
    if init == "noise" or condition is None:
        return noise
    a_T = sched.alphas_cumprod[-1]
    return (float(np.sqrt(a_T)) * condition
            + float(np.sqrt(np.float32(1.0) - a_T)) * noise)


def _run_steps(step: Callable[..., torch.Tensor], img: torch.Tensor,
               n: int, draw: Callable[[], torch.Tensor], *,
               differentiable: bool, remat: bool, remat_chunk: int,
               what: str) -> torch.Tensor:
    """``img = step(k, img, z_k)`` for k = 0 .. n−1, ``z_k`` the k-th
    per-step draw.  With ``differentiable`` and ``remat``, each run of
    ``remat_chunk`` steps is one non-reentrant ``torch.utils.checkpoint``
    (the chunk must divide ``n``).  The chunk's draws are made before its
    checkpointed call and passed in: the recompute restores only the global
    RNG, never an explicit generator, so a draw inside would give the
    backward another trajectory than the one sampled."""
    ckpt = differentiable and remat
    chunk = int(remat_chunk) if ckpt else 1
    if chunk < 1 or n % chunk:
        raise ValueError(f"remat_chunk {chunk} must divide {what}={n}")

    def run(k0: int, img: torch.Tensor, *zs: torch.Tensor) -> torch.Tensor:
        for j, z in enumerate(zs):
            img = step(k0 + j, img, z)
        return img

    for k0 in range(0, n, chunk):
        with annotate("sr3d.step", k=k0):
            zs = [draw() for _ in range(chunk)]
            img = (checkpoint(run, k0, img, *zs, use_reentrant=False)
                   if ckpt else run(k0, img, *zs))
    return img


class SampleOutput(NamedTuple):
    final: torch.Tensor          # x₀, the shape of x_in
    intermediates: torch.Tensor  # [ceil(T / sample_inter), *x_in.shape]


def p_sample_loop(denoise: DenoiseFn, sched: DiffusionSchedule,
                  x_in: torch.Tensor, *,
                  generator: torch.Generator | None = None,
                  noise: Sequence[torch.Tensor] | None = None,
                  conditional: bool = True, clip_denoised: bool = True,
                  init: str = "noise", differentiable: bool = False,
                  remat: bool = True, remat_chunk: int = 1,
                  time_input: str = "gamma",
                  return_intermediates: bool = False
                  ) -> torch.Tensor | SampleOutput:
    """The reference's full T-step ancestral loop.  ``x_in`` is the
    bicubic-upsampled conditioning (or, unconditional, only a shape).

    Without ``differentiable`` the loop runs under ``torch.no_grad()``.
    With it the loop stays on the autograd tape (model3's hand-off), each
    step checkpointed when ``remat``, or each run of ``remat_chunk`` steps
    (which must divide T); the gradients are the same either way.

    ``return_intermediates`` returns ``SampleOutput(final,
    intermediates)``, the reference's continuous trajectory: with
    ``sample_inter = 1 | (T // 10)`` (a bitwise or), the state after the
    step at t lands in slot ``t // sample_inter`` when ``t % sample_inter
    == 0``, so slot 0 is the final image; ``ceil(T / sample_inter)``
    frames."""
    T = sched.num_timesteps
    condition = x_in if conditional else None
    draw = _noise_stream(x_in.shape, x_in.device, generator, noise)
    inter = 1 | (T // 10)
    kept: dict[int, torch.Tensor] = {}

    def step(k: int, img: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        t = T - 1 - k
        mean, log_var = p_mean_variance(denoise, sched, img, t, condition,
                                        clip_denoised, time_input)
        img = (mean + float(np.exp(np.float32(0.5) * log_var)) * z
               if t > 0 else mean)
        if return_intermediates and t % inter == 0:
            kept[t // inter] = img   # a recompute rewrites the same slot
        return img

    with contextlib.nullcontext() if differentiable else torch.no_grad():
        img = _sampler_init(sched, draw(), init, condition)
        img = _run_steps(step, img, T, draw, differentiable=differentiable,
                         remat=remat, remat_chunk=remat_chunk, what="T")
        if not return_intermediates:
            return img
        return SampleOutput(img, torch.stack(
            [kept[i] for i in range(-(-T // inter))]))


def _strided_taus(T: int, num_steps: int) -> np.ndarray:
    """Strided timestep subsequence τ_0 < ... < τ_{S-1} = T-1."""
    return np.linspace(0, T - 1, num_steps, dtype=np.float32).round() \
        .astype(np.int64)


def _make_x0_eps_pred(denoise: DenoiseFn, sched: DiffusionSchedule,
                      condition: torch.Tensor | None, clip_denoised: bool,
                      time_input: str = "gamma"):
    """One UNet evaluation at timestep ``t`` → ``(x0, eps)``."""

    def x0_eps(img: torch.Tensor, t: int):
        net_in = (img if condition is None
                  else torch.cat([condition, img], dim=1))
        eps = denoise(net_in, _time(sched, img, t, time_input)).float()
        x0 = predict_start_from_noise(sched, img, t, eps)
        if clip_denoised:
            x0 = clip(x0, -1.0, 1.0)
        return x0, eps

    return x0_eps


def ddim_sample_loop(denoise: DenoiseFn, sched: DiffusionSchedule,
                     x_in: torch.Tensor, *, num_steps: int = 50,
                     eta: float = 0.0,
                     generator: torch.Generator | None = None,
                     noise: Sequence[torch.Tensor] | None = None,
                     conditional: bool = True, clip_denoised: bool = True,
                     init: str = "noise", differentiable: bool = False,
                     remat: bool = True, remat_chunk: int = 1,
                     time_input: str = "gamma") -> torch.Tensor:
    """DDIM over a strided timestep subsequence: ``eta=0`` deterministic,
    ``eta=1`` ancestral-like variance.  The serving recipe is
    ``num_steps=25, eta=1, init="marginal"``.  ``differentiable``,
    ``remat``, ``remat_chunk`` (which must divide ``num_steps``) and
    ``time_input`` as in :func:`p_sample_loop`."""
    T = sched.num_timesteps
    num_steps = min(num_steps, T)
    condition = x_in if conditional else None
    taus = _strided_taus(T, num_steps)
    x0_eps = _make_x0_eps_pred(denoise, sched, condition, clip_denoised,
                               time_input)
    draw = _noise_stream(x_in.shape, x_in.device, generator, noise)
    ac = sched.alphas_cumprod
    one, eta32 = np.float32(1.0), np.float32(eta)

    def step(k: int, img: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        i = num_steps - 1 - k
        t = int(taus[i])
        t_prev = int(taus[i - 1]) if i > 0 else -1
        x0, eps = x0_eps(img, t)
        a_t = ac[t]
        a_prev = ac[t_prev] if t_prev >= 0 else one
        sigma = (eta32 * np.sqrt((one - a_prev) / (one - a_t))
                 * np.sqrt(one - a_t / a_prev))
        dir_coef = np.sqrt(np.maximum(one - a_prev - sigma * sigma,
                                      np.float32(0.0)))
        img = float(np.sqrt(a_prev)) * x0 + float(dir_coef) * eps
        return img + float(sigma) * z if t_prev >= 0 else img

    with contextlib.nullcontext() if differentiable else torch.no_grad():
        img = _sampler_init(sched, draw(), init, condition)
        return _run_steps(step, img, num_steps, draw,
                          differentiable=differentiable, remat=remat,
                          remat_chunk=remat_chunk, what="num_steps")


@torch.no_grad()
def dpmpp_sample_loop(denoise: DenoiseFn, sched: DiffusionSchedule,
                      x_in: torch.Tensor, *, num_steps: int = 25,
                      eta: float = 0.0,
                      generator: torch.Generator | None = None,
                      noise: Sequence[torch.Tensor] | None = None,
                      conditional: bool = True, clip_denoised: bool = True,
                      init: str = "noise", time_input: str = "gamma"
                      ) -> torch.Tensor:
    """DPM-Solver++(2M) over the strided subsequence: second-order
    multistep in the data-prediction form, first order at the first and
    the last update.  ``eta=0`` is the deterministic solver; ``eta>0`` the
    2M SDE (extra ``e^{-ηh}`` decay toward the x₀ prediction, fresh noise
    ``σ_p·sqrt(1 − e^{-2ηh})·ε`` each step, one draw per loop iteration as
    the JAX package's ``fold_in`` stream; ``eta=0`` draws only x_T).  No
    gradient, as the JAX loop ends in ``stop_gradient``.  The step scalars
    are float32, computed on the host as the JAX loop computes them.
    ``time_input`` as in :func:`p_sample_loop`."""
    T = sched.num_timesteps
    num_steps = min(num_steps, T)
    condition = x_in if conditional else None
    taus = _strided_taus(T, num_steps)
    x0_eps = _make_x0_eps_pred(denoise, sched, condition, clip_denoised,
                               time_input)
    draw = _noise_stream(x_in.shape, x_in.device, generator, noise)
    img = _sampler_init(sched, draw(), init, condition)
    f32 = np.float32
    eta32, one = f32(eta), f32(1.0)
    d_prev, lam_prev = None, f32(0.0)
    for i in range(num_steps - 1, -1, -1):
        with annotate("sr3d.step", k=num_steps - 1 - i):
            t = int(taus[i])
            t_prev = int(taus[i - 1]) if i > 0 else -1
            d, _ = x0_eps(img, t)
            a_c = sched.alphas_cumprod[t]
            a_p = sched.alphas_cumprod[t_prev] if t_prev >= 0 else one
            alpha_c, sigma_c = np.sqrt(a_c), np.sqrt(one - a_c)
            alpha_p = np.sqrt(a_p)
            sigma_p = np.sqrt(np.maximum(one - a_p, f32(0.0)))
            e_neg_h = (alpha_c * sigma_p) / (alpha_p * sigma_c)
            lam_c = np.log(alpha_c / sigma_c)
            h = np.maximum(-np.log(np.maximum(e_neg_h, f32(1e-38))),
                           f32(1e-12))
            r = np.maximum((lam_c - lam_prev) / h, f32(1e-6))
            use_2nd = d_prev is not None and t_prev >= 0
            if eta == 0.0:
                d_eff = (d + (d - d_prev) / float(f32(2.0) * r) if use_2nd
                         else d)
                img = (float(sigma_p / sigma_c) * img
                       + float(alpha_p * (one - e_neg_h)) * d_eff)
            else:
                c = (one + eta32) * h
                e_neg_c = e_neg_h ** (one + eta32)
                d_term = float(one - e_neg_c) * d
                if use_2nd:
                    d_term = d_term + float((one - (one - e_neg_c) / c) / r) \
                        * (d - d_prev)
                z = draw()
                img = (float(sigma_p / sigma_c * e_neg_h ** eta32) * img
                       + float(alpha_p) * d_term)
                if t_prev >= 0:
                    img = img + float(sigma_p * np.sqrt(np.maximum(
                        one - e_neg_h ** (f32(2.0) * eta32), f32(0.0)))) * z
            d_prev, lam_prev = d, lam_c
    return img
