"""Exponential moving average of the SR parameters.

Counterpart of ``sr3d_tpu/diffusion/ema.py``: the same warm-up (below
``step_start_ema`` the average copies the parameters) and the same
``update_every`` gate (on other steps it keeps its value; the step count
advances every call).  Unlike the JAX version, ``ema_update`` updates the
average in place, under ``torch.no_grad()``, and returns the same state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch


@dataclasses.dataclass
class EmaState:
    params: dict[str, torch.Tensor]  # name -> tensor, the module's names
    step: int = 0


def ema_init(params: Mapping[str, torch.Tensor]) -> EmaState:
    """A copy of ``params`` (e.g. ``dict(unet.named_parameters())``) that
    owns its own storage; step 0."""
    return EmaState(params={k: v.detach().clone() for k, v in params.items()})


@torch.no_grad()
def ema_update(state: EmaState, new_params: Mapping[str, torch.Tensor], *,
               decay: float = 0.9999, step_start_ema: int = 5000,
               update_every: int = 1) -> EmaState:
    """One EMA step, in place: ``step += 1``; if ``step % update_every ==
    0``, copy ``new_params`` while ``step < step_start_ema``, else blend
    ``ema·decay + new·(1 − decay)``."""
    state.step += 1
    if state.step % update_every:
        return state
    names = list(state.params)
    ema = [state.params[k] for k in names]
    new = [new_params[k].detach() for k in names]
    if state.step < step_start_ema:
        torch._foreach_copy_(ema, new)
    else:
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - decay))
    return state
