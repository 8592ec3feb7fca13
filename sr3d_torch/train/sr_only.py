"""SR-only training: the SR diffusion branch alone, with its own optimizer
and checkpoints, the first stage of the staged workflow.

Counterpart of ``sr3d_tpu/train/sr_only.py`` (``SRModel``,
``SRTrainState``), itself the reference's ``DDPM`` wrapper:

* the UNet comes from ``models/networks.py::define_g`` (the SR3 or the DDPM
  family, ``which_model_G``), in ``tpu.compute_dtype``, its blocks
  checkpointed under ``tpu.train_remat``;
* the optimizer is ``optax.adam(lr)``'s: ``torch.optim.Adam`` (β = 0.9,
  0.999, ε = 1e-8), one param group; under ``sr.model.finetune_norm`` only
  the parameters under a scope named ``attn`` train, the others get no
  gradient, no update and no Adam state;
* the EMA follows ``sr.train.ema_scheduler``;
* the checkpoint pair ``I{iter}_E{epoch}_gen.npz`` (the UNet's leaves in
  ``jax.tree_util`` order) and ``_opt.npz`` (``epoch``, ``iter`` and the
  optimizer's leaves in optax's order: the count, every μ, every ν; under
  ``finetune_norm`` the ``multi_transform`` state, the frozen leaves
  absent), so a pair written by either package resumes in the other and
  warm-starts both joint Trainers (``sr.pretrained_model_path``).

Unlike the JAX package the parameters live in the module and a train step
updates them in place; the state carries the step, the optimizer and the
EMA.  Batches are NHWC in [−1, 1], as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from ..diffusion.ema import EmaState, ema_init, ema_update
from ..diffusion.gaussian import (
    ddim_sample_loop,
    dpmpp_sample_loop,
    p_sample_loop,
)
from ..diffusion.schedules import schedule_from_config
from ..models.layers import init_lecun_normal_
from ..models.networks import FAMILIES, define_g
from ..models.sr3_unet import SR3UNet
from ..utils.bridge import flax_to_state_dict, state_dict_to_flax
from .checkpoint import (
    load_leaves_into,
    load_optimizer_tree,
    optimizer_tree,
    save_leaves,
    sr_layout,
)
from .joint import compute_dtype, sr_loss

logger = logging.getLogger("sr3d_torch")

SAMPLERS = ("ddpm", "ddim", "dpm++")


@dataclasses.dataclass
class SRTrainState:
    """The train steps taken, the optimizer (with its moments) and the EMA
    of the UNet's parameters (None without an EMA scheduler)."""

    step: int
    opt: torch.optim.Optimizer
    ema: EmaState | None


def in_attn(name: str) -> bool:
    """Whether parameter ``name`` sits under a scope named ``attn``."""
    return "attn" in name.split(".")[:-1]


class SRModel:
    """The SR diffusion branch of ``cfg`` on ``device`` (None: the GPU; it
    raises where there is none).  ``unet`` reuses a UNet built elsewhere
    (the alternating trainer's joint modules); otherwise ``define_g``'s,
    with random weights from ``init_seed`` (default ``cfg.seed``)."""

    def __init__(self, cfg, dtype: torch.dtype | None = None, *,
                 unet: SR3UNet | None = None,
                 device: str | torch.device | None = None,
                 init_seed: int | None = None):
        self.cfg = cfg
        which = str(cfg.sr.model.get("which_model_G", "sr3"))
        if unet is None:
            self.device = resolve_device(device)
            seed = int(cfg.seed if init_seed is None else init_seed)
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                unet, self.time_input = define_g(
                    cfg.sr.model,
                    dtype=dtype if dtype is not None else compute_dtype(cfg),
                    remat=bool(cfg.tpu.train_remat))
            init_lecun_normal_(unet, torch.Generator().manual_seed(seed))
            unet.to(self.device)
        else:
            if which not in FAMILIES or not isinstance(
                    unet, FAMILIES[which][0]):
                raise ValueError(f"the UNet given is a {type(unet).__name__},"
                                 f" which_model_G is {which!r}")
            self.device = next(unet.parameters()).device
            self.time_input = FAMILIES[which][1]
        self.unet = unet.eval()
        d = cfg.sr.model.diffusion
        self.sched_train = schedule_from_config(
            cfg.sr.model.beta_schedule.train)
        self.sched_val = schedule_from_config(cfg.sr.model.beta_schedule.val)
        self.loss_type = str(d.get("loss", "l1"))
        self.conditional = bool(d.get("conditional", True))
        self.sample_remat = bool(cfg.tpu.sample_remat)
        self.finetune_norm = bool(cfg.sr.model.get("finetune_norm", False))
        self.layout = sr_layout(self.unet, self.finetune_norm)
        ema = cfg.sr.train.get("ema_scheduler")
        self.ema_cfg = dict(ema) if ema else None

    def init_state(self) -> SRTrainState:
        """Make the UNet trainable (all of it, or its ``attn`` scopes under
        ``finetune_norm``) and start from its current weights: a fresh
        Adam, the EMA a copy of the parameters."""
        for n, p in self.unet.named_parameters():
            p.requires_grad_(not self.finetune_norm or in_attn(n))
        params = [p for p in self.unet.parameters() if p.requires_grad]
        label = next(iter(self.layout.labels))
        opt = torch.optim.Adam(
            [{"name": label, "params": params}],
            lr=float(self.cfg.sr.train.optimizer.lr), betas=(0.9, 0.999),
            eps=1e-8)
        ema = (ema_init(dict(self.unet.named_parameters()))
               if self.ema_cfg else None)
        return SRTrainState(step=0, opt=opt, ema=ema)

    # -- checkpoints: the SR-only pair -----------------------------------

    def _gen_tree(self) -> dict:
        return {"params": state_dict_to_flax(dict(
            self.unet.named_parameters()))}

    def save_network(self, ckpt_dir, state: SRTrainState, epoch: int,
                     iter_step: int) -> str:
        """Write ``I{iter}_E{epoch}_gen.npz`` (the UNet) and ``_opt.npz``
        (the optimizer, ``epoch``, ``iter``); returns the prefix."""
        ckpt_dir = Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        prefix = ckpt_dir / f"I{iter_step}_E{epoch}"
        save_leaves(f"{prefix}_gen.npz", self._gen_tree())
        save_leaves(f"{prefix}_opt.npz", optimizer_tree(self.layout, state),
                    epoch=np.asarray(int(epoch)),
                    iter=np.asarray(int(iter_step)))
        return str(prefix)

    @staticmethod
    def latest_prefix(ckpt_dir) -> str | None:
        """The ``I{iter}_E{epoch}`` prefix of the highest iter in
        ``ckpt_dir`` (I10 after I9), or None."""
        gens = list(Path(ckpt_dir).glob("I*_E*_gen.npz"))
        if not gens:
            return None
        best = max(gens, key=lambda p: int(p.name.split("_")[0][1:]))
        return str(best)[:-len("_gen.npz")]

    def load_network(self, state: SRTrainState, prefix_or_dir,
                     phase: str = "train") -> tuple[SRTrainState, int, int]:
        """The UNet from ``{prefix}_gen.npz`` (a prefix, or the newest in a
        directory), the EMA restarted from it; in the train phase, where
        ``{prefix}_opt.npz`` exists, the optimizer and the counters too.
        Returns ``(state, begin_step, begin_epoch)``."""
        prefix = str(prefix_or_dir)
        if Path(prefix).is_dir():
            latest = self.latest_prefix(prefix)
            if latest is None:
                raise FileNotFoundError(f"no I*_E*_gen.npz in {prefix}")
            prefix = latest
        tree = load_leaves_into(f"{prefix}_gen.npz", self._gen_tree())
        self.unet.load_state_dict({k: v.to(self.device) for k, v in
                                   flax_to_state_dict(tree).items()})
        if state.ema is not None:
            state.ema = ema_init(dict(self.unet.named_parameters()))
        begin_step = begin_epoch = 0
        opt_path = Path(f"{prefix}_opt.npz")
        if phase == "train" and opt_path.exists():
            with np.load(opt_path) as data:
                begin_step, begin_epoch = int(data["iter"]), \
                    int(data["epoch"])
            load_optimizer_tree(self.layout, state, load_leaves_into(
                opt_path, optimizer_tree(self.layout, state)))
            state.step = begin_step
        return state, begin_step, begin_epoch

    # -- the steps ---------------------------------------------------------

    def make_train_step(self):
        """``train_step(state, batch, *, generator=None, draws=None) ->
        (state, {"l_pix"})``: the diffusion loss of ``batch["HR"]``
        conditioned on ``batch["SR"]`` (NHWC), summed and divided by
        ``HR.numel()``, the UNet in train mode (deterministic, as the JAX
        step's ``apply``), one Adam step, the EMA.  The draws come from
        ``generator`` (on the UNet's device) or ``draws`` (``"gamma"`` or
        ``"t"``, and ``"noise"``, NCHW)."""

        def train_step(state: SRTrainState, batch: dict, *,
                       generator: torch.Generator | None = None,
                       draws: dict | None = None
                       ) -> tuple[SRTrainState, dict]:
            hr = torch.as_tensor(batch["HR"]).to(self.device, torch.float32)
            cond = (torch.as_tensor(batch["SR"]).to(self.device,
                                                     torch.float32)
                    if self.conditional else None)
            state.opt.zero_grad(set_to_none=True)
            self.unet.train()
            try:
                loss = sr_loss(self.unet, self.sched_train, self.time_input,
                               hr, cond, generator=generator, draws=draws,
                               loss_type=self.loss_type)
                loss.backward()
            finally:
                self.unet.eval()
            state.opt.step()
            if state.ema is not None:
                e = self.ema_cfg
                ema_update(state.ema, dict(self.unet.named_parameters()),
                           decay=float(e["ema_decay"]),
                           step_start_ema=int(e["step_start_ema"]),
                           update_every=int(e["update_ema_every"]))
            state.step += 1
            return state, {"l_pix": loss.detach()}

        return train_step

    def make_sampler(self, use_ema: bool = False, continuous: bool = False,
                     sampler: str | None = None):
        """``sample(state, cond, *, generator=None, noise=None)``: NHWC
        conditioning → NHWC samples with ``sampler`` (default
        ``sr.model.diffusion.sampler``): ``ddpm`` the ancestral loop,
        ``ddim`` / ``dpm++`` at ``ddim_steps``; an unknown name raises.
        ``use_ema`` samples with the EMA's weights where there is an EMA.
        ``continuous`` returns the ancestral loop's trajectory
        ``[frames, B, H, W, C]`` (a strided sampler warns and runs the
        ancestral loop)."""
        d = self.cfg.sr.model.diffusion
        sampler = sampler or str(d.get("sampler", "ddpm"))
        if sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {sampler!r}; expected "
                             f"ddpm | ddim | dpm++")
        if continuous and sampler != "ddpm":
            logger.warning("sampler=%s does not support continuous "
                           "trajectories; falling back to the ancestral "
                           "ddpm loop", sampler)
            sampler = "ddpm"
        init = str(d.get("sampler_init", "noise"))

        @torch.no_grad()
        def sample(state: SRTrainState, cond, *,
                   generator: torch.Generator | None = None,
                   noise=None) -> torch.Tensor:
            def denoise(x, t):
                if use_ema and state.ema is not None:
                    return functional_call(self.unet, state.ema.params,
                                           (x, t))
                return self.unet(x, t)

            c = torch.as_tensor(cond).to(self.device, torch.float32) \
                .permute(0, 3, 1, 2).contiguous()
            kw = dict(generator=generator, noise=noise,
                      conditional=self.conditional, init=init,
                      time_input=self.time_input)
            if sampler == "ddim":
                out = ddim_sample_loop(
                    denoise, self.sched_val, c,
                    num_steps=int(d.get("ddim_steps", 50)),
                    eta=float(d.get("ddim_eta", 1.0)), **kw)
            elif sampler == "dpm++":
                out = dpmpp_sample_loop(
                    denoise, self.sched_val, c,
                    num_steps=int(d.get("ddim_steps", 50)),
                    eta=float(d.get("dpmpp_eta", 0.0)), **kw)
            else:
                out = p_sample_loop(denoise, self.sched_val, c,
                                    remat=self.sample_remat,
                                    return_intermediates=continuous, **kw)
                if continuous:
                    return out.intermediates.permute(0, 1, 3, 4, 2)
            return out.permute(0, 2, 3, 1)

        return sample
