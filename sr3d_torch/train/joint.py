"""The joint SR-diffusion + MICA model: the model2 train step and the
serving step.

Counterpart of ``sr3d_tpu/train/joint.py`` (``build_joint``,
``make_optimizer``, ``init_train_state``, ``make_train_step`` for model2,
``encode_mica``, ``decode_mica``, ``gt_flame_vertices``,
``make_val_step``): SR sampling (ancestral or DDIM), the quantised uint8
hand-off to the 224² image and the 112² ArcFace blob, ArcFace →
L2-normalise → mapping network → FLAME vertices → 68 landmarks; in training
also the SR3 loss, the masked vertex loss, the two optimizers and the EMA.

Model3 (the differentiable hand-off), the int8 hand-off and gradient
accumulation are not ported yet; the train step raises for them.

The public steps keep the JAX package's layouts: the batch's ``"HR"``,
``"SR"`` and the returned ``"sr"`` / ``"img224"`` are NHWC; the UNet and
ArcFace run NCHW inside.  Unlike the JAX package, parameters and ArcFace's
BatchNorm statistics live in the modules, and a train step updates them in
place.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from ..diffusion.ema import EmaState, ema_init, ema_update
from ..diffusion.gaussian import (
    ddim_sample_loop,
    p_losses_continuous,
    p_sample_loop,
)
from ..diffusion.schedules import DiffusionSchedule, schedule_from_config
from ..models import masking
from ..models.arcface import IResNet, frozen_prefix_mask
from ..models.flame import (
    FlameModel,
    compute_landmarks,
    flame_forward,
    load_flame,
    sphere_flame,
    synthetic_flame,
)
from ..models.layers import init_lecun_normal_
from ..models.mapping import MappingNetwork
from ..models.sr3_unet import SR3UNet, unet_from_config
from ..ops.image import sr_to_mica_inputs


@dataclasses.dataclass(frozen=True)
class JointModules:
    """The model: networks (eval mode unless a train step runs them, on
    ``device``), FLAME buffers, the schedules, the vertex loss weights and
    the knobs of the train and val steps."""

    unet: SR3UNet
    arcface: IResNet
    mapping: MappingNetwork
    flame: FlameModel
    sched_train: DiffusionSchedule
    sched_val: DiffusionSchedule
    vertex_weights: torch.Tensor       # [V, 1] fp32 on ``device``
    device: torch.device
    variant: str = "model2"
    sever_sr_grad: bool = False
    loss_type: str = "l1"
    val_sampler: str = "ddpm"
    ddim_steps: int = 50
    ddim_eta: float = 1.0
    sampler_init: str = "noise"
    # the in-step SR → MICA hand-off: "ddpm" is the reference's T-step
    # ancestral loop, "ddim" the serving recipe (η = 1, marginal init) at
    # train_ddim_steps UNet evaluations
    train_sampler: str = "ddpm"
    train_ddim_steps: int = 25
    # what the MICA branch sees: "sampled" (the reference pipeline), or the
    # control arms "cond" (bicubic conditioning) and "hr" (the HR oracle)
    handoff_source: str = "sampled"
    handoff_grad_scale: float = 1.0
    train_arcface_prefix: bool = False
    train_handoff_int8: bool = False
    image_size: int = 224
    blob_size: int = 112


@dataclasses.dataclass
class JointTrainState:
    """What a train step carries besides the modules: the step count, the
    optimizer (with its moments) and the EMA of the UNet's parameters."""

    step: int
    opt: torch.optim.Optimizer
    ema: EmaState | None


def compute_dtype(cfg) -> torch.dtype:
    """``cfg.tpu.compute_dtype`` ("bfloat16" | "float32") as a torch dtype."""
    return {"bfloat16": torch.bfloat16,
            "float32": torch.float32}[str(cfg.tpu.compute_dtype)]


def _default_flame(cfg, device) -> FlameModel:
    m = cfg.mica.model
    try:
        return load_flame(m.flame_model_path, m.flame_lmk_embedding_path,
                          n_shape=m.n_shape, device=device)
    except OSError:  # the licensed assets are absent
        if str(m.get("synthetic_flame_kind", "random")) == "sphere":
            return sphere_flame(n_shape=m.n_shape, n_exp=m.n_exp,
                                device=device)
        return synthetic_flame(n_shape=m.n_shape, n_exp=m.n_exp,
                               device=device)


def _vertex_weights(cfg, masks: dict | None, n_vertices: int) -> np.ndarray:
    """``use_mask`` → the region weights of ``weights_per_vertex``;
    otherwise ones (the plain mean |diff| × 1000)."""
    if not bool(cfg.mica.train.use_mask):
        return np.ones((n_vertices, 1), np.float32)
    if masks is None:
        try:
            masks = masking.load_masks(cfg.mica.model.masks_path)
        except OSError:  # FLAME_masks.pkl is absent
            masks = masking.synthetic_masks(n_vertices)
    return masking.weights_per_vertex(masks, cfg.mica.mask_weights,
                                      n_vertices)


def build_joint(cfg, flame: FlameModel | None = None,
                masks: dict | None = None,
                dtype: torch.dtype | None = None,
                device: str | torch.device | None = None,
                init_seed: int = 0) -> JointModules:
    """Build every module from a merged config tree, with random weights
    drawn from ``init_seed`` (load trained ones over them with
    ``utils.bridge.load_jax_params``).  ``device=None`` means the GPU and
    raises where there is none."""
    device = resolve_device(device)
    dtype = dtype if dtype is not None else compute_dtype(cfg)
    if flame is None:
        flame = _default_flame(cfg, device)
    m = cfg.mica.model
    train_prefix = not bool(cfg.mica.train.get("freeze_arcface_prefix",
                                               True))
    with torch.random.fork_rng(devices=[]):  # construction draws globally
        unet = unet_from_config(cfg.sr.model.unet, cfg.sr.model.diffusion,
                                dtype=dtype, remat=bool(cfg.tpu.train_remat))
        arcface = IResNet(layers=tuple(m.get("arcface_layers",
                                             (3, 13, 30, 3))), dtype=dtype,
                          train_frozen_prefix=train_prefix)
        mapping = MappingNetwork(z_dim=512, map_hidden_dim=m.map_hidden_dim,
                                 map_output_dim=m.n_shape,
                                 hidden=m.mapping_layers)
    gen = torch.Generator().manual_seed(int(init_seed))
    for net in (unet, arcface, mapping):
        init_lecun_normal_(net, gen).to(device).eval().requires_grad_(False)
    d = cfg.sr.model.diffusion
    return JointModules(
        unet=unet, arcface=arcface, mapping=mapping, flame=flame,
        sched_train=schedule_from_config(cfg.sr.model.beta_schedule.train),
        sched_val=schedule_from_config(cfg.sr.model.beta_schedule.val),
        vertex_weights=torch.from_numpy(
            _vertex_weights(cfg, masks, flame.n_vertices)).to(device),
        device=device,
        variant=str(cfg.model),
        sever_sr_grad=bool(cfg.train.get("sever_sr_grad", False)),
        loss_type=str(d.get("loss", "l1")),
        val_sampler=str(d.get("sampler", "ddpm")),
        ddim_steps=int(d.get("ddim_steps", 50)),
        ddim_eta=float(d.get("ddim_eta", 1.0)),
        sampler_init=str(d.get("sampler_init", "noise")),
        train_sampler=str(d.get("train_sampler", "ddpm")),
        train_ddim_steps=int(d.get("train_ddim_steps", 25)),
        handoff_source=str(cfg.train.get("handoff_source", "sampled")),
        handoff_grad_scale=float(cfg.train.get("handoff_grad_scale", 1.0)),
        train_arcface_prefix=train_prefix,
        train_handoff_int8=bool(d.get("train_handoff_int8", False)),
    )


def make_optimizer(cfg, modules: JointModules) -> torch.optim.AdamW:
    """The JAX package's ``optax.multi_transform`` as param groups of one
    ``AdamW`` (β = 0.9, 0.999, ε = 1e-8):

    * ``sr``: the UNet, Adam at the constant ``cfg.sr.train.optimizer.lr``
      (AdamW with weight decay 0 is Adam);
    * ``arcface``: ArcFace's trainable parameters (stage 4 and the head, or
      all with ``freeze_arcface_prefix: false``) at
      ``cfg.mica.train.arcface_lr``, and ``mapping``: the mapping network at
      ``cfg.mica.train.lr``; both with ``weight_decay`` and the staircase
      StepLR ``lr·lr_gamma^(step // lr_update_step)`` (``set_step_lr``).

    The frozen prefix is in no group: no update and no weight decay."""
    if int(cfg.tpu.get("grad_accum", 1)) > 1:
        raise NotImplementedError(
            "tpu.grad_accum > 1 (gradient accumulation) is not ported yet; "
            "it comes with a later slice of the train step")
    t = cfg.mica.train
    freeze = bool(t.get("freeze_arcface_prefix", True))
    trainable = frozen_prefix_mask(modules.arcface)
    arcface = [p for n, p in modules.arcface.named_parameters()
               if trainable[n] or not freeze]
    decay = dict(weight_decay=float(t.weight_decay),
                 lr_update_step=int(t.lr_update_step),
                 lr_gamma=float(t.lr_gamma))
    groups = [
        dict(name="sr", params=list(modules.unet.parameters()),
             lr=float(cfg.sr.train.optimizer.lr), weight_decay=0.0),
        dict(name="arcface", params=arcface, lr=float(t.arcface_lr),
             base_lr=float(t.arcface_lr), **decay),
        dict(name="mapping", params=list(modules.mapping.parameters()),
             lr=float(t.lr), base_lr=float(t.lr), **decay),
    ]
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)


def set_step_lr(opt: torch.optim.Optimizer, step: int) -> None:
    """Set each StepLR group's lr for the update after ``step`` updates:
    ``base_lr · lr_gamma^(step // lr_update_step)`` (optax's staircase
    ``exponential_decay``)."""
    for g in opt.param_groups:
        if "base_lr" in g:
            g["lr"] = g["base_lr"] * g["lr_gamma"] ** (
                step // g["lr_update_step"])


def init_train_state(modules: JointModules, cfg) -> JointTrainState:
    """Make ``modules`` trainable and start training from their current
    weights (random from ``build_joint``'s ``init_seed``, or bridged JAX
    ones): the UNet, the mapping network and ArcFace's trainable part get
    ``requires_grad``, the optimizer of ``make_optimizer`` is built, and the
    EMA starts as a copy of the UNet's parameters when
    ``cfg.sr.train.ema_scheduler`` is set."""
    modules.unet.requires_grad_(True)
    modules.mapping.requires_grad_(True)
    trainable = frozen_prefix_mask(modules.arcface)
    for n, p in modules.arcface.named_parameters():
        p.requires_grad_(trainable[n] or modules.train_arcface_prefix)
    ema = (ema_init(dict(modules.unet.named_parameters()))
           if cfg.sr.train.ema_scheduler else None)
    return JointTrainState(step=0, opt=make_optimizer(cfg, modules), ema=ema)


def scale_handoff_grad(x: torch.Tensor, s: float) -> torch.Tensor:
    """Value-preserving gradient scale: forward ``x`` unchanged, backward
    ``s·∂/∂x`` (``s = 1`` is the identity, ``s = 0`` a detach)."""
    if s == 1.0:
        return x
    return s * x + (1.0 - s) * x.detach()


def encode_mica(modules: JointModules, blob: torch.Tensor) -> torch.Tensor:
    """ArcFace embedding of NHWC blobs, L2-normalised (norm clipped at
    1e-12, as ``F.normalize``).  ArcFace's mode decides its BatchNorm."""
    emb = modules.arcface(blob.permute(0, 3, 1, 2).contiguous())
    return emb / torch.linalg.norm(emb, dim=1, keepdim=True).clamp_min(1e-12)


def decode_mica(modules: JointModules, embedding: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedding → shape code → canonical FLAME vertices (shape only)."""
    code = modules.mapping(embedding)
    verts, _, _ = flame_forward(modules.flame, code)
    return verts, code


@torch.no_grad()
def gt_flame_vertices(modules: JointModules, shape_params: torch.Tensor
                      ) -> torch.Tensor:
    """Ground-truth canonical vertices from the dataset's FLAME shape
    parameters, without gradient."""
    verts, _, _ = flame_forward(modules.flame, shape_params)
    return verts


@torch.no_grad()
def _handoff_sample(modules: JointModules, cond: torch.Tensor,
                    generator: torch.Generator | None,
                    noise: Sequence[torch.Tensor] | None) -> torch.Tensor:
    """The in-step SR sample (NCHW) of the NCHW conditioning: the T-step
    ancestral loop (``ddpm``) or DDIM η = 1 with marginal init at
    ``train_ddim_steps`` (``ddim``)."""
    kw = dict(generator=generator, noise=noise)
    if modules.train_sampler == "ddim":
        return ddim_sample_loop(modules.unet, modules.sched_train, cond,
                                num_steps=modules.train_ddim_steps, eta=1.0,
                                init="marginal", **kw)
    if modules.train_sampler != "ddpm":
        raise ValueError(f"unknown train_sampler {modules.train_sampler!r}: "
                         f"expected 'ddpm' or 'ddim'")
    return p_sample_loop(modules.unet, modules.sched_train, cond, **kw)


def _handoff_image(modules: JointModules, cond: torch.Tensor,
                   hr: torch.Tensor, generator: torch.Generator | None,
                   noise: Sequence[torch.Tensor] | None) -> torch.Tensor:
    """The NHWC image the MICA branch sees, per ``handoff_source``:
    ``sampled`` runs the in-step sampling; ``cond`` and ``hr`` are the
    bicubic and HR control arms."""
    src = modules.handoff_source
    if src == "cond":
        return cond
    if src == "hr":
        return hr
    if src != "sampled":
        raise ValueError(f"unknown train.handoff_source {src!r}: expected "
                         f"'sampled', 'cond' or 'hr'")
    final = _handoff_sample(modules, cond.permute(0, 3, 1, 2).contiguous(),
                            generator, noise)
    return final.permute(0, 2, 3, 1)


def make_train_step(ema_cfg: dict | None = None):
    """``train_step(modules, state, batch, *, generator=None, draws=None)
    -> (state, metrics)`` for model2, updating the modules, the optimizer
    and the EMA in place.

    ``batch``: ``HR``/``SR`` ``[N, h, h, 3]`` NHWC in [−1, 1] (the
    flattened K×B batch) and ``flame_shape`` ``[N, n_shape]``.  The random
    draws come from ``generator`` (on ``modules.device``): the hand-off's
    noise and l_sr's t, γ and noise.  ``draws`` replaces some of them:
    ``"gamma"`` ``[N]`` and ``"noise"`` (NCHW) for l_sr, ``"handoff"`` the
    sampler's noise list (see ``diffusion.gaussian``).

    One step: the hand-off sample under ``no_grad`` with the UNet in eval
    mode; ``l_sr = p_losses_continuous(…)/hr.numel()`` conditioned on
    ``batch["SR"]`` with the UNet in train mode (remat) and deterministic,
    as the JAX step's ``unet.apply`` leaves flax's default; the
    quantised uint8 hand-off → ArcFace in train mode → mapping → FLAME →
    ``l_mica = masked_vertex_l1``; one backward of ``l_sr + l_mica``; the
    optimizer step (StepLR set from ``state.step``); the EMA update.
    ``metrics``: ``l_sr``, ``l_mica``, ``loss`` (0-d tensors)."""

    def train_step(modules: JointModules, state: JointTrainState,
                   batch: dict, *, generator: torch.Generator | None = None,
                   draws: dict | None = None
                   ) -> tuple[JointTrainState, dict]:
        if modules.variant != "model2":
            raise NotImplementedError(
                f"the {modules.variant} train step (differentiable hand-off)"
                f" is not ported yet; a later slice ports it")
        if modules.train_handoff_int8:
            raise NotImplementedError(
                "train_handoff_int8 (the w8a8 int8 hand-off) is not ported "
                "yet; a later slice ports it")
        draws = draws or {}
        dev = modules.device
        hr = batch["HR"].to(dev, torch.float32)
        cond = batch["SR"].to(dev, torch.float32)

        # The hand-off runs first, so that the UNet stays in train mode
        # from the loss forward to the end of its backward, where the
        # checkpointed blocks run again.
        modules.unet.eval()
        final = _handoff_image(modules, cond, hr, generator,
                               draws.get("handoff"))
        _, blob = sr_to_mica_inputs(final, image_size=modules.image_size,
                                    blob_size=modules.blob_size)

        modules.unet.train()
        modules.arcface.train()
        try:
            l_sr = p_losses_continuous(
                modules.unet,
                modules.sched_train, hr.permute(0, 3, 1, 2).contiguous(),
                cond.permute(0, 3, 1, 2).contiguous(), generator=generator,
                gamma=draws.get("gamma"), noise=draws.get("noise"),
                loss_type=modules.loss_type) / hr.numel()
            pred, _ = decode_mica(modules, encode_mica(modules, blob))
            gt = gt_flame_vertices(modules, batch["flame_shape"].to(
                dev, torch.float32))
            l_mica = masking.masked_vertex_l1(pred, gt,
                                              modules.vertex_weights)
            loss = l_sr + l_mica
            state.opt.zero_grad(set_to_none=True)
            loss.backward()
        finally:
            modules.unet.eval()
            modules.arcface.eval()
        set_step_lr(state.opt, state.step)
        state.opt.step()
        if state.ema is not None and ema_cfg is not None:
            ema_update(state.ema, dict(modules.unet.named_parameters()),
                       decay=float(ema_cfg["ema_decay"]),
                       step_start_ema=int(ema_cfg["step_start_ema"]),
                       update_every=int(ema_cfg["update_ema_every"]))
        state.step += 1
        return state, {"l_sr": l_sr.detach(), "l_mica": l_mica.detach(),
                       "loss": loss.detach()}

    return train_step


def make_val_step(use_ema: bool = False):
    """``val_step(modules, batch, *, generator=None, noise=None, ema=None)
    -> dict``: sampling with ``modules.val_sampler`` (``ddpm`` = the
    ancestral loop, ``ddim`` = strided DDIM), then the MICA branch.  With
    ``use_ema`` the UNet samples with the EMA's parameters (``ema``, a
    ``diffusion.ema.EmaState``; without one, with its own, as the JAX
    package does).  ``noise`` replays an explicit noise sequence (see
    ``diffusion.gaussian``).  Returns NHWC ``sr`` [−1, 1] and ``img224``
    [0, 1], ``identity`` (shape code), ``verts`` and ``lmk68``."""

    @torch.no_grad()
    def val_step(modules: JointModules, batch: dict, *,
                 generator: torch.Generator | None = None,
                 noise: Sequence[torch.Tensor] | None = None,
                 ema: EmaState | None = None) -> dict:
        cond = batch["SR"].to(modules.device, torch.float32) \
            .permute(0, 3, 1, 2).contiguous()
        denoise = modules.unet
        if use_ema and ema is not None:
            def denoise(x, t):
                return functional_call(modules.unet, ema.params, (x, t))
        kw = dict(generator=generator, noise=noise, init=modules.sampler_init)
        if modules.val_sampler == "ddim":
            final = ddim_sample_loop(denoise, modules.sched_val, cond,
                                     num_steps=modules.ddim_steps,
                                     eta=modules.ddim_eta, **kw)
        elif modules.val_sampler == "ddpm":
            final = p_sample_loop(denoise, modules.sched_val, cond, **kw)
        else:
            raise NotImplementedError(
                f"val sampler {modules.val_sampler!r} is not ported yet "
                f"(ddpm | ddim)")
        sr = final.permute(0, 2, 3, 1)
        img224, blob = sr_to_mica_inputs(sr, image_size=modules.image_size,
                                         blob_size=modules.blob_size)
        verts, code = decode_mica(modules, encode_mica(modules, blob))
        return {"sr": sr, "img224": img224, "identity": code, "verts": verts,
                "lmk68": compute_landmarks(modules.flame, verts)}

    return val_step
