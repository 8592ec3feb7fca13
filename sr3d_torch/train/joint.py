"""The joint SR-diffusion + MICA model: the train, eval and serving steps.

Counterpart of ``sr3d_tpu/train/joint.py`` (``build_joint``,
``make_optimizer``, ``init_train_state``, ``make_train_step``,
``make_eval_step``, ``encode_mica``, ``decode_mica``,
``gt_flame_vertices``, ``make_val_step``): SR sampling (ancestral, DDIM or
DPM-Solver++), the hand-off to the 224² image and the 112² ArcFace blob,
ArcFace → L2-normalise → mapping network → FLAME vertices → 68 landmarks;
in training also the SR3 loss, the masked vertex loss, the two optimizers,
gradient accumulation and the EMA.

Both variants train: model2 samples without gradient and hands off through
the uint8 round trip; model3 hands off through the continuous blob, and
unless ``sever_sr_grad`` its sampling stays on the autograd tape (each
step checkpointed), so l_mica trains the UNet too.  With
``train_handoff_int8`` a severed hand-off samples with the w8a8 int8 UNet.

The public steps keep the JAX package's layouts: the batch's ``"HR"``,
``"SR"`` and the returned ``"sr"`` / ``"img224"`` are NHWC; the UNet and
ArcFace run NCHW inside.  Unlike the JAX package, parameters and ArcFace's
BatchNorm statistics live in the modules, and a train step updates them in
place.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call

from ..device import resolve_device
from ..diffusion.ema import EmaState, ema_init, ema_update
from ..diffusion.gaussian import (
    ddim_sample_loop,
    dpmpp_sample_loop,
    p_losses_continuous,
    p_losses_discrete,
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
from ..models.networks import define_g
from ..models.sr3_unet import SR3UNet
from ..ops.image import sr_to_mica_inputs
from ..parallel.layout import average_gradients
from ..utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class JointModules:
    """The model: networks (eval mode unless a train step runs them, on
    ``device``), FLAME buffers, the schedules, the vertex loss weights and
    the knobs of the train and val steps."""

    unet: SR3UNet                      # or its DDPM subclass
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
    dpmpp_eta: float = 0.0             # > 0: the 2M SDE
    # model3's differentiable hand-off: checkpoint each run of
    # sample_remat_chunk sampling steps (the same gradients, less memory)
    sample_remat: bool = True
    sample_remat_chunk: int = 1
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
    # the UNet's time input (models/networks.py::define_g): the SR3
    # family's noise level "gamma" or the DDPM family's timestep "t"
    time_input: str = "gamma"


@dataclasses.dataclass
class JointTrainState:
    """What a train step carries besides the modules: the step count (train
    steps called, micro-steps under gradient accumulation), the optimizer
    (with its moments), the EMA of the UNet's parameters, ``grad_accum``,
    the micro-steps an optimizer update averages, and ``mini_step``, the
    micro-steps taken since the last update (optax ``MultiSteps``'
    ``mini_step``; their mean gradient waits in the parameters'
    ``.grad``)."""

    step: int
    opt: torch.optim.Optimizer
    ema: EmaState | None
    grad_accum: int = 1
    mini_step: int = 0


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
    # construction draws from the global RNG (the biases keep those
    # values): seed it, inside a fork, so that init_seed alone decides
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(int(init_seed))
        unet, time_input = define_g(cfg.sr.model, dtype=dtype,
                                    remat=bool(cfg.tpu.train_remat))
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
        dpmpp_eta=float(d.get("dpmpp_eta", 0.0)),
        sample_remat=bool(cfg.tpu.sample_remat),
        sample_remat_chunk=int(cfg.tpu.get("sample_remat_chunk", 1)),
        train_sampler=str(d.get("train_sampler", "ddpm")),
        train_ddim_steps=int(d.get("train_ddim_steps", 25)),
        handoff_source=str(cfg.train.get("handoff_source", "sampled")),
        handoff_grad_scale=float(cfg.train.get("handoff_grad_scale", 1.0)),
        train_arcface_prefix=train_prefix,
        train_handoff_int8=bool(d.get("train_handoff_int8", False)),
        time_input=time_input,
    )


def mica_param_groups(cfg, modules: JointModules, freeze: bool = True
                      ) -> list[dict]:
    """The MICA branch's param groups: ``arcface`` (ArcFace's trainable
    parameters: stage 4 and the head, or all where ``freeze`` is False) at
    ``cfg.mica.train.arcface_lr`` and ``mapping`` at ``cfg.mica.train.lr``,
    both with ``weight_decay`` and the staircase StepLR
    ``lr·lr_gamma^(step // lr_update_step)`` (``set_step_lr``).  The
    frozen prefix is in no group: no update and no weight decay."""
    t = cfg.mica.train
    trainable = frozen_prefix_mask(modules.arcface)
    arcface = [p for n, p in modules.arcface.named_parameters()
               if trainable[n] or not freeze]
    decay = dict(weight_decay=float(t.weight_decay),
                 lr_update_step=int(t.lr_update_step),
                 lr_gamma=float(t.lr_gamma))
    return [dict(name="arcface", params=arcface, lr=float(t.arcface_lr),
                 base_lr=float(t.arcface_lr), **decay),
            dict(name="mapping", params=list(modules.mapping.parameters()),
                 lr=float(t.lr), base_lr=float(t.lr), **decay)]


def make_optimizer(cfg, modules: JointModules) -> torch.optim.AdamW:
    """The JAX package's ``optax.multi_transform`` as param groups of one
    ``AdamW`` (β = 0.9, 0.999, ε = 1e-8): ``sr``, the UNet, Adam at the
    constant ``cfg.sr.train.optimizer.lr`` (AdamW with weight decay 0 is
    Adam), and :func:`mica_param_groups` (``freeze_arcface_prefix``).
    ``tpu.grad_accum`` (optax's ``MultiSteps``) is the train step's:
    ``JointTrainState.grad_accum``."""
    freeze = bool(cfg.mica.train.get("freeze_arcface_prefix", True))
    groups = [dict(name="sr", params=list(modules.unet.parameters()),
                   lr=float(cfg.sr.train.optimizer.lr), weight_decay=0.0),
              *mica_param_groups(cfg, modules, freeze)]
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)


def group_update_count(opt: torch.optim.Optimizer, group: dict) -> int:
    """The updates ``group`` (one of ``opt.param_groups``) has applied: the
    ``step`` of its first parameter with state, 0 before the first."""
    for p in group["params"]:
        st = opt.state.get(p)
        if st and "step" in st:
            return int(st["step"])
    return 0


def set_step_lr(opt: torch.optim.Optimizer, step: int | None = None
                ) -> None:
    """Set each StepLR group's lr for its next update:
    ``base_lr · lr_gamma^(n // lr_update_step)`` (optax's staircase
    ``exponential_decay``), ``n`` = ``step``, or where it is None the
    updates that group has applied (its schedule's count in optax)."""
    for g in opt.param_groups:
        if "base_lr" in g:
            n = group_update_count(opt, g) if step is None else step
            g["lr"] = g["base_lr"] * g["lr_gamma"] ** (
                n // g["lr_update_step"])


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
    return JointTrainState(step=0, opt=make_optimizer(cfg, modules), ema=ema,
                           grad_accum=int(cfg.tpu.get("grad_accum", 1)))


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


def _handoff_quant(modules: JointModules, differentiable: bool) -> bool:
    """Whether the hand-off samples with the int8 UNet
    (``train_handoff_int8``), with the JAX package's two refusals."""
    if not modules.train_handoff_int8:
        return False
    if differentiable:
        raise ValueError(
            "train_handoff_int8 requires a gradient-severed hand-off "
            "(model2, or model3 with train.sever_sr_grad) — the w8a8 int8 "
            "rounding has zero gradient and would silently sever "
            "flow-through model3's l_mica→UNet path")
    if modules.unet.quant_min_res <= 0:
        raise ValueError(
            "train_handoff_int8 is set but sr.model.unet.quant_min_res is "
            "0 — set quant_min_res (e.g. 1 = every ResnetBlock conv) to "
            "choose which levels quantize")
    return True


def _handoff_sample(modules: JointModules, cond: torch.Tensor,
                    generator: torch.Generator | None,
                    noise: Sequence[torch.Tensor] | None,
                    differentiable: bool) -> torch.Tensor:
    """The in-step SR sample (NCHW) of the NCHW conditioning: the T-step
    ancestral loop (``ddpm``) or DDIM η = 1 with marginal init at
    ``train_ddim_steps`` (``ddim``); on the autograd tape when
    ``differentiable``; with the int8 UNet under ``train_handoff_int8``.
    A ``sample_remat_chunk`` that does not divide ``train_ddim_steps``
    falls back to per-step checkpoints with a warning (the same
    gradients); the ancestral loop raises for one that does not divide
    T."""
    quant = _handoff_quant(modules, differentiable)
    # The UNet's own block checkpoints are fixed here, not left to its
    # mode: a checkpointed sampling step must recompute as it ran.  Under
    # the per-step checkpoints they would only recompute twice.
    denoise = functools.partial(
        modules.unet, remat=modules.unet.remat and not modules.sample_remat,
        quant=quant)
    kw = dict(generator=generator, noise=noise, differentiable=differentiable,
              remat=modules.sample_remat, time_input=modules.time_input)
    chunk = modules.sample_remat_chunk
    if modules.train_sampler == "ddim":
        if chunk > 1 and modules.train_ddim_steps % chunk:
            warnings.warn(
                f"tpu.sample_remat_chunk={chunk} does not divide "
                f"train_ddim_steps={modules.train_ddim_steps}; the ddim "
                f"hand-off falls back to per-step remat (chunk=1)")
            chunk = 1
        return ddim_sample_loop(denoise, modules.sched_train, cond,
                                num_steps=modules.train_ddim_steps, eta=1.0,
                                init="marginal", remat_chunk=chunk, **kw)
    if modules.train_sampler != "ddpm":
        raise ValueError(f"unknown train_sampler {modules.train_sampler!r}: "
                         f"expected 'ddpm' or 'ddim'")
    return p_sample_loop(denoise, modules.sched_train, cond,
                         remat_chunk=chunk, **kw)


def _handoff_image(modules: JointModules, cond: torch.Tensor,
                   hr: torch.Tensor, generator: torch.Generator | None,
                   noise: Sequence[torch.Tensor] | None,
                   differentiable: bool = False) -> torch.Tensor:
    """The NHWC image the MICA branch sees, per ``handoff_source``:
    ``sampled`` runs the in-step sampling; ``cond`` and ``hr`` are the
    bicubic and HR control arms (no sampling, no UNet dependence)."""
    src = modules.handoff_source
    if src == "cond":
        return cond
    if src == "hr":
        return hr
    if src != "sampled":
        raise ValueError(f"unknown train.handoff_source {src!r}: expected "
                         f"'sampled', 'cond' or 'hr'")
    final = _handoff_sample(modules, cond.permute(0, 3, 1, 2).contiguous(),
                            generator, noise, differentiable)
    return final.permute(0, 2, 3, 1)


def sr_loss(unet: SR3UNet, sched: DiffusionSchedule, time_input: str,
            hr: torch.Tensor, cond: torch.Tensor | None, *,
            generator: torch.Generator | None = None,
            draws: dict | None = None, loss_type: str = "l1"
            ) -> torch.Tensor:
    """The diffusion loss of NHWC ``hr`` conditioned on NHWC ``cond``
    (None: unconditional), divided by ``hr.numel()``:
    ``p_losses_continuous`` for the SR3 family (``draws``: ``"gamma"``,
    ``"noise"``), ``p_losses_discrete`` for the DDPM family (``"t"``,
    ``"noise"``)."""
    draws = draws or {}
    x = hr.permute(0, 3, 1, 2).contiguous()
    c = None if cond is None else cond.permute(0, 3, 1, 2).contiguous()
    if time_input == "t":
        loss = p_losses_discrete(unet, sched, x, c, generator=generator,
                                 t=draws.get("t"), noise=draws.get("noise"),
                                 loss_type=loss_type)
    else:
        loss = p_losses_continuous(unet, sched, x, c, generator=generator,
                                   gamma=draws.get("gamma"),
                                   noise=draws.get("noise"),
                                   loss_type=loss_type)
    return loss / hr.numel()


def _l_sr(modules: JointModules, hr: torch.Tensor, cond: torch.Tensor,
          generator: torch.Generator | None, draws: dict) -> torch.Tensor:
    return sr_loss(modules.unet, modules.sched_train, modules.time_input,
                   hr, cond, generator=generator, draws=draws,
                   loss_type=modules.loss_type)


def _l_mica(modules: JointModules, blob: torch.Tensor,
            flame_shape: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor,
                                                torch.Tensor]:
    """ArcFace → mapping → FLAME → the masked vertex L1 against the
    ground truth of ``flame_shape``: ``(l_mica, verts, gt_verts)``."""
    pred, _ = decode_mica(modules, encode_mica(modules, blob))
    gt = gt_flame_vertices(modules, flame_shape.to(modules.device,
                                                   torch.float32))
    return masking.masked_vertex_l1(pred, gt, modules.vertex_weights), \
        pred, gt


def train_losses(modules: JointModules, batch: dict, *,
                 generator: torch.Generator | None = None,
                 draws: dict | None = None) -> dict:
    """The train step's forward (the JAX package's ``loss_fn``), on the
    autograd tape, the networks in the modes the caller set (the step: train
    mode).  Returns ``l_sr``, ``l_mica`` and the detached ``vis`` tensors
    (``verts``, ``gt_verts``, ``img224``).

    l_sr conditions on ``batch["SR"]`` for both variants.  The hand-off
    (``handoff_source``): model2 samples without gradient and hands off
    through the uint8 round trip; model3 hands off through the continuous
    blob, its sample detached under ``sever_sr_grad`` and otherwise on the
    tape with its backward scaled by ``handoff_grad_scale``."""
    if modules.variant not in ("model2", "model3"):
        raise ValueError(f"unknown model variant {modules.variant!r}: "
                         f"expected 'model2' or 'model3'")
    draws = draws or {}
    model3 = modules.variant == "model3"
    hr = batch["HR"].to(modules.device, torch.float32)
    cond = batch["SR"].to(modules.device, torch.float32)
    l_sr = _l_sr(modules, hr, cond, generator, draws)
    final = _handoff_image(modules, cond, hr, generator,
                           draws.get("handoff"),
                           differentiable=model3 and not modules.sever_sr_grad)
    if model3 and modules.sever_sr_grad:
        final = final.detach()
    elif model3:
        final = scale_handoff_grad(final, modules.handoff_grad_scale)
    img224, blob = sr_to_mica_inputs(final, image_size=modules.image_size,
                                     blob_size=modules.blob_size,
                                     differentiable=model3)
    l_mica, pred, gt = _l_mica(modules, blob, batch["flame_shape"])
    return {"l_sr": l_sr, "l_mica": l_mica,
            "vis": {"verts": pred.detach(), "gt_verts": gt,
                    "img224": img224.detach()}}


def accumulate_and_step(state: JointTrainState, loss_fn,
                        nets: Sequence[torch.nn.Module]) -> torch.Tensor:
    """One micro-step: ``loss_fn()`` with ``nets`` in train mode, its
    backward, and under ``state.grad_accum = k`` the running mean of the
    gradients of k calls (optax's ``MultiSteps``); the optimizer steps on
    every k-th call only (StepLR set from the updates made so far).
    Returns the loss."""
    k = state.grad_accum
    micro = state.mini_step
    params = [p for g in state.opt.param_groups for p in g["params"]]
    acc = [p.grad for p in params] if micro else None
    state.opt.zero_grad(set_to_none=True)
    for net in nets:
        net.train()
    try:
        loss = loss_fn()
        loss.backward()
    finally:
        for net in nets:
            net.eval()
    # under the data layout (parallel.pjit_train_step): the global batch's
    # gradient on every rank, before it joins the running mean
    average_gradients(params)
    if acc is not None:   # acc + (g − acc)/(n + 1), optax's mean
        grads = [p.grad for p in params]
        torch._foreach_sub_(grads, acc)
        torch._foreach_div_(grads, micro + 1)
        torch._foreach_add_(grads, acc)
    if micro == k - 1:
        set_step_lr(state.opt)
        state.opt.step()
    state.mini_step = (micro + 1) % k
    return loss


def make_train_step(ema_cfg: dict | None = None, with_vis: bool = False):
    """``train_step(modules, state, batch, *, generator=None, draws=None)
    -> (state, metrics)`` for model2 and model3, updating the modules, the
    optimizer and the EMA in place.

    ``batch``: ``HR``/``SR`` ``[N, h, h, 3]`` NHWC in [−1, 1] (the
    flattened K×B batch) and ``flame_shape`` ``[N, n_shape]``.  The random
    draws come from ``generator`` (on ``modules.device``): l_sr's t, γ and
    noise and the hand-off's noise.  ``draws`` replaces some of them:
    ``"gamma"`` ``[N]`` and ``"noise"`` (NCHW) for l_sr, ``"handoff"`` the
    sampler's noise list (see ``diffusion.gaussian``).

    One step: :func:`train_losses` with the UNet and ArcFace in train mode
    (the UNet deterministic, as the JAX step's ``unet.apply`` leaves
    flax's default; its blocks checkpointed under ``train_remat``), one
    backward of ``l_sr + l_mica``, then the optimizer (StepLR set from the
    updates made so far) and the EMA.  Under ``state.grad_accum = k`` the
    gradients of k calls are averaged as optax's ``MultiSteps`` does
    (running mean) and the optimizer steps on every k-th call only; the EMA
    and ArcFace's BatchNorm statistics move on every call.  ``metrics``:
    ``l_sr``, ``l_mica``, ``loss`` (0-d tensors), and with ``with_vis``
    ``vis`` = ``{verts, gt_verts, img224}`` of the same forward, detached.
    """

    def train_step(modules: JointModules, state: JointTrainState,
                   batch: dict, *, generator: torch.Generator | None = None,
                   draws: dict | None = None
                   ) -> tuple[JointTrainState, dict]:
        out = {}

        def loss_fn():
            out.update(train_losses(modules, batch, generator=generator,
                                    draws=draws))
            return out["l_sr"] + out["l_mica"]

        loss = accumulate_and_step(state, loss_fn,
                                   (modules.unet, modules.arcface))
        if state.ema is not None and ema_cfg is not None:
            ema_update(state.ema, dict(modules.unet.named_parameters()),
                       decay=float(ema_cfg["ema_decay"]),
                       step_start_ema=int(ema_cfg["step_start_ema"]),
                       update_every=int(ema_cfg["update_ema_every"]))
        state.step += 1
        metrics = {"l_sr": out["l_sr"].detach(),
                   "l_mica": out["l_mica"].detach(), "loss": loss.detach()}
        if with_vis:
            metrics["vis"] = out["vis"]
        return state, metrics

    return train_step


def make_eval_step():
    """``eval_step(modules, batch, *, generator=None, draws=None) ->
    {"l_sr", "l_mica", "combined"}``: the validation losses without
    gradient, the networks in eval mode (ArcFace on its running
    statistics), the hand-off quantised whatever the variant (no gradient
    is taken).  ``batch``, ``generator`` and ``draws`` as the train
    step's."""

    @torch.no_grad()
    def eval_step(modules: JointModules, batch: dict, *,
                  generator: torch.Generator | None = None,
                  draws: dict | None = None) -> dict:
        draws = draws or {}
        hr = batch["HR"].to(modules.device, torch.float32)
        cond = batch["SR"].to(modules.device, torch.float32)
        l_sr = _l_sr(modules, hr, cond, generator, draws)
        final = _handoff_image(modules, cond, hr, generator,
                               draws.get("handoff"))
        _, blob = sr_to_mica_inputs(final, image_size=modules.image_size,
                                    blob_size=modules.blob_size)
        l_mica, _, _ = _l_mica(modules, blob, batch["flame_shape"])
        return {"l_sr": l_sr, "l_mica": l_mica, "combined": l_sr + l_mica}

    return eval_step


def make_val_step(use_ema: bool = False, int8: bool | None = None,
                  sample_over: Callable | None = None):
    """``val_step(modules, batch, *, generator=None, noise=None, ema=None)
    -> dict``: sampling with ``modules.val_sampler`` (``ddim`` = strided
    DDIM, ``dpm++`` = DPM-Solver++(2M) at ``ddim_steps``, the 2M SDE where
    ``dpmpp_eta`` > 0, any other name = the ancestral loop, as in the JAX
    package), then the MICA branch.  With ``use_ema`` the UNet samples with
    the EMA's parameters (``ema``, a ``diffusion.ema.EmaState``; without
    one, with its own, as the JAX package does).  ``int8``: None samples
    with the w8a8 int8 UNet iff ``quant_min_res`` > 0 (serving), False
    forces fp and True int8.  ``noise`` replays an explicit noise sequence
    (see ``diffusion.gaussian``).  Returns NHWC ``sr`` [−1, 1] and
    ``img224`` [0, 1], ``identity`` (shape code), ``verts`` and ``lmk68``;
    when the batch has ``flame_shape``, also ``l_mica``, the masked vertex
    L1 against its ground-truth vertices.

    ``sample_over``: the sampling ``fn(cond, **kw)`` laid out over a mesh
    (``parallel.pjit_sample`` or ``pjit_sample_spatial`` of it, as
    ``Predictor(mesh=)`` passes): each rank samples its rows or band of
    rows, the sample comes back whole on every rank and the MICA branch
    runs on it there, as the JAX step's replicated outputs."""

    @torch.no_grad()
    def val_step(modules: JointModules, batch: dict, *,
                 generator: torch.Generator | None = None,
                 noise: Sequence[torch.Tensor] | None = None,
                 ema: EmaState | None = None) -> dict:
        cond = batch["SR"].to(modules.device, torch.float32) \
            .permute(0, 3, 1, 2).contiguous()
        quant = (modules.unet.quant_min_res > 0 if int8 is None
                 else bool(int8))
        denoise = functools.partial(modules.unet, quant=quant)
        if use_ema and ema is not None:
            def denoise(x, t):
                return functional_call(modules.unet, ema.params, (x, t),
                                       {"quant": quant})

        def sample(cond, **kw):
            if modules.val_sampler == "ddim":
                return ddim_sample_loop(denoise, modules.sched_val, cond,
                                        num_steps=modules.ddim_steps,
                                        eta=modules.ddim_eta, **kw)
            if modules.val_sampler == "dpm++":
                return dpmpp_sample_loop(denoise, modules.sched_val, cond,
                                         num_steps=modules.ddim_steps,
                                         eta=modules.dpmpp_eta, **kw)
            return p_sample_loop(denoise, modules.sched_val, cond, **kw)

        if sample_over is not None:
            sample = sample_over(sample)
        final = sample(cond, generator=generator, noise=noise,
                       init=modules.sampler_init,
                       time_input=modules.time_input)
        sr = final.permute(0, 2, 3, 1)
        img224, blob = sr_to_mica_inputs(sr, image_size=modules.image_size,
                                         blob_size=modules.blob_size)
        with annotate("sr3d.mica"):
            verts, code = decode_mica(modules, encode_mica(modules, blob))
            lmk68 = compute_landmarks(modules.flame, verts)
        out = {"sr": sr, "img224": img224, "identity": code, "verts": verts,
               "lmk68": lmk68}
        if "flame_shape" in batch:
            gt = gt_flame_vertices(modules, batch["flame_shape"].to(
                modules.device, torch.float32))
            out["l_mica"] = masking.masked_vertex_l1(verts, gt,
                                                     modules.vertex_weights)
        return out

    return val_step
