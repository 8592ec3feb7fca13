"""MICA-only training: the ArcFace tail and the mapping network on
ground-truth ArcFace blobs and FLAME shapes, no SR branch.

Counterpart of ``sr3d_tpu/train/mica_only.py`` (``MicaTrainState``,
``make_mica_optimizer``, ``init_mica_state``, ``make_mica_train_step``,
``make_mica_predict``, ``MicaTrainer``), itself the reference's standalone
MICA trainer:

* the optimizer is the joint's MICA half (``train.joint.
  mica_param_groups``): AdamW groups ``arcface`` and ``mapping`` with the
  staircase StepLR, ArcFace's frozen prefix in no group (always, as the
  JAX package's MICA-only labels it), and ``tpu.grad_accum`` as optax's
  ``MultiSteps``;
* a step is the masked vertex L1 of ArcFace → mapping → FLAME against the
  ground truth, ArcFace in train mode (batch statistics); it draws
  nothing;
* ``model_mica.npz`` is the JAX package's ``save_state_npz`` of ``{"meta":
  {"epoch", "global_step"}, "state": MicaTrainState(step, params
  {arcface, mapping}, arcface_stats, opt_state)}``, the optimizer in
  optax's leaf order (``train/checkpoint.py::mica_layout``), so either
  package resumes the other's; files of the layout before the epoch
  counter (meta ``global_step`` alone) load too.

The state is the joint's ``JointTrainState`` without an EMA: the
parameters and ArcFace's statistics live in the modules.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Mapping

import numpy as np
import torch

from ..data.pipeline import flatten_actors, prefetch_to_device
from ..models.arcface import frozen_prefix_mask
from ..models.flame import compute_landmarks
from ..ops.image import bgr_swap, resize
from ..utils.bridge import export_jax_params, flax_to_state_dict
from .checkpoint import (
    load_arcface_npz,
    load_leaves_into,
    load_optimizer_tree,
    mica_layout,
    optimizer_tree,
    save_leaves,
)
from .joint import (
    JointModules,
    JointTrainState,
    _l_mica,
    accumulate_and_step,
    decode_mica,
    encode_mica,
    gt_flame_vertices,
    mica_param_groups,
)

logger = logging.getLogger("sr3d_torch")

MicaTrainState = JointTrainState   # step, opt, ema (None), grad_accum


def make_mica_optimizer(cfg, modules: JointModules) -> torch.optim.AdamW:
    """AdamW over :func:`train.joint.mica_param_groups` (the frozen prefix
    always frozen), β = 0.9, 0.999, ε = 1e-8."""
    return torch.optim.AdamW(mica_param_groups(cfg, modules, freeze=True),
                             betas=(0.9, 0.999), eps=1e-8)


def init_mica_state(modules: JointModules, cfg) -> MicaTrainState:
    """Make ArcFace's tail and the mapping network trainable and start
    from their current weights: a fresh optimizer, step 0."""
    trainable = frozen_prefix_mask(modules.arcface)
    for n, p in modules.arcface.named_parameters():
        p.requires_grad_(trainable[n])
    modules.mapping.requires_grad_(True)
    return MicaTrainState(step=0, opt=make_mica_optimizer(cfg, modules),
                          ema=None,
                          grad_accum=int(cfg.tpu.get("grad_accum", 1)))


def make_mica_train_step():
    """``train_step(modules, state, batch) -> (state, {"loss"})``; batch:
    ``arcface`` ``[N, 112, 112, 3]`` NHWC blobs and ``flame_shape`` ``[N,
    n_shape]``.  One micro-step of :func:`train.joint.accumulate_and_step`
    (ArcFace in train mode); ArcFace's statistics move every call."""

    def train_step(modules: JointModules, state: MicaTrainState,
                   batch: dict) -> tuple[MicaTrainState, dict]:
        blobs = torch.as_tensor(batch["arcface"]).to(modules.device,
                                                     torch.float32)
        shape = torch.as_tensor(batch["flame_shape"])
        loss = accumulate_and_step(
            state, lambda: _l_mica(modules, blobs, shape)[0],
            (modules.arcface,))
        state.step += 1
        return state, {"loss": loss.detach()}

    return train_step


def make_mica_predict():
    """``predict(modules, state, blobs) -> (vertices, shape code, 68
    landmarks)`` of NHWC blobs, ArcFace on its running statistics, no
    gradient.  ``state`` is unused (the weights live in the modules); it
    keeps the JAX package's signature."""

    @torch.no_grad()
    def predict(modules: JointModules, state, blobs):
        blobs = torch.as_tensor(blobs).to(modules.device, torch.float32)
        verts, code = decode_mica(modules, encode_mica(modules, blobs))
        return verts, code, compute_landmarks(modules.flame, verts)

    return predict


def mica_state_tree(modules: JointModules, state: MicaTrainState,
                    meta: Mapping[str, int]) -> dict:
    """``{"meta", "state"}`` as the JAX package's ``save_state_npz``
    flattens a ``MicaTrainState`` (numpy)."""
    tmpl = export_jax_params(modules)
    return {"meta": {k: np.asarray(int(v), np.int64)
                     for k, v in meta.items()},
            "state": (np.asarray(state.step, np.int32),
                      {"arcface": tmpl["arcface"],
                       "mapping": tmpl["mapping"]},
                      tmpl["arcface_stats"],
                      optimizer_tree(mica_layout(modules), state))}


def save_mica_state(path, modules: JointModules, state: MicaTrainState,
                    meta: Mapping[str, int]) -> Path:
    return save_leaves(path, mica_state_tree(modules, state, meta))


def load_mica_state(path, modules: JointModules, state: MicaTrainState,
                    meta_keys=("epoch", "global_step"),
                    reset_optimizer: bool = False) -> dict:
    """Resume ``modules`` (ArcFace, its statistics, the mapping network)
    and ``state`` (the step and, unless ``reset_optimizer``, the
    optimizer) in place from a ``model_mica.npz`` whose meta holds
    ``meta_keys``; returns the meta.  ValueError where the leaf count or a
    shape differs."""
    got = load_leaves_into(path, mica_state_tree(
        modules, state, dict.fromkeys(meta_keys, 0)))
    step, params, stats, opt_tree = got["state"]
    arcface = flax_to_state_dict(params["arcface"])
    arcface.update(flax_to_state_dict(stats))
    modules.arcface.load_state_dict(arcface)
    modules.mapping.load_state_dict(flax_to_state_dict(params["mapping"]))
    state.step = int(step)
    if not reset_optimizer:
        load_optimizer_tree(mica_layout(modules), state, opt_tree)
    return {k: int(v) for k, v in got["meta"].items()}


class MicaTrainer:
    """The standalone MICA ``fit`` loop on ``modules``' device: steps over
    ArcFace-blob / FLAME-shape batches, a validation cadence that feeds
    ``BestModel``, train visualisations, ``model_mica.npz`` checkpoints
    and ``model_mica_{step}.npz`` snapshots, and auto-resume."""

    def __init__(self, cfg, modules: JointModules, validator=None,
                 output_dir=None):
        from .trainer import BestModel

        self.cfg = cfg
        self.modules = modules
        self.validator = validator
        self.output_dir = Path(output_dir or cfg.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.state = init_mica_state(modules, cfg)
        # a converted pretrained ArcFace, before any resume
        af = cfg.mica.model.get("arcface_pretrained_model")
        if af and str(af).endswith(".npz") and Path(af).exists():
            load_arcface_npz(af, modules)
            logger.info("[MICA] loaded pretrained arcface from %s", af)
        self._step = make_mica_train_step()
        self.global_step = 0
        self.epoch = 0
        self.best_model = BestModel(int(cfg.mica.running_average),
                                    save_fn=self._save_best)
        if validator is not None and \
                getattr(validator, "best_model", None) is None:
            validator.best_model = self.best_model

    def _meta(self) -> dict:
        return {"epoch": self.epoch, "global_step": self.global_step}

    def _save_best(self, tag: str) -> None:
        save_mica_state(self.output_dir / "best_models" / f"{tag}.npz",
                        self.modules, self.state, self._meta())

    def save_checkpoint(self) -> None:
        save_mica_state(self.output_dir / "model_mica.npz", self.modules,
                        self.state, self._meta())

    def load_checkpoint(self) -> bool:
        """Resume from ``model_mica.npz`` where it exists; a file of the
        layout before the epoch counter sets the epoch to −1, which
        ``fit`` re-derives.  ``mica.train.reset_optimizer`` starts a fresh
        optimizer over the restored weights."""
        path = self.output_dir / "model_mica.npz"
        if not path.exists():
            return False
        reset = bool(self.cfg.mica.train.reset_optimizer)
        try:
            meta = load_mica_state(path, self.modules, self.state,
                                   reset_optimizer=reset)
            self.epoch = meta["epoch"]
        except ValueError:
            meta = load_mica_state(path, self.modules, self.state,
                                   ("global_step",), reset_optimizer=reset)
            self.epoch = -1
        self.global_step = meta["global_step"]
        logger.info("mica resume @ step %d", self.global_step)
        if reset:
            self.state.opt = make_mica_optimizer(self.cfg, self.modules)
            self.state.mini_step = 0
            for g in self.state.opt.param_groups:
                for p in g["params"]:
                    p.grad = None
            logger.info("[MICA] Optimizer was reset")
        return True

    def validation_step(self) -> dict:
        if self.validator is None:
            return {}
        return self.validator.run(self.state)

    def visualize_train(self, batch: dict, n_show: int = 4) -> None:
        """Predicted meshes over the ground-truth meshes over the network's
        input blobs (BGR swapped back), tiled into
        ``train_images/train_{epoch}.jpg``."""
        from ..eval.renderer import render_meshes, visualize_grid

        faces = self.modules.flame.faces
        blobs = torch.as_tensor(batch["arcface"][:n_show]).to(
            self.modules.device, torch.float32)
        verts, _, _ = make_mica_predict()(self.modules, self.state, blobs)
        rows = [render_meshes(verts, faces, image_size=256)]
        if "flame_shape" in batch:
            gt = gt_flame_vertices(self.modules, torch.as_tensor(
                batch["flame_shape"][:n_show]).to(self.modules.device,
                                                  torch.float32))
            rows.append(render_meshes(gt, faces, image_size=256))
        imgs = ((bgr_swap(blobs) + 1.0) / 2.0).clamp(0.0, 1.0)
        rows.append(resize(imgs, 256, 256, "bilinear").to(rows[0].device))
        dst = self.output_dir / "train_images"
        dst.mkdir(parents=True, exist_ok=True)
        visualize_grid(torch.cat(rows).cpu().numpy(),
                       path=str(dst / f"train_{self.epoch}.jpg"),
                       ncol=rows[0].shape[0])

    def fit(self, loader, max_steps: int | None = None,
            val_steps: int | None = None,
            checkpoint_steps: int | None = None,
            log_steps: int | None = None, vis_steps: int | None = None,
            snapshot_steps: int | None = None, eval_hook=None,
            eval_steps: int | None = None) -> None:
        """Train to ``max_steps`` (default ``mica.train.max_steps``); each
        cadence defaults to its ``mica.train`` key and 0 turns it off.
        ``eval_hook(state)`` runs every ``eval_steps``."""
        t = self.cfg.mica.train

        def knob(v, key, default=None):
            return int(t.get(key, default) if v is None else v)

        max_steps = knob(max_steps, "max_steps")
        val_steps = knob(val_steps, "val_steps")
        checkpoint_steps = knob(checkpoint_steps, "checkpoint_steps")
        log_steps = knob(log_steps, "log_steps")
        vis_steps = knob(vis_steps, "vis_steps")
        snapshot_steps = knob(snapshot_steps, "checkpoint_epochs_steps", 0)
        eval_steps = knob(eval_steps, "eval_steps")
        if self.global_step == 0:
            self.load_checkpoint()
        try:
            steps_per_epoch = max(1, len(loader))
        except TypeError:       # an unsized iterable: no epoch counting
            steps_per_epoch = 0
        if self.epoch < 0:
            self.epoch = (self.global_step // steps_per_epoch
                          if steps_per_epoch else 0)
        it = prefetch_to_device(
            (flatten_actors(raw, ("arcface", "flame_shape"))
             for raw in loader),
            size=int(self.cfg.tpu.get("prefetch_depth", 2)),
            device=self.modules.device)
        try:
            while self.global_step < max_steps:
                batch = next(it)
                self.state, metrics = self._step(self.modules, self.state,
                                                 batch)
                self.global_step += 1
                step = self.global_step
                if steps_per_epoch and step % steps_per_epoch == 0:
                    self.epoch += 1
                if log_steps and step % log_steps == 0:
                    logger.info("mica step %d | loss %.4f", step,
                                float(metrics["loss"]))
                if vis_steps and step % vis_steps == 0:
                    try:
                        self.visualize_train(batch)
                    except Exception:
                        logger.exception("mica train vis failed")
                if val_steps and step % val_steps == 0:
                    self.validation_step()
                if eval_hook is not None and eval_steps and \
                        step % eval_steps == 0:
                    eval_hook(self.state)
                if checkpoint_steps and step % checkpoint_steps == 0:
                    self.save_checkpoint()
                if snapshot_steps and step % snapshot_steps == 0:
                    save_mica_state(
                        self.output_dir / f"model_mica_{step}.npz",
                        self.modules, self.state, {"global_step": step})
        finally:
            it.close()
        self.save_checkpoint()
