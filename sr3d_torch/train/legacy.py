"""The alternating trainer (``--legacy``): an SR update, then a MICA update
on the SR branch's own samples, each with its own optimizer.

Counterpart of ``sr3d_tpu/train/legacy.py`` (``AlternatingTrainer``), the
reference's model1-era ``main.py`` stack.  One step:

1. an SR-only update (``train/sr_only.py``'s step) on the batch's HR/SR;
2. a sample of the batch's conditioning with the config's sampler, with the
   EMA's weights under ``train.val_use_ema``;
3. the uint8 hand-off of that sample to 112² ArcFace blobs;
4. a MICA-only update (``train/mica_only.py``'s step) on those blobs and
   the batch's FLAME shapes.

The SR branch is ``modules.unet`` (one UNet on the card, not two).  The
checkpoints are the SR-only pair ``checkpoint_sr/I{step}_E0_{gen,opt}.npz``
and ``model_mica.npz`` (meta ``global_step``), the JAX package's layouts.
Each step's draws come from a generator seeded from ``(cfg.seed + 7,
step, k)``, k = 0 the SR loss, 1 the sample; on resume the data starts
again, as the JAX trainer's does.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ..data.pipeline import flatten_actors, prefetch_to_device
from ..eval.metrics import calculate_psnr
from ..ops.image import sr_to_mica_inputs, tensor_to_uint8
from .joint import JointModules
from .mica_only import (
    init_mica_state,
    load_mica_state,
    make_mica_train_step,
    save_mica_state,
)
from .sr_only import SRModel
from .trainer import _seed

logger = logging.getLogger("sr3d_torch")


class AlternatingTrainer:
    def __init__(self, cfg, modules: JointModules):
        self.cfg = cfg
        self.modules = modules
        self.sr = SRModel(cfg, unet=modules.unet)
        self.sr_state = self.sr.init_state()
        self.mica_state = init_mica_state(modules, cfg)
        self._sr_step = self.sr.make_train_step()
        # the joint trainer's val-weights knob applies to this sampling too
        self._sr_sample = self.sr.make_sampler(
            use_ema=bool(cfg.train.get("val_use_ema", False)))
        self._mica_step = make_mica_train_step()
        self._gen = torch.Generator(device=modules.device)
        self.step = 0

    def _generator(self, *key: int) -> torch.Generator:
        return self._gen.manual_seed(_seed(int(self.cfg.seed) + 7, *key))

    def _dirs(self) -> tuple[Path, Path]:
        root = Path(self.cfg.output_dir) / (self.cfg.get("name") or
                                            "default")
        return root, root / str(self.cfg.path.checkpoint_sr)

    def save_checkpoint(self) -> None:
        root, sr_dir = self._dirs()
        self.sr.save_network(sr_dir, self.sr_state, epoch=0,
                             iter_step=self.step)
        save_mica_state(root / "model_mica.npz", self.modules,
                        self.mica_state, {"global_step": self.step})
        logger.info("legacy checkpoint saved @ step %d", self.step)

    def load_checkpoint(self) -> bool:
        """Resume both branches where their files exist; the step comes
        from ``model_mica.npz``."""
        root, sr_dir = self._dirs()
        resumed = False
        if (root / "model_mica.npz").exists():
            meta = load_mica_state(root / "model_mica.npz", self.modules,
                                   self.mica_state, ("global_step",))
            self.step = meta["global_step"]
            resumed = True
        if sr_dir.is_dir() and self.sr.latest_prefix(sr_dir):
            self.sr_state, _, _ = self.sr.load_network(
                self.sr_state, sr_dir, phase=str(self.cfg.phase))
            resumed = True
        if resumed:
            logger.info("legacy resume @ step %d", self.step)
        return resumed

    def training_step(self, batch: dict, *, draws: dict | None = None
                      ) -> dict:
        """One alternating step on ``batch`` (NHWC ``HR``/``SR`` ``[N, h,
        h, 3]``, ``flame_shape`` ``[N, n_shape]``).  ``draws`` replaces
        the generators': ``"sr"`` the SR loss's (see ``SRModel.
        make_train_step``), ``"sample"`` the sampler's noise list."""
        draws = draws or {}
        self.sr_state, sr_m = self._sr_step(
            self.sr_state, {"HR": batch["HR"], "SR": batch["SR"]},
            generator=self._generator(self.step, 0), draws=draws.get("sr"))
        sr_img = self._sr_sample(self.sr_state, batch["SR"],
                                 generator=self._generator(self.step, 1),
                                 noise=draws.get("sample"))
        _, blobs = sr_to_mica_inputs(sr_img,
                                     image_size=self.modules.image_size,
                                     blob_size=self.modules.blob_size)
        self.mica_state, mica_m = self._mica_step(
            self.modules, self.mica_state,
            {"arcface": blobs, "flame_shape": batch["flame_shape"]})
        self.step += 1
        return {"l_pix": float(sr_m["l_pix"]),
                "l_mica": float(mica_m["loss"])}

    def fit(self, loader, max_steps: int, val_batches=None,
            val_freq: int = 0, log_every: int = 10,
            checkpoint_every: int | None = None) -> list[dict]:
        """Train to ``max_steps`` over a loader of joint batches (actor-K
        ``[B, K, …]`` flattened); returns each step's losses and its
        seconds (``sec_per_it``: the step ends in a host read of its
        losses)."""
        if checkpoint_every is None:
            checkpoint_every = int(self.cfg.train.checkpoint_steps)
        it = prefetch_to_device(
            (flatten_actors(raw, ("HR", "SR", "flame_shape"))
             for raw in loader),
            size=int(self.cfg.tpu.get("prefetch_depth", 2)),
            device=self.modules.device)
        history = []
        try:
            while self.step < max_steps:
                t = time.perf_counter()
                m = self.training_step(next(it))
                m["sec_per_it"] = time.perf_counter() - t
                history.append(m)
                if log_every and self.step % log_every == 0:
                    logger.info("legacy step %d | l_pix %.4f l_mica %.4f",
                                self.step, m["l_pix"], m["l_mica"])
                if val_freq and val_batches and self.step % val_freq == 0:
                    self.validate_sr(val_batches)
                if checkpoint_every and self.step % checkpoint_every == 0:
                    self.save_checkpoint()
        finally:
            it.close()
        if checkpoint_every:
            self.save_checkpoint()
        return history

    def validate_sr(self, val_batches) -> float:
        """The mean PSNR of the SR samples against HR over ``val_batches``
        (``[B, K, …]`` joint batches flatten to ``[B·K, …]``)."""
        psnrs = []
        for i, raw in enumerate(val_batches):
            b = flatten_actors(raw, ("HR", "SR"))
            sr = self._sr_sample(self.sr_state, b["SR"],
                                 generator=self._generator(self.step, 2, i))
            sr_u8 = tensor_to_uint8(sr).cpu().numpy()
            hr_u8 = tensor_to_uint8(torch.from_numpy(b["HR"])).numpy()
            psnrs.extend(calculate_psnr(s, h) for s, h in zip(sr_u8, hr_u8))
        avg = float(np.mean(psnrs)) if psnrs else 0.0
        logger.info("legacy SR val: psnr %.3f over %d images", avg,
                    len(psnrs))
        return avg
