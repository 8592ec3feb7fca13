"""The joint trainer: the cadenced train and val loop over the train step.

The port's counterpart of ``sr3d_tpu/train/trainer.py``: the joint
datasets split 80/20 with a seed, batches decoded by ``BatchLoader``
threads and copied to the card by ``prefetch_to_device`` while the previous
step runs, then ``make_train_step``; logs, train visualisations,
checkpoints (written in the background, as the JAX Trainer's orbax
saves are), ``evaluate_MICA`` (the combined val loss, the best models) and
``evaluate`` (PSNR/SSIM, mesh exports) each on their own cadence; a final
checkpoint, and the wait for its write; resume from the newest
checkpoint, a step, a train-state ``.npz`` or a converted UNet.  The files
have the JAX Trainer's names and layouts
(``checkpoint/ckpt_{step:010d}.npz``, ``best_model.npz`` and ``.txt``,
``best_models/best_model_{0,1,3}.npz``, ``results/step_N/<name>/``,
``val_metrics.jsonl``, ``logs/``), so a run moves between the two
packages in either direction.

Unlike the JAX Trainer:

* the losses stay on the card between log lines: one host sync a log line;
* each step's draws come from a device generator seeded from ``(cfg.seed +
  1, global_step)`` (torch cannot reproduce JAX's key chain), and a resumed
  run continues the data where it stopped, so a run interrupted and resumed
  ends in the state of an unbroken one;
* the mesh (``tpu.mesh_shape``, the world's processes: ``torchrun``, or a
  caller that started the process group) is SPMD over
  ``torch.distributed``: every rank runs this loop on the same data and
  draws, keeps its rows of each batch (``data``), and holds its output
  channels of the widest weights where the ``model`` axis is wider than 1
  (``parallel.shard_state_dp_tp``, ``tpu.tp_min_channels``); rank 0 alone
  logs and writes files, and the others wait for each write.  Checkpoints
  hold the whole weights in the JAX layout whatever the mesh.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path

import numpy as np
import torch

from .. import data as data_lib
from ..data.pipeline import flatten_actors, prefetch_to_device, shard_batch
from ..device import resolve_device
from ..diffusion.ema import ema_init
from ..eval.export import export_prediction
from ..eval.metrics import calculate_psnr, calculate_ssim, save_img
from ..ops.image import resize, tensor_to_uint8
from ..parallel.layout import Layout, mean_metric, use
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, barrier, is_main_rank,
                             local_rows, make_mesh)
from ..parallel.steps import (data_layout, pjit_train_step,
                              shard_state_dp_tp, unsharded)
from ..utils.bridge import export_jax_params, flax_to_state_dict
from ..utils.logging import MetricsWriter
from .checkpoint import (
    CheckpointManager,
    load_arcface_npz,
    load_leaves_into,
    load_train_state,
    save_train_state,
    transfer_sr_adam_moments,
)
from .joint import (
    JointModules,
    build_joint,
    init_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    make_val_step,
)

logger = logging.getLogger("sr3d_torch")

EVAL_SEED_OFFSET = 104729   # evaluate_MICA's fixed draws: cfg.seed + this


class BestModel:
    """The reference's best-model tracker: four independent bests, each
    with its checkpoint tag — ``best_model_0`` (weighted average),
    ``best_model_1`` (raw average), ``best_model_3`` (running average over
    a window of ``n``: ``r ← r·(n−1)/n + avg/n``) and ``best_model_now``
    (the NoW mean, :meth:`now`).  The first call only sets the baselines.
    ``save_fn(tag)`` runs for each improvement; ``__call__`` returns the
    tags saved."""

    def __init__(self, n: int = 7, save_fn=None):
        self.n = int(n)
        self.save_fn = save_fn or (lambda tag: None)
        self.average = float("inf")
        self.weighted_average = float("inf")
        self.smoothed_average = float("inf")
        self.running_average = float("inf")
        self.now_mean: float | None = None
        self.counter: int | None = None

    def state_dict(self) -> dict:
        return {"average": self.average,
                "weighted_average": self.weighted_average,
                "smoothed_average": self.smoothed_average,
                "running_average": self.running_average,
                "now_mean": (float("nan") if self.now_mean is None
                             else self.now_mean),
                "counter": -1 if self.counter is None else self.counter}

    def load_state_dict(self, d: dict) -> None:
        self.average = float(d["average"])
        self.weighted_average = float(d.get("weighted_average",
                                            self.average))
        self.smoothed_average = float(d["smoothed_average"])
        self.running_average = float(d["running_average"])
        nm = float(d["now_mean"])
        self.now_mean = None if np.isnan(nm) else nm
        c = int(d["counter"])
        self.counter = None if c < 0 else c

    def __call__(self, weighted_average: float,
                 average: float | None = None) -> list[str]:
        if average is None:
            average = weighted_average
        if self.counter is None:
            self.counter = 1
            self.average = average
            self.weighted_average = weighted_average
            self.running_average = average
            return []
        saved = []
        if weighted_average < self.weighted_average:
            self.weighted_average = weighted_average
            self.save_fn("best_model_0")
            saved.append("best_model_0")
        if average < self.average:
            self.average = average
            self.save_fn("best_model_1")
            saved.append("best_model_1")
        n = self.n
        self.running_average = (self.running_average * ((n - 1) / n)
                                + average / n)
        if self.running_average < self.smoothed_average:
            self.smoothed_average = self.running_average
            self.save_fn("best_model_3")
            saved.append("best_model_3")
        self.counter += 1
        return saved

    def now(self, median: float, mean: float, std: float) -> bool:
        """The NoW-benchmark hook: a lower mean saves
        ``best_model_now``."""
        if self.now_mean is None:
            self.now_mean = mean
            return False
        if mean < self.now_mean:
            self.now_mean = mean
            self.save_fn("best_model_now")
            return True
        return False


class _NoWriter:
    """The metrics sink of the ranks other than 0: every call does
    nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _seed(*key: int) -> int:
    """A 63-bit seed from integers (``SeedSequence``)."""
    return int(np.random.SeedSequence([int(k) for k in key])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


class Trainer:
    """The joint trainer of ``cfg`` on ``device`` (None: the GPU; it raises
    where there is none)."""

    def __init__(self, cfg, modules: JointModules | None = None, *,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.mesh = make_mesh(tuple(cfg.tpu.mesh_shape),
                              tuple(cfg.tpu.mesh_axis_names))
        self._main = is_main_rank()
        self._dp = data_layout(self.mesh)
        self.device = (modules.device if modules is not None
                       else resolve_device(device))
        self.output_dir = Path(cfg.output_dir) / (cfg.name or "default")
        self.ckpt_dir = self.output_dir / cfg.path.checkpoint
        self.output_dir.mkdir(parents=True, exist_ok=True)

        self.modules = modules if modules is not None else build_joint(
            cfg, device=self.device, init_seed=int(cfg.seed))
        self.state = init_train_state(self.modules, cfg)
        self._load_mica_pretrained()
        if self.mesh.shape[MODEL_AXIS] > 1:
            shard_state_dp_tp(self.mesh, self.modules, self.state,
                              int(cfg.tpu.get("tp_min_channels", 128)))
        self.global_step = 0
        self.epoch = 0

        ema_cfg = (cfg.sr.train.ema_scheduler.to_dict()
                   if cfg.sr.train.ema_scheduler else None)
        accum = int(cfg.tpu.get("grad_accum", 1))
        if ema_cfg is not None and accum > 1:
            # the step counts micro-steps, the optimizer updates every
            # accum of them: scale the EMA cadences so that its horizon in
            # updates is the big-batch run's
            ema_cfg = dict(
                ema_cfg,
                update_ema_every=int(ema_cfg["update_ema_every"]) * accum,
                step_start_ema=int(ema_cfg["step_start_ema"]) * accum)
        vis_on = int(cfg.train.get("vis_steps", 0)) > 0
        # data parallel: this rank's rows of each batch, the gradients
        # averaged over the data axis, the metrics global-batch means
        self._train_step = pjit_train_step(
            make_train_step(ema_cfg, with_vis=vis_on), self.mesh,
            batch_argnum=2)
        # train.val_use_ema: evaluate with the EMA's UNet weights; the
        # best-model selection (evaluate_MICA) keeps the live weights
        self._val_use_ema = bool(cfg.train.get("val_use_ema", False))
        if self._val_use_ema and self.state.ema is None:
            logger.warning(
                "train.val_use_ema=True but sr.train.ema_scheduler is "
                "disabled — no EMA state exists; val uses live params")
        self._val_step = make_val_step(use_ema=self._val_use_ema, int8=False)
        self._eval_step = make_eval_step()

        keep = int(cfg.train.get("checkpoint_max_keep", 5))
        self.ckpt = CheckpointManager(
            self.ckpt_dir, max_to_keep=(keep if keep > 0 else 10 ** 9))
        self._saved_step: int | None = None
        self.best_model = BestModel(int(cfg.mica.running_average),
                                    save_fn=self._save_best)
        self.best_model_loss: float | None = None  # the plain combined best
        self._best_psnr = -float("inf")
        self._gen = torch.Generator(device=self.device)
        # seconds blocked on the loader, in the loop and in its cadenced
        # work (checkpoints, evals, vis; each also as "{kind}_s"), logged
        # as perf/* at the loop's end
        self.stats = {"loader_wait_s": 0.0, "loop_s": 0.0, "cadence_s": 0.0}

        self.metrics_writer = MetricsWriter(
            self.output_dir / cfg.path.log,
            enable_wandb=bool(cfg.enable_wandb),
            wandb_cfg=dict(cfg.wandb) if cfg.enable_wandb else None) \
            if self._main else _NoWriter()

    # ------------------------------------------------------------------
    def _written(self, write, *args):
        """``write(*args)`` on rank 0; every rank returns once it is
        done, also where it raised (a swallowed failure must not leave the
        other ranks at the barrier while rank 0 goes on to the next
        collective)."""
        try:
            return write(*args) if self._main else None
        finally:
            barrier()

    def _generator(self, *key: int) -> torch.Generator:
        """The device generator, seeded from ``(cfg.seed + 1, *key)``."""
        return self._gen.manual_seed(_seed(int(self.cfg.seed) + 1, *key))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _load_mica_pretrained(self) -> None:
        """Converted pretrained MICA weights, before any resume:
        ``mica.model.arcface_pretrained_model`` → ArcFace and its
        statistics, ``mica.pretrained_model_path`` → the mapping network
        (``utils/convert.py`` files)."""
        mcfg = self.cfg.mica
        af = mcfg.model.get("arcface_pretrained_model")
        if af and str(af).endswith(".npz") and Path(af).exists():
            load_arcface_npz(af, self.modules)
            logger.info("[MICA] loaded pretrained arcface from %s", af)
        mp = mcfg.get("pretrained_model_path")
        if mp and str(mp).endswith(".npz") and Path(mp).exists():
            tree = load_leaves_into(
                mp, export_jax_params(self.modules)["mapping"])
            self.modules.mapping.load_state_dict(flax_to_state_dict(tree))
            logger.info("[MICA] loaded pretrained mapping from %s", mp)

    def _reset_optimizer(self) -> None:
        """A fresh optimizer on the current parameters (no moments, counts
        0, no accumulated gradient)."""
        self.state.opt = make_optimizer(self.cfg, self.modules)
        self.state.mini_step = 0
        for net in (self.modules.unet, self.modules.arcface,
                    self.modules.mapping):
            for p in net.parameters():
                p.grad = None

    def load_checkpoint(self, path_or_step=None) -> bool:
        """Resume from the newest checkpoint (None), a step number, or a
        ``.npz`` file: a train state (the port's or the JAX package's), or
        else a converted reference UNet (the SR branch only).  Returns
        False where there is nothing to resume.  Under a model axis the
        whole file is read, then split.  A checkpoint still being written
        is waited for first, on every rank."""
        self.wait_checkpoints()
        with unsharded(self.modules, self.state):
            return self._load_checkpoint(path_or_step)

    def _load_checkpoint(self, path_or_step) -> bool:
        t0 = time.perf_counter()
        reset = bool(self.cfg.train.reset_optimizer)
        if isinstance(path_or_step, str) and path_or_step.endswith(".npz"):
            path = Path(path_or_step)
            if not path.exists():
                raise FileNotFoundError(
                    f"-ckt {path_or_step!r}: file does not exist")
            try:
                meta = load_train_state(path, self.modules, self.state,
                                        reset_optimizer=reset)
            except (ValueError, KeyError):
                # not a train state: a converted reference UNet (-ckt)
                return self.load_sr_pretrained(path_or_step)
        else:
            if isinstance(path_or_step, str):
                if not path_or_step.isdigit():
                    # an explicit checkpoint never falls back to the newest
                    raise FileNotFoundError(
                        f"-ckt {path_or_step!r}: not a step number and not "
                        f"an existing .npz checkpoint")
                path_or_step = int(path_or_step)
            step = (path_or_step if path_or_step is not None
                    else self.ckpt.latest_step())
            if step is None:
                return False
            path = self.ckpt_dir / f"ckpt_{step:010d}.npz"
            if not path.exists():
                return False
            meta = self.ckpt.restore(step, self.modules, self.state,
                                     reset_optimizer=reset)
        self.global_step = int(meta["global_step"])
        self.epoch = int(meta["epoch"])
        self._saved_step = None
        self._log_io("ckpt_read", time.perf_counter() - t0, path)
        logger.info("resumed from step %d", self.global_step)
        if reset:
            self._reset_optimizer()
            logger.info("[TRAINER] Optimizer was reset")
        return True

    def _log_io(self, what: str, seconds: float, path: Path) -> None:
        self.metrics_writer.add_scalars(
            {f"{what}_s": seconds,
             f"{what}_mib": path.stat().st_size / 2 ** 20},
            self.global_step, prefix="perf/")

    def save_checkpoint(self) -> None:
        """Save ``checkpoint/ckpt_{step:010d}.npz`` in the background, as
        the JAX Trainer does: the state is copied inside ``unsharded``
        (whole weights, before the split reassigns them), rank 0's writer
        thread writes the file, and every rank goes on once the copy is
        taken.  Logs the seconds it blocked (``perf/ckpt_snapshot_s``; of
        them ``perf/ckpt_wait_s`` on the write before it)."""
        t0 = time.perf_counter()
        with unsharded(self.modules, self.state):
            self._written(self.ckpt.save, self.global_step, self.modules,
                          self.state, self._meta())
        self._sync()
        self._saved_step = self.global_step
        self.metrics_writer.add_scalars(
            {"ckpt_snapshot_s": time.perf_counter() - t0,
             "ckpt_wait_s": self.ckpt.last_wait_s},
            self.global_step, prefix="perf/")
        self._log_writes()

    def wait_checkpoints(self) -> None:
        """Every rank returns once rank 0's checkpoint write in flight
        has finished (its failure raised on rank 0)."""
        self._written(self.ckpt.wait)
        self._log_writes()

    def _log_writes(self) -> None:
        """The finished background writes' ``perf/ckpt_write_s`` and
        ``perf/ckpt_write_mib`` (and their wandb registration), at each
        one's step; a failed write raises."""
        for w in self.ckpt.poll():
            self.metrics_writer.add_scalars(
                {"ckpt_write_s": w.seconds,
                 "ckpt_write_mib": w.nbytes / 2 ** 20},
                w.step, prefix="perf/")
            if self.cfg.get("log_wandb_ckpt"):
                self.metrics_writer.log_checkpoint([str(w.path)], w.step)

    def load_sr_pretrained(self, prefix: str) -> bool:
        """Warm-start the SR branch from an SR-only checkpoint pair
        (``{prefix}_gen.npz``, and in the train phase ``{prefix}_opt.npz``'s
        counters and Adam moments) or from a converted reference UNet
        ``.npz``; the EMA restarts from the loaded weights."""
        with unsharded(self.modules, self.state):
            return self._load_sr_pretrained(prefix)

    def _load_sr_pretrained(self, prefix: str) -> bool:
        gen_path = f"{prefix}_gen.npz"
        sr_tmpl = export_jax_params(self.modules)["sr"]
        if Path(gen_path).exists():
            self.modules.unet.load_state_dict(flax_to_state_dict(
                load_leaves_into(gen_path, sr_tmpl)))
            opt_path = f"{prefix}_opt.npz"
            if Path(opt_path).exists() and self.cfg.phase == "train":
                with np.load(opt_path) as data:
                    self.global_step = int(data["iter"])
                    self.epoch = int(data["epoch"])
                if transfer_sr_adam_moments(self.modules, self.state,
                                            opt_path):
                    logger.info("[SR] transferred Adam moments from %s",
                                opt_path)
                else:
                    logger.info("[SR] %s does not match a plain-Adam SR "
                                "state; moments start fresh", opt_path)
                logger.info("[SR] resumed counters from %s (step %d)",
                            opt_path, self.global_step)
        elif prefix.endswith(".npz") and Path(prefix).exists():
            self.modules.unet.load_state_dict(flax_to_state_dict(
                load_leaves_into(prefix, sr_tmpl)))
        else:
            logger.info("[SR] no pretrained model found at %s", prefix)
            return False
        if self.state.ema is not None:
            # the EMA still holds the random init: restart it from the
            # loaded weights, keeping its step
            step = self.state.ema.step
            self.state.ema = ema_init(dict(
                self.modules.unet.named_parameters()))
            self.state.ema.step = step
        logger.info("[SR] warm-started SR branch from %s", prefix)
        return True

    # ------------------------------------------------------------------
    @staticmethod
    def prepare_batch(raw: dict) -> dict:
        """Flatten actor-K batches to ``[B·K, …]`` float32 (NHWC) and keep
        the step's inputs."""
        return flatten_actors(raw, [k for k in ("HR", "SR", "LR",
                                                "flame_shape", "arcface",
                                                "image") if k in raw])

    @classmethod
    def step_batch(cls, raw: dict) -> dict:
        batch = cls.prepare_batch(raw)
        return {k: batch[k] for k in ("HR", "SR", "flame_shape")
                if k in batch}

    def prepare_data(self) -> None:
        cfg = self.cfg
        if cfg.phase == "train":
            ds = data_lib.build_train(cfg)
            # the 80/20 seeded split; the 20% feeds evaluate_MICA
            train_ds, mica_val_ds = data_lib.random_split(
                ds, 0.8, seed=int(cfg.seed))
            if len(mica_val_ds) == 0 or len(train_ds) == 0:
                train_ds, mica_val_ds = ds, ds   # tiny datasets
            if len(train_ds) < int(cfg.mica.datasets.batch_size):
                raise ValueError(
                    f"train split has {len(train_ds)} actors < batch_size "
                    f"{cfg.mica.datasets.batch_size}; drop_last would yield "
                    f"zero batches")
            self.train_loader = data_lib.BatchLoader(
                train_ds, batch_size=int(cfg.mica.datasets.batch_size),
                shuffle=True, seed=int(cfg.seed),
                num_workers=int(cfg.mica.datasets.num_workers))
            bs_val = min(int(cfg.mica.datasets.batch_size), len(mica_val_ds))
            self.mica_val_loader = data_lib.BatchLoader(
                mica_val_ds, batch_size=bs_val, shuffle=False,
                num_workers=0)
        v = cfg.sr.datasets.val
        if str(v.get("datatype", "img")) == "srpk":
            from ..data.srpk import SrpkImageDataset

            val = SrpkImageDataset(v.dataroot, int(v.l_resolution),
                                   int(v.r_resolution), need_LR=True)
        else:
            val = data_lib.LRHRDataset(
                dataroot=v.dataroot, l_resolution=int(v.l_resolution),
                r_resolution=int(v.r_resolution), split="val",
                data_len=int(v.data_len), need_LR=True,
                datatype=str(v.get("datatype", "img")))
        self.val_loader = data_lib.BatchLoader(
            val, batch_size=1, shuffle=False, num_workers=0, drop_last=False)

    # ------------------------------------------------------------------
    def training_step(self, max_steps: int | None = None) -> None:
        cfg = self.cfg
        n_iter = int(cfg.sr.train.n_iter) + int(cfg.mica.train.max_steps)
        if max_steps is not None:
            n_iter = min(n_iter, self.global_step + max_steps)
        log_steps = int(cfg.train.log_steps)
        ckpt_steps = int(cfg.train.checkpoint_steps)
        eval_steps = int(cfg.train.eval_steps)
        mica_eval_steps = int(cfg.mica.train.eval_steps)
        vis_steps = int(cfg.train.get("vis_steps", 0))

        dp = self.mesh.shape[DATA_AXIS]

        def batches():
            for raw in self.train_loader:
                batch = self.step_batch(raw)
                n = next(iter(batch.values())).shape[0]
                if n % dp:
                    raise ValueError(
                        f"flattened batch {n} not divisible by the mesh's "
                        f"data axis ({dp}); adjust mica.datasets.batch_size"
                        f"/K or tpu.mesh_shape")
                yield batch

        # continue the data where the run stopped
        self.train_loader.skip(self.global_step)
        it = prefetch_to_device(batches(), size=int(cfg.tpu.prefetch_depth),
                                device=self.device)
        st = self.stats
        window: list[dict] = []
        steps_per_epoch = max(1, len(self.train_loader))
        t_loop = t_log = time.perf_counter()
        cadence_at_log = st["cadence_s"]

        def cadenced(kind, fn, *args):
            t = time.perf_counter()
            fn(*args)
            self._sync()
            dt = time.perf_counter() - t
            st["cadence_s"] += dt
            st[f"{kind}_s"] = st.get(f"{kind}_s", 0.0) + dt

        try:
            while self.global_step < n_iter:
                t = time.perf_counter()
                batch = next(it)
                st["loader_wait_s"] += time.perf_counter() - t
                self.state, metrics = self._train_step(
                    self.modules, self.state, batch,
                    generator=self._generator(self.global_step))
                vis = metrics.pop("vis", None)
                self.global_step += 1
                if self.global_step % steps_per_epoch == 0:
                    self.epoch += 1   # one pass over the loader
                window.append(metrics)

                if log_steps and self.global_step % log_steps == 0:
                    keys = list(window[0])
                    # the window's losses leave the card once, here
                    means = torch.stack([torch.stack([w[k] for k in keys])
                                         for w in window]).double() \
                        .mean(0).tolist()
                    m = dict(zip(keys, means))
                    window.clear()
                    now = time.perf_counter()
                    dt = (now - t_log - (st["cadence_s"] - cadence_at_log)
                          ) / log_steps
                    t_log, cadence_at_log = now, st["cadence_s"]
                    logger.info(
                        "step %d | loss %.4f (sr %.4f mica %.4f) | %.2f s/it",
                        self.global_step, m["loss"], m["l_sr"], m["l_mica"],
                        dt)
                    self.metrics_writer.add_scalars(m, self.global_step,
                                                    prefix="train/")
                    self.metrics_writer.add_scalar(
                        "train/sec_per_it", dt, self.global_step)
                    self._log_writes()
                if vis is not None and vis_steps \
                        and self.global_step % vis_steps == 0:
                    try:
                        cadenced("vis", self._written, self.visualize_train,
                                 vis)
                    except Exception:
                        logger.exception("train visualization failed")
                if ckpt_steps and self.global_step % ckpt_steps == 0:
                    cadenced("checkpoint", self.save_checkpoint)
                if mica_eval_steps \
                        and self.global_step % mica_eval_steps == 0:
                    cadenced("evaluate_mica", self.evaluate_MICA)
                if eval_steps and self.global_step % eval_steps == 0:
                    cadenced("evaluate", self.evaluate)
        finally:
            it.close()
            self._sync()
            st["loop_s"] += time.perf_counter() - t_loop
        if self._saved_step != self.global_step:
            self.save_checkpoint()
        self.wait_checkpoints()   # drain the background write, as JAX's
        self.metrics_writer.add_scalars(
            {k: v for k, v in st.items() if k.endswith("_s")},
            self.global_step, prefix="perf/")

    def visualize_train(self, vis: dict, n_show: int = 4) -> None:
        """The train step's own forward at the ``train.vis_steps`` cadence:
        up to ``n_show`` predicted meshes over their ground-truth meshes
        over the network's input images, tiled into
        ``train_images/{epoch}_{step}/train_3d.jpg`` and logged."""
        from ..eval.renderer import render_meshes, visualize_grid

        faces = self.modules.flame.faces
        pred = render_meshes(vis["verts"][:n_show], faces, image_size=256)
        gt = render_meshes(vis["gt_verts"][:n_show], faces, image_size=256)
        imgs = resize(vis["img224"][:n_show].clamp(0.0, 1.0), 256, 256,
                      "bilinear")
        rows = torch.cat([pred, gt, imgs.to(pred.device)]).cpu().numpy()
        dst = (self.output_dir / "train_images"
               / f"{self.epoch}_{self.global_step}")
        dst.mkdir(parents=True, exist_ok=True)
        grid = visualize_grid(rows, path=str(dst / "train_3d.jpg"),
                              ncol=pred.shape[0])
        self.metrics_writer.add_image("train/train_3d", grid,
                                      self.global_step)

    def _meta(self) -> dict:
        return {"global_step": self.global_step, "epoch": self.epoch}

    def _save_best(self, tag: str) -> None:
        """A named best-model snapshot, ``best_models/{tag}.npz``."""
        if not bool(self.cfg.train.get("best_snapshots", True)):
            logger.info("[BEST] %s @ step %d (snapshot writes disabled)",
                        tag, self.global_step)
            return
        with unsharded(self.modules, self.state):
            self._written(save_train_state,
                          self.output_dir / "best_models" / f"{tag}.npz",
                          self.modules, self.state, self._meta())
        logger.info("[BEST] saved %s @ step %d", tag, self.global_step)

    def evaluate_MICA(self) -> dict:
        """The combined val loss over the held-out 20% of the joint data,
        without gradient, from fixed draws (``cfg.seed + 104729``): the
        plain best → ``best_model.npz`` + ``best_model.txt``; the tracker →
        ``best_models/best_model_{0,1,3}.npz``."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(
            int(cfg.seed) + EVAL_SEED_OFFSET)
        dp = self.mesh.shape[DATA_AXIS]
        acc = []
        for raw in self.mica_val_loader.epoch():
            batch = shard_batch(self.step_batch(raw), self.device)
            n = next(iter(batch.values())).shape[0]
            # full batches over the data axis, as the train step's; a
            # final batch it does not divide, whole on every rank
            lay = self._dp if n % dp == 0 else Layout()
            with use(lay):
                m = self._eval_step(self.modules,
                                    local_rows(batch, lay.batch),
                                    generator=gen)
                acc.append(torch.stack([mean_metric(m["l_sr"]),
                                        mean_metric(m["l_mica"])]))
        if not acc:
            return {}
        l_sr, l_mica = torch.stack(acc).double().mean(0).tolist()
        combined = l_sr + l_mica
        logger.info("evaluate_MICA @%d: l_sr %.4f l_mica %.4f combined %.4f",
                    self.global_step, l_sr, l_mica, combined)
        self.metrics_writer.add_scalars(
            {"l_sr": l_sr, "l_mica": l_mica, "combined": combined},
            self.global_step, prefix="val_mica/")
        if self.best_model_loss is None or combined < self.best_model_loss:
            self.best_model_loss = combined
            if bool(cfg.train.get("best_snapshots", True)):
                with unsharded(self.modules, self.state):
                    self._written(self._write_best)
                logger.info("New best model saved.")
        self.best_model(combined, l_mica)
        return {"l_sr": l_sr, "l_mica": l_mica, "combined": combined}

    def _write_best(self) -> None:
        save_train_state(self.output_dir / "best_model.npz", self.modules,
                         self.state, self._meta())
        (self.output_dir / "best_model.txt").write_text(
            "<epoch:{:3d}, iter:{:8,d}, loss: {:4f}> ".format(
                self.epoch, self.global_step, self.best_model_loss))

    def _append_val_metrics(self, res: dict) -> None:
        with (self.output_dir / "val_metrics.jsonl").open("a") as f:
            f.write(json.dumps(res) + "\n")

    def evaluate(self) -> dict:
        """The val loop: ``cfg.sample`` samples a face, PSNR/SSIM of the SR
        output against HR, and for the first ``train.val_n_img`` faces the
        mesh and landmark exports and ``{name}_{sr,hr,inf,lr}.png`` under
        ``results/step_N/<name>/``."""
        cfg = self.cfg
        n_samples = int(cfg.sample)
        psnrs, ssims = [], []
        last_verts = None
        faces = self.modules.flame.faces.cpu().numpy()
        result_dir = self.output_dir / "results" / f"step_{self.global_step}"
        ema = self.state.ema if self._val_use_ema else None
        t0 = time.perf_counter()
        n_faces = 0

        def u8(x) -> np.ndarray:
            return tensor_to_uint8(torch.as_tensor(x)).cpu().numpy() \
                .astype(np.uint8)[0]

        for bi, raw in enumerate(self.val_loader.epoch()):
            hr_u8, inf_u8 = u8(raw["HR"]), u8(raw["SR"])
            cond = shard_batch({"SR": np.asarray(raw["SR"], np.float32)},
                               self.device)
            for k in range(n_samples):
                out = self._val_step(
                    self.modules, cond,
                    generator=self._generator(self.global_step, bi, k),
                    ema=ema)
                sr_u8 = u8(out["sr"])
                n_faces += 1
                psnrs.append(calculate_psnr(sr_u8, hr_u8))
                ssims.append(calculate_ssim(sr_u8, hr_u8))
                if cfg.get("log_eval"):
                    self.metrics_writer.log_eval_data(
                        inf_u8, sr_u8, hr_u8, psnrs[-1], ssims[-1])
                last_verts = out["verts"]
                if bi < int(cfg.train.val_n_img) and self._main:
                    base = Path(str(raw.get("path_sr",
                                            [f"{bi:04d}"])[0])).stem
                    name = (base if n_samples == 1 else
                            f"{base}_{str(k).zfill(len(str(n_samples)))}")
                    dst = result_dir / name
                    export_prediction(
                        dst, out["verts"][0].cpu().numpy(), faces,
                        out["identity"][0].cpu().numpy(),
                        out["lmk68"][0].cpu().numpy())
                    save_img(sr_u8, str(dst / f"{name}_sr.png"))
                    save_img(hr_u8, str(dst / f"{name}_hr.png"))
                    save_img(inf_u8, str(dst / f"{name}_inf.png"))
                    if "LR" in raw:
                        save_img(u8(raw["LR"]), str(dst / f"{name}_lr.png"))
        if n_faces:
            self.metrics_writer.add_scalar(
                "perf/val_s_per_face", (time.perf_counter() - t0) / n_faces,
                self.global_step)
        if cfg.get("log_eval"):
            self.metrics_writer.log_eval_table(self.global_step)
        res = {"psnr": float(np.mean(psnrs)) if psnrs else 0.0,
               "ssim": float(np.mean(ssims)) if ssims else 0.0,
               "step": self.global_step}
        logger.info("val @%d: psnr %.3f ssim %.4f", self.global_step,
                    res["psnr"], res["ssim"])
        self._written(self._append_val_metrics, res)
        self.metrics_writer.add_scalar("val/psnr", res["psnr"],
                                       self.global_step)
        self.metrics_writer.add_scalar("val/ssim", res["ssim"],
                                       self.global_step)
        if last_verts is not None and self._main:
            try:
                from ..eval.renderer import render_meshes, visualize_grid

                imgs = render_meshes(last_verts[:4], self.modules.flame.faces,
                                     image_size=256)
                self.metrics_writer.add_image(
                    "val/pred_meshes", visualize_grid(imgs.cpu().numpy()),
                    self.global_step)
            except Exception:
                logger.exception("mesh visualization failed")
        # PSNR is an extra signal; the best model is keyed on the combined
        # val loss (evaluate_MICA)
        if res["psnr"] > self._best_psnr:
            self._best_psnr = res["psnr"]
            self.metrics_writer.add_scalar("val/best_psnr", res["psnr"],
                                           self.global_step)
        return res

    def fit(self, max_steps: int | None = None) -> None:
        self.prepare_data()
        if self.cfg.checkpoint:
            loaded = self.load_checkpoint(str(self.cfg.checkpoint))
        else:
            loaded = self.load_checkpoint()
        if not loaded and self.cfg.sr.get("pretrained_model_path"):
            # staged workflow: SR pretraining → joint fine-tuning
            self.load_sr_pretrained(str(self.cfg.sr.pretrained_model_path))
        if self.cfg.phase == "train":
            self.training_step(max_steps)
        else:
            self.evaluate()
