"""The training CLI, flag for flag the JAX package's
(``sr3d_tpu/cli/main.py``, itself the reference's ``main_temp.py``)::

    python -m sr3d_torch.cli.main -p train -c configs/<config>.yml
    python -m sr3d_torch.cli.main -p val -c configs/<config>.yml \\
        -ckt output/<name>/checkpoint/ckpt_0000001000.npz

    python -m sr3d_torch.cli.main --sr-only -c configs/<config>.yml
    python -m sr3d_torch.cli.main --legacy -c configs/<config>.yml

``-p train`` and ``-p val`` run the joint ``train.trainer.Trainer`` on the
GPU.  ``--sr-only`` pretrains the SR branch alone (``run_sr_only``: the
LR/HR data of ``sr.datasets.train``, the ``I{iter}_E{epoch}_{gen,opt}.npz``
pairs under ``checkpoint_sr/`` that the joint Trainer warm-starts from
through ``sr.pretrained_model_path``); ``--legacy`` runs the alternating
SR/MICA trainer (``train/legacy.py``) over the joint data.  ``--max-steps``
caps the steps of this call; ``--debug`` (or ``debug`` in the experiment
name) shrinks the run as the reference's debug mode does; ``--profile DIR``
writes a ``torch.profiler`` trace.  From Python: ``main(argv,
device="cpu")``.

Data and tensor parallel training (``tpu.mesh_shape``, e.g. ``[2, 1]`` or
``[1, 2]``)::

    torchrun --nproc_per_node=2 -m sr3d_torch.cli.main -p train -c <cfg.yml>
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import random
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..config import get_cfg_defaults, update_cfg
from ..data.pipeline import prefetch_to_device
from ..device import resolve_device
from ..parallel.mesh import init_distributed, is_main_rank


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="sr3d_torch joint trainer")
    parser.add_argument("--cfg", "-c", type=str, default=None,
                        help="experiment YAML overlay")
    parser.add_argument("--phase", "-p", type=str, default="train",
                        choices=["train", "val"])
    parser.add_argument("--sample", "-s", type=int, default=1,
                        help="samples per val input")
    parser.add_argument("--checkpoint", "-ckt", type=str, default=None)
    parser.add_argument("--model", "-m", type=str, default=None,
                        choices=["model2", "model3"])
    parser.add_argument("--max-steps", type=int, default=None,
                        help="cap on train steps this invocation")
    parser.add_argument("--debug", action="store_true",
                        help="shrink timesteps/data for a fast smoke run "
                             "(the reference's debug mode)")
    parser.add_argument("--legacy", action="store_true",
                        help="alternating SR/MICA trainer (the reference's "
                             "main.py stack) instead of the joint trainer")
    parser.add_argument("--sr-only", action="store_true",
                        help="SR-diffusion pretraining only: trains on the "
                             "LRHR data and writes I{iter}_E{epoch}_{gen,opt}"
                             ".npz pairs the joint trainer warm-starts from")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="wrap the run in a torch.profiler trace "
                             "written to DIR")
    args = parser.parse_args(argv)

    cfg = get_cfg_defaults()
    if args.cfg:
        cfg = update_cfg(cfg, args.cfg)
        cfg.cfg_file = args.cfg
        if not cfg.get("name"):
            cfg.name = Path(args.cfg).stem
    cfg.phase = args.phase
    cfg.sample = args.sample
    if args.checkpoint:
        cfg.checkpoint = args.checkpoint
    if args.model:
        cfg.model = args.model
    # the reference's debug mode triggers on 'debug' in the experiment
    # NAME; --debug is the explicit spelling of the same
    if args.debug or "debug" in (cfg.get("name") or ""):
        cfg.debug = True
        cfg.train.eval_steps = 2
        cfg.mica.train.eval_steps = 2
        cfg.train.log_steps = 2
        cfg.train.checkpoint_steps = 3
        cfg.sr.datasets.train.batch_size = 2
        for ph in ("train", "val"):
            cfg.sr.model.beta_schedule[ph].n_timestep = 10
        cfg.sr.datasets.train.data_len = 6
        cfg.sr.datasets.val.data_len = 3
        if args.debug and "debug" not in (cfg.get("name") or ""):
            cfg.name = (cfg.get("name") or "run") + "_debug"
    return cfg, args


def sr_train_dataset(cfg):
    """``sr.datasets.train``: a packed store (``datatype: srpk``), or
    ``LRHRDataset`` over image dirs (``img``) or a reference LMDB
    (``lmdb``); any other datatype raises."""
    from .. import data as data_lib

    tr = cfg.sr.datasets.train
    kw = dict(data_len=int(tr.get("data_len", -1)),
              use_flip=bool(tr.get("use_flip", True)), seed=int(cfg.seed))
    if str(tr.get("datatype", "img")) == "srpk":
        from ..data.srpk import SrpkImageDataset

        return SrpkImageDataset(tr.dataroot, int(tr.l_resolution),
                                int(tr.r_resolution), split="train", **kw)
    return data_lib.LRHRDataset(
        dataroot=tr.dataroot, l_resolution=int(tr.l_resolution),
        r_resolution=int(tr.r_resolution), split="train",
        datatype=str(tr.get("datatype", "img")), **kw)


def run_sr_only(cfg, max_steps: int | None = None, *,
                device: str | torch.device | None = None) -> dict:
    """SR-only pretraining: LR/HR batches of ``sr.datasets.train``
    through ``SRModel``'s step; ``-ckt`` (a prefix or a directory; never a
    silent fall-back) or else auto-resume from ``checkpoint_sr/``; a pair
    every ``train.checkpoint_steps`` and at the end; ``train/l_pix``,
    ``train/sec_per_it`` and the pairs' write and read times in
    ``logs/metrics.jsonl``.  Each step's draws come from a generator
    seeded from ``(cfg.seed + 3, step)``; on resume the data starts again,
    as the JAX package's does.  Returns ``{"step", "epoch", "prefix"}``."""
    from .. import data as data_lib
    from ..train.sr_only import SRModel
    from ..train.trainer import _seed
    from ..utils.logging import MetricsWriter

    logger = logging.getLogger("sr3d_torch")
    m = SRModel(cfg, device=device)
    state = m.init_state()
    out = Path(cfg.output_dir) / (cfg.name or "default")
    ckpt_dir = out / str(cfg.path.checkpoint_sr)
    writer = MetricsWriter(out / cfg.path.log, enable_tensorboard=False)
    begin_step = epoch = 0
    t0 = time.perf_counter()
    if cfg.checkpoint:
        state, begin_step, epoch = m.load_network(
            state, str(cfg.checkpoint), phase=str(cfg.phase))
        logger.info("[SR] loaded -ckt %s @ step %d", cfg.checkpoint,
                    begin_step)
    elif ckpt_dir.is_dir() and m.latest_prefix(ckpt_dir):
        state, begin_step, epoch = m.load_network(state, ckpt_dir,
                                                  phase=str(cfg.phase))
        logger.info("[SR] resumed @ step %d", begin_step)
    if begin_step or cfg.checkpoint:
        writer.add_scalar("perf/ckpt_read_s", time.perf_counter() - t0,
                          begin_step)

    tr = cfg.sr.datasets.train
    loader = data_lib.BatchLoader(
        sr_train_dataset(cfg), batch_size=int(tr.batch_size), shuffle=True,
        seed=int(cfg.seed), num_workers=int(tr.get("num_workers", 0)))
    step_fn = m.make_train_step()
    gen = torch.Generator(device=m.device)
    n_iter = int(cfg.sr.train.n_iter)
    if max_steps is not None:
        n_iter = min(n_iter, begin_step + max_steps)
    ckpt_every = int(cfg.train.checkpoint_steps)
    log_every = int(cfg.train.log_steps)
    steps_per_epoch = max(1, len(loader))
    gstep = begin_step
    saved: dict = {}

    def save():
        t = time.perf_counter()
        p = m.save_network(ckpt_dir, state, epoch, gstep)
        writer.add_scalars(
            {"ckpt_write_s": time.perf_counter() - t,
             "ckpt_write_mib": sum(Path(f"{p}_{k}.npz").stat().st_size
                                   for k in ("gen", "opt")) / 2 ** 20},
            gstep, prefix="perf/")
        saved.update(step=gstep, prefix=p)

    it = prefetch_to_device(
        ({k: np.asarray(raw[k], np.float32) for k in ("HR", "SR")}
         for raw in loader),
        size=int(cfg.tpu.get("prefetch_depth", 2)), device=m.device)
    window: list[torch.Tensor] = []
    t_log = time.perf_counter()
    try:
        while gstep < n_iter:
            state, metrics = step_fn(
                state, next(it),
                generator=gen.manual_seed(_seed(int(cfg.seed) + 3, gstep)))
            window.append(metrics["l_pix"])
            gstep += 1
            if gstep % steps_per_epoch == 0:
                epoch += 1   # one pass over the data
            if log_every and gstep % log_every == 0:
                # the window's losses leave the card once, here
                l_pix = float(torch.stack(window).double().mean())
                writer.add_scalars(
                    {"l_pix": l_pix,
                     "sec_per_it": (time.perf_counter() - t_log)
                     / len(window)}, gstep, prefix="train/")
                logger.info("sr step %d | l_pix %.5f", gstep, l_pix)
                window.clear()
            if ckpt_every and gstep % ckpt_every == 0:
                save()
            if not window:
                t_log = time.perf_counter()
    finally:
        it.close()
    if saved.get("step") != gstep:
        save()
    writer.close()
    logger.info("[SR] done @ step %d -> %s", gstep, ckpt_dir)
    return {"step": gstep, "epoch": epoch, "prefix": saved["prefix"]}


def run_legacy(cfg, max_steps: int | None = None, *,
               device: str | torch.device | None = None) -> list[dict]:
    """The alternating trainer over the joint data (``mica.datasets``),
    auto-resumed, to ``--max-steps`` more steps (default
    ``mica.train.max_steps``); each step's ``train/l_pix``,
    ``train/l_mica`` and ``train/sec_per_it`` in ``logs/metrics.jsonl``.
    Returns each step's losses."""
    from .. import data as data_lib
    from ..train.joint import build_joint
    from ..train.legacy import AlternatingTrainer
    from ..utils.logging import MetricsWriter

    modules = build_joint(cfg, device=device, init_seed=int(cfg.seed))
    trainer = AlternatingTrainer(cfg, modules)
    trainer.load_checkpoint()
    loader = data_lib.BatchLoader(
        data_lib.build_train(cfg),
        batch_size=int(cfg.mica.datasets.batch_size), shuffle=True,
        seed=int(cfg.seed),
        num_workers=int(cfg.mica.datasets.get("num_workers", 0)))
    out = Path(cfg.output_dir) / (cfg.name or "default")
    writer = MetricsWriter(out / cfg.path.log, enable_tensorboard=False)
    end = (trainer.step + max_steps if max_steps
           else int(cfg.mica.train.max_steps))
    begin = trainer.step
    history = trainer.fit(loader, max_steps=end,
                          log_every=int(cfg.train.log_steps))
    for i, h in enumerate(history):
        writer.add_scalars(h, begin + i + 1, prefix="train/")
    writer.close()
    return history


def main(argv=None, *, device: str | torch.device | None = None) -> int:
    """Run the CLI on ``device`` (None: the GPU; it raises where there is
    none).  Under ``torchrun`` it starts the process group (NCCL, one card a
    rank; a group the caller started is used as it is), and the joint
    Trainer trains over ``tpu.mesh_shape``; the branch trainers run on one
    device, as the JAX package's do."""
    cfg, args = parse_args(argv)
    _, n_ranks = init_distributed()
    device = resolve_device(device)
    if n_ranks > 1 and (args.sr_only or args.legacy):
        raise ValueError("--sr-only and --legacy train on one device; run "
                         "them as one process")

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    random.seed(int(cfg.seed))
    np.random.seed(int(cfg.seed))

    out = Path(cfg.output_dir) / (cfg.name or "default")
    log_dir = out / cfg.path.log
    log_dir.mkdir(parents=True, exist_ok=True)
    # the raw experiment YAML → logs/config.yml, the merged tree →
    # logs/full_config.yaml
    if is_main_rank():
        if cfg.get("cfg_file") and Path(str(cfg.cfg_file)).exists():
            shutil.copy(str(cfg.cfg_file), str(log_dir / "config.yml"))
        cfg.dump(str(log_dir / "full_config.yaml"))

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from ..utils.profiling import trace
        profile_ctx = trace(args.profile)

    with profile_ctx:
        if args.sr_only:
            run_sr_only(cfg, max_steps=args.max_steps, device=device)
        elif args.legacy:
            run_legacy(cfg, max_steps=args.max_steps, device=device)
        else:
            from ..train.trainer import Trainer

            trainer = Trainer(cfg, device=device)
            trainer.fit(max_steps=args.max_steps)
            trainer.metrics_writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
