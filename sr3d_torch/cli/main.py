"""The training CLI, flag for flag the JAX package's
(``sr3d_tpu/cli/main.py``, itself the reference's ``main_temp.py``)::

    python -m sr3d_torch.cli.main -p train -c configs/<config>.yml
    python -m sr3d_torch.cli.main -p val -c configs/<config>.yml \\
        -ckt output/<name>/checkpoint/ckpt_0000001000.npz

``-p train`` and ``-p val`` run the joint ``train.trainer.Trainer`` on the
GPU; ``--max-steps`` caps the steps of this call; ``--debug`` (or
``debug`` in the experiment name) shrinks the run as the reference's debug
mode does; ``--profile DIR`` writes a ``torch.profiler`` trace.
``--sr-only`` and ``--legacy`` (the SR-only and the alternating trainers)
are not ported yet and raise.  From Python: ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import random
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

from ..config import get_cfg_defaults, update_cfg
from ..device import resolve_device


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
                        help="alternating SR/MICA trainer (not ported yet)")
    parser.add_argument("--sr-only", action="store_true",
                        help="SR-diffusion pretraining only (not ported "
                             "yet)")
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


def main(argv=None, *, device: str | torch.device | None = None) -> int:
    """Run the CLI on ``device`` (None: the GPU; it raises where there is
    none)."""
    cfg, args = parse_args(argv)
    device = resolve_device(device)
    for flag, what in (("sr_only", "--sr-only (train/sr_only.py)"),
                       ("legacy", "--legacy (train/legacy.py)")):
        if getattr(args, flag):
            raise NotImplementedError(
                f"{what} is not ported to sr3d_torch yet (ROADMAP Queue 1 "
                f"item 4); the joint trainer runs without the flag")

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
    if cfg.get("cfg_file") and Path(str(cfg.cfg_file)).exists():
        shutil.copy(str(cfg.cfg_file), str(log_dir / "config.yml"))
    cfg.dump(str(log_dir / "full_config.yaml"))

    profile_ctx = contextlib.nullcontext()
    if args.profile:
        from ..utils.profiling import trace
        profile_ctx = trace(args.profile)

    from ..train.trainer import Trainer

    with profile_ctx:
        trainer = Trainer(cfg, device=device)
        trainer.fit(max_steps=args.max_steps)
        trainer.metrics_writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
