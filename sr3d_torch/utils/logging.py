"""Logging: console + file logs, and a metrics sink.

The port's copy of ``sr3d_tpu/utils/logging.py``: ``setup_logger`` (console
and ``{phase}.log``) and ``MetricsWriter``, which always appends JSON lines
to ``metrics.jsonl`` and writes images as PNG files, and also writes
TensorBoard events through ``torch.utils.tensorboard`` where that is
installed (a no-op where it is not).  W&B is off unless asked for, and a
no-op where it is absent or unreachable.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path


def setup_logger(name: str = "sr3d_torch", log_dir: str | None = None,
                 level: str = "INFO", phase: str = "train") -> logging.Logger:
    """Console + optional file handler (reference core/logger.py:122-135)."""
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper()))
    logger.handlers.clear()
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d | %(levelname)s | %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir is not None:
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(Path(log_dir) / f"{phase}.log")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class MetricsWriter:
    """Fan-out metrics sink: JSONL (always), TensorBoard + W&B (if present).

    API mirrors what the reference trainer calls on tensorboardX
    (add_scalar/add_image) plus the WandbLogger's log_metrics.
    """

    def __init__(self, log_dir: str, enable_tensorboard: bool = True,
                 enable_wandb: bool = False, wandb_cfg: dict | None = None):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = (self.log_dir / "metrics.jsonl").open("a")
        self._tb = None
        self._wandb = None
        if enable_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(str(self.log_dir / "tb"))
            except Exception:
                self._tb = None
        if enable_wandb:
            try:  # pragma: no cover
                import wandb

                wandb.init(**(wandb_cfg or {}))
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log({tag: float(value)}, step=step)

    def add_scalars(self, scalars: dict, step: int, prefix: str = "") -> None:
        for k, v in scalars.items():
            self.add_scalar(f"{prefix}{k}", v, step)

    def add_image(self, tag: str, img_hwc01, step: int) -> None:
        """img: [H,W,C] float in [0,1]."""
        import numpy as np

        img = np.asarray(img_hwc01)
        if self._tb is not None:
            self._tb.add_image(tag, img.transpose(2, 0, 1), step)
        # always persist to disk for zero-dependency inspection
        try:
            from PIL import Image

            out = self.log_dir / "images" / f"{tag.replace('/', '_')}_{step}.png"
            out.parent.mkdir(parents=True, exist_ok=True)
            Image.fromarray(
                (img.clip(0, 1) * 255).astype(np.uint8)).save(out)
        except Exception:
            pass

    # -- W&B extras (reference core/wandb_logger.py:60-116), with an
    # always-on JSONL/disk twin so the features work without wandb --------

    def log_checkpoint(self, paths, step: int) -> None:
        """Register checkpoint files as a model artifact (reference
        log_checkpoint :71-89).  Without wandb, records the file list in
        the JSONL sink."""
        paths = [str(p) for p in paths]
        self._jsonl.write(json.dumps(
            {"tag": "checkpoint_artifact", "files": paths,
             "step": int(step), "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._wandb is not None:  # pragma: no cover
            art = self._wandb.Artifact(
                f"{self._wandb.run.id}_model", type="model")
            for p in paths:
                art.add_file(p)
            self._wandb.log_artifact(art, aliases=["latest"])

    def log_eval_data(self, fake_img, sr_img, hr_img, psnr=None,
                      ssim=None) -> None:
        """Append a row to the eval table (reference log_eval_data
        :91-108); the images also persist to disk via add_image."""
        row = {"tag": "eval_table_row", "ts": time.time()}
        if psnr is not None:
            row["psnr"] = float(psnr)
        if ssim is not None:
            row["ssim"] = float(ssim)
        self._eval_rows = getattr(self, "_eval_rows", [])
        self._eval_rows.append((fake_img, sr_img, hr_img,
                                row.get("psnr"), row.get("ssim")))
        self._jsonl.write(json.dumps(row) + "\n")
        self._jsonl.flush()

    def log_eval_table(self, step: int = 0, commit: bool = False) -> int:
        """Flush accumulated eval rows (reference log_eval_table :110-116).
        Returns the number of rows flushed."""
        rows = getattr(self, "_eval_rows", [])
        if self._wandb is not None and rows:  # pragma: no cover
            cols = ["fake_image", "sr_image", "hr_image", "psnr", "ssim"]
            table = self._wandb.Table(columns=cols)
            for fake, sr, hr, psnr, ssim in rows:
                table.add_data(self._wandb.Image(fake),
                               self._wandb.Image(sr),
                               self._wandb.Image(hr), psnr, ssim)
            self._wandb.log({"eval_data": table}, commit=commit)
        n = len(rows)
        self._eval_rows = []
        return n

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
