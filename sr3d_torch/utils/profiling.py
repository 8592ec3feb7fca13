"""Profiling hooks: a ``torch.profiler`` trace of a block, named ranges and
a step timer.

The port's counterpart of ``sr3d_tpu/utils/profiling.py``: ``trace(DIR)``
records the host's operators and, where a GPU is present, the card's
kernels, and writes a Chrome trace (``trace.json``, readable in Perfetto or
``chrome://tracing``) and a table of the slowest operators
(``key_averages.txt``) to DIR; ``annotate`` names a range in it;
``StepTimer`` times steps, synchronising the card before it reads the
clock.  ``python -m sr3d_torch.cli.main --profile DIR`` wraps a run in
``trace``.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """``with trace("logs/trace"): ...``: a profiler trace of the block."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield str(out)
    prof.export_chrome_trace(str(out / "trace.json"))
    sort = ("cuda_time_total" if torch.cuda.is_available()
            else "cpu_time_total")
    (out / "key_averages.txt").write_text(
        prof.key_averages().table(sort_by=sort, row_limit=40))


def annotate(name: str):
    """A named range inside a trace (shows on the timeline)."""
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Wall-clock step timing with warm-up steps discarded and items/s."""
    warmup: int = 2
    _times: list = field(default_factory=list)
    _t0: float | None = None
    _count: int = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        """Seconds since ``start``; with ``sync_on`` (a tensor) the card
        is synchronised first."""
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def items_per_sec(self, items_per_step: int) -> float:
        return items_per_step / self.mean if self.mean else 0.0
