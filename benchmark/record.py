"""What a run recorded, as the metric readers (``metrics/*.py``) see it, and
the reductions they share: the device slice's busy time and wall, the least
time of its work, the launches and kernel time under the benchmark's ranges
in the host slice, and the ``breakdown`` of the result line.

A traced run profiles two slices of the same traffic after the window: the
device slice (``device_trace``: the device's activity alone, so the host
runs at nearly its untraced pace and the idle share is the program's) and
the host slice (``trace``: the host's operators and the benchmark's ranges
too, for launches and work by range; the profiler slows its host).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict

from . import count
from .trace import Trace, covered, gaps, in_ranges, union

TOP = 10          # entries of each breakdown list
NAME_CHARS = 120  # a kernel's name is cut to this in the breakdown


@dataclasses.dataclass
class Record:
    cell: dict
    window: dict            # the window: latencies, faces, wall
    setup_s: float
    work: dict              # the reference spec: what a face needs
    trace: Trace | None = None          # the host slice
    slice_faces: int = 0
    device_trace: Trace | None = None   # the device slice
    device_faces: int = 0
    host: dict = dataclasses.field(default_factory=dict)  # window spans, s

    @functools.cached_property
    def least_s_per_face(self) -> float:
        """The least seconds a served face needs at the card's peaks."""
        return count.least_seconds(count.serve_flops_per_face(self.work))

    @property
    def slice_s(self) -> float:
        """The device slice's wall seconds."""
        return self.device_trace.wall_s

    @functools.cached_property
    def busy_s(self) -> float:
        """Seconds of the device slice in which any device operation ran."""
        lo, hi = self.device_trace.slice
        return covered(self.device_trace.device, lo, hi) / 1e6

    def ranges(self, name: str) -> list[tuple[float, float]]:
        return union(self.trace.ranges_named(name))

    def launches_in(self, name: str) -> int:
        """Host launch calls made inside the ``name`` ranges."""
        r = self.ranges(name)
        return sum(in_ranges(ts, r) for ts, _ in self.trace.launches)

    def device_s_under(self, name: str) -> float:
        """Device time of the operations whose host call was made inside
        the ``name`` ranges (matched by correlation)."""
        r = self.ranges(name)
        host = self.trace.host_of
        return sum((e - s) for (s, e, _), c in zip(self.trace.device,
                                                   self.trace.device_corr)
                   if c in host and in_ranges(host[c], r)) / 1e6


def innermost(trace: Trace, t: float) -> str:
    """The latest-opened benchmark range that is open at ``t``."""
    best, start = "none", float("-inf")
    for name, s, e in trace.ranges:
        if s <= t <= e and s >= start:
            best, start = name, s
    return best


def breakdown(rec: Record) -> dict:
    """The device operations that took most time in the host slice, and
    its longest idle gaps, each named by the range the host had open (their
    lengths hold the profiler's cost on the host)."""
    tr = rec.trace
    lo, hi = tr.slice
    per = defaultdict(float)
    for s, e, name in tr.device:
        if e > lo and s < hi:
            per[name[:NAME_CHARS]] += (min(e, hi) - max(s, lo)) / 1e6
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps(tr.device, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[innermost(tr, (s + e) / 2), (e - s) / 1e6]
                          for s, e in idle]}


def device_info(torch, device, chips: int, peak: int,
                traced: Record | None) -> dict:
    cuda = torch.device(device).type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(chips), "memory_peak_bytes": int(peak)}
    if traced is not None and traced.device_trace is not None:
        out["busy_s"] = traced.busy_s
        out["window_s"] = traced.slice_s
    return out
