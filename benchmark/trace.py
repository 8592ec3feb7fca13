"""The traced slice: ``torch.profiler`` over a fixed piece of work at the end
of the window, reduced to what the per-layer readers need.

``profile(fn, host)`` runs ``fn`` inside a ``bm.slice`` range under the
profiler, writes the Chrome trace to a temporary file, reads it back and
deletes it.  With ``host`` the profiler records the host's operators and
the benchmark's ranges besides the device's activity, and slows the host
by as much as the work it records (1.3-1.9x a request of 8 on the H100);
without, it records the device's activity and the CUDA API calls alone,
and the slice's wall is the host clock's.  The result, ``Trace``, holds:

* ``device``: every kernel, memcpy and memset on the device, as
  ``(start_us, end_us, name)``;
* ``launches``: the host's launch calls (runtime or driver API events whose
  name holds ``LaunchKernel`` or ``GraphLaunch``), as ``(ts_us,
  correlation)``;
* ``host_of``: correlation → the host time of the API call that issued it;
* ``ranges``: the benchmark's own ``bm.*`` ranges, ``(name, start_us,
  end_us)``, on the host's clock (the trace's one clock);
* ``slice``: the ``bm.slice`` range's ``(start_us, end_us)``, or without
  the host's ranges the span of the trace's events;
* ``wall_s``: the slice's seconds.

``union`` and ``gaps`` are the interval arithmetic of the idle share: the
device is busy where any device operation runs, whatever the stream, so
overlapping operations count once.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time
from typing import Callable

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")


def is_launch(name: str) -> bool:
    return "LaunchKernel" in name or "GraphLaunch" in name


@dataclasses.dataclass
class Trace:
    device: list[tuple[float, float, str]]
    launches: list[tuple[float, int]]
    host_of: dict[int, float]
    device_corr: list[int]
    ranges: list[tuple[str, float, float]]
    slice: tuple[float, float]
    wall_s: float

    def ranges_named(self, name: str) -> list[tuple[float, float]]:
        return [(s, e) for n, s, e in self.ranges if n == name]


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted ``(start, end)`` covering every interval."""
    out: list[list[float]] = []
    for s, e in sorted((s, e) for s, e, *_ in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def covered(intervals, lo: float, hi: float) -> float:
    """The length of [lo, hi] that ``intervals`` cover, each point once."""
    return sum(e - s for s, e in clip(union(intervals), lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that ``intervals`` leave uncovered."""
    out, t = [], lo
    for s, e in clip(union(intervals), lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def in_ranges(ts: float, ranges: list[tuple[float, float]]) -> bool:
    """Whether ``ts`` lies in one of the sorted, disjoint ``ranges``."""
    i = bisect.bisect_right([s for s, _ in ranges], ts) - 1
    return i >= 0 and ts <= ranges[i][1]


def parse(events: list[dict], wall_s: float | None = None) -> Trace:
    """The trace's events reduced; ``wall_s`` is the slice's wall on the
    host clock, for a trace without the host's ranges."""
    device, dev_corr, launches, host_of, ranges = [], [], [], {}, []
    for ev in events:
        cat, ph = ev.get("cat"), ev.get("ph")
        if ph != "X":
            continue
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        args = ev.get("args") or {}
        if cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev.get("name", "")))
            dev_corr.append(int(args.get("correlation", -1)))
        elif cat in API_CATS:
            corr = int(args.get("correlation", -1))
            host_of[corr] = ts
            if is_launch(ev.get("name", "")):
                launches.append((ts, corr))
        elif cat == "user_annotation" and ev.get("name", "").startswith(
                "bm."):
            ranges.append((ev["name"], ts, ts + dur))
    sl = [(s, e) for n, s, e in ranges if n == "bm.slice"]
    if wall_s is not None and not sl:
        t = [s for s, _, _ in device] + [ts for ts, _ in launches] \
            + list(host_of.values())
        if not t:
            raise RuntimeError("the trace holds no device or API event")
        sl = [(min(t), max([e for _, e, _ in device] + t))]
    if len(sl) != 1:
        raise RuntimeError(f"the trace holds {len(sl)} bm.slice ranges")
    if wall_s is None:
        wall_s = (sl[0][1] - sl[0][0]) / 1e6
    order = sorted(range(len(device)), key=lambda i: device[i][0])
    return Trace([device[i] for i in order], sorted(launches), host_of,
                 [dev_corr[i] for i in order], sorted(ranges,
                                                      key=lambda r: r[1]),
                 sl[0], wall_s)


def profile(fn: Callable[[], object], host: bool = True
            ) -> tuple[object, Trace]:
    """``fn()`` under the profiler, inside a ``bm.slice`` range, the device
    synchronised before and after; returns its result and the ``Trace``.
    ``host``: record the host's operators and ranges too."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, \
        record_function

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function("bm.slice"):
            out = fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, parse(events, None if host else wall)
