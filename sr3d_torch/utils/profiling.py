"""Profiling: the program's own spans, and a ``torch.profiler`` trace of a
block.

Spans.  ``with annotate(name, **attrs):`` marks one phase of the program.
The serving path has seven: ``sr3d.request`` (``Predictor.predict``,
whole), ``sr3d.prep`` (the condition's H2D copy and resize), ``sr3d.step``
(one sampler iteration with its noise draw), ``sr3d.unet`` (one UNet
forward), ``sr3d.mica`` (ArcFace, the mapping, FLAME and the landmarks),
``sr3d.arcface`` (ArcFace's forward, inside ``sr3d.mica``) and
``sr3d.fetch`` (the host's wait for the device and the copy back).  A span
records only while ``spans_on()`` holds or a ``torch.profiler`` records;
otherwise a span site costs one flag check and reads no clock.  A recorded
span keeps its name, start and end on the ``time.perf_counter_ns()`` clock,
its parent, the id of its request (the outermost span it lies in), the
rank under ``torch.distributed`` and its attributes; ``take_spans()``
hands them over.  No span synchronises the device or reads a tensor.

Under a profiler a span also opens a ``record_function`` range of its
name, and an outermost span launches a marker kernel (``MARKER``, one
``torch.cuda._sleep`` of a cycle) at its start and end, noting the clock
before and after each launch (``Span.marks``).  ``clock_offset`` finds
those launches in the profiler's trace and puts the spans on its clock, so
that a trace of the device's activity alone, which holds no host ranges,
can still say where the host was.

``trace(DIR)`` records the host's operators and, where a GPU is present,
the card's kernels, and writes to DIR a Chrome trace (``trace.json``,
readable in Perfetto or ``chrome://tracing``), a table of the slowest
operators (``key_averages.txt``) and the spans recorded (``spans.json``,
Chrome trace events on ``trace.json``'s clock where the markers place
them).  The train and serve CLIs' ``--profile DIR`` wrap a run in it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import time
from pathlib import Path
from typing import Sequence

import torch
import torch.autograd.profiler as _prof

MARKER = "spin_kernel"      # the kernel ``torch.cuda._sleep`` launches
ALIGN_US = 1000.0           # markers that spread more do not align

_on = False
_done: list["Span"] = []
_stack: list["Span"] = []
_ids = itertools.count()
_requests = itertools.count()
_NULL = contextlib.nullcontext()


def _rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _mark() -> tuple[int, int]:
    before = time.perf_counter_ns()
    torch.cuda._sleep(1)
    return before, time.perf_counter_ns()


class Span:
    """One recorded span; ``with`` records it."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "request",
                 "rank", "attrs", "marks", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.marks: list[tuple[int, int]] = []
        self._range = None

    def __enter__(self) -> "Span":
        self.id = next(_ids)
        up = _stack[-1] if _stack else None
        self.parent = up.id if up else None
        self.request = up.request if up else next(_requests)
        self.rank = _rank()
        _stack.append(self)
        self.start_ns = time.perf_counter_ns()
        if _prof._is_profiler_enabled:
            self._range = _prof.record_function(self.name)
            self._range.__enter__()
            if up is None and torch.cuda.is_initialized():
                self.marks.append(_mark())
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            if self.marks:
                self.marks.append(_mark())
            self._range.__exit__(*exc)
            self._range = None
        self.end_ns = time.perf_counter_ns()
        _stack.pop()
        _done.append(self)

    def as_event(self, offset_us: float = 0.0) -> dict:
        """The span as a Chrome trace event, ``offset_us`` after its clock's
        zero."""
        return {"ph": "X", "cat": "sr3d_span", "name": self.name,
                "ts": self.start_ns / 1e3 + offset_us,
                "dur": (self.end_ns - self.start_ns) / 1e3,
                "pid": self.rank, "tid": self.request,
                "args": dict(self.attrs, id=self.id, parent=self.parent,
                             request=self.request)}


def recording() -> bool:
    """Whether spans record now: ``spans_on()`` holds or a profiler
    records."""
    return _on or _prof._is_profiler_enabled


def annotate(name: str, **attrs):
    """``with annotate("sr3d.step", k=3): ...``: a span of the block (a
    no-op unless spans are on or a profiler records)."""
    if not recording():
        return _NULL
    return Span(name, attrs)


def spans_on() -> None:
    """Record spans from now on, profiler or not."""
    global _on
    _on = True


def spans_off() -> None:
    """Record spans only under a profiler again."""
    global _on
    _on = False


def take_spans() -> list[Span]:
    """The spans recorded and closed since the last call, in the order they
    closed; the buffer is emptied."""
    out = list(_done)
    _done.clear()
    return out


def marker_launches(events: Sequence[dict]) -> list[float]:
    """The host start (``ts``, µs) of every launch of ``MARKER`` in a
    Kineto trace's events, in order: the API call whose correlation id
    the marker kernel carries."""
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and MARKER in e.get("name", "")}
    return sorted(float(e["ts"]) for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and (e.get("args") or {}).get("correlation") in corr)


def clock_offset(launches_us: Sequence[float], spans: Sequence[Span]
                 ) -> tuple[float, float] | None:
    """``(offset, error)`` in µs: a trace's time is ``ns / 1e3 + offset``
    for a ``perf_counter_ns`` time ``ns``, to within ``error``.
    ``launches_us``: the marker launches of the trace
    (``marker_launches``); ``spans``: spans that hold the marks of those
    launches, matched in order to the run of marks that agrees best.  Each
    launch's API call starts between the clock reads around it, so each
    mark bounds the offset from both sides; the offset is the middle of
    the range every mark allows, ``error`` half its width.  None where no
    run of marks agrees within ``ALIGN_US``."""
    marks = sorted(m for s in spans for m in s.marks)
    t = sorted(launches_us)
    if not t or len(t) > len(marks):
        return None
    best = None
    for j in range(len(marks) - len(t) + 1):
        run = marks[j:j + len(t)]
        lo = max(ts - a / 1e3 for ts, (_, a) in zip(t, run))
        hi = min(ts - b / 1e3 for ts, (b, _) in zip(t, run))
        if best is None or lo - hi < best[0] - best[1]:
            best = (lo, hi)
    lo, hi = best
    if lo - hi > ALIGN_US:
        return None
    return (lo + hi) / 2, abs(hi - lo) / 2


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
    spans = take_spans()
    prof.export_chrome_trace(str(out / "trace.json"))
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    found = clock_offset(marker_launches(events), spans)
    offset, error = found if found else (0.0, None)
    (out / "spans.json").write_text(json.dumps({
        "traceEvents": [s.as_event(offset) for s in spans],
        "otherData": {"clock": "trace.json" if found else "perf_counter",
                      "offset_us": offset, "error_us": error}}))
    sort = ("cuda_time_total" if torch.cuda.is_available()
            else "cpu_time_total")
    (out / "key_averages.txt").write_text(
        prof.key_averages().table(sort_by=sort, row_limit=40))
