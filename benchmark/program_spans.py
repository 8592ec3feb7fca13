"""The program's own spans (``sr3d_torch.utils.profiling``: ``sr3d.request``,
``sr3d.step``, ``sr3d.unet``, ...), as the readers of the ``sampler`` and
``device`` layers see them.

The program records its spans while a ``torch.profiler`` records, so a
``--trace 1`` run holds those of both traced slices, and those of the
window too where spans were switched on for it.  ``spans(rec)`` takes them
from the program once and keeps them on the record (``rec.program_spans``,
which the tests set themselves).  ``placed(rec)`` puts them on the device
slice's clock: that slice records no host ranges, but each outermost span
launched a marker kernel at its start and end, which the slice holds;
``profiling.clock_offset`` matches those launches to the spans' clock
reads.  Without a device slice (a run on the CPU) the spans keep their own
clock.  Where the program records no spans (a checkout from before them)
or the markers match nothing, ``placed`` gives None and the readers leave
their metric out.
"""

from __future__ import annotations

from .trace import gaps, union

SLACK_US = 1000.0   # a span of the slice may start this long before it


def spans(rec) -> list | None:
    """Every span the program recorded in the run, or None where it has no
    spans."""
    if "program_spans" not in vars(rec):
        try:
            from sr3d_torch.utils import profiling
            rec.program_spans = profiling.take_spans()
        except (ImportError, AttributeError):
            rec.program_spans = None
    return rec.program_spans


def placed(rec) -> list[tuple] | None:
    """``(span, start_us, end_us)`` of the device slice's spans on its
    trace's clock; without a device slice every span on the
    ``perf_counter`` clock in µs."""
    sp = spans(rec)
    tr = rec.device_trace
    if not sp:
        return None
    if tr is None:
        return [(s, s.start_ns / 1e3, s.end_ns / 1e3) for s in sp]
    from sr3d_torch.utils import profiling

    launches = [tr.host_of[c] for (_, _, name), c
                in zip(tr.device, tr.device_corr)
                if profiling.MARKER in name and c in tr.host_of]
    found = profiling.clock_offset(launches, sp)
    if found is None:
        return None
    off = found[0]
    lo, hi = tr.slice
    out = [(s, s.start_ns / 1e3 + off, s.end_ns / 1e3 + off) for s in sp]
    return [x for x in out
            if x[1] >= lo - SLACK_US and x[2] <= hi + SLACK_US]


def intervals(found: list[tuple], name: str) -> list[tuple[float, float]]:
    """The merged intervals of the ``name`` spans."""
    return union((a, b) for s, a, b in found if s.name == name)


def overlap(a, b) -> float:
    """The length that two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(rec, name: str) -> float | None:
    """µs of the device slice in which the device was idle while a ``name``
    span was open."""
    tr = rec.device_trace
    found = placed(rec) if tr is not None else None
    if found is None:
        return None
    idle = gaps(tr.device, *tr.slice)
    return overlap(idle, intervals(found, name))
