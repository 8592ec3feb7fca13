"""The UNet's level marks in the device slice, and the segments of its
forwards between them.

A forward replayed as a CUDA graph is one launch, so no host span can say
where inside it the device spends its time.  The program launches a level
mark (a one-thread kernel whose name holds ``MARK``) at boundaries between
the UNet's resolution levels, as nodes of the graph, and its ``sr3d.unet``
spans name the segments between the marks in their ``levels`` attribute
(``e512-e256, e128-d128, d256-d512``: a segment names the levels it runs
from and to, ``mid`` the mid block).  A forward's ``len(levels) + 1`` marks,
in the device's order, bound its segments: the marks are grouped into
forwards by that count, in order, and nothing is placed by host time (a
replay runs after its host span has ended).

A segment's time is the device's kernel time between its two marks: the
union of the device slice's operations there (overlapping streams count
once), the marks left out.  A segment whose levels all lie at the
``OUTER`` highest resolutions, encoder or decoder, is an outer one; the
rest, mid block included, are inner.

Where the program records no ``levels`` or launches no marks (a checkout
from before them), or the marks do not make whole forwards, ``split``
gives None and the readers leave their metric out.
"""

from __future__ import annotations

from . import program_spans
from .trace import union

MARK = "sr3d_level_mark"    # a substring of the mark kernel's name
OUTER = 2                   # resolutions counted as the outer levels


def labels(rec) -> tuple[str, ...] | None:
    """The segment labels of the program's UNet forwards, or None."""
    for s in program_spans.spans(rec) or ():
        if s.name == "sr3d.unet" and s.attrs.get("levels"):
            return tuple(s.attrs["levels"])
    return None


def _covered_each(merged, bounds) -> list[float]:
    """The length of each ``[a, b]`` of the sorted, disjoint ``bounds``
    that the sorted, disjoint ``merged`` intervals cover."""
    out, i = [], 0
    for a, b in bounds:
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        t, j = 0.0, i
        while j < len(merged) and merged[j][0] < b:
            t += max(0.0, min(merged[j][1], b) - max(merged[j][0], a))
            j += 1
        out.append(t)
    return out


def segments(rec) -> dict[str, float] | None:
    """µs of device time in each segment, summed over the device slice's
    forwards, or None."""
    tr = rec.device_trace
    names = labels(rec) if tr is not None else None
    if not names:
        return None
    lo, hi = tr.slice
    marks = [(s, e) for s, e, n in tr.device if MARK in n and lo <= s <= hi]
    per = len(names) + 1
    if not marks or len(marks) % per:
        return None
    bounds, which = [], []
    for f in range(0, len(marks), per):
        fw = marks[f:f + per]
        for name, (_, a), (b, _) in zip(names, fw, fw[1:]):
            bounds.append((a, b))
            which.append(name)
    work = union((s, e) for s, e, n in tr.device if MARK not in n)
    out = dict.fromkeys(names, 0.0)
    for name, t in zip(which, _covered_each(work, bounds)):
        out[name] += t
    return out


def resolutions(label: str) -> set[int]:
    """The resolutions a segment label names (``e512-e256`` → {512, 256};
    ``mid``: none)."""
    return {int(p[1:]) for p in label.split("-")
            if p[:1] in ("e", "d") and p[1:].isdigit()}


def split(rec) -> tuple[float, float] | None:
    """``(outer, inner)`` µs of the device slice's UNet forwards, or
    None."""
    seg = segments(rec)
    if seg is None:
        return None
    top = set(sorted(set().union(*map(resolutions, seg)),
                     reverse=True)[:OUTER])
    outer = sum(t for k, t in seg.items()
                if resolutions(k) and resolutions(k) <= top)
    return outer, sum(seg.values()) - outer


def ms_per_face(rec, outer: bool) -> float | None:
    """The outer or inner levels' device ms per face of the slice."""
    found = split(rec)
    if found is None or not rec.device_faces:
        return None
    return found[0 if outer else 1] / 1e3 / rec.device_faces


def replay_us(rec) -> float:
    """µs of the device slice's time in CUDA graph replays: the union of
    the operations that share their launch's correlation id with another
    (a graph's launch runs all of its kernels under its one id)."""
    tr = rec.device_trace
    count: dict[int, int] = {}
    for c in tr.device_corr:
        count[c] = count.get(c, 0) + 1
    lo, hi = tr.slice
    return sum(e - s for s, e in union(
        (max(s, lo), min(e, hi)) for (s, e, _), c
        in zip(tr.device, tr.device_corr) if count[c] > 1 and e > lo
        and s < hi))
