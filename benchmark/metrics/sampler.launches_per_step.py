"""Kernel and graph launch calls of the device slice made while a sampler
step (``sr3d.step``) was open and its UNet forward (``sr3d.unet``) was not,
per step: the launches a graph of the UNet forward alone would leave."""

from benchmark.program_spans import intervals, placed
from benchmark.trace import in_ranges


def read(rec):
    tr = rec.device_trace
    found = placed(rec) if tr is not None else None
    if not found:
        return None
    n = sum(s.name == "sr3d.step" for s, _, _ in found)
    steps, unet = intervals(found, "sr3d.step"), intervals(found,
                                                          "sr3d.unet")
    hits = sum(in_ranges(ts, steps) and not in_ranges(ts, unet)
               for ts, _ in tr.launches)
    return hits / n if n else None
