"""The readers of the UNet's level marks (``benchmark/levels.py``) on a
synthetic device slice, and the benchmark's count of the 64->512
configuration's work."""

import pytest
import torch

from benchmark import count, levels, record, spec, trace, weights
from sr3d_torch.kernels.level_mark import LEVEL_MARK
from sr3d_torch.utils import profiling

# the program's three segments of a 4-level UNet on 16² inputs, and the
# same forward cut at every level
LEVELS = ("e16-e8", "e4-d4", "d8-d16")
FINE = ("e16", "e8", "mid", "d8", "d16")
MARK = LEVEL_MARK + "()"
READERS = ("unet.outer_levels_ms_per_face", "unet.inner_levels_ms_per_face")


def _forward(t0: float, corr: int, labels=LEVELS) -> list[tuple]:
    """One replayed forward from ``t0`` µs, all of it under its graph
    launch's correlation id: marks of 1 µs and between them e16 300 µs;
    e8 two kernels on two streams that overlap, 598 µs of union; the
    inner levels 200; d8 400; d16 500 and, after a gap, 200.  ``FINE``
    has a mark between each of those, ``LEVELS`` only around e16–e8,
    the inner levels and d8–d16."""
    fine = labels == FINE
    k = [(0, 1, MARK), (1, 301, "gn")] + ([(301, 302, MARK)] if fine
                                           else []) + [
         (302, 702, "conv"), (500, 900, "attn"), (900, 901, MARK),
         (901, 1101, "conv"), (1101, 1102, MARK), (1102, 1502, "conv")] \
        + ([(1502, 1503, MARK)] if fine else []) + [
         (1503, 2003, "conv"), (2100, 2300, "gn"), (2300, 2301, MARK)]
    return [(t0 + a, t0 + b, n, corr) for a, b, n in k]


def _rec(forwards=((1000, 10), (6000, 20)), labels=LEVELS, faces=4):
    """A device slice [0, 10000] µs: the forwards, and between them a
    MICA kernel and a copy, each launched alone.  The ``sr3d.unet``
    spans ended on the host long before their replays ran on the
    device."""
    ops = [x for t0, c in forwards
           for x in _forward(t0, c, labels or LEVELS)]
    ops += [(3500, 3700, "arcface", 30), (3800, 3810, "copy", 31)]
    ev = [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a,
           "args": {"correlation": c}} for a, b, n, c in ops]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
            "ts": t0 - 900, "dur": 5, "args": {"correlation": c}}
           for t0, c in forwards]
    ev += [{"ph": "X", "cat": "kernel", "name": "edge", "ts": 0, "dur": 1,
            "args": {"correlation": 40}},
           {"ph": "X", "cat": "kernel", "name": "edge", "ts": 9999,
            "dur": 1, "args": {"correlation": 41}}]
    spans = []
    for i, (t0, _) in enumerate(forwards):
        s = profiling.Span("sr3d.unet", {"graph": "replay"}
                           if labels is None else {"graph": "replay",
                                                   "levels": labels})
        s.id, s.parent, s.request, s.rank = i, None, 0, 0
        s.start_ns, s.end_ns = (t0 - 950) * 1e3, (t0 - 880) * 1e3
        spans.append(s)
    rec = record.Record(cell={}, window={}, setup_s=0.0, work={},
                        device_trace=trace.parse(ev, wall_s=10000e-6),
                        device_faces=faces)
    rec.program_spans = spans
    return rec


def test_mark_name_is_the_programs():
    assert levels.MARK in LEVEL_MARK


@pytest.mark.parametrize("labels,want", [
    (LEVELS, {"e16-e8": 1796.0, "e4-d4": 400.0, "d8-d16": 2200.0}),
    (FINE, {"e16": 600.0, "e8": 1196.0, "mid": 400.0, "d8": 800.0,
            "d16": 1400.0}),
])
def test_segments_of_two_replays(labels, want):
    rec = _rec(labels=labels)
    assert levels.labels(rec) == labels
    assert levels.segments(rec) == pytest.approx(want)
    # the two highest resolutions, 16 and 8: all but the inner levels
    assert levels.split(rec) == pytest.approx((3996.0, 400.0))
    read = {n: spec.reader(n)(rec) for n in READERS}
    assert read["unet.outer_levels_ms_per_face"] == pytest.approx(0.999)
    assert read["unet.inner_levels_ms_per_face"] == pytest.approx(0.1)


def test_the_levels_make_up_the_replays_within_3_percent():
    """The segments leave out only the marks (8 µs of 4404); the MICA
    kernel and the copy, launched alone, are no replay's."""
    rec = _rec()
    replay = levels.replay_us(rec)
    assert replay == pytest.approx(2 * 2202.0)
    assert abs(sum(levels.split(rec)) - replay) <= 0.03 * replay


def test_readers_leave_out_what_they_cannot_read():
    no_levels = _rec(labels=None)           # a program without the attribute
    wrong = _rec()                          # marks that make no whole forward
    wrong.program_spans[0].attrs["levels"] = LEVELS[:-1]
    no_trace = _rec()
    no_trace.device_trace = None
    no_spans = _rec()
    no_spans.program_spans = None
    no_faces = _rec(faces=0)
    for rec in (no_levels, wrong, no_trace, no_spans, no_faces):
        for name in READERS:
            assert spec.reader(name)(rec) is None, name


def test_a_slice_without_marks_reads_nothing():
    """The parent's program: spans with ``levels`` but no mark kernel."""
    rec = _rec()
    tr = rec.device_trace
    keep = [i for i, (_, _, n) in enumerate(tr.device) if MARK != n]
    tr.device = [tr.device[i] for i in keep]
    tr.device_corr = [tr.device_corr[i] for i in keep]
    assert levels.segments(rec) is None


def _spec(config: str) -> dict:
    return spec.reference_spec(
        spec.load_json(spec.HERE / "configs" / f"{config}.json"),
        spec.load_json(spec.HERE / "traffic" / "serve_b4.json"))


def test_count_of_the_64_512_configuration():
    """One face's forward at 512² with the serving int8 gates: 1884.4 GOP
    int8 and 110.4 GFLOP bf16 (22.4× the flagship's 89.0 GFLOP); 563.8 M
    UNet parameters (the paper's table: 625 M, with BigGAN-style
    blocks)."""
    s = _spec("sr3_64_512")
    q = count.unet_flops(s, 512, True)
    assert round(q["int8"] / 1e9, 1) == 1884.4
    assert round(q["bf16"] / 1e9, 1) == 110.4
    assert round(sum(count.unet_flops(s, 512, False).values()) / 1e9,
                 1) == 1994.8
    n = sum(torch.Size(sh).numel() for _, sh, _ in weights.specs(s)["unet"])
    assert round(n / 1e6, 1) == 563.8
    # 25 forwards and the MICA branch a face
    assert 25e-3 < count.least_seconds(count.serve_flops_per_face(s)) \
        < 28e-3
