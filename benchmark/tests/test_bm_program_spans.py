"""The readers of the program's own spans: the sampler's two metrics and the
device's idle split, on a synthetic device slice and on the CPU run."""

import pytest
from conftest import tiny_cell

from benchmark import record, spec, trace
from benchmark import run as run_mod
from sr3d_torch.utils import profiling

NEW = ("sampler.self_ms_per_step", "sampler.launches_per_step",
       "device.idle_share.in_unet", "device.idle_share.outside_unet")
PERF_US = 5000.0    # the spans' clock reads this much later than the trace


def _span(name, sid, parent, a, b, marks=()):
    """A span from ``a`` to ``b`` µs on the trace's clock."""
    s = profiling.Span(name, {})
    s.id, s.parent, s.request, s.rank = sid, parent, 0, 0
    s.start_ns, s.end_ns = (a + PERF_US) * 1e3, (b + PERF_US) * 1e3
    s.marks = [((t + PERF_US) * 1e3,) * 2 for t in marks]
    return s


def _slice():
    """One request [100, 900] µs of a 1000 µs device slice: two steps
    [200, 500] and [500, 800], each with a UNet forward ([250, 450],
    [520, 780]), then the MICA branch; the request's markers at 105 and
    884; and a longer request of another slice, 50 ms later, that must be
    left out."""
    spans = [_span("sr3d.request", 1, None, 100, 900, marks=(105, 884)),
             _span("sr3d.step", 2, 1, 200, 500),
             _span("sr3d.unet", 3, 2, 250, 450),
             _span("sr3d.step", 4, 1, 500, 800),
             _span("sr3d.unet", 5, 4, 520, 780),
             _span("sr3d.mica", 6, 1, 810, 860),
             _span("sr3d.request", 7, None, 50000, 60000,
                   marks=(50005, 59990)),
             _span("sr3d.step", 8, 7, 50100, 59900)]
    launch = {1: 105, 2: 884, 3: 210, 4: 300, 5: 460, 6: 505, 7: 600,
              8: 810}
    kernels = {1: (106, 107, profiling.MARKER), 2: (885, 886,
                                                   profiling.MARKER),
               3: (220, 260, "k"), 4: (300, 400, "k"),
               7: (600, 700, "k"), 8: (815, 850, "k")}
    ev = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
           "ts": ts, "dur": 1, "args": {"correlation": c}}
          for c, ts in launch.items()]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s,
            "args": {"correlation": c}} for c, (s, e, n) in kernels.items()]
    rec = record.Record(cell={}, window={}, setup_s=0.0, work={},
                        device_trace=trace.parse(ev, wall_s=1000e-6),
                        device_faces=1)
    rec.program_spans = spans
    return rec


def test_readers_on_a_synthetic_device_slice():
    rec = _slice()
    read = {n: spec.reader(n)(rec) for n in NEW}
    # steps' own time: 300 − 200 and 300 − 260 µs
    assert read["sampler.self_ms_per_step"] == pytest.approx(0.070)
    # 210 and 460 in the first step, 505 in the second, outside the UNet
    assert read["sampler.launches_per_step"] == pytest.approx(1.5)
    # idle in the slice [105, 886]: [105,106] [107,220] [260,300]
    # [400,600] [700,815] [850,885], 504 µs; 250 of it inside a UNet
    assert read["device.idle_share.in_unet"] == pytest.approx(25.0)
    assert read["device.idle_share.outside_unet"] == pytest.approx(25.4)
    # with the 219 µs of the wall outside the slice's events, the split
    # makes up the device's whole idle share
    idle = spec.reader("device.idle_share.serve")(rec)
    assert idle == pytest.approx(25.0 + 25.4 + 21.9)


def test_readers_leave_out_what_they_cannot_read():
    empty = record.Record(cell={}, window={}, setup_s=1.0, work={})
    empty.program_spans = None          # a program that records no spans
    rec = _slice()
    rec.program_spans = rec.program_spans[6:]   # markers of no request
    no_marks = _slice()
    for s in no_marks.program_spans:
        s.marks = []
    for r in (empty, rec, no_marks):
        for name in NEW:
            assert spec.reader(name)(r) is None, name


def test_the_cpu_traced_run_reports_the_sampler_step():
    """On the CPU there is no device slice: with spans on over the window
    the sampler's own time is read from every step recorded, and the
    device's metrics are left out."""
    cell = tiny_cell()
    cell["per_layer"] = [{"name": n, "unit": "x"} for n in NEW]
    profiling.take_spans()
    profiling.spans_on()
    try:
        res = run_mod.run("tiny.serve_b8", 3000000123, 1.0, True,
                          device="cpu", cell=cell)
    finally:
        profiling.spans_off()
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"sampler.self_ms_per_step"}
    assert res["metrics"]["sampler.self_ms_per_step"]["value"] > 0
    assert profiling.take_spans() == []
