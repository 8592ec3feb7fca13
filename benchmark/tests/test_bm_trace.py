"""The interval arithmetic of the idle share and the reductions of a traced
slice, on synthetic events."""

import pytest

from benchmark import record, trace


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31), (40, 41)]
    assert trace.union(iv) == [(0, 15), (20, 31), (40, 41)]
    assert trace.covered(iv, 0, 100) == 27
    assert trace.covered(iv, 8, 25) == 7 + 5
    assert trace.gaps(iv, -5, 45) == [(-5, 0), (15, 20), (31, 40), (41, 45)]
    assert trace.covered([], 0, 1) == 0
    assert trace.gaps([], 0, 1) == [(0, 1)]


def _events():
    """A slice [0, 100] us: a UNet range [10, 40] that launches two
    kernels, a MICA range [50, 70] that launches one, two streams that
    overlap, and an event outside the slice."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "bm.slice",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bm.unet",
         "ts": 10, "dur": 30},
        {"ph": "X", "cat": "user_annotation", "name": "bm.mica",
         "ts": 50, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0,
         "dur": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernelEx",
         "ts": 20, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 30, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 55, "dur": 1, "args": {"correlation": 4}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 15, "dur": 20,
         "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 20,
         "args": {"correlation": 2}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 50,
         "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60, "dur": 10,
         "args": {"correlation": 4}},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]
    return ev


def test_parse_and_reductions():
    tr = trace.parse(_events())
    assert tr.slice == (0, 100)
    assert [n for n, _, _ in tr.ranges] == ["bm.slice", "bm.unet", "bm.mica"]
    assert len(tr.device) == 4 and len(tr.launches) == 3
    rec = record.Record(cell={}, window={}, setup_s=0.0, work={},
                        trace=tr, slice_faces=2, device_trace=tr,
                        device_faces=2)
    # busy: [15, 45] ∪ [50, 55] ∪ [60, 70] = 45 us of 100
    assert rec.busy_s == pytest.approx(45e-6)
    assert rec.slice_s == pytest.approx(100e-6)
    assert rec.launches_in("bm.unet") == 2
    assert rec.launches_in("bm.mica") == 1
    # k1, k2 and the copy were issued inside the UNet range
    assert rec.device_s_under("bm.unet") == pytest.approx(45e-6)
    assert rec.device_s_under("bm.mica") == pytest.approx(10e-6)
    b = record.breakdown(rec)
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    assert len(b["device_ops"]) == 3
    # gaps: [0, 15], [45, 50] and [70, 100] with only bm.slice open, and
    # [55, 60] inside bm.mica
    assert b["idle_gaps"][0] == ["bm.slice", pytest.approx(30e-6)]
    assert b["idle_gaps"][1] == ["bm.slice", pytest.approx(15e-6)]
    assert sorted(g[0] for g in b["idle_gaps"][2:]) == ["bm.mica",
                                                        "bm.slice"]


def test_device_slice_takes_the_host_clocks_wall():
    """A trace of the device's activity alone has no ranges: the busy time
    is every device operation's, the wall the host clock's."""
    ev = [e for e in _events() if e["cat"] != "user_annotation"]
    tr = trace.parse(ev, wall_s=250e-6)
    assert tr.ranges == [] and tr.wall_s == 250e-6
    assert tr.slice == (12, 70)
    rec = record.Record(cell={}, window={}, setup_s=0.0, work={},
                        device_trace=tr, device_faces=2)
    assert rec.busy_s == pytest.approx(45e-6)
    assert rec.slice_s == pytest.approx(250e-6)
    assert spec_reader("device.idle_share.serve")(rec) == pytest.approx(
        100 * (1 - 45 / 250))
    with pytest.raises(RuntimeError):
        trace.parse([], wall_s=1.0)


def spec_reader(name):
    from benchmark import spec
    return spec.reader(name)


def test_parse_needs_one_slice():
    ev = [e for e in _events() if e["name"] != "bm.slice"]
    with pytest.raises(RuntimeError):
        trace.parse(ev)


def test_readers_leave_out_what_they_cannot_read():
    from benchmark import spec
    rec = record.Record(cell={}, window={}, setup_s=1.0, work={})
    for name in ("device.idle_share.serve", "mfu.serve",
                 "kernels.roofline_share.serve", "unet.launches_per_call",
                 "unet.host_ms_per_call", "mica.device_ms_per_face",
                 "faces_per_s", "request_p90_ms"):
        assert spec.reader(name)(rec) is None
    assert spec.reader("setup_s")(rec) == 1.0
