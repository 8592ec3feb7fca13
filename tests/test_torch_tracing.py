"""The program's own spans (``sr3d_torch/utils/profiling.py``) on the CPU:
the tree one ``Predictor.predict`` records under each sampler, the request
ids, the switch, ``trace(DIR)``'s ``spans.json``, and the mapping of spans
onto a profiler trace's clock through the marker launches."""

import json
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults, update_cfg
from sr3d_torch.models.ddpm_unet import DDPMUNet
from sr3d_torch.serve import Predictor
from sr3d_torch.utils import profiling

torch.set_num_threads(1)

CONFIG = str(Path(__file__).resolve().parents[1] / "configs"
             / "tiny_8_16_model2.yml")
STEPS = 4       # ddim and dpm++; the ancestral loop takes the T = 20 steps
LR = np.random.RandomState(0).randint(0, 255, (3, 8, 8, 3), np.uint8)


@pytest.fixture(autouse=True)
def _clean():
    profiling.spans_off()
    profiling.take_spans()
    yield
    profiling.spans_off()
    profiling.take_spans()


def _predictor(sampler: str) -> Predictor:
    cfg = update_cfg(get_cfg_defaults(), CONFIG)
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.sampler = sampler
    cfg.sr.model.diffusion.ddim_steps = STEPS
    return Predictor.from_config(cfg, init_seed=3, batch_size=2,
                                 device="cpu")


@pytest.fixture(scope="module")
def ddim():
    return _predictor("ddim")


def _recorded(p: Predictor, lr=LR) -> tuple[dict, list]:
    profiling.spans_on()
    out = p.predict(lr)
    profiling.spans_off()
    return out, profiling.take_spans()


@pytest.mark.parametrize("sampler,steps", [("ddim", STEPS),
                                           ("dpm++", STEPS),
                                           ("ddpm", 20)])
def test_predict_records_one_request_tree(sampler, steps, ddim):
    """One request, its prep and fetch under it, one step a sampler step
    with exactly one UNet forward under it, one MICA branch a chunk with
    its ArcFace forward under it; every span carries the request's id,
    rank 0 and its parent."""
    p = ddim if sampler == "ddim" else _predictor(sampler)
    _, spans = _recorded(p)
    count = Counter(s.name for s in spans)
    chunks = 2                                  # 3 faces in chunks of 2
    assert count == {"sr3d.request": 1, "sr3d.prep": 1, "sr3d.fetch": 1,
                     "sr3d.step": chunks * steps,
                     "sr3d.unet": chunks * steps, "sr3d.mica": chunks,
                     "sr3d.arcface": chunks}
    by_id = {s.id: s for s in spans}
    (req,) = [s for s in spans if s.name == "sr3d.request"]
    assert req.parent is None and req.attrs == {"faces": 3, "chunks": 2}
    assert {s.request for s in spans} == {req.request}
    assert {s.rank for s in spans} == {0}
    for s in spans:
        assert req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns
        want = {"sr3d.request": None, "sr3d.unet": "sr3d.step",
                "sr3d.arcface": "sr3d.mica"}.get(s.name, "sr3d.request")
        assert (by_id[s.parent].name if s.parent is not None
                else None) == want, s.name
    steps_seen = [s for s in spans if s.name == "sr3d.step"]
    assert sorted(s.attrs["k"] for s in steps_seen) == sorted(
        list(range(steps)) * chunks)
    for st in steps_seen:
        kids = [s for s in spans if s.parent == st.id]
        assert [k.name for k in kids] == ["sr3d.unet"]
    assert not any(s.marks for s in spans)       # no profiler, no markers


def test_a_second_request_gets_a_new_id(ddim):
    _, a = _recorded(ddim)
    _, b = _recorded(ddim, LR[:1])
    ra, rb = {s.request for s in a}, {s.request for s in b}
    assert len(ra) == len(rb) == 1 and ra != rb
    (req,) = [s for s in b if s.name == "sr3d.request"]
    assert req.attrs == {"faces": 1, "chunks": 1}


def test_spans_off_record_nothing_and_change_no_output(ddim):
    on, spans = _recorded(ddim)
    assert spans
    off = ddim.predict(LR)
    assert profiling.take_spans() == []
    assert profiling.annotate("sr3d.unet") is profiling.annotate("x", k=1)
    for k in on:
        assert on[k].dtype == off[k].dtype
        np.testing.assert_array_equal(on[k], off[k])


def test_the_ddpm_unet_family_records_its_forward():
    net = DDPMUNet(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
                   attn_res=(8,), res_blocks=1, image_size=16,
                   dtype=torch.float32).eval()
    profiling.spans_on()
    with torch.no_grad():
        net(torch.zeros(1, 6, 16, 16), torch.zeros(1, dtype=torch.long))
    assert [s.name for s in profiling.take_spans()] == ["sr3d.unet"]


def test_a_profiler_records_spans_and_their_ranges(tmp_path, ddim):
    """Under a profiler the spans record with the switch off, each also a
    range of the trace; ``trace(DIR)`` writes them to ``spans.json`` (on
    the perf_counter clock: the CPU has no marker kernel)."""
    with profiling.trace(str(tmp_path / "t")):
        ddim.predict(LR[:2])
    assert profiling.take_spans() == []          # trace took them
    events = json.loads((tmp_path / "t" / "trace.json").read_text())
    ranges = Counter(e["name"] for e in events["traceEvents"]
                     if e.get("cat") == "user_annotation")
    doc = json.loads((tmp_path / "t" / "spans.json").read_text())
    spans = doc["traceEvents"]
    assert Counter(e["name"] for e in spans) == {
        "sr3d.request": 1, "sr3d.prep": 1, "sr3d.fetch": 1,
        "sr3d.step": STEPS, "sr3d.unet": STEPS, "sr3d.mica": 1,
        "sr3d.arcface": 1}
    for name, n in Counter(e["name"] for e in spans).items():
        assert ranges[name] == n
    assert doc["otherData"] == {"clock": "perf_counter", "offset_us": 0.0,
                                "error_us": None}
    req = [e for e in spans if e["name"] == "sr3d.request"][0]
    assert req["args"]["faces"] == 2 and req["args"]["parent"] is None
    assert all(e["args"]["request"] == req["args"]["request"]
               for e in spans)


def _span(marks):
    s = profiling.Span("sr3d.request", {})
    s.marks = marks
    return s


def _kineto(launch_us):
    """A Kineto trace's events: one marker launch (API call + kernel, by
    correlation) at each time, and another kernel in between."""
    ev = []
    for i, t in enumerate(launch_us):
        ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": t, "dur": 40.0, "args": {"correlation": 2 * i}},
               {"ph": "X", "cat": "kernel", "ts": t + 50.0, "dur": 1.0,
                "name": "at::cuda::(anonymous namespace)::spin_kernel(long)",
                "args": {"correlation": 2 * i}},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": t + 9.0, "dur": 4.0, "args": {"correlation": 2 * i + 1}},
               {"ph": "X", "cat": "kernel", "ts": t + 60.0, "dur": 9.0,
                "name": "gemm", "args": {"correlation": 2 * i + 1}}]
    return ev


def test_clock_offset_on_a_synthetic_kineto_trace():
    """Two requests of one slice, after a request of another: the marker
    launches are found by correlation, matched to the run of marks that
    agrees, and the offset lies within the error given."""
    offset = 1.7e12                     # trace µs at perf_counter zero
    delays = [12.0, 18.0, 9.0, 15.0]    # clock read → API call start, µs
    # marks (before, after) in ns: an earlier request, then the slice's two
    starts = [1_000_000_000, 1_600_000_000, 2_500_000_000, 2_650_000_000,
              3_700_000_000, 3_750_000_000]
    marks = [(b, b + 20_000) for b in starts]     # 20 µs a launch
    spans = [_span(marks[i:i + 2]) for i in range(0, 6, 2)]
    launches = [marks[2 + i][0] / 1e3 + offset + d
                for i, d in enumerate(delays)]
    found = profiling.marker_launches(_kineto(launches))
    assert found == launches
    off, err = profiling.clock_offset(found, spans)
    # the marks allow offset + [max(delays) − 20, min(delays)]
    assert off - offset == pytest.approx((18.0 - 20.0 + 9.0) / 2)
    assert err == pytest.approx((9.0 - (18.0 - 20.0)) / 2)
    assert abs(off - offset) <= err
    # markers that match no run of marks, or more markers than marks
    skewed = [t + 5000.0 * i for i, t in enumerate(launches)]
    assert profiling.clock_offset(skewed, spans) is None
    assert profiling.clock_offset(launches * 2, spans) is None
    assert profiling.clock_offset([], spans) is None
