"""The MICA branch without waits on the device, on the CPU: ArcFace's
forward as a CUDA graph (``IResNet.forward``, ``models/forward_graph.py``)
— the rule that decides which calls may replay one, the bookkeeping
around capture and replay, and the ``sr3d.arcface`` span in a served
request — and the hand-off's interpolation matrices and FLAME's joint-tree
indices kept on the device (``ops/image.py``, ``models/lbs.py``).
Capturing, replaying and the device copies themselves need the card
(``tests/test_torch_cuda.py``): here ``capture`` and ``replay`` are stood
in for by the eager forward, and the meta device stands in for the card."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sr3d_torch.config import get_cfg_defaults, update_cfg
from sr3d_torch.models import lbs
from sr3d_torch.models.arcface import BatchNorm, IResNet
from sr3d_torch.models.forward_graph import ForwardGraphs
from sr3d_torch.ops import image
from sr3d_torch.parallel import layout
from sr3d_torch.parallel.mesh import Axis
from sr3d_torch.serve import Predictor
from sr3d_torch.utils import profiling

torch.set_num_threads(1)


def _net(seed=0):
    """One block a stage, on 16² blobs (1² after the four stages)."""
    torch.manual_seed(seed)
    return IResNet(layers=(1, 1, 1, 1), dtype=torch.float32,
                   fc_scale=1).eval()


def _blob(seed=1, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, 16, 16, generator=g) * 2 - 1


def _on_card(x):
    """What the rule reads of a CUDA input, for an input on the CPU."""
    return SimpleNamespace(is_cuda=True, shape=x.shape, stride=x.stride,
                           dtype=x.dtype, device=torch.device("cuda"))


@pytest.mark.parametrize("bypass", [None, "cpu", "grad", "train",
                                    "one_batchnorm", "layout",
                                    "tensor_parallel", "capturing"])
def test_the_rule_keeps_each_bypass_eager(bypass, monkeypatch):
    """A CUDA input, grad off, every submodule in eval mode, no collective
    inside the forward and no capture underway: a signature.  Any one of
    them otherwise: eager."""
    net, x = _net(), _blob()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: bypass == "capturing")
    if bypass == "train":
        net.train()                 # stage 4 and the head
    if bypass == "one_batchnorm":
        net.layer1.block0.bn2.train()
    if bypass == "tensor_parallel":
        net.fc.tp = Axis("model", None, 0, 2)
    lay = (layout.Layout(batch=Axis("data", None, 0, 2))
           if bypass == "layout" else layout.Layout())
    with torch.set_grad_enabled(bypass == "grad"), layout.use(lay):
        key = net._graph_key(x if bypass == "cpu" else _on_card(x))
    if bypass is None:
        assert key == (x.shape, x.stride(), x.dtype, torch.device("cuda"))
    else:
        assert key is None


@pytest.fixture
def graphed(monkeypatch):
    """The forward's graph path on the CPU: every call has a signature
    (its shape), a capture runs the eager forward and keeps it, a replay
    runs what was kept.  Returns the modes of the calls, in order."""
    modes = []

    def capture(self, g, fn, inputs):
        modes.append("capture")
        g.graph, g.out = fn, None
        return fn(*inputs)

    def replay(self, g, inputs):
        modes.append("replay")
        return g.graph(*inputs)

    monkeypatch.setattr(IResNet, "_graph_key", lambda self, x: (x.shape,))
    monkeypatch.setattr(ForwardGraphs, "capture", capture)
    monkeypatch.setattr(ForwardGraphs, "replay", replay)
    return modes


def test_a_signature_captures_then_replays_and_follows_the_weights(graphed):
    """Eager, capture, replay, each the eager forward and counted once; a
    new set of running statistics, written in place, keeps the signature
    (the graph reads the buffers); an in-place write of a parameter starts
    it over."""
    net, x = _net(), _blob()
    ran = (IResNet.eager_calls, IResNet.graph_captures, IResNet.graph_replays)

    def calls(n):
        before = len(graphed)
        with torch.no_grad():
            outs = [net(x) for _ in range(n)]
        return graphed[before:], outs

    modes, first = calls(3)
    assert modes == ["capture", "replay"]
    assert (IResNet.eager_calls - ran[0], IResNet.graph_captures - ran[1],
            IResNet.graph_replays - ran[2]) == (1, 1, 1)
    assert all(torch.equal(o, first[0]) for o in first)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.mean.add_(0.1)
    modes, outs = calls(1)
    assert modes == ["replay"]
    with torch.no_grad():
        assert torch.equal(outs[0], net._forward(x))
    assert not torch.equal(outs[0], first[0])
    with torch.no_grad():
        net.fc.weight.add_(0.01)    # an optimizer step writes in place
    modes, outs = calls(3)
    assert modes == ["capture", "replay"]
    with torch.no_grad():
        want = net._forward(x)
    assert all(torch.equal(o, want) for o in outs)
    assert len(net._graphs._graphs) == 1


def test_a_served_request_nests_the_arcface_span_in_the_mica_branch():
    """On the CPU each chunk's ArcFace forward runs eagerly, as its
    ``sr3d.arcface`` span says, inside that chunk's ``sr3d.mica``."""
    cfg = update_cfg(get_cfg_defaults(), str(
        Path(__file__).resolve().parents[1] / "configs"
        / "tiny_8_16_model2.yml"))
    cfg.tpu.compute_dtype = "float32"
    cfg.mica.model.arcface_layers = [1, 1, 1, 1]
    cfg.sr.model.diffusion.sampler = "ddim"
    cfg.sr.model.diffusion.ddim_steps = 2
    p = Predictor.from_config(cfg, init_seed=3, batch_size=2, device="cpu")
    lr = np.random.RandomState(0).randint(0, 255, (3, 8, 8, 3), np.uint8)
    profiling.take_spans()
    profiling.spans_on()
    try:
        p.predict(lr)
    finally:
        profiling.spans_off()
    spans = profiling.take_spans()
    by_id = {s.id: s for s in spans}
    arc = [s for s in spans if s.name == "sr3d.arcface"]
    mica = [s for s in spans if s.name == "sr3d.mica"]
    assert len(arc) == len(mica) == 2                # 3 faces, chunks of 2
    assert [s.attrs for s in arc] == [{"graph": "eager"}] * 2
    for s in arc:
        up = by_id[s.parent]
        assert up.name == "sr3d.mica"
        assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns


def _old_resize(x, height, width, method, antialias):
    """``resize`` as it was: each matrix copied from host memory at every
    call."""
    B, H, W, C = x.shape
    x = x.float()
    if H != height:
        wh = torch.from_numpy(image._weight_matrix(H, height, method,
                                                   antialias))
        x = torch.einsum("oh,bhwc->bowc", wh.to(x.device), x)
    if W != width:
        ww = torch.from_numpy(image._weight_matrix(W, width, method,
                                                   antialias))
        x = torch.einsum("pw,bowc->bopc", ww.to(x.device), x)
    return x


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("antialias", [False, True])
@pytest.mark.parametrize("size", [(24, 16), (16, 9), (9, 24)])
def test_resize_is_bit_equal_to_the_copying_path(method, antialias, size,
                                                 monkeypatch):
    """Up and down, along either axis and both: the CPU path, and the
    device path's cached matrices (here on the CPU), give the old path's
    values bit for bit."""
    x = torch.rand(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    want = _old_resize(x, *size, method, antialias)
    assert torch.equal(image.resize(x, *size, method, antialias), want)
    monkeypatch.setattr(image, "_weights", lambda *k: image._on_device(*k))
    assert torch.equal(image.resize(x, *size, method, antialias), want)


def test_the_device_cache_is_keyed_by_device_and_never_filled_on_the_cpu():
    image._on_device.cache_clear()
    image.resize(torch.rand(1, 16, 16, 3), 32, 32, "bicubic")
    cpu = image._weights(16, 32, "bicubic", False, torch.device("cpu"))
    assert image._on_device.cache_info().currsize == 0
    meta = image._weights(16, 32, "bicubic", False, torch.device("meta"))
    assert meta.device.type == "meta" and meta.shape == cpu.shape
    assert meta is image._weights(16, 32, "bicubic", False,
                                  torch.device("meta"))
    assert image._on_device.cache_info().currsize == 1
    # the same matrix on another device is another entry
    on_cpu = image._on_device(16, 32, "bicubic", False, torch.device("cpu"))
    assert torch.equal(on_cpu, cpu)
    assert image._on_device.cache_info().currsize == 2
    # FLAME's joint-tree index: one copy a device, the list's values
    joints = torch.rand(2, 5, 3)
    idx = lbs.index_on((0, 1, 1, 1), joints.device)
    assert idx is lbs.index_on((0, 1, 1, 1), torch.device("cpu"))
    assert torch.equal(joints[:, idx], joints[:, [0, 1, 1, 1]])
