"""A forward as a CUDA graph (``models/forward_graph.py``), on the CPU,
for both modules that run theirs through ``ForwardGraphs.run``: the UNet
(``SR3UNet``, ``DDPMUNet``) and ArcFace (``IResNet``).  The rule that
decides which calls may replay a graph, over each condition that keeps a
call eager; the signature a graph is held against, over every kind of
weight change a serving or training run makes; the CPU forward, eager and
unchanged; the span that says how a call ran, and ArcFace's inside the
MICA branch's.  Capturing and replaying need the card
(``tests/test_torch_cuda.py``): here the rule sees the inputs as on the
card, and ``capture`` and ``replay`` are stood in for by the eager
forward, so the bookkeeping around them runs."""

import copy
import functools
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.func import functional_call

from sr3d_torch.config import get_cfg_defaults, update_cfg
from sr3d_torch.models.arcface import BatchNorm, IResNet
from sr3d_torch.models.ddpm_unet import DDPMUNet
from sr3d_torch.models.forward_graph import ForwardGraphs
from sr3d_torch.models.sr3_unet import SR3UNet
from sr3d_torch.parallel import layout
from sr3d_torch.parallel.mesh import Axis
from sr3d_torch.serve import Predictor
from sr3d_torch.utils import profiling

torch.set_num_threads(1)

KW = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
          attn_res=(8,), res_blocks=1, image_size=16, dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _arcface(seed):
    """Built once a seed; ``_net`` hands out copies."""
    torch.manual_seed(seed)
    with torch.inference_mode(False):
        return IResNet(layers=(1, 1, 1, 1), dtype=torch.float32,
                       fc_scale=1)


def _net(cls, seed=0, **kw):
    """A tiny eval-mode ``cls``: the UNet on 16² inputs, or ArcFace with
    one block a stage on 16² blobs (1² after the four stages)."""
    if cls is IResNet:
        return copy.deepcopy(_arcface(seed)).eval()
    torch.manual_seed(seed)
    return cls(**dict(KW, **kw)).eval()


def _inputs(net, seed=1):
    g = torch.Generator().manual_seed(seed)
    if isinstance(net, IResNet):
        return (torch.rand(2, 3, 16, 16, generator=g) * 2 - 1,)
    x, t = torch.randn(2, 6, 16, 16, generator=g), torch.rand(2, 1,
                                                              generator=g)
    return x, torch.tensor([3, 17]) if isinstance(net, DDPMUNet) else t


def _forward(net, xs):
    """The module's own forward, past ``ForwardGraphs``."""
    if isinstance(net, IResNet):
        return net._forward(*xs)
    return net._forward(*xs, None, True, None, False)


def _on_card(t):
    """What the rule reads of a CUDA input, for an input on the CPU."""
    return SimpleNamespace(is_cuda=True, shape=t.shape, stride=t.stride,
                           dtype=t.dtype, device=torch.device("cuda"))


@pytest.fixture
def graphed(monkeypatch):
    """The graph path on the CPU: the rule sees every input as on the card
    (unless ``card`` is unset) and a capture underway where ``capturing``
    is set; a capture runs the eager forward and keeps it, a replay runs
    what was kept."""
    state = {"card": True, "capturing": False}
    rule = ForwardGraphs.signature

    def signature(self, inputs, statics):
        return rule(self, [_on_card(t) for t in inputs] if state["card"]
                    else inputs, statics)

    def capture(self, g, fn, inputs):
        g.graph, g.out = fn, None
        return fn(*inputs)

    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["capturing"])
    monkeypatch.setattr(ForwardGraphs, "signature", signature)
    monkeypatch.setattr(ForwardGraphs, "capture", capture)
    monkeypatch.setattr(ForwardGraphs, "replay",
                        lambda self, g, inputs: g.graph(*inputs))
    return state


def _calls(net, n, call):
    """``n`` calls of ``call``; how each ran (``ForwardGraphs.calls``, one
    count a call) and their outputs."""
    modes, outs = [], []
    for _ in range(n):
        before = dict(net._graphs.calls)
        outs.append(call())
        ran = [m for m, k in net._graphs.calls.items() if k != before[m]]
        assert [net._graphs.calls[m] - before[m] for m in ran] == [1]
        modes += ran
    return modes, outs


@pytest.mark.parametrize("cls,bypass", [
    (cls, bypass) for cls in (SR3UNet, IResNet)
    for bypass in (None, "cpu", "grad", "layout", "tensor_parallel",
                   "capturing")
] + [(SR3UNet, "dropout"), (IResNet, "train"), (IResNet, "one_batchnorm")])
def test_each_bypass_keeps_the_call_eager(cls, bypass, graphed):
    """On the card, grad off, no collective inside the forward (a layout
    with axes, a tensor-parallel layer), no capture underway, and neither
    the UNet's dropout drawn nor any ArcFace submodule in train mode: the
    call is eager, the first of its signature (the UNet in train mode
    without dropout drawn, under axes of one rank).  Any one of them
    otherwise: eager, and no signature kept.  The tensor-parallel layer
    sits on a one-rank model axis, so that the forward runs here: the
    rule reads that a layer is tensor-parallel, whatever the axis's
    size."""
    net = _net(cls, dropout=0.1) if cls is SR3UNet else _net(cls)
    xs, kw = _inputs(net), {}
    graphed["card"] = bypass != "cpu"
    graphed["capturing"] = bypass == "capturing"
    if bypass is None and cls is SR3UNet or bypass == "train":
        net.train()                     # ArcFace: stage 4 and the head
    if bypass == "dropout":
        net.train()
        kw = dict(deterministic=False,
                  generator=torch.Generator().manual_seed(0))
    if bypass == "one_batchnorm":
        net.layer1.block0.bn2.train()
    if bypass == "tensor_parallel":
        (net.fc if cls is IResNet else net.conv_in).tp = Axis(
            "model", None, 0, 1)
    lay = layout.Layout(batch=Axis("data", None, 0,
                                   2 if bypass == "layout" else 1))
    with torch.set_grad_enabled(bypass == "grad"), layout.use(lay):
        assert _calls(net, 1, lambda: net(*xs, **kw))[0] == ["eager"]
    statics = () if cls is IResNet else (False,)      # the UNet's quant
    assert list(net._graphs._graphs) == ([] if bypass else [tuple(
        (t.shape, t.stride(), t.dtype, torch.device("cuda")) for t in xs)
        + statics])


@pytest.mark.parametrize("cls,change", [
    (SR3UNet, change) for change in (None, "load_state_dict", "in_place",
                                     "to", "functional_call")
] + [(IResNet, "in_place"), (IResNet, "statistics")])
def test_the_signature_follows_every_weight_change(cls, change, graphed):
    """A signature runs eagerly, captures, then replays, each the eager
    forward; a change of the weights it was captured on starts it over
    (eagerly, replacing its graph: at most one is held); nothing else
    does, ArcFace's running statistics written in place included (the
    graph reads the buffers)."""
    net = _net(cls)
    xs = _inputs(net)
    call = lambda: net(*xs)                             # noqa: E731
    with torch.no_grad():
        modes, outs = _calls(net, 3, call)
    assert modes == ["eager", "capture", "replay"]
    assert all(torch.equal(o, outs[0]) for o in outs)
    again = ["eager", "capture", "replay"]
    if change is None:
        net.state_dict()
        net.train().eval()
        _net(cls, seed=5).load_state_dict(net.state_dict())
        again = ["replay"] * 3
    elif change == "statistics":
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, BatchNorm):
                    m.mean.add_(0.1)
        again = ["replay"] * 3
    elif change == "functional_call":
        ema = {k: v.detach().clone() + 0.01
               for k, v in net.named_parameters()}
        call = lambda: functional_call(net, ema, xs)    # noqa: E731
    else:
        with torch.no_grad():
            {"load_state_dict": lambda: net.load_state_dict(
                _net(cls, seed=5).state_dict()),
             "in_place": lambda: next(net.parameters()).add_(0.01),
             "to": lambda: net.to(torch.float64).to(torch.float32)
             }[change]()
    with torch.no_grad():
        modes, got = _calls(net, 3, call)
        graphed["card"] = False
        want = call()                   # eager: off the card
        graphed["card"] = True
    assert modes == again
    assert all(torch.equal(o, want) for o in got)
    if change not in (None, "to"):
        assert not torch.equal(want, outs[0])
    if change == "functional_call":
        # the EMA's in-place update is a new signature too
        torch._foreach_copy_(list(ema.values()),
                             [v * 0.5 for v in ema.values()])
        with torch.no_grad():
            assert _calls(net, 1, call)[0] == ["eager"]
    assert net._graphs.held() <= 1 and len(net._graphs._graphs) == 1


@pytest.mark.parametrize("cls", [SR3UNet, IResNet])
def test_inference_tensor_parameters_run_eagerly(cls, graphed):
    """Parameters made under ``inference_mode`` keep no version: every
    call runs eagerly and no signature is kept."""
    with torch.inference_mode():
        net = _net(cls)
        xs = _inputs(net)
        modes, _ = _calls(net, 3, lambda: net(*xs))
    assert modes == ["eager"] * 3
    assert net._graphs._graphs == {}


@pytest.mark.parametrize("cls", [SR3UNet, DDPMUNet, IResNet])
def test_the_cpu_forward_stays_eager_and_bit_equal(cls):
    net = _net(cls)
    xs = _inputs(net)
    with torch.no_grad():
        modes, outs = _calls(net, 3, lambda: net(*xs))
        want = _forward(net, xs)
    assert modes == ["eager"] * 3
    assert all(torch.equal(o, want) for o in outs)
    assert net._graphs._graphs == {}


@pytest.mark.parametrize("cls,span,attrs", [
    (SR3UNet, "sr3d.unet", {"levels": ("e16-e8", "mid", "d8-d16")}),
    (IResNet, "sr3d.arcface", {}),
])
def test_the_span_says_how_the_forward_ran(cls, span, attrs, graphed):
    net = _net(cls)
    xs = _inputs(net)
    profiling.take_spans()
    profiling.spans_on()
    try:
        with torch.no_grad():
            _calls(net, 3, lambda: net(*xs))
    finally:
        profiling.spans_off()
    assert [(s.name, s.attrs) for s in profiling.take_spans()] == [
        (span, {"graph": m, **attrs}) for m in ("eager", "capture", "replay")]


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
