"""The UNet forward as a CUDA graph (``SR3UNet.forward``,
``models/forward_graph.py``), on the CPU: the rule that decides which
calls may replay a graph, over each condition that keeps a call eager;
the signature a graph is held against, over every kind of weight change a
serving or training run makes (the cases of ``test_torch_int8_cache.py``);
the CPU forward, eager and unchanged; and the ``graph`` attribute of the
``sr3d.unet`` span.  Capturing and replaying need the card
(``tests/test_torch_cuda.py``): here ``capture`` and ``replay`` are
stood in for by the eager forward, so the bookkeeping around them runs."""

from types import SimpleNamespace

import pytest
import torch
from torch.func import functional_call

from sr3d_torch.models.ddpm_unet import DDPMUNet
from sr3d_torch.models.forward_graph import ForwardGraphs
from sr3d_torch.models.sr3_unet import SR3UNet
from sr3d_torch.parallel import layout
from sr3d_torch.parallel.mesh import Axis
from sr3d_torch.utils import profiling

torch.set_num_threads(1)

KW = dict(inner_channel=16, norm_groups=8, channel_mults=(1, 2),
          attn_res=(8,), res_blocks=1, image_size=16, dtype=torch.float32)


def _unet(seed=0, cls=SR3UNet, **kw):
    torch.manual_seed(seed)
    return cls(**dict(KW, **kw)).eval()


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, 6, 16, 16, generator=g), torch.rand(2, 1,
                                                               generator=g)


def _on_card(x):
    """What the rule reads of a CUDA input, for an input on the CPU."""
    return SimpleNamespace(is_cuda=True, shape=x.shape, stride=x.stride,
                           dtype=x.dtype, device=torch.device("cuda"))


@pytest.fixture
def capturing(monkeypatch):
    """The current stream's capture state, as the rule reads it."""
    state = {"on": False}
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: state["on"])
    return state


@pytest.mark.parametrize("bypass", [None, "cpu", "grad", "dropout",
                                    "layout", "tensor_parallel",
                                    "capturing"])
def test_the_rule_keeps_each_bypass_eager(bypass, capturing):
    """A CUDA input, grad off, no dropout drawn, no collective inside the
    forward and no capture underway: a signature.  Any one of them
    otherwise: eager."""
    unet = _unet(dropout=0.1)
    x, t = _inputs()
    xin = x if bypass == "cpu" else _on_card(x)
    deterministic = True
    grad = bypass == "grad"
    if bypass == "dropout":
        unet.train()
        deterministic = False
    if bypass == "tensor_parallel":
        unet.conv_in.tp = Axis("model", None, 0, 2)
    capturing["on"] = bypass == "capturing"
    lay = (layout.Layout(batch=Axis("data", None, 0, 2))
           if bypass == "layout" else layout.Layout())
    with torch.set_grad_enabled(grad), layout.use(lay):
        key = unet._graph_key(xin, t, deterministic, True)
    if bypass is not None:
        assert key is None
        return
    assert key == (x.shape, x.stride(), x.dtype, torch.device("cuda"),
                   t.shape, t.stride(), t.dtype, True)
    # train mode without dropout drawn, and axes of one rank, keep it
    unet.train()
    with torch.no_grad(), layout.use(layout.Layout(
            batch=Axis("data", None, 0, 1))):
        assert unet._graph_key(_on_card(x), t, True, False) is not None


@pytest.fixture
def graphed(monkeypatch):
    """The forward's graph path on the CPU: every call has a signature
    (its shapes), a capture runs the eager forward and keeps it, a replay
    runs what was kept.  Returns the modes of the calls, in order."""
    modes = []

    def key(self, x, time, deterministic, quant):
        return (x.shape, time.shape, quant)

    def capture(self, g, fn, inputs):
        modes.append("capture")
        g.graph, g.out = fn, None
        return fn(*inputs)

    def replay(self, g, inputs):
        modes.append("replay")
        return g.graph(*inputs)

    monkeypatch.setattr(SR3UNet, "_graph_key", key)
    monkeypatch.setattr(ForwardGraphs, "capture", capture)
    monkeypatch.setattr(ForwardGraphs, "replay", replay)
    return modes


def _calls(unet, n, modes, call=None):
    """``n`` forwards; the modes they ran in and their outputs."""
    x, t = _inputs()
    call = call or (lambda: unet(x, t))
    eager = SR3UNet.eager_calls
    outs, got = [], []
    for _ in range(n):
        before = len(modes)
        with torch.no_grad():
            outs.append(call())
        got.append(modes[-1] if len(modes) > before else "eager")
    assert SR3UNet.eager_calls - eager == got.count("eager")
    return got, outs


def _add(unet):
    with torch.no_grad():
        unet.conv_in.weight.add_(0.01)


@pytest.mark.parametrize("change", [None, "load_state_dict", "in_place",
                                    "to", "functional_call"])
def test_the_signature_follows_every_weight_change(change, graphed):
    """A signature runs eagerly, captures, then replays, bit-equal; a
    change of the weights it was captured on starts it over (eagerly,
    replacing its graph: at most one is held); nothing else does."""
    unet, (x, t) = _unet(), _inputs()
    modes, outs = _calls(unet, 3, graphed)
    assert modes == ["eager", "capture", "replay"]
    assert all(torch.equal(o, outs[0]) for o in outs)
    held = unet._graphs
    if change is None:
        unet.state_dict()
        unet.train().eval()
        _unet(seed=5).load_state_dict(unet.state_dict())
        assert _calls(unet, 2, graphed)[0] == ["replay", "replay"]
        return
    if change == "functional_call":
        ema = {k: v.detach().clone() + 0.01
               for k, v in unet.named_parameters()}
        modes, outs = _calls(unet, 3, graphed, lambda: functional_call(
            unet, ema, (x, t)))
        assert modes == ["eager", "capture", "replay"]
        with torch.no_grad():
            want = functional_call(unet, ema, (x, t))
        # the EMA's in-place update is a new signature too
        torch._foreach_copy_(list(ema.values()),
                             [v * 0.5 for v in ema.values()])
        assert _calls(unet, 1, graphed, lambda: functional_call(
            unet, ema, (x, t)))[0] == ["eager"]
    else:
        {"load_state_dict": lambda: unet.load_state_dict(
            _unet(seed=5).state_dict()),
         "in_place": lambda: _add(unet),
         "to": lambda: unet.to(torch.float64).to(torch.float32)}[change]()
        modes, outs = _calls(unet, 3, graphed)
        assert modes == ["eager", "capture", "replay"]
        with torch.no_grad():
            want = unet._forward(x, t, None, True, None, False)
    assert all(torch.equal(o, want) for o in outs)
    assert held.held() <= 1 and len(held._graphs) == 1


def test_inference_tensor_parameters_run_eagerly(graphed):
    """Parameters made under ``inference_mode`` keep no version: every
    call runs eagerly and no signature is kept."""
    with torch.inference_mode():
        unet = _unet()
        modes, _ = _calls(unet, 3, graphed)
    assert modes == ["eager"] * 3
    assert unet._graphs._graphs == {}


@pytest.mark.parametrize("cls", [SR3UNet, DDPMUNet])
def test_the_cpu_forward_stays_eager_and_bit_equal(cls):
    unet = _unet(cls=cls)
    x, t = _inputs()
    if cls is DDPMUNet:
        t = torch.tensor([3, 17])
    eager, captures, replays = (SR3UNet.eager_calls, SR3UNet.graph_captures,
                                SR3UNet.graph_replays)
    with torch.no_grad():
        outs = [unet(x, t) for _ in range(3)]
        want = unet._forward(x, t, None, True, None, False)
    assert all(torch.equal(o, want) for o in outs)
    assert SR3UNet.eager_calls == eager + 3
    assert (SR3UNet.graph_captures, SR3UNet.graph_replays) == (captures,
                                                               replays)
    assert unet._graphs._graphs == {}


def test_the_unet_span_says_how_the_forward_ran(graphed):
    unet = _unet()
    profiling.take_spans()
    profiling.spans_on()
    try:
        _calls(unet, 3, graphed)
    finally:
        profiling.spans_off()
    spans = profiling.take_spans()
    assert [(s.name, s.attrs) for s in spans] == [
        ("sr3d.unet", {"graph": m}) for m in ("eager", "capture", "replay")]
