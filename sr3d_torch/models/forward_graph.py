"""A module's forward replayed as a CUDA graph, one graph per input
signature.

A serving UNet forward enqueues ~460 kernels, each through a Python
wrapper, and on the H100 the host takes longer to launch them than the
device to run them.  Replayed as a CUDA graph the forward is one launch:
the same kernels, in the same order, on the same data, so its output is
the eager forward's bit for bit.  ``ForwardGraphs`` keeps those graphs
for one module, and a module whose forward may be graphed runs it
through ``ForwardGraphs.run``, the one place that decides how a call runs.

A call runs eagerly where the module says so (``run(eager=True)``: the
UNet's dropout drawn, ArcFace in train mode) or where ``signature``
finds it may not replay a graph: an input off CUDA, grad enabled, a
collective inside the forward (a layout with axes, a tensor-parallel
``Conv2d`` or ``Linear`` in the module), or another capture underway.
Otherwise its input signature is each input's shape, stride, dtype and
device with the module's static arguments, and for each signature it
holds at most one graph, made in three steps:

* the signature's first call runs eagerly: it fills the weight caches
  (``ops.quant.Versioned``: the packed int8 weights, the static scales),
  the kernels' attributes and their plans;
* the second captures the forward on a side stream, then replays it;
* later calls copy their inputs into the graph's static buffers, replay,
  and return a clone of its output, never a view of the graph's pool.

Each call counts in ``calls`` by how it ran, and runs inside the
module's span, whose ``graph`` attribute says the same.

A graph is held against every parameter the forward sees at call time
(those ``functional_call`` swaps in too): each one's object, storage and
version, as ``Versioned`` keys its values.  An in-place write, a
``load_state_dict``, an optimizer or EMA step, ``.to()`` or other tensors
give a new signature, whose first call runs eagerly and replaces the
graph of that input signature, so graphs never pile up.  Parameters that
are inference tensors have no version: such calls run eagerly.  A graph
keeps what it reads alive: the parameters (through the key) and the
values of the module's ``Versioned`` caches at its capture, which a
recompute for other weights would otherwise free.

The kernel wrappers' launch counts (``kernels.launch_counts()``) advance
on each replay by what the captured forward launched, and not on the
capture itself, so a replayed forward counts as the eager one does.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from ..kernels import WRAPPERS, launch_counts
from ..ops.quant import Versioned
from ..parallel import layout
from ..utils.profiling import annotate
from .layers import Conv2d, Linear


class _Graph:
    """One input signature's graph: the parameters' key, and once
    captured the graph, its static inputs and output, what it keeps
    alive and the launches it counts."""

    __slots__ = ("params", "graph", "inputs", "out", "keep", "launches")

    def __init__(self, params: list):
        self.params = params
        self.graph = None


class ForwardGraphs:
    """The CUDA graphs of ``module``'s forward (see the module's
    docstring).  ``run`` runs a call; ``lookup`` says how, ``capture``
    and ``replay`` run it."""

    def __init__(self, module: nn.Module):
        mods = tuple(module.modules())
        self._slots = [(m._parameters, n) for m in mods for n in m._parameters]
        self._caches = [v for m in mods
                        for v in vars(m).values() if isinstance(v, Versioned)]
        self._tp_layers = tuple(m for m in mods
                                if isinstance(m, (Conv2d, Linear)))
        self._graphs: dict[tuple, _Graph] = {}
        self._stream: torch.cuda.Stream | None = None
        self.calls = dict.fromkeys(("eager", "capture", "replay"), 0)

    def run(self, fn: Callable[..., torch.Tensor],
            inputs: Sequence[torch.Tensor], *, statics: tuple = (),
            eager: bool = False, span: str, **attrs) -> torch.Tensor:
        """``fn(*inputs)``, eagerly, captured or replayed, inside a
        ``span`` span with ``attrs`` and ``graph`` = how it ran.
        ``statics``: the other arguments ``fn`` closes over that change
        what it computes; ``eager``: the module's own reason to run
        eagerly."""
        key = None if eager else self.signature(inputs, statics)
        mode, g = ("eager", None) if key is None else self.lookup(key)
        self.calls[mode] += 1
        with annotate(span, graph=mode, **attrs):
            if mode == "replay":
                return self.replay(g, inputs)
            if mode == "capture":
                return self.capture(g, fn, inputs)
            return fn(*inputs)

    def signature(self, inputs: Sequence[torch.Tensor],
                  statics: tuple) -> tuple | None:
        """The input signature under which a call may replay a graph, or
        None where it runs eagerly (see the module's docstring)."""
        if not (all(t.is_cuda for t in inputs)
                and not torch.is_grad_enabled()
                and not layout.current().axes()
                and all(m.tp is None for m in self._tp_layers)
                and not torch.cuda.is_current_stream_capturing()):
            return None
        return tuple((t.shape, t.stride(), t.dtype, t.device)
                     for t in inputs) + statics

    def held(self) -> int:
        """How many graphs are held."""
        return sum(g.graph is not None for g in self._graphs.values())

    def lookup(self, key: tuple) -> tuple[str, _Graph | None]:
        """``("replay" | "capture" | "eager", graph)`` for a call under
        input signature ``key``; an eager call under new parameters starts
        the signature over."""
        # every parameter the forward sees now
        params = [p for d, n in self._slots if (p := d[n]) is not None]
        g = self._graphs.get(key)
        if g is not None and Versioned.same(g.params, params):
            return ("capture" if g.graph is None else "replay"), g
        if any(p.is_inference() for p in params):
            return "eager", None
        self._graphs[key] = _Graph(Versioned.key(params))
        return "eager", None

    def capture(self, g: _Graph, fn: Callable[..., torch.Tensor],
                inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        """Capture ``fn`` on static copies of ``inputs`` into ``g``, then
        replay it on ``inputs``."""
        dev = inputs[0].device
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        g.inputs = [torch.empty_like(t) for t in inputs]
        graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(dev))
        # not torch.cuda.graph: it collects garbage and empties the cache
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                g.out = fn(*g.inputs)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        after = launch_counts()
        g.launches = {k: after[k] - n for k, n in before.items()
                      if after[k] != n}
        for k, n in before.items():
            WRAPPERS[k].launches = n
        g.keep = [v._value for v in self._caches]
        g.graph = graph
        return self.replay(g, inputs)

    def replay(self, g: _Graph, inputs: Sequence[torch.Tensor]
               ) -> torch.Tensor:
        for static, t in zip(g.inputs, inputs):
            static.copy_(t)
        g.graph.replay()
        for k, n in g.launches.items():
            WRAPPERS[k].launches += n
        return g.out.clone()
