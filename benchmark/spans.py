"""The benchmark's spans around the calls into the program's layers,
recorded from the benchmark's own files.

``Spans.range(name)`` is a ``record_function`` range (seen by the profiler
in the traced slice) that also notes its host-clock duration.
``Spans.hook(module, name)`` opens such a range in a forward pre-hook and
closes it in the forward hook, so every call of the module is a span; no
device synchronisation, so a span's host time is the time to enqueue the
module's work.  ``open``/``close`` split a range over two call sites (the
MICA branch opens at ArcFace's pre-hook and closes when the serving step
returns, after the FLAME decode, which is no module).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from torch.autograd.profiler import record_function


class Spans:
    def __init__(self):
        self.seconds: dict[str, list[float]] = defaultdict(list)
        self._open: dict[str, list] = defaultdict(list)
        self._handles: list = []

    def open(self, name: str) -> None:
        rf = record_function(name)
        rf.__enter__()
        self._open[name].append((rf, time.perf_counter()))

    def close(self, name: str) -> None:
        if not self._open[name]:
            return
        rf, t0 = self._open[name].pop()
        self.seconds[name].append(time.perf_counter() - t0)
        rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def range(self, name: str):
        self.open(name)
        try:
            yield
        finally:
            self.close(name)

    def hook(self, module, name: str, then_open: str | None = None) -> None:
        """Every call of ``module`` is a ``name`` span; ``then_open`` also
        opens a range at the call's start, closed elsewhere."""

        def pre(mod, args, kwargs):
            if then_open:
                self.open(then_open)
            self.open(name)

        def post(mod, args, kwargs, out):
            self.close(name)

        self._handles.append(module.register_forward_pre_hook(
            pre, with_kwargs=True))
        self._handles.append(module.register_forward_hook(
            post, with_kwargs=True))

    def wrap(self, fn, name: str, closes: tuple[str, ...] = ()):
        """``fn`` inside a ``name`` span; on return it also closes the
        ranges ``closes`` that its callees opened."""

        def wrapped(*args, **kwargs):
            with self.range(name):
                try:
                    return fn(*args, **kwargs)
                finally:
                    for c in closes:
                        self.close(c)

        return wrapped

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles.clear()
