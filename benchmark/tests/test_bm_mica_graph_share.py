"""``mica.graph_share``: the share of the device slice's ArcFace forwards
that replayed a CUDA graph, on a synthetic device slice, and nothing where
the program records no ``sr3d.arcface`` span or the spans carry no
``graph`` attribute."""

import pytest
from test_bm_program_spans import _slice, _span

from benchmark import spec

READ = spec.reader("mica.graph_share")


def _with_modes(*modes):
    """The synthetic slice, an ``sr3d.arcface`` span inside its MICA
    branch for each mode (None: a span without the attribute)."""
    rec = _slice()
    (mica,) = [s for s in rec.program_spans if s.name == "sr3d.mica"]
    for i, m in enumerate(modes):
        s = _span("sr3d.arcface", 100 + i, mica.id, 815 + 10 * i,
                  820 + 10 * i)
        if m is not None:
            s.attrs = {"graph": m}
        rec.program_spans.append(s)
    return rec


@pytest.mark.parametrize("modes,share", [
    (("replay", "replay"), 100.0),
    (("eager", "replay"), 50.0),
    (("capture", "eager", "replay", "replay"), 50.0),
    (("capture",), 0.0),
])
def test_the_share_of_replayed_arcface_forwards(modes, share):
    assert READ(_with_modes(*modes)) == pytest.approx(share)


def test_nothing_without_the_span_or_its_attribute():
    assert READ(_with_modes()) is None              # the parent: no span
    assert READ(_with_modes(None)) is None
    assert READ(_with_modes("replay", None)) is None
    rec = _with_modes("replay")
    rec.program_spans = None
    assert READ(rec) is None
