"""``unet.graph_share``: the share of the device slice's UNet forwards
that replayed a CUDA graph, on a synthetic device slice, and nothing
where the program's spans carry no ``graph`` attribute."""

import pytest
from test_bm_program_spans import _slice

from benchmark import spec

READ = spec.reader("unet.graph_share")


def _with_modes(*modes):
    """The synthetic slice, its two UNet spans given ``graph`` modes."""
    rec = _slice()
    unet = [s for s in rec.program_spans if s.name == "sr3d.unet"]
    for s, m in zip(unet, modes):
        if m is not None:
            s.attrs = {"graph": m}
    return rec


@pytest.mark.parametrize("modes,share", [
    (("replay", "replay"), 100.0),
    (("eager", "replay"), 50.0),
    (("capture", "eager"), 0.0),
])
def test_the_share_of_replayed_forwards(modes, share):
    assert READ(_with_modes(*modes)) == pytest.approx(share)


def test_nothing_without_the_attribute():
    assert READ(_with_modes(None, None)) is None
    assert READ(_with_modes("replay", None)) is None
    rec = _with_modes("replay", "replay")
    rec.program_spans = None
    assert READ(rec) is None
