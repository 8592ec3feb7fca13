"""The share of the device slice's ArcFace forwards (the program's
``sr3d.arcface`` spans, inside the MICA branch) that replayed a CUDA graph
of the forward (their ``graph`` attribute is ``replay``), in %.  None
where the program records no such span or the spans carry no ``graph``
attribute (a program that runs ArcFace eagerly, without the span)."""

from benchmark.program_spans import placed


def read(rec):
    found = placed(rec)
    if not found:
        return None
    modes = [s.attrs.get("graph") for s, _, _ in found
             if s.name == "sr3d.arcface"]
    if not modes or None in modes:
        return None
    return 100.0 * modes.count("replay") / len(modes)
