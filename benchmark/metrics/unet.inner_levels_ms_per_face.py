"""Device ms per face of the UNet's inner levels: the segments between its
level marks that lie below its two highest resolutions, the mid block
with them (``e128-d128`` at 512²), summed over the device slice's
forwards (``benchmark/levels.py``)."""

from benchmark.levels import ms_per_face


def read(rec):
    return ms_per_face(rec, outer=False)
