"""Device ms per face of the UNet's outer levels: the segments of its two
highest resolutions, encoder and decoder (``e512-e256`` and
``d256-d512`` at 512²), each the kernel time between its two level
marks, summed over the device slice's forwards (``benchmark/levels.py``).
With ``unet.inner_levels_ms_per_face`` it makes up the slice's UNet
kernel time."""

from benchmark.levels import ms_per_face


def read(rec):
    return ms_per_face(rec, outer=True)
