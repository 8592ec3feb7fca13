"""The share of the device slice's wall in which the device was idle (no
kernel, memcpy or memset on any stream) while the host was inside a UNet
forward (the program's ``sr3d.unet`` spans, placed on the slice's clock by
their marker launches), in %: the idle a graph of the UNet forward can
reach."""

from benchmark.program_spans import idle_under


def read(rec):
    idle = idle_under(rec, "sr3d.unet")
    return None if idle is None else 100.0 * idle / (rec.slice_s * 1e6)
