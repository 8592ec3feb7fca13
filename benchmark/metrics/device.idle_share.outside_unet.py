"""The share of the device slice's wall in which the device was idle while
the host was inside a request (``sr3d.request``) but outside its UNet
forwards (``sr3d.unet``): the sampler's own work, the hand-off, the MICA
branch, the condition's upload and the fetch, in %.  With
``device.idle_share.in_unet`` and the idle between requests it makes up
``device.idle_share.serve``."""

from benchmark.program_spans import idle_under


def read(rec):
    req, unet = idle_under(rec, "sr3d.request"), idle_under(rec,
                                                            "sr3d.unet")
    if req is None or unet is None:
        return None
    return 100.0 * (req - unet) / (rec.slice_s * 1e6)
