"""Kernel and graph launch calls the host made between the UNet's forward
pre-hook and its forward hook, per UNet call, in the traced slice."""


def read(rec):
    if rec.trace is None:
        return None
    calls = len(rec.trace.ranges_named("bm.unet"))
    return rec.launches_in("bm.unet") / calls if calls else None
