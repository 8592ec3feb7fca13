"""Host-clock ms between the UNet's forward pre-hook and forward hook, with
no synchronisation: the time to enqueue one forward, the mean over the
traced run's window (the profiled slice left out)."""


def read(rec):
    s = rec.host.get("bm.unet")
    return 1e3 * sum(s) / len(s) if s else None
