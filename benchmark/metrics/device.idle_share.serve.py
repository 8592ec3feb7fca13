"""The share of the device slice's wall time in which no kernel, memcpy or
memset ran on the device (the union of their intervals, so overlapping
streams count once), in %.  The device slice records the device's
activity alone, so the profiler leaves the host's pace nearly as it is."""


def read(rec):
    if rec.device_trace is None:
        return None
    return 100.0 * (1.0 - rec.busy_s / rec.slice_s)
