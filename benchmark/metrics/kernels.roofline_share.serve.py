"""The same least time over the device's busy time in the device slice (the
union of kernel, memcpy and memset intervals), in %: how close the
operations that ran came to the peaks.  mfu.serve = this × (1 − idle
share)."""


def read(rec):
    if rec.device_trace is None or not rec.device_faces or rec.busy_s <= 0:
        return None
    return 100.0 * rec.device_faces * rec.least_s_per_face / rec.busy_s
