"""The least time of the faces the device slice served, over the slice's
wall time, in %: each conv, dense layer and attention product of the
benchmark's own count at the peak of the precision the configuration
states for it (int8 1979 TOP/s, bf16 989 TF/s, fp32 67 TF/s)."""


def read(rec):
    if rec.device_trace is None or not rec.device_faces:
        return None
    return 100.0 * rec.device_faces * rec.least_s_per_face / rec.slice_s
