"""Device ms of the operations launched inside the MICA branch (from
ArcFace's forward pre-hook to the serving step's return: ArcFace, the
mapping network, the FLAME decode and landmarks), per face of the traced
slice; device operations are matched to their launch by correlation."""


def read(rec):
    if rec.trace is None or not rec.slice_faces:
        return None
    return 1e3 * rec.device_s_under("bm.mica") / rec.slice_faces
