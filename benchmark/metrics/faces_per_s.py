"""Faces the window's requests returned, over the window's seconds (from
the first request's call to the last one's return, host clock)."""


def read(rec):
    w = rec.window
    return w["faces"] / w["wall_s"] if "faces" in w else None
