"""The 90th percentile of the latency of every request of the window, from
the call to its return, in ms (host clock; ``predict`` returns numpy, so
each request ends synchronised)."""

import numpy as np


def read(rec):
    lat = rec.window.get("latencies_s")
    return float(np.percentile(lat, 90) * 1e3) if lat else None
