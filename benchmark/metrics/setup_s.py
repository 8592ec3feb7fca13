"""Seconds from the process's start to the window's first request: imports,
the program built with the benchmark's weights, the kernels built or
loaded, the traffic made and its shapes warmed up (host clock)."""


def read(rec):
    return rec.setup_s
