"""Host ms of a sampler step outside its UNet forward: the mean over the
program's ``sr3d.step`` spans of the span's length less the part its
``sr3d.unet`` child covers (the noise draw, the concatenation with the
condition, the time input, x̂₀ and ε, the update).  The steps of the device
slice, which runs near the program's untraced pace; without one (a run on
the CPU) every step recorded."""

from benchmark.program_spans import placed


def read(rec):
    found = placed(rec)
    if not found:
        return None
    unet = {}
    for s, a, b in found:
        if s.name == "sr3d.unet":
            unet[s.parent] = unet.get(s.parent, 0.0) + (b - a)
    own = [(b - a) - unet.get(s.id, 0.0) for s, a, b in found
           if s.name == "sr3d.step"]
    return sum(own) / len(own) / 1e3 if own else None
