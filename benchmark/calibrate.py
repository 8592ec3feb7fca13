"""The readings the limits of ``correct`` are set from, for one cell.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--out FILE]

For each seed the program serves the requests a run would compare
(``check_requests`` at the cell's load, one client) with that seed's
weights, FLAME and traffic, and the numbers of ``correct`` are read
against the plain reference: the sound readings.  For each control seed
the reference in the precision below the configuration's
(``reference/ops.py``) stands in the program's place: the control's
readings.  One JSON line per reading goes to standard output (and to
``--out``), then a summary: the largest sound reading and the smallest
control reading of each number.  Needs the card, like a run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def readings(cell: dict, seed: int, device, control: bool) -> dict:
    from .loads.serve_closed import Load

    d = Load(cell, seed, device)
    n = int(cell["traffic"]["check_requests"])
    if control:
        d.make_inputs()
        return d.check(control=True, requests=list(range(n)))
    d.setup()
    for i in range(n):
        d.serve(i)
    d.release()
    if d.failed:
        raise RuntimeError(f"seed {seed}: {d.errors}")
    return d.check(requests=list(range(n)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from .run import cache_dirs
    cache_dirs(Path.cwd())
    import torch

    from . import spec as spec_mod

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec_mod.cell(args.workload)
    lines = []
    for kind, seeds in (("sound", args.seeds),
                        ("control", args.control_seeds)):
        for s in [int(x) for x in seeds.split(",") if x]:
            r = readings(cell, s, "cuda", kind == "control")
            line = {"workload": args.workload, "kind": kind, "seed": s, **r}
            lines.append(line)
            print(json.dumps(line), flush=True)
    summary = {"workload": args.workload, "kind": "summary",
               "device": torch.cuda.get_device_name(0)}
    for k in lines[0]:
        if k in ("workload", "kind", "seed"):
            continue
        sound = [x[k] for x in lines if x["kind"] == "sound"]
        ctl = [x[k] for x in lines if x["kind"] == "control"]
        summary[k] = {"sound_max": max(sound), "control_min":
                      min(ctl) if ctl else None}
    lines.append(summary)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for x in lines:
                f.write(json.dumps(x) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
