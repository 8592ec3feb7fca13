"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program (``sr3d_torch``), on a
machine with as many CUDA devices as the cell asks for; it never falls back
to the CPU.  The cell, its configuration, traffic, limits and metrics come
from ``BENCHMARK.json`` and the files under ``benchmark/`` named there.

A run: set-up (the program built with the benchmark's seeded weights, the
traffic made, every shape the traffic uses warmed up), then the measured
window of ``--seconds``, then with ``--trace 1`` two profiled slices of the
same traffic (``record.py``), then the check of the window's outputs
against the plain reference, which decides ``correct``.  The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared,
with its limit.  The same numbers are the last lines of standard error.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sr3d_tpu")


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its own CUDA kernels into ``build/kernels``)."""
    base = root / "build" / "bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
    # transformers, if anything loads it, must not load JAX
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def result_line(correct, attempted, failed, metrics, device, checks,
                breakdown=None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device="cuda", cell: dict | None = None) -> dict:
    """One run; returns the fields of the result line.  ``device`` and
    ``cell`` are for the CPU tests of the harness."""
    import torch

    from . import spec as spec_mod
    from .record import Record, breakdown, device_info
    from .spans import Spans
    from .trace import profile

    cell = cell or spec_mod.cell(cell_name)
    load_mod = __import__(f"benchmark.loads.{cell['traffic']['load']}",
                          fromlist=["Load"])
    load = load_mod.Load(cell, seed, device)
    cuda = torch.device(device).type == "cuda"
    load.setup()
    setup_s = time.time() - T_START
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    spans = Spans()
    if trace:
        load.hook(spans)
    win = load.window(seconds)
    rec = Record(cell=cell, window=win, setup_s=setup_s, work=load.spec,
                 host={k: list(v) for k, v in spans.seconds.items()})
    if trace:
        if cuda:
            rec.device_faces, rec.device_trace, n_dev = load.traced(
                profile, host=False)
            rec.slice_faces, rec.trace, n_host = load.traced(profile,
                                                             host=True)
        spans.remove()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    load.release()
    numbers = load.check()
    limits = cell["limits"]["limits"]
    checks = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    failed = load.failed
    correct = (failed == 0 and all(c["value"] <= c["limit"]
                                   for c in checks.values()))
    group = cell["per_layer"] if trace else cell["end_to_end"]
    metrics = {}
    for m in group:
        v = spec_mod.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = device_info(torch, device, cell["workload"]["chips"], peak,
                      rec if trace else None)
    notes = [f"setup phases (s): {load.setup_phases}",
             f"window: {win['requests']} requests, {win['faces']} faces in "
             f"{win['wall_s']:.3f} s (spans {'on' if trace else 'off'}), "
             f"{win['wall_s'] / win['requests']!r} s a request"]
    if trace and cuda:
        for what, tr, n in (("device", rec.device_trace, n_dev),
                            ("host", rec.trace, n_host)):
            notes.append(f"{what} slice: {n} requests in {tr.wall_s!r} s, "
                         f"{tr.wall_s / n!r} s a request")
    return {"correct": correct, "attempted": win["requests"], "notes": notes,
            "failed": failed, "metrics": metrics, "device": dev,
            "checks": checks, "errors": load.errors,
            "breakdown": breakdown(rec) if trace and cuda else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path.cwd()
    cache_dirs(root)
    import torch

    from . import spec as spec_mod

    cell = spec_mod.cell(args.workload)
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 2
    res = run(args.workload, args.seed, args.seconds, bool(args.trace),
              cell=cell)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    for line in res["notes"] + res["errors"]:
        print(line, file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(result_line(res["correct"], res["attempted"], res["failed"],
                      res["metrics"], res["device"], res["checks"],
                      res["breakdown"]))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
