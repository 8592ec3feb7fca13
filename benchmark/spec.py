"""What a cell is, read from data: ``BENCHMARK.json``, the configuration
file, the traffic file, the cell's limits and the metric readers, each
found by its name.

* ``configs/<config>.json``: ``yaml``, the published configuration as the
  framework's YAML holds it; ``defaults``, the values the YAML leaves to
  the framework's schema that the benchmark states itself (dotted keys);
  ``flame``, the sizes of the synthetic FLAME; ``source``, ``reduced``,
  ``assumed``.
* ``traffic/<traffic>.json``: ``load`` (a module of ``loads/``, the one
  generator of that kind of traffic) and its parameters.
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.
* ``metrics/<metric>.py``: ``read(record) -> float | None``.
"""

from __future__ import annotations

import copy
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The cell's ``workloads`` entry, its config and traffic files, its
    limits and its metric lists."""
    bm = benchmark()
    work = [w for w in bm["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[0]
    conf = [c for c in bm["configs"] if c["name"] == w["config"]][0]

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "workload": w,
        "config": load_json(ROOT / conf["file"]),
        "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        "limits": load_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": [m for m in bm["end_to_end"] if reports(m)],
        "per_layer": [m for m in bm["per_layer"] if reports(m)],
    }


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def _set(tree: dict, dotted: str, value) -> None:
    *path, last = dotted.split(".")
    for k in path:
        tree = tree.setdefault(k, {})
    tree[last] = value


# Every serving cell samples with bench.py's headline recipe: DDIM with
# eta 1 from the marginal start (SAMPLER_STUDY_r3), the resample convs
# quantized wherever every ResnetBlock conv is.
SAMPLER = "ddim"
ETA = 1.0
INIT = "marginal"


def program_tree(config: dict, traffic: dict) -> dict:
    """The configuration tree the program is given: the YAML, the stated
    defaults, and the serving settings: the recipe above, the traffic's
    ``steps``, and its ``int8`` resolved as the serving CLI resolves its
    flag (``serving_flags``)."""
    tree = copy.deepcopy(config["yaml"])
    for k, v in config.get("defaults", {}).items():
        _set(tree, k, v)
    serve = traffic.get("serve")
    if serve:
        d = tree["sr"]["model"].setdefault("diffusion", {})
        d["sampler"] = SAMPLER
        d["ddim_steps"] = int(serve["steps"])
        d["ddim_eta"] = ETA
        d["sampler_init"] = INIT
        qmin, resample = serving_flags(tree, serve)
        tree["sr"]["model"]["unet"]["quant_min_res"] = qmin
        tree["sr"]["model"]["unet"]["quant_resample"] = resample
    return tree


def serving_flags(tree: dict, serve: dict) -> tuple[int, bool]:
    """``(quant_min_res, quant_resample)`` of a served request: the
    traffic's ``int8`` (None: the configuration's own ``quant_min_res``, or
    1 where it has none, the w8a8 UNet at every ResnetBlock conv); the
    resample convs quantize where the configuration says so or at
    ``quant_min_res`` 1."""
    unet = tree["sr"]["model"]["unet"]
    qmin = serve.get("int8")
    if qmin is None:
        qmin = int(unet.get("quant_min_res", 0) or 0) or 1
    resample = bool(unet.get("quant_resample", False)) or qmin == 1
    return int(qmin), resample


def reference_spec(config: dict, traffic: dict) -> dict:
    """What the plain reference needs, from the configuration and traffic
    files alone (``reference/serve.py``)."""
    tree = program_tree(config, traffic)
    sr, m = tree["sr"], tree["mica"]["model"]
    unet = dict(sr["model"]["unet"])
    val = sr["model"]["beta_schedule"]["val"]
    if val["schedule"] != "linear":
        raise NotImplementedError(f"schedule {val['schedule']!r}")
    serve = traffic.get("serve", {})
    return {
        "unet": unet,
        "image_size": int(sr["model"]["diffusion"]["image_size"]),
        "schedule": {"n": int(val["n_timestep"]),
                     "start": float(val["linear_start"]),
                     "end": float(val["linear_end"])},
        "sampler": {"steps": int(serve.get("steps", 0)), "eta": ETA,
                    "init": INIT},
        "lr": int(sr["datasets"]["val"]["l_resolution"]),
        "hr": int(sr["datasets"]["val"]["r_resolution"]),
        "mica": {"arcface_layers": list(m["arcface_layers"]),
                 "mapping_layers": int(m["mapping_layers"]),
                 "map_hidden_dim": int(m["map_hidden_dim"]),
                 "n_shape": int(m["n_shape"]),
                 "n_vertices": int(config["flame"]["n_vertices"])},
    }
