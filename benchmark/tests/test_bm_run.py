"""A run from outside: the result line, no card, the modules it
loads, and the whole flow on the CPU at a test size."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import tiny_cell

from benchmark import run as run_mod
from benchmark import spec

BM_DIR = spec.HERE


def test_result_line_keys():
    dev = {"platform": "gpu", "kind": "x", "count": 1,
           "memory_peak_bytes": 1}
    checks = {"a": {"value": 1.0, "limit": 2.0}}
    plain = json.loads(run_mod.result_line(True, 3, 0, {}, dev, checks))
    assert list(plain) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    traced = json.loads(run_mod.result_line(
        True, 3, 0, {}, dev, checks,
        {"device_ops": [], "idle_gaps": []}))
    assert list(traced) == ["correct", "attempted", "failed", "metrics",
                            "device", "breakdown", "checks"]


def test_no_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "sr3_16_128.serve_b8", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=spec.ROOT, env=env, capture_output=True,
        text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def _imports(path: Path) -> set[str]:
    """Top-level names of the absolute imports of a source file."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_import_check_by_top_level_names():
    for path in BM_DIR.rglob("*.py"):
        names = _imports(path)
        assert not names & set(run_mod.FORBIDDEN), path
        if "reference" in path.relative_to(BM_DIR).parts:
            assert "sr3d_torch" not in names, path
            assert "benchmark" not in names, path


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("jaxtyping_like", "sr3d_tpu_like", "sr3d_torch.x"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run_mod.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sr3d_tpu.serve", sys)
    monkeypatch.setitem(sys.modules, "jax", sys)
    assert run_mod.forbidden_modules() == ["jax", "sr3d_tpu"]


def test_a_run_loads_no_jax():
    """The harness, the program's serving path and the reference in one
    process load neither JAX nor the JAX package."""
    code = ("import benchmark.run as r, benchmark.calibrate, "
            "benchmark.loads.serve_closed, benchmark.reference.serve, "
            "sr3d_torch.serve; print(r.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("trace", [False, True])
def test_whole_run_on_cpu(trace):
    cell = tiny_cell()
    res = run_mod.run("tiny.serve_b8", 3000000123, 1.5, trace,
                      device="cpu", cell=cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    names = set(res["metrics"])
    if trace:
        assert names == {"unet.host_ms_per_call"}
    else:
        assert names == {"faces_per_s", "request_p90_ms", "setup_s"}
    assert res["metrics"]["unet.host_ms_per_call" if trace
                          else "faces_per_s"]["value"] > 0
    assert res["device"]["platform"] == "cpu"


def test_same_seed_same_inputs_and_weights():
    from benchmark import weights
    from benchmark.loads.serve_closed import Load

    cell = tiny_cell()
    a, b = Load(cell, 2 ** 33 + 5, "cpu"), Load(cell, 2 ** 33 + 5, "cpu")
    for d in (a, b):
        d.make_inputs()
    for i in range(3):
        (la, ga), (lb, gb) = a.request(i), b.request(i)
        assert (la == lb).all() and ga == gb
    wa = weights.make(a.spec, 2 ** 33 + 5, "cpu")
    wb = weights.make(b.spec, 2 ** 33 + 5, "cpu")
    assert all((wa["unet"][k] == wb["unet"][k]).all() for k in wa["unet"])
    c = Load(cell, 2 ** 33 + 6, "cpu")
    c.make_inputs()
    # another seed: other faces, the same sizes in each pair of requests
    for k in range(0, 6, 2):
        ra = [a.request(k + j)[0] for j in range(2)]
        rc = [c.request(k + j)[0] for j in range(2)]
        assert sorted(len(r) for r in ra) == sorted(len(r) for r in rc) \
            == [2, 3]
    assert not (c.pool == a.pool).all()
