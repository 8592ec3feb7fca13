"""BENCHMARK.json against the contract's shape, and every file it names."""

import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BM = spec.benchmark()


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"}
    assert 1 <= BM["run_seconds"] <= 51
    assert BM["paths"] == ["benchmark"]
    assert all(not w.startswith("/") and ".." not in w
               for w in BM["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BM[kind]]
    assert len(names) == len(set(names))
    for e in BM[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_cells():
    configs = {c["name"] for c in BM["configs"]}
    pairs = set()
    for w in BM["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        c = spec.cell(w["name"])      # every file it names is there
        assert set(c["limits"]["limits"]) == {
            "sr_median_u8", "sr_over64_share", "identity_rel", "verts_rel",
            "lmk68_rel"}
    assert {w["config"] for w in BM["workloads"]} == configs


def test_end_to_end():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BM["workloads"]:
        got = [m for m in e2e.values() if _reports(m, w["name"])]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2


def test_per_layer_moves_and_workloads():
    e2e = {m["name"]: m for m in BM["end_to_end"]}
    cells = {w["name"] for w in BM["workloads"]}
    for m in BM["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells
        for c in m["workloads"]:
            assert _reports(e2e[m["moves"]], c)
    for w in BM["workloads"]:
        assert any(_reports(m, w["name"]) for m in BM["per_layer"])


def test_every_metric_has_a_reader():
    for m in BM["end_to_end"] + BM["per_layer"]:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("name", [c["name"] for c in BM["configs"]])
def test_config_files(name):
    conf = [c for c in BM["configs"] if c["name"] == name][0]
    data = spec.load_json(spec.ROOT / conf["file"])
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"] == []
    assert {"yaml", "defaults", "flame", "assumed"} <= set(data)
