"""BENCHMARK.json against the benchmark's contract: names, units, keys,
files found by name, and each per-layer metric's end-to-end metric
reported in each of its cells."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = harness.load_manifest()


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert M["paths"] == ["benchmark"]
    assert M["command"] == ["python3", "-m", "benchmark.run"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    cells = len(M["workloads"])
    # the check's time: 2 + 14 runs a cell, each run_seconds + 60, 180 s of
    # compiles a cell, 1200 s spare, for the most cells a benchmark may hold
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in M[kind]]
    assert len(names) == len(set(names))
    for e in M[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert c["name"] in {w["config"] for w in M["workloads"]}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert NAME.match(w["traffic"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "_roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_needs():
    for w in M["workloads"]:
        mets = harness.cell_metrics(M, w["name"])
        e2e = {m["name"] for m in mets["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert mets["per_layer"]


def test_moves_is_reported_by_each_cell_of_the_metric():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in M["workloads"]]):
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (m["name"], cell)


def test_files_are_found_by_name():
    for c in M["configs"]:
        cfg = harness.data_file("configs", c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert harness.ROOT / c["file"] == harness.BENCH / "configs" / f"{c['name']}.json"
    for w in M["workloads"]:
        cell = harness.data_file("workloads", w["name"])
        assert (harness.BENCH / "runners" / f"{cell['runner']}.py").exists()
        assert set(cell["limits"])
    for m in M["end_to_end"] + M["per_layer"]:
        assert (harness.BENCH / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_size():
    assert len(json.dumps(M)) <= 64 * 1024
