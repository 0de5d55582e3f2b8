"""The program's spans read against the device's idle time
(benchmark/spans.py): the attribution on synthetic intervals, and the six
readers on the CPU harness, with the profiler's CPU ops standing in for
device work (the CPU has no device timeline); without the program's
tracer they read nothing."""

import dataclasses
import json
import sys
from typing import Optional

import pytest

from benchmark import harness, spans, tracing
from benchmark.tests.helpers import run_cell

NEW = {"example.greedy-b4096": ["history_idle_ms_per_call", "outside_idle_ms_per_call",
                                "evaluate_ms_per_step"],
       "example.zero-b1024": ["descent_idle_ms_per_replan", "syncs_per_replan",
                              "outside_idle_ms_per_call.zero"],
       "temperature_cmaes.cmaes-b8192": ["history_idle_ms_per_call",
                                         "outside_idle_ms_per_call"]}


@dataclasses.dataclass
class S:
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float] = None


def test_idle_is_put_down_to_the_innermost_span():
    run = S("plan.run", 1, None, 1, 5, 80)
    sweep = S("plan.sweep", 2, 1, 1, 12, 35, device_ms=1.0)
    history = S("plan.history", 3, 1, 1, 60, 78)
    stray = S("plan.sweep", 4, None, None, 82, 88)  # outside any request
    idle = spans.idle_intervals([(10, 20), (30, 40), (90, 95), (-5, 2), (98, 120)], 0, 100)
    assert idle == [(2, 10), (20, 30), (40, 90), (95, 98)]
    out = spans.summarize([run, sweep, history, stray], idle, 0, 100)
    ms = 1e-6
    assert out["idle_ms"] == pytest.approx(71 * ms)
    # [2, 5) and [80, 90) and [95, 98) outside: 3 + 10 + 3
    assert out["outside"]["idle_ms"] == pytest.approx(16 * ms)
    by = out["spans"]
    assert by["plan.run"]["self_idle_ms"] == pytest.approx((5 + 20 + 2) * ms)
    assert by["plan.sweep"]["self_idle_ms"] == pytest.approx(10 * ms)
    assert by["plan.history"]["self_idle_ms"] == pytest.approx(18 * ms)
    assert by["plan.run"]["idle_ms"] == pytest.approx(55 * ms)
    assert by["plan.sweep"]["idle_ms"] == pytest.approx(10 * ms)
    assert by["plan.sweep"]["count"] == 2 and by["plan.sweep"]["device_ms"] == 1.0
    assert by["plan.run"]["device_ms"] is None
    assert by["plan.run"]["host_ms"] == pytest.approx(75 * ms)
    assert out["outside"]["idle_ms"] + sum(v["self_idle_ms"] for v in by.values()) == \
        pytest.approx(out["idle_ms"])


def test_a_window_without_device_work_is_all_idle():
    assert spans.idle_intervals([], 0, 10) == [(0, 10)]
    out = spans.summarize([], [(0, 10)], 0, 10)
    assert out["outside"]["idle_ms"] == pytest.approx(1e-5) and out["spans"] == {}


def test_nested_names_count_once_in_idle():
    outer = S("zero.backup", 1, None, 1, 0, 10)
    inner = S("zero.backup", 2, 1, 1, 2, 8)
    out = spans.summarize([outer, inner], [(0, 10)], 0, 10)
    assert out["spans"]["zero.backup"]["idle_ms"] == pytest.approx(1e-5)
    assert out["spans"]["zero.backup"]["self_idle_ms"] == pytest.approx(1e-5)


def _cpu_ops_as_device(monkeypatch):
    """The profiler's aten ops stand in for the device's work on the CPU."""
    events = tracing._events

    def ops_as_device(prof):
        dev, rt, host = events(prof)
        return dev + [h for h in host if h[2].startswith("aten::")], rt, host

    monkeypatch.setattr(tracing, "_events", ops_as_device)


def _bench_with(tmp_path, cell):
    """A benchmark directory whose BENCHMARK.json asks ``cell`` for the
    new per-layer metrics alone."""
    m = harness.load_manifest()
    m["per_layer"] = [e for e in m["per_layer"] if e["name"] in NEW[cell]]
    (tmp_path / "benchmark").symlink_to(harness.BENCH, target_is_directory=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    return tmp_path / "benchmark"


@pytest.mark.parametrize("cell", sorted(NEW))
def test_readers_on_the_cpu_harness(cell, tmp_path, monkeypatch):
    _cpu_ops_as_device(monkeypatch)
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path / "out")
    seed = 4100000000123
    rc, res, err = run_cell(cell, seed=seed, trace=1, bench=_bench_with(tmp_path, cell))
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    got = res["metrics"]
    # no card: no CUDA events, so no device ms
    want = {n for n in NEW[cell] if n != "evaluate_ms_per_step"}
    assert set(got) == want
    assert all(v["value"] >= 0 for v in got.values())
    with open(tmp_path / "out" / f"{cell}-{seed}-spans.json") as f:
        out = json.load(f)
    assert out["calls"] > 0 and out["batch_replans"] > 0
    self_idle = out["outside"]["idle_ms"] + sum(v["self_idle_ms"] for v in out["spans"].values())
    assert self_idle == pytest.approx(out["idle_ms"])
    assert out["idle_ms"] == pytest.approx(out["trace_idle_ms"], rel=0.01)
    assert out["spans"]["plan.run"]["count"] == out["calls"]
    assert tracing.start.__module__ == "benchmark.tracing"  # unwrapped again
    if cell == "example.zero-b1024":
        assert got["syncs_per_replan"]["value"] >= 1
        assert out["counters"]["zero.descent_steps"] > 0


def test_without_the_programs_tracer_the_readers_read_nothing(tmp_path, monkeypatch):
    _cpu_ops_as_device(monkeypatch)
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path / "out")
    import ipp_rl_tpu_torch.planners  # noqa: F401 (the program, loaded with its tracer)
    import ipp_rl_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "ipp_rl_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(ipp_rl_tpu_torch.utils, "tracing")
    cell = "example.greedy-b4096"
    rc, res, err = run_cell(cell, trace=1, bench=_bench_with(tmp_path, cell))
    assert rc == 0, err[-2000:]
    assert res["correct"] and res["metrics"] == {}
    assert not (tmp_path / "out").exists() or not list((tmp_path / "out").glob("*-spans.json"))
