"""The classic MCTS cell at a CPU size: it runs correct against the plain
reference, the lower-precision control and faults planted under the
timed path come out not correct, and its readers read a traced run."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import control, harness, tracing
from benchmark.tests.helpers import run_cell
from benchmark.tests.test_bench_cells import _mutated

CELL = "example_classic.classic-b1024"
#: the cell's traffic at a CPU size: a smaller batch and ring, every
#: simulation of the calls searched again kept, and 16 simulations, so that
#: UCT chooses among the children of a widened node
TINY = {"batch": 6, "ring": 2, "sample": 3, "keep_share": 1.0, "knobs": {"num_simulations": 16}}
READERS = ["classic_gemm_ms_per_replan", "classic_idle_ms_per_replan",
           "classic_steps_per_replan", "spd_trace_product_roofline.classic",
           "edge_factor_gain_roofline.classic", "idle_share.classic"]


def test_cell_runs_correct_on_the_cpu():
    rc, res, err = run_cell(CELL, overrides=TINY)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"replans_per_s.zero", "setup_s"}
    assert "search_violations" in res["checks"]


def test_a_run_loads_no_jax():
    code = f"""
import json, sys
from benchmark.tests.helpers import run_cell
rc, res, err = run_cell({CELL!r}, overrides={TINY!r})
print(json.dumps({{'rc': rc, 'correct': res['correct'],
                  'mods': sorted({{k.split('.')[0] for k in sys.modules}})}}))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                       text=True, timeout=600)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0 and out["correct"]
    assert "ipp_rl_tpu_torch" in out["mods"]
    assert not set(harness.FORBIDDEN) & set(out["mods"])


def test_control_is_not_correct():
    limits = harness.data_file("workloads", CELL)["limits"]
    prog, low = control.readings(CELL, 98765432109, 1.0, device="cpu", overrides=TINY)
    assert prog["sims_checked"] > 0 and prog["steps_checked"] > 0
    assert all(prog[k] <= v for k, v in limits.items()), prog
    assert any(low[k] > v for k, v in limits.items()), low


# ------------------------------------------------------------ planted faults

def _commit_skipped(monkeypatch):
    from ipp_rl_tpu_torch.env.world import IPPWorld

    monkeypatch.setattr(IPPWorld, "step_index", lambda self, state, *a, **k: state)


def _downdate_dropped(monkeypatch):
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicMCTSPlanner

    monkeypatch.setattr(ClassicMCTSPlanner, "_downdate", staticmethod(lambda P, WcT, keep: P))


def _uct_constant_changed(monkeypatch):
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicMCTSPlanner

    init = ClassicMCTSPlanner.__init__

    def wider(self, *a, **k):
        init(self, *a, **k)
        self.c = 1.5 * self.c

    monkeypatch.setattr(ClassicMCTSPlanner, "__init__", wider)


def _widening_off_by_one(monkeypatch):
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicMCTSPlanner

    # one child more than k·N^α allows
    _mutated(monkeypatch, ClassicMCTSPlanner, "_descend",
             "(n_child.to(dt) <= self.k * node_visits ** self.alpha)",
             "(n_child.to(dt) - 1 <= self.k * node_visits ** self.alpha)")


def _bf16_sweep(monkeypatch):
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicMCTSPlanner

    _mutated(monkeypatch, ClassicMCTSPlanner, "_sweep_rewards", "fast_math=False",
             "fast_math=True")


FAULTS = {"commit_skipped": _commit_skipped, "downdate_dropped": _downdate_dropped,
          "uct_constant_changed": _uct_constant_changed,
          "widening_off_by_one": _widening_off_by_one, "bf16_sweep": _bf16_sweep}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rc, res, err = run_cell(CELL, overrides=TINY)
    assert rc == 0, err[-2000:]
    assert not res["correct"], res["checks"]


# ------------------------------------------------------------ the readers

def test_readers_on_the_cpu_harness(tmp_path, monkeypatch):
    """A traced CPU run, with the profiler's aten ops standing in for the
    device's work: the idle and the step count read; the GEMM kernels' time
    and the rooflines need a card (and its graph's capture) and read
    nothing."""
    events = tracing._events

    def ops_as_device(prof):
        dev, rt, host = events(prof)
        return dev + [h for h in host if h[2].startswith("aten::")], rt, host

    monkeypatch.setattr(tracing, "_events", ops_as_device)
    monkeypatch.setattr(harness, "OUT_DIR", tmp_path / "out")
    m = harness.load_manifest()
    m["per_layer"] = [e for e in m["per_layer"] if e["name"] in READERS]
    assert len(m["per_layer"]) == len(READERS)
    (tmp_path / "benchmark").symlink_to(harness.BENCH, target_is_directory=True)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    seed = 4100000000321
    rc, res, err = run_cell(CELL, seed=seed, trace=1, bench=tmp_path / "benchmark",
                            overrides=TINY)
    assert rc == 0, err[-2000:]
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == {"classic_idle_ms_per_replan", "classic_steps_per_replan",
                        "idle_share.classic"}
    hc, h = 5 + 1, 5  # the configuration's horizon 5
    assert got["classic_steps_per_replan"]["value"] == 16 * (hc + h)
    assert got["classic_idle_ms_per_replan"]["value"] >= 0
    with open(tmp_path / "out" / f"{CELL}-{seed}-spans.json") as f:
        out = json.load(f)
    for name in ("classic.search", "classic.sweep", "classic.edge"):
        assert out["spans"][name]["count"] > 0
    assert out["spans"]["classic.sweep"]["device_ms"] is None  # no card


def test_a_program_without_the_graph_path_stops_at_setup(monkeypatch):
    """The parent of the graph path cannot run the cell: its set-up says so
    and the run exits at once, with no result."""
    from ipp_rl_tpu_torch.planners.mcts_classic import ClassicMCTSPlanner

    init = ClassicMCTSPlanner.__init__

    def older(self, *a, **k):
        init(self, *a, **k)
        del self.use_graphs

    monkeypatch.setattr(ClassicMCTSPlanner, "__init__", older)
    with pytest.raises(RuntimeError, match="CUDA-graph"):
        run_cell(CELL, overrides=TINY)


def test_the_graphs_root_must_equal_the_loops():
    """A root that the search again does not reproduce bit for bit is a
    violation."""
    from benchmark.reference.world import RefWorld
    from benchmark.runners import classic_batch

    config = harness.data_file("configs", "example_classic")
    hp = classic_batch.ref_classic.hyper(config["config"])
    j = classic_batch._Judge(RefWorld(config["config"], device="cpu"), hp)
    root = {"visits": torch.tensor([100.0, 100.0]), "best": torch.tensor([3, 4]),
            "ch_values": torch.tensor([[1.0, 2.0], [3.0, 4.0]])}
    j.same_root(root, {k: v.clone() for k, v in root.items()})
    assert j.bad == 0
    other = {k: v.clone() for k, v in root.items()}
    other["ch_values"][1, 0] = torch.nextafter(torch.tensor(3.0), torch.tensor(4.0))
    j.same_root(root, other)
    assert j.bad == 1
