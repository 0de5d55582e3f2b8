"""A configuration, a cell and a metric are added by files and entries
alone: a throw-away copy of each, in a temporary copy of the benchmark,
is found by name and runs, with no file that was there edited."""

import json
import shutil

from benchmark import harness
from benchmark.tests.helpers import TINY, run_cell


def test_throw_away_config_cell_and_metric(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    # every file but the manifest, which gains entries, stays as it was
    before = {p: p.read_bytes() for p in root.rglob("*")
              if p.is_file() and p.name != "BENCHMARK.json"}
    bench = root / "benchmark"

    cfg = json.loads((bench / "configs" / "example.json").read_text())
    cfg["name"] = "scratch_cfg"
    cfg["config"]["experiment"]["constraints"]["budget"] = 60
    (bench / "configs" / "scratch_cfg.json").write_text(json.dumps(cfg))
    cell = json.loads((bench / "workloads" / "example.greedy-b4096.json").read_text())
    cell["batch"] = 5
    (bench / "workloads" / "scratch_cfg.tiny.json").write_text(json.dumps(cell))
    (bench / "metrics" / "calls_per_s.py").write_text(
        "def read(run, runner):\n    return run.calls / run.window_s\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "scratch_cfg", "source": "a test", "reduced": [],
                         "file": "benchmark/configs/scratch_cfg.json", "why": "a test"})
    m["workloads"].append({"name": "scratch_cfg.tiny", "config": "scratch_cfg",
                           "traffic": "tiny", "chips": 1, "why": "a test"})
    m["end_to_end"].append({"name": "calls_per_s", "unit": "calls/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["scratch_cfg.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    rc, res, err = run_cell("scratch_cfg.tiny", bench=bench,
                            overrides=dict(TINY["example.greedy-b4096"], batch=5))
    assert rc == 0, err[-2000:]
    assert res["correct"]
    assert res["metrics"]["calls_per_s"]["value"] > 0
    assert set(res["metrics"]) == {"calls_per_s", "setup_s"}
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
