"""The benchmark's harness: finds a cell's files by name, sets up, drives
the window, reads the metrics, judges the outputs and prints the result.

Everything that belongs to one item lives in a file of its own, found by
the name ``BENCHMARK.json`` gives it:

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/workloads/<cell>.json``: the cell's traffic (the runner
  that runs it, batch, pool of inputs, sample to check) and the limits
  of its comparison;
* ``benchmark/runners/<runner>.py``: a runner of one planner's entry point;
* ``benchmark/metrics/<metric>.py``: one metric's reader, ``read(run, runner)``
  (and ``prepare(run, runner)`` before a traced window), which returns a number
  or None when it finds nothing to read.

A later cell, configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import pathlib
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
#: top-level module names that no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ipp_rl_tpu")
#: where traced runs leave their summaries (inside the checkout)
OUT_DIR = ROOT / "bench_out"


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


# ------------------------------------------------------------ discovery

def load_manifest(root: pathlib.Path = ROOT) -> Dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def data_file(kind: str, name: str, bench: pathlib.Path = BENCH) -> Dict:
    """The JSON data file ``benchmark/<kind>/<name>.json``."""
    path = bench / kind / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} file named {name!r} under {bench / kind}")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str, bench: pathlib.Path = BENCH):
    """The module ``benchmark/<kind>/<name>.py`` (a name may hold dots)."""
    path = bench / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {kind} module named {name!r} under {bench / kind}")
    key = f"benchmark_{kind}_" + re.sub(r"\W", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[key] = module
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: Dict, cell: str) -> Dict[str, List[Dict]]:
    """The end-to-end and per-layer metrics a cell reports."""
    def mine(m):
        return cell in m.get("workloads", [cell])

    return {"end_to_end": [m for m in manifest["end_to_end"] if mine(m)],
            "per_layer": [m for m in manifest["per_layer"] if mine(m)]}


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


# ------------------------------------------------------------ the run

class Run:
    """One run of one cell: what the runner, the readers and the check share."""

    def __init__(self, args, device, manifest: Dict, cell: Dict, config: Dict):
        self.args = args
        self.name = args.workload
        self.seed = args.seed
        self.seconds = args.seconds
        self.trace = bool(args.trace)
        self.device = device
        self.manifest = manifest
        self.cell = cell
        self.config = config
        self.setup_s = math.nan
        self.window_s = 0.0
        self.replans = 0  # mission-replans of missions still active
        self.batch_replans = 0  # replan steps of the whole batch
        self.calls = 0
        self.timer = None  # PhaseTimer in a traced run
        self.trace_summary: Optional[Dict] = None
        self.trace_replans = 0  # replans done while the profiler traced
        self.tracing = False  # the profiler is on
        self.launches: Dict[str, List] = {}  # kernel name -> shapes of each launch
        self.values: Dict = {}  # anything a runner leaves for its readers


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def main(argv, start: float, device: Optional[str] = None, overrides: Optional[Dict] = None,
         bench: pathlib.Path = BENCH) -> int:
    """Run one cell.  ``device`` (a test's CPU) skips the look for a card;
    ``overrides`` replace keys of the cell's workload file (a test's sizes)."""
    args = parse(argv)
    import torch

    manifest = load_manifest(bench.parent)
    entries = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in entries:
        log(f"benchmark: no workload {args.workload!r} in BENCHMARK.json")
        return 2
    entry = entries[args.workload]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            log(f"benchmark: the cell needs {entry['chips']} CUDA card(s); "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = "cuda"
    # the configurations state float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = dict(data_file("workloads", args.workload, bench))
    cell.update(overrides or {})
    config = data_file("configs", entry["config"], bench)
    run = Run(args, torch.device(device), manifest, cell, config)
    on_card = run.device.type == "cuda"
    mets = cell_metrics(manifest, args.workload)
    if on_card:
        log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")

    runner = load_module("runners", cell["runner"], bench).Runner(run)
    runner.setup()
    readers = {}
    prof = None
    if run.trace:
        from benchmark.yardsticks import PhaseTimer

        run.timer = PhaseTimer()
        for m in mets["per_layer"]:
            readers[m["name"]] = load_module("metrics", m["name"], bench)
            if hasattr(readers[m["name"]], "prepare"):
                readers[m["name"]].prepare(run, runner)
        from benchmark import tracing

        prof = tracing.start(on_card)
        run.tracing = True
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.perf_counter() - start

    # a cell may trace only the window's first trace_seconds (a host-paced
    # loop's millions of events would take minutes to reduce)
    trace_s = float(cell.get("trace_seconds", run.seconds))
    t0 = time.perf_counter()
    while True:
        runner.call()
        run.calls += 1
        run.window_s = time.perf_counter() - t0
        if prof is not None and run.window_s >= trace_s:
            prof = _stop_trace(run, prof, t0, on_card)
        if run.window_s >= run.seconds:
            break
    if on_card:
        torch.cuda.synchronize()
    run.window_s = time.perf_counter() - t0
    if prof is not None:
        _stop_trace(run, prof, t0, on_card)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"window: {run.calls} calls, {run.window_s:.3f} s, {run.replans} replans "
        f"({run.batch_replans} batch steps); set-up {run.setup_s:.3f} s; "
        f"peak device memory {peak} B")

    metrics = {}
    if run.trace:
        for m in mets["per_layer"]:
            value = readers[m["name"]].read(run, runner)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in mets["end_to_end"]:
            value = load_module("metrics", m["name"], bench).read(run, runner)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    readings = runner.check()  # frees the program's state first
    limits = cell["limits"]
    checks = {k: {"value": float(readings[k]), "limit": float(limits[k])} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    extra = {k: v for k, v in readings.items() if k not in limits}
    log(f"also read: {json.dumps(extra)}")

    bad = forbidden_modules()
    if bad:
        log(f"benchmark: the run loaded {bad}; no result")
        return 3
    result = {
        "correct": correct,
        "attempted": run.replans,
        "failed": 0,
        "metrics": metrics,
        "device": device_info(run, peak),
    }
    if run.trace_summary is not None:
        result["breakdown"] = run.trace_summary["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


def _stop_trace(run: Run, prof, t0: float, on_card: bool) -> None:
    import torch

    from benchmark import tracing

    if on_card:
        torch.cuda.synchronize()
    run.trace_replans = run.replans
    run.tracing = False
    run.trace_summary = tracing.stop(prof, time.perf_counter() - t0, on_card)
    tracing.write_summary(run.name, run.seed, run.trace_summary, OUT_DIR)
    return None


def device_info(run: Run, peak: int) -> Dict:
    import torch

    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(), "count": 1,
            "memory_peak_bytes": int(peak)}
    if run.trace_summary is not None:
        info["busy_s"] = run.trace_summary["busy_s"]
        info["window_s"] = run.trace_summary["window_s"]
    return info
