"""Readings that set a cell's limits: the program's over many seeds and
the lower-precision control's, in one process.

    python3 -m benchmark.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed: the cell's set-up and a window of ``--seconds`` as a run
makes them, the comparison of what the program produced (the lower
reading), then the plain reference in the precision below the
configuration's put in the program's place on the same kept inputs and
judged alike (the upper reading).  One JSON line per seed on standard
output.  The benchmark's own runs do not run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(workload: str, seed: int, seconds: float, device=None, overrides=None, bench=None):
    """(program's readings, control's readings) of one seed."""
    import torch

    from benchmark import harness

    bench = bench or harness.BENCH
    args = harness.parse(["--workload", workload, "--seed", str(seed), "--seconds", str(seconds)])
    manifest = harness.load_manifest(bench.parent)
    entry = {w["name"]: w for w in manifest["workloads"]}[workload]
    cell = dict(harness.data_file("workloads", workload, bench))
    cell.update(overrides or {})
    config = harness.data_file("configs", entry["config"], bench)
    dev = torch.device(device or "cuda")
    run = harness.Run(args, dev, manifest, cell, config)
    runner = harness.load_module("runners", cell["runner"], bench).Runner(run)
    runner.setup()
    t0 = time.perf_counter()
    while True:
        runner.call()
        if time.perf_counter() - t0 >= seconds:
            break
    low = runner.control()
    return runner.check(), low


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("benchmark.control: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, low = readings(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, "program": prog,
                          "control": low, "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
