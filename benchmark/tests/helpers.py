"""Tiny CPU runs of the cells, for the tests."""

import contextlib
import io
import json
import time

from benchmark import harness

#: each cell's sizes for a CPU run (its traffic and its network's shape are
#: the cell's own; only the batch, the pools and the width shrink)
TINY = {
    "example.greedy-b4096": {"batch": 8, "pool": 2, "sample": 2},
    "example.zero-b1024": {"batch": 4, "pool": 2, "sample": 2, "keep_share": 1.0,
                           "hyper_params": {"num_channels": 16, "num_global_pooling_channels": 8,
                                            "num_mcts_simulations": 6}},
    "temperature_cmaes.cmaes-b8192": {"batch": 6, "ring": 2, "sample": 3},
}
CELLS = sorted(TINY)


def run_cell(cell, seed=1234567890123, seconds=1.0, trace=0, bench=harness.BENCH,
             overrides=None):
    """(exit code, the result's JSON or None, standard error) of a CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = harness.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], start=time.perf_counter(), device="cpu",
                          overrides=dict(TINY.get(cell, {}), **(overrides or {})), bench=bench)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
