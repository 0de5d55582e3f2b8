"""spd_trace_product_roofline.classic: spd_trace_product_roofline in the
classic MCTS cells (the search's full-precision sweeps, float32 streams),
which move replans_per_s.zero.  The search runs there as a CUDA graph, so
the share is read from the graph's kernels (benchmark/graphed.py) with the
base reader's bound model."""

import pathlib

from benchmark import graphed, harness

_BASE = harness.load_module("metrics", "spd_trace_product_roofline",
                            pathlib.Path(__file__).resolve().parents[1])


def read(run, runner):
    return graphed.kernel_share(run, runner, _BASE.NAME, "spd_trace_product", _BASE._bound_ms)
