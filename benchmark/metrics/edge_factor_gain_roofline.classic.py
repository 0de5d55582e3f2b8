"""edge_factor_gain_roofline.classic: edge_factor_gain_roofline in the
classic MCTS cells (an edge update at every lockstep step of the descent
and the rollouts, (1024, 9, 100) a launch), which move replans_per_s.zero.
The search runs there as a CUDA graph, so the share is read from the
graph's kernels (benchmark/graphed.py) with the base reader's bound
model."""

import pathlib

from benchmark import graphed, harness

_BASE = harness.load_module("metrics", "edge_factor_gain_roofline",
                            pathlib.Path(__file__).resolve().parents[1])


def read(run, runner):
    return graphed.kernel_share(run, runner, _BASE.NAME, "edge_factor_gain", _BASE._bound_ms)
