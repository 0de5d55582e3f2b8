"""replans_per_s.zero: replans_per_s in the MCTS-zero cells. It is a metric of
its own because a window there holds a few long replans, whose rate spreads
wider between runs than the batch cells' do (PERF.md, section 2), and one
bound serves one metric."""

import pathlib

from benchmark import harness

_BASE = harness.load_module("metrics", "replans_per_s",
                            pathlib.Path(__file__).resolve().parents[1])
read = _BASE.read
