"""idle_share.classic: idle_share in the classic MCTS cells, which move
replans_per_s.zero."""

import pathlib

from benchmark import harness

_BASE = harness.load_module("metrics", "idle_share",
                            pathlib.Path(__file__).resolve().parents[1])
read = _BASE.read
