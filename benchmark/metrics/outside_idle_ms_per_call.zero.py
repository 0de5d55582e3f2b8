"""outside_idle_ms_per_call.zero: outside_idle_ms_per_call in the MCTS-zero
cells, which move replans_per_s.zero."""

import pathlib

from benchmark import harness

_BASE = harness.load_module("metrics", "outside_idle_ms_per_call",
                            pathlib.Path(__file__).resolve().parents[1])
prepare = _BASE.prepare
read = _BASE.read
