"""edge_factor_gain_roofline.zero: edge_factor_gain_roofline in the MCTS-zero
cells (the descent's edge updates), which move replans_per_s.zero."""

import pathlib

from benchmark import harness

_BASE = harness.load_module("metrics", "edge_factor_gain_roofline",
                            pathlib.Path(__file__).resolve().parents[1])
prepare = _BASE.prepare
read = _BASE.read
