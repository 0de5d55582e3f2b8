"""A run without a card fails and prints no result; so does one in a
directory that holds only the benchmark.  Nothing a run or the reference
loads is JAX or the JAX package, and the reference loads none of the
program."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.helpers import CELLS

FORBIDDEN = set(harness.FORBIDDEN)


def _python(code, cwd=harness.ROOT, env=None):
    e = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e, capture_output=True,
                          text=True, timeout=600)


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "example.greedy-b4096", "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "example.greedy-b4096", "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = f"""
import json, sys
from benchmark.tests.helpers import run_cell
from benchmark import harness, control, tracing, rooflines, weights
rc, res, err = run_cell({cell!r})
for m in harness.load_manifest()['per_layer'] + harness.load_manifest()['end_to_end']:
    harness.load_module('metrics', m['name'])
print(json.dumps({{'rc': rc, 'mods': sorted({{k.split('.')[0] for k in sys.modules}})}}))
"""
    p = _python(code)
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert "ipp_rl_tpu_torch" in out["mods"]
    assert not FORBIDDEN & set(out["mods"]), FORBIDDEN & set(out["mods"])


def test_reference_loads_none_of_the_program():
    code = """
import json, sys, pkgutil, importlib, benchmark.reference as r
for m in pkgutil.iter_modules(r.__path__):
    importlib.import_module('benchmark.reference.' + m.name)
print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))
"""
    p = _python(code)
    mods = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not (FORBIDDEN | {"ipp_rl_tpu_torch"}) & mods
