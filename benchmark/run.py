"""The benchmark of ipp_rl_tpu_torch on one NVIDIA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  One process: set up and warm up the
cell's shapes, drive the cell's planner for ``--seconds``, judge what the
timed path produced against the plain reference, and print one JSON line
(the last line of standard output).  Without a CUDA card it exits 2 and
prints no result.
"""

import time

START = time.perf_counter()  # setup_s counts from here

import sys  # noqa: E402

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], start=START))
