#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout:

    python3 bench_h100/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result's JSON; the numbers the
output check compared, each beside its limit, are the last lines of
standard error.  Exits 2 without a result when the cell's CUDA devices are
missing.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT     # the checkout's root, not this folder

from bench_h100 import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], t0=T0))
