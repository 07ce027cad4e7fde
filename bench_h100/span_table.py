#!/usr/bin/env python3
"""A traced run of one cell that also prints the program's spans as a
table on standard error (`program_spans.table`): for each ``f9.`` span,
and ``(outside)``, a batch's host ms in all and its own, the device ms and
operations it launched, the idle it opened and its synchronising runtime
calls.  Otherwise it is ``run.py ... --trace 1``, result line and all:

    python3 bench_h100/span_table.py --workload reverb48.stems_reverb --seed 7 --seconds 50

With ``--json PATH`` the rows are also written to ``PATH`` as JSON.
"""

import json
import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT     # the checkout's root, not this folder

from bench_h100 import harness, program_spans, tracing  # noqa: E402


def main(argv: list[str]) -> int:
    path = None
    if "--json" in argv:
        i = argv.index("--json")
        path = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    breakdown = tracing.breakdown

    def with_table(rec, *args, **kw):
        rows = program_spans.table(rec)
        print("spans, a batch's averages:\n" + program_spans.format_table(rows),
              file=sys.stderr, flush=True)
        if path:
            with open(path, "w") as f:
                json.dump(rows, f, indent=1)
        return breakdown(rec, *args, **kw)

    tracing.breakdown = with_table
    try:
        return harness.main([*argv, "--trace", "1"], t0=T0)
    finally:
        tracing.breakdown = breakdown


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
