"""Percent of the SRC's least time (roofline/cycle_src.py: the algorithm's
count, whatever implements it) that the device time of every operation
launched inside the program's ``f9.src`` span reaches: `cycle_src`, or the
L < 8 unfold and matmul."""

import os

from bench_h100 import program_spans, tracing
from bench_h100.roofline import peaks


def read(rec):
    f9 = program_spans.of(rec)
    if not program_spans.holds(f9, "f9.src"):
        return None
    secs = program_spans.device_seconds(f9, "f9.src")
    if secs <= 0:
        return None
    mod = tracing.load_file(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "roofline", "cycle_src.py"))
    return 100.0 * sum(peaks.bound_s(*mod.work(s)) for s in rec["shapes"]) / secs
