"""Percent of its roofline (roofline/cycle_src.py) the kernel's device time reaches."""

from bench_h100 import tracing


def read(rec):
    return tracing.roofline_share(rec, "cycle_src")
