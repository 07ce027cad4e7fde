"""Percent of its roofline (roofline/upols_mac.py) the kernel's device time reaches."""

from bench_h100 import tracing


def read(rec):
    return tracing.roofline_share(rec, "upols_mac")
