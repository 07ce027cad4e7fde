"""Percent of its roofline (roofline/epilogue.py) the kernel's device time reaches."""

from bench_h100 import tracing


def read(rec):
    return tracing.roofline_share(rec, "epilogue")
