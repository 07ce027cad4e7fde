"""Device time a batch, in ms, of every operation launched inside the
program's ``f9.chain`` span: the chain's hand kernels, cuFFT, torch's
eager passes and copies."""

from bench_h100 import program_spans


def read(rec):
    f9 = program_spans.of(rec)
    if not rec["events"] or not program_spans.holds(f9, "f9.chain"):
        return None
    return 1e3 * program_spans.device_seconds(f9, "f9.chain") / rec["batches"]
