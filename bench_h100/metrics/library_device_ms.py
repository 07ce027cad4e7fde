"""Device time a batch of every kernel that is not one of the program's own
CUDA kernels (library matmuls, cuFFT, eager elementwise passes), in ms."""

from bench_h100 import tracing


def read(rec):
    if not rec["events"]:
        return None
    return 1e3 * tracing.device_seconds(rec, port=False) / rec["batches"]
