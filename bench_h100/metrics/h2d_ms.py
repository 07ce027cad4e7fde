"""Host-to-device copy time a batch (pipeline/link.py), ms of device time."""

from bench_h100 import tracing


def read(rec):
    if not rec["events"]:
        return None
    return 1e3 * tracing.device_seconds(rec, kinds=("htod",)) / rec["batches"]
