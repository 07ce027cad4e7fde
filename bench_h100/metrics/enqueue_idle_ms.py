"""Device idle a batch, in ms, that the program's host enqueue opens: the
gaps of the busy union (as device_idle_pct reads it) at whose first
instant the dispatching thread is inside one of the program's ``f9.``
spans.  Listed for the device-bound cell alone: where the host paces the
card, the trace's recording of every host operation sets the reading
(PERF.md §6)."""

from bench_h100 import program_spans


def read(rec):
    f9 = program_spans.of(rec)
    if not rec["events"] or not program_spans.holds(f9, "f9.graph"):
        return None
    idle = sum(g["end"] - g["start"] for g in f9["gaps"] if g["span"] is not None)
    return idle / 1e3 / rec["batches"]
