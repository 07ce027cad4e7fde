"""Host time of one `process_batch_raw` call (pipeline/graph.py), from the
harness's span around it, in ms: what the host takes to enqueue a batch."""


def read(rec):
    d = [s["end"] - s["start"] for s in rec["spans"] if s["name"] == "bench.process_batch_raw"]
    return sum(d) / len(d) / 1e3 if d else None
