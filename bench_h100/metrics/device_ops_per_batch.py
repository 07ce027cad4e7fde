"""Device operations (kernels, copies, memsets) a batch in the trace
(pipeline/graph.py and the link)."""


def read(rec):
    return len(rec["events"]) / rec["batches"] if rec["events"] else None
