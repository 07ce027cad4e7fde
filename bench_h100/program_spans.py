"""The program's own spans (``f9.*``, `f9tpu_torch/spans.py`) in a traced
run, and the device operations each launched.

`tracing.record` keeps each device operation's name and interval but not
the profiler's link from it to the runtime call that launched it, so the
readers of this module take the spans and that link from the finished
profile itself (the live one whose device operations and host events are
the record's: the harness keeps it until its readers have run) and add
them to the record once, as ``rec["f9"]``:

- ``spans``: each ``f9.`` host range, with its name, start, end, thread
  and parent (the index of the innermost ``f9.`` span that holds it on its
  thread, or None);
- ``ops``: each device operation of ``rec["events"]`` with the span it
  was launched in: the innermost ``f9.`` span open on the launching thread
  when the runtime call that bears the operation's correlation id
  (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...) began; None, the
  ``(outside)`` row, where no span was open or no such call was recorded.
  An operation is never put down to a span by overlap of time on the
  device;
- ``syncs``: the synchronising runtime calls of the launching threads,
  each with the span it was made in.  A call that another host event
  starts inside was made on another thread (the collector's wait), even
  where the profile gives it the launching thread's id: a thread that
  waits in a call starts nothing until it returns;
- ``gaps``: the idle gaps of the busy union (``rec["busy"]``, as
  ``device_idle_pct`` reads it), each with the innermost span open on
  the dispatching thread at its first instant.

A profile without the program's spans (a program that has none) gives
empty spans, and a record without device operations (a run on the CPU)
nothing to read, so the readers return None.
"""

from __future__ import annotations

import bisect
import collections

from torch.autograd import DeviceType

#: the program's span names start with it
PREFIX = "f9."
#: the row of the operations, gaps and calls in no program span
OUTSIDE = "(outside)"
#: runtime calls that wait for the device (``cudaMemcpy`` alone: the
#: synchronous copy)
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy")
#: how far back from an instant to look for a span open at it
_LOOK_BACK = 512


def _is_runtime(e) -> bool:
    """A CUDA runtime or driver call (the profile of an older torch names
    no activity type: its calls are told by name)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind in ("cuda_runtime", "cuda_driver")
    return e.name.startswith("cu") and not getattr(e, "is_user_annotation", False)


def _device_ops(events) -> list:
    """The profile's device operations, filtered as `tracing.record`
    filters them (so in the record's order)."""
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not (e.name.startswith("bench.") or getattr(e, "is_user_annotation", False))]


def _on_device(e) -> bool:
    return e.device_type != DeviceType.CPU


def _same(events, got) -> bool:
    return len(events) == len(got) and all(
        e.name == g["name"] and float(e.time_range.start) == g["start"]
        and float(e.time_range.end) == g["end"] for e, g in zip(events, got))


def _matches(events, rec) -> bool:
    """Whether ``events`` are those `tracing.record` made ``rec`` from: its
    device operations and its host events, in order."""
    return (_same(_device_ops(events), rec["events"])
            and _same([e for e in events if e.device_type != DeviceType.CUDA], rec["cpu"]))


def _profile_events(rec):
    """The events of the finished profile the record was made from: the
    harness keeps it until its readers have run."""
    import gc

    from torch.profiler import profile

    for obj in gc.get_objects():
        if not issubclass(type(obj), profile):
            continue
        inner = getattr(obj, "profiler", None)
        events = getattr(inner, "function_events", None)
        if events is not None and _matches(events, rec):
            return events
    return None


class _Open:
    """The innermost span open at an instant on one thread."""

    def __init__(self, spans: list, idx: list[int]):
        self.idx = sorted(idx, key=lambda i: spans[i]["start"])
        self.starts = [spans[i]["start"] for i in self.idx]
        self.spans = spans

    def at(self, t: float):
        j = bisect.bisect_right(self.starts, t)
        for i in reversed(self.idx[max(0, j - _LOOK_BACK):j]):
            if self.spans[i]["end"] >= t:
                return i
        return None


def build(events, rec: dict) -> dict:
    """``rec["f9"]`` from the profile's ``events`` (`FunctionEvent`s)."""
    spans = sorted((dict(name=e.name, start=float(e.time_range.start),
                         end=float(e.time_range.end), thread=e.thread)
                    for e in events if e.name.startswith(PREFIX) and not _on_device(e)),
                   key=lambda s: (s["start"], -s["end"]))
    by_thread = collections.defaultdict(list)
    for i, s in enumerate(spans):
        by_thread[s["thread"]].append(i)
    for idx in by_thread.values():
        stack: list[int] = []
        for i in idx:
            while stack and spans[stack[-1]]["end"] <= spans[i]["start"]:
                stack.pop()
            spans[i]["parent"] = stack[-1] if stack else None
            stack.append(i)
    runtime = {e.id: e for e in events if not _on_device(e) and _is_runtime(e)}
    graph_threads = {s["thread"] for s in spans if s["name"] == "f9.graph"}
    launch_threads = set(graph_threads)
    ops = []
    for e in _device_ops(events):
        call = runtime.get(e.id)
        if call is not None:
            launch_threads.add(call.thread)
        ops.append((e, call))
    # the launching threads' spans: a launch recorded under another
    # thread id than its spans' (a runtime call the profiler did not tie
    # to a host operation) still finds the dispatching thread's spans
    open_on = {t: _Open(spans, by_thread[t]) for t in by_thread}
    on_disp = _Open(spans, [i for t in graph_threads for i in by_thread[t]])

    def span_at(thread, t):
        return (open_on[thread] if thread in open_on else on_disp).at(t)

    out_ops = [dict(name=e.name, start=float(e.time_range.start), end=float(e.time_range.end),
                    span=None if call is None
                    else span_at(call.thread, float(call.time_range.start)))
               for e, call in ops]
    starts = sorted(float(e.time_range.start) for e in events if not _on_device(e))

    def leaf(e) -> bool:
        a, b = float(e.time_range.start), float(e.time_range.end)
        return bisect.bisect_left(starts, b) - bisect.bisect_right(starts, a) == 0

    syncs = [dict(name=e.name, span=span_at(e.thread, float(e.time_range.start)))
             for e in runtime.values()
             if e.name in SYNCS and e.thread in launch_threads and leaf(e)]
    busy = rec["busy"]
    gaps = [dict(start=a, end=b, span=on_disp.at(a)) for (_, a), (b, _) in zip(busy, busy[1:])]
    return dict(spans=spans, ops=out_ops, syncs=syncs, gaps=gaps)


def of(rec: dict) -> dict | None:
    """``rec["f9"]``, made once; None where its profile is gone."""
    if "f9" not in rec:
        events = _profile_events(rec)
        rec["f9"] = build(events, rec) if events is not None else None
    return rec["f9"]


def within(f9: dict, i, name: str) -> bool:
    """Whether span ``i`` is a span named ``name`` or lies inside one."""
    while i is not None:
        if f9["spans"][i]["name"] == name:
            return True
        i = f9["spans"][i]["parent"]
    return False


def device_seconds(f9: dict, name: str) -> float:
    """Device seconds of the operations launched inside spans ``name``."""
    return sum(o["end"] - o["start"] for o in f9["ops"] if within(f9, o["span"], name)) / 1e6


def holds(f9: dict | None, name: str) -> bool:
    return f9 is not None and any(s["name"] == name for s in f9["spans"])


def table(rec: dict) -> list[dict]:
    """One row a span name, and ``(outside)``, each a batch's average:
    host ms in all and its own (less its ``f9.`` children), device ms and
    operations launched, idle ms opened (by the innermost span at the gap's
    first instant) and synchronising runtime calls."""
    f9 = of(rec)
    if f9 is None:
        return []
    n = max(1, rec["batches"])
    rows: dict[str, collections.Counter] = {}

    def row(i) -> collections.Counter:
        name = OUTSIDE if i is None else f9["spans"][i]["name"]
        return rows.setdefault(name, collections.Counter())

    for i, s in enumerate(f9["spans"]):
        d = s["end"] - s["start"]
        row(i).update(host_ms=d / 1e3, self_ms=d / 1e3)
        if s["parent"] is not None:
            row(s["parent"])["self_ms"] -= d / 1e3
    row(None)
    for o in f9["ops"]:
        row(o["span"]).update(device_ms=(o["end"] - o["start"]) / 1e3, ops=1)
    for g in f9["gaps"]:
        row(g["span"]).update(idle_ms=(g["end"] - g["start"]) / 1e3)
    for c in f9["syncs"]:
        row(c["span"]).update(syncs=1)
    keys = ("host_ms", "self_ms", "device_ms", "ops", "idle_ms", "syncs")
    return [dict(span=name, **{k: r[k] / n for k in keys}) for name, r in rows.items()]


def format_table(rows: list[dict]) -> str:
    head = ("span", "host ms", "self ms", "device ms", "ops", "idle ms", "syncs")
    lines = ["{:<28} {:>9} {:>9} {:>10} {:>8} {:>8} {:>6}".format(*head)]
    for r in rows:
        lines.append("{:<28} {:>9.3f} {:>9.3f} {:>10.4f} {:>8.2f} {:>8.4f} {:>6.2f}".format(
            r["span"], r["host_ms"], r["self_ms"], r["device_ms"], r["ops"], r["idle_ms"],
            r["syncs"]))
    return "\n".join(lines)
