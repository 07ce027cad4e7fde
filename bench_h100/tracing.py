"""The traced run's record: `torch.profiler`'s device events (kernels,
copies, memsets on every stream) and the harness's own host spans
(``bench.*``), reduced to what the per-layer readers (``metrics/``) read.

The traced window runs from the first device operation of the traced
batches to the last; the device is busy where any operation runs, the
union of their intervals over all streams, so a copy on the side stream
that overlaps a kernel counts once.
"""

from __future__ import annotations

import bisect
import collections
import glob
import os
import re

from .cell import ROOT

#: the program's launch counters, and a part of the name of the kernel
#: each counts: a kernel whose counter moved in the warm-up must be traced
COUNTER_KERNELS = {
    ("src_kernel", "launches"): "cycle_src",
    ("frontend", "launches"): "front_end_kernel",
    ("epilogue", "launches"): "finish_pass",
    ("cycle_fold", "launches"): "cycle_fold_kernel",
    ("chain_kernels", "launches_mac"): "upols_mac",
    ("chain_kernels", "launches_fold"): "fir_fold_kernel",
    ("chain_kernels", "launches_ma"): "ma_past",
    ("chain_kernels", "launches_env"): "env_scan",
    ("chain_kernels", "launches_wmax"): "wmax_",
}


def read_counters(mods) -> dict:
    by_name = {m.__name__.rsplit(".", 1)[-1]: m for m in mods}
    return {key: int(getattr(by_name[key[0]], key[1], 0)) for key in COUNTER_KERNELS}


def counters_moved(before: dict, after: dict) -> list[str]:
    """The kernels whose counters rose between two readings."""
    return [COUNTER_KERNELS[k] for k in COUNTER_KERNELS if after[k] > before[k]]


def port_kernel_names() -> list[str]:
    """Every ``__global__`` function of the program's CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "f9tpu_torch", "csrc", "*.cu")):
        with open(path) as f:
            src = f.read()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(", src))
    return sorted(names)


def is_port(name: str, port: list[str]) -> bool:
    return any(re.search(r"\b" + re.escape(p) + r"\b", name) for p in port)


def profiler(on_card: bool):
    """``(profile context, span factory)`` for a traced stretch."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=acts), record_function


def _kind(name: str) -> str:
    if name.startswith("Memcpy HtoD"):
        return "htod"
    if name.startswith("Memcpy DtoH"):
        return "dtoh"
    if name.startswith("Memcpy"):
        return "dtod"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def _union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def record(prof, shapes: list[dict], port: list[str]) -> dict:
    """The record the metric readers take, from a finished profile of the
    batches described by ``shapes``."""
    from torch.autograd import DeviceType

    events, spans, cpu = [], [], []
    for e in prof.events():
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith("bench.") or getattr(e, "is_user_annotation", False):
                continue                      # a host span's range on the device timeline
            events.append(dict(name=e.name, start=t0, end=t1, kind=_kind(e.name)))
        else:
            cpu.append(dict(name=e.name, start=t0, end=t1, thread=e.thread))
            if e.name.startswith("bench."):
                spans.append(dict(name=e.name, start=t0, end=t1, thread=e.thread))
    if events:
        w0 = min(e["start"] for e in events)
        w1 = max(e["end"] for e in events)
    else:
        w0 = w1 = 0.0
    busy = _union((e["start"], e["end"]) for e in events)
    return dict(events=events, spans=spans, cpu=cpu, batches=len(shapes), shapes=shapes,
                port=port, window=(w0, w1),
                window_s=(w1 - w0) / 1e6, busy=busy,
                busy_s=sum(b - a for a, b in busy) / 1e6)


def port_kernels_seen(rec: dict) -> list[str]:
    return sorted({p for e in rec["events"] if e["kind"] == "kernel"
                   for p in rec["port"] if re.search(r"\b" + re.escape(p) + r"\b", e["name"])})


def missing_kernels(rec: dict, launched: list[str]) -> list[str]:
    """The launched kernels (by a part of their name) the trace lacks."""
    names = [e["name"] for e in rec["events"] if e["kind"] == "kernel"]
    return [k for k in launched if not any(k in n for n in names)]


def device_seconds(rec: dict, parts=None, kinds=("kernel",), port=None) -> float:
    """Device seconds of the record's operations of ``kinds`` whose name
    holds one of ``parts`` (every name with None), of the program's own
    kernels (``port=True``) or of the others (``port=False``)."""
    total = 0.0
    for e in rec["events"]:
        if e["kind"] not in kinds:
            continue
        if parts is not None and not any(p in e["name"] for p in parts):
            continue
        if port is not None and is_port(e["name"], rec["port"]) != port:
            continue
        total += e["end"] - e["start"]
    return total / 1e6


def breakdown(rec: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps of the
    traced window summed by what the dispatching thread was doing when the
    device went idle (its harness span and innermost operation)."""
    by_op: collections.Counter = collections.Counter()
    for e in rec["events"]:
        by_op[e["name"][:120]] += (e["end"] - e["start"]) / 1e6
    disp = {s["thread"] for s in rec["spans"] if s["name"] == "bench.process_batch_raw"}
    host = sorted((c for c in rec["cpu"] if c["thread"] in disp), key=lambda c: c["start"])
    mine = sorted((s for s in rec["spans"] if s["thread"] in disp), key=lambda s: s["start"])
    seqs = [(seq, [c["start"] for c in seq]) for seq in (mine, host)]
    gaps: collections.Counter = collections.Counter()
    busy = rec["busy"]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = []
        for seq, starts in seqs:
            i = bisect.bisect_right(starts, a)
            inside = [c["name"] for c in seq[max(0, i - 512):i] if c["end"] >= a]
            label.append(inside[-1] if inside else "-")
        gaps[f"{label[0]} > {label[1]}"[:120]] += (b - a) / 1e6
    return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}


def load_file(path: str):
    """The module in ``path`` (a metric reader or a roofline count), found
    by its file name: the names hold dots."""
    import importlib.util

    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_share(rec: dict, kernel: str) -> float | None:
    """Percent of the least time (``roofline/<kernel>.py`` against the
    card's peaks) that the kernel's traced device time reaches; None where
    the trace holds no such kernel or the cell runs no such stage."""
    from .roofline import peaks

    mod = load_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "roofline",
                                 kernel + ".py"))
    secs = device_seconds(rec, parts=mod.NAMES)
    if secs <= 0:
        return None
    bound = 0.0
    for shape in rec["shapes"]:
        w = mod.work(shape)
        if w is None:
            return None
        bound += peaks.bound_s(*w)
    return 100.0 * bound / secs
