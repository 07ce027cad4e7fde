"""The readers of the program's spans (`program_spans.py`, the metrics
``src_roofline``, ``chain_device_ms`` and ``enqueue_idle_ms``) on hand-made
profiles: each device operation goes to the span its runtime call was made
in, found by correlation id, whatever its time on the device."""

from __future__ import annotations

import collections
import os
import types

import pytest
from torch.autograd import DeviceType

from bench_h100 import program_spans, tracing

import _small

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISPATCH, OS_TID, COLLECTOR = 1, 4242, 7


def _ev(name, start, end, *, device=False, kind=None, cid=0, thread=DISPATCH, note=False):
    return types.SimpleNamespace(
        name=name, device_type=DeviceType.CUDA if device else DeviceType.CPU,
        activity_type=kind or ("kernel" if device else "cpu_op"), id=cid,
        linked_correlation_id=0, thread=thread, is_user_annotation=note,
        time_range=types.SimpleNamespace(start=float(start), end=float(end)))


def _span(name, start, end):
    return _ev(name, start, end, kind="user_annotation", note=True)


def _launch(cid, at, thread=DISPATCH, name="cudaLaunchKernel"):
    return _ev(name, at, at + 1, kind="cuda_runtime", cid=cid, thread=thread)


def _op(name, cid, start, end):
    return _ev(name, start, end, device=True, cid=cid)


def _profile():
    """Two batches.  Batch one: the front end, the SRC (two operations, one
    launched by a call the profiler tied to no host operation, so under
    another thread id), the chain (a stage inside it), the epilogue; its
    download after the graph.  Batch two: the SRC alone.  One operation
    launched outside every span; the device's ranges of the spans; a
    synchronising call on the dispatching thread, and two of the
    collector's: one under its own thread id, one under the dispatching
    thread's (as some profiles give it) that other calls start inside."""
    return [
        _span("f9.graph", 0, 99),
        _span("f9.front_end", 1, 10), _launch(1, 2),
        _span("f9.src", 10, 31), _launch(2, 11), _launch(3, 12, thread=OS_TID),
        _span("f9.chain", 31, 59), _span("f9.chain.limiter", 40, 55), _launch(4, 41),
        _launch(5, 56, name="cudaMemcpyAsync"),
        _launch(10, 57, name="cudaStreamSynchronize"),
        _span("f9.epilogue", 61, 90), _launch(6, 62),
        _span("f9.link.download", 99.5, 125), _launch(7, 102, name="cudaMemcpyAsync"),
        _span("f9.graph", 200, 260), _span("f9.src", 210, 250), _launch(8, 211),
        _launch(9, 300),
        _launch(11, 150, thread=COLLECTOR, name="cudaEventSynchronize"),
        _ev("cudaEventSynchronize", 11.5, 40, kind="cuda_runtime", cid=12),
        _op("front_end_kernel", 1, 20, 30),
        _op("cycle_src_tc", 2, 40, 60),
        _op("gemv2T_kernel", 3, 80, 100),
        _op("wmax_reg", 4, 120, 130),
        _op("Memcpy DtoD (Device -> Device)", 5, 130, 135),
        _op("finish_pass", 6, 140, 150),
        _op("Memcpy DtoH (Device -> Pinned)", 7, 150, 170),
        _op("cycle_src_tc", 8, 300, 340),
        _op("elementwise_kernel", 9, 400, 405),
        _ev("f9.src", 40, 100, device=True, kind="gpu_user_annotation", note=True),
    ]


def _shape(valid):
    return dict(files=len(valid), channels=2, L=1, M=2, taps=[256], src_out=30000,
                valid=valid)


def _record(events=None, shapes=None):
    events = _profile() if events is None else events
    shapes = shapes or [_shape([40000, 30000]), _shape([50000, 10])]
    prof = types.SimpleNamespace(events=lambda: events)
    rec = tracing.record(prof, shapes, [])
    rec["f9"] = program_spans.build(events, rec)
    return rec


def _read(metric: str, rec):
    return tracing.load_file(os.path.join(HERE, "metrics", metric + ".py")).read(rec)


def test_device_ranges_of_spans_stay_out_of_the_events():
    rec = _record()
    assert len(rec["events"]) == 9
    assert not any(e["name"].startswith("f9.") for e in rec["events"])


@pytest.mark.parametrize("typed", [True, False], ids=["activity_types", "names_alone"])
def test_each_operation_goes_to_the_span_that_launched_it(typed):
    events = _profile()
    if not typed:
        # an older torch's events name no activity type
        for e in events:
            del e.activity_type
    f9 = _record(events)["f9"]
    got = [(o["name"], None if o["span"] is None else f9["spans"][o["span"]]["name"])
           for o in f9["ops"]]
    assert got == [("front_end_kernel", "f9.front_end"), ("cycle_src_tc", "f9.src"),
                   ("gemv2T_kernel", "f9.src"), ("wmax_reg", "f9.chain.limiter"),
                   ("Memcpy DtoD (Device -> Device)", "f9.chain"),
                   ("finish_pass", "f9.epilogue"),
                   ("Memcpy DtoH (Device -> Pinned)", "f9.link.download"),
                   ("cycle_src_tc", "f9.src"), ("elementwise_kernel", None)]
    parents = {s["name"]: s["parent"] for s in f9["spans"]}
    assert f9["spans"][parents["f9.chain.limiter"]]["name"] == "f9.chain"
    assert parents["f9.link.download"] is None
    # the collector's waits are not the dispatching thread's
    assert [(s["name"], f9["spans"][s["span"]]["name"]) for s in f9["syncs"]] == [
        ("cudaStreamSynchronize", "f9.chain")]


def test_src_roofline_against_a_hand_count():
    # L = 1, M = 2, 256 taps: ceil(v / 2) outputs a file, at most 30,000;
    # bytes: each file's input and outputs, the taps once a batch
    bound = sum(max(2.0 * 2 * 256 * outs / 165e12, nbytes / 3.35e12) for outs, nbytes in (
        (20000 + 15000, 4.0 * 2 * (40000 + 30000 + 2 * 30000) + 4.0 * 256),
        (25000 + 5, 4.0 * 2 * (50000 + 10 + 2 * 30000) + 4.0 * 256)))
    # launched inside f9.src: 20 + 20 + 40 us on the device
    assert _read("src_roofline", _record()) == pytest.approx(100.0 * bound / 80e-6)


def test_chain_device_ms_reads_what_the_chain_launched():
    # the limiter's 10 us and the chain's own copy's 5, over two batches
    assert _read("chain_device_ms", _record()) == pytest.approx(15e-3 / 2)


def test_chain_device_ms_is_none_without_a_chain():
    events = [e for e in _profile() if not e.name.startswith("f9.chain")]
    rec = _record(events)
    assert _read("chain_device_ms", rec) is None
    assert _read("src_roofline", rec) is not None


def test_enqueue_idle_ms_counts_the_gaps_inside_spans():
    rec = _record()
    assert rec["busy"] == [(20, 30), (40, 60), (80, 100), (120, 135), (140, 170), (300, 340),
                           (400, 405)]
    # the gaps at 30 (f9.src open), 60 (the first graph, between its chain
    # and its epilogue) and 100 (f9.link.download) count; those at 135
    # (the first batch's download has ended), 170 and 340 (after the
    # second graph) open in no span
    assert _read("enqueue_idle_ms", rec) == pytest.approx((10 + 20 + 20) / 1e3 / 2)
    idle = {r["span"]: r["idle_ms"] for r in program_spans.table(rec)}
    assert idle["f9.src"] == pytest.approx(10 / 1e3 / 2)
    assert idle["f9.graph"] == pytest.approx(20 / 1e3 / 2)
    assert idle[program_spans.OUTSIDE] == pytest.approx((5 + 130 + 60) / 1e3 / 2)


def test_table_accounts_for_every_operation_and_gap():
    rec = _record()
    rows = {r["span"]: r for r in program_spans.table(rec)}
    assert sum(r["ops"] for r in rows.values()) * 2 == len(rec["events"])
    assert sum(r["device_ms"] for r in rows.values()) * 2 == pytest.approx(
        sum(e["end"] - e["start"] for e in rec["events"]) / 1e3)
    assert rows["f9.graph"]["host_ms"] == pytest.approx((99 + 60) / 1e3 / 2)
    # the first graph less front end, SRC, chain and epilogue; the second less its SRC
    assert rows["f9.graph"]["self_ms"] == pytest.approx((99 - 9 - 21 - 28 - 29 + 60 - 40)
                                                        / 1e3 / 2)
    assert rows[program_spans.OUTSIDE]["ops"] == 0.5


def test_readers_are_silent_without_the_programs_spans():
    events = [e for e in _profile() if not e.name.startswith("f9.")]
    rec = _record(events)
    for metric in ("src_roofline", "chain_device_ms", "enqueue_idle_ms"):
        assert _read(metric, rec) is None


@pytest.mark.parametrize("workload", ["studio48.cd_masters", "reverb48.stems_reverb"])
def test_a_traced_run_finds_its_profile_and_the_programs_spans(workload, monkeypatch):
    """The harness's own traced run on the CPU: its readers find the
    finished profile the record was made from, as long as the harness
    keeps it, and in it each batch's spans; without device operations
    they read nothing."""
    found = []
    of = program_spans.of

    def spy(rec):
        found.append(of(rec))
        return found[-1]

    monkeypatch.setattr(program_spans, "of", spy)
    rc, res = _small.run(workload, trace=1)
    assert rc == 0 and res["correct"]
    assert found and found[0] is not None and all(f is found[0] for f in found)
    f9 = found[0]
    batches = _small.overrides(workload)["traffic"]["trace_batches"]
    names = collections.Counter(s["name"] for s in f9["spans"])
    # a batch uploads five things (wire, lengths, seeds, latency, noise
    # floor); the studio job has no latency to trim, no chain, no tail
    each = ["f9.graph", "f9.front_end", "f9.src", "f9.epilogue", "f9.tail_floor",
            "f9.link.download"]
    if workload.startswith("reverb48"):
        each += ["f9.chain", "f9.trim", "f9.tail"] + ["f9.chain." + s for s in (
            "delay", "biquad", "compressor", "convolutionreverb", "limiter")]
    assert names == {"f9.link.upload": 5 * batches, **{n: batches for n in each}}
    graphs = [i for i, s in enumerate(f9["spans"]) if s["name"] == "f9.graph"]
    for i, s in enumerate(f9["spans"]):
        if s["name"] not in ("f9.graph", "f9.link.download"):
            assert program_spans.within(f9, i, "f9.graph"), s
    assert all(f9["spans"][i]["parent"] is None for i in graphs)
    assert f9["ops"] == [] and f9["gaps"] == []
    for metric in ("src_roofline", "chain_device_ms", "enqueue_idle_ms"):
        assert metric not in res["metrics"]
