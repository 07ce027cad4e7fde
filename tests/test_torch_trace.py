"""The device path's named spans (`f9tpu_torch.spans`).

With no profiler recording, every span the program opens is the one shared
no-op context.  Under a CPU `torch.profiler` run of `process_batch_raw`
(a studio job, and an insert chain in reverb mode) the trace holds every
documented span, nested as documented: one ``f9.graph`` a call on the
dispatching thread holding every other program span of the batch, and
``f9.link.download`` after it.  Recording changes no result bit."""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from f9tpu_torch import spans  # noqa: E402
from f9tpu_torch.config import ProcessingConfig  # noqa: E402
from f9tpu_torch.ops import chain as ch  # noqa: E402
from f9tpu_torch.pipeline import graph, link  # noqa: E402

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "f9tpu_torch")
FILES, C, BUCKET, BITS = 2, 2, 8192, 24
VALID = np.array([8192, 5000], np.int32)
SEEDS = np.array([11, 12], np.int32)

STAGES = ("delay", "biquad", "compressor", "convolutionreverb", "limiter")
#: the spans of a studio batch, and those a chain in reverb mode adds
STUDIO = ("f9.graph", "f9.link.upload", "f9.front_end", "f9.src", "f9.trim", "f9.epilogue",
          "f9.tail_floor", "f9.link.download")
REVERB = STUDIO + ("f9.chain", "f9.tail") + tuple("f9.chain." + s for s in STAGES)


def _literal_spans() -> set:
    """Every constant name passed to `span` or `spanned` in the package's
    sources."""
    names = set()
    for d, _, fs in os.walk(PKG):
        for f in fs:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(d, f)) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "id", None) in ("span", "spanned")
                        and node.args and isinstance(node.args[0], ast.Constant)):
                    names.add(node.args[0].value)
    return names


def test_the_documented_spans_are_the_programs():
    assert _literal_spans() == set(REVERB) - {"f9.chain." + s for s in STAGES}


def test_spanned_keeps_the_function_and_records_each_call():
    @spans.spanned("f9.probe")
    def add(a, b=1):
        """Adds."""
        return a + b

    assert add.__name__ == "add" and add.__doc__ == "Adds." and add(2, b=3) == 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        add(1)
        add(2)
    assert sum(e.name == "f9.probe" for e in prof.events()) == 2


@pytest.mark.parametrize("name", REVERB)
def test_span_is_the_shared_noop_with_nothing_recording(name):
    assert spans.span(name) is spans._OFF
    with spans.span(name) as inside:
        assert inside is None


def _chain():
    rng = np.random.default_rng(3)
    ir = (rng.standard_normal((2, 1500)) * np.exp(-np.arange(1500) / 300.0)).astype(np.float32)
    ir[:, 0] = 0.5
    return ch.Chain(ch.Delay(0.002), ch.Biquad("peaking", 1000.0, q=1.0, gain_db=3.0),
                    ch.Compressor(threshold_db=-18.0, ratio=3.0, attack_ms=5.0,
                                  release_db_per_s=80.0, knee_db=6.0, makeup_db=0.0,
                                  detector_ms=1.0),
                    ch.ConvolutionReverb(ir, wet=1.0, dry=0.0),
                    ch.Limiter(ceiling_db=-0.3, lookahead_ms=1.5, release_db_per_s=300.0))


def _case(kind: str):
    if kind == "studio":
        return ProcessingConfig(output_dir="unused", target_rate=48000), 37, STUDIO
    cfg = ProcessingConfig(output_dir="unused", target_rate=48000, chain=_chain(),
                           reverb_mode=True, max_tail_seconds=0.4, channel_routing=[1, 0])
    return cfg, 101, REVERB


def _wire() -> np.ndarray:
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (FILES, BUCKET * C * BITS // 8), dtype=np.uint8)
    for i, n in enumerate(VALID):
        raw[i, n * C * BITS // 8:] = 0
    return raw


def _batch(cfg, latency):
    """One dispatch as the batch job makes it: the graph, then the six
    results queued for the host."""
    res = graph.process_batch_raw(_wire(), VALID, cfg, 44100, SEEDS, in_channels=C,
                                  in_bits=BITS, latency_frames=latency,
                                  noise_floor_db=-90.0 if cfg.reverb_mode else None,
                                  device="cpu")
    return link.Download(res.codes, res.out_frames, res.peak_db, res.rms_db,
                         res.noise_floor_db, res.tail_terminated).get()


def _spans_of(prof) -> list:
    return sorted((e for e in prof.events() if e.name.startswith("f9.")),
                  key=lambda e: (e.time_range.start, -e.time_range.end))


def _inside(a, b) -> bool:
    return (a.thread == b.thread and b.time_range.start <= a.time_range.start
            and a.time_range.end <= b.time_range.end)


@pytest.mark.parametrize("kind", ["studio", "reverb_chain"])
def test_traced_batches_hold_every_span_nested(kind):
    cfg, latency, names = _case(kind)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            _batch(cfg, latency)
    got = _spans_of(prof)
    assert {e.name for e in got} == set(names)
    calls = [e for e in got if e.name == "f9.graph"]
    downloads = [e for e in got if e.name == "f9.link.download"]
    assert len(calls) == 2 and len(downloads) == 2
    for call, dl, nxt in zip(calls, downloads, calls[1:] + [None]):
        # the batch's downloads are queued after its graph, before the next
        assert call.time_range.end <= dl.time_range.start
        assert nxt is None or dl.time_range.end <= nxt.time_range.start
    for e in got:
        if e.name not in ("f9.graph", "f9.link.download"):
            assert sum(_inside(e, c) for c in calls) == 1, e.name
    for e in got:
        if e.name.startswith("f9.chain."):
            assert sum(_inside(e, c) for c in got if c.name == "f9.chain") == 1, e.name
    for c in (e for e in got if e.name == "f9.chain"):
        stages = [e.name for e in got if e.name.startswith("f9.chain.") and _inside(e, c)]
        assert stages == ["f9.chain." + s for s in STAGES]


@pytest.mark.parametrize("kind", ["studio", "reverb_chain"])
def test_recording_changes_no_result_bit(kind):
    cfg, latency, _ = _case(kind)
    plain = _batch(cfg, latency)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _batch(cfg, latency)
    assert len(plain) == len(traced) == 6
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
