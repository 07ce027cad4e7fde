"""Reverb-tail detection, latency calibration through an insert chain, and
the reverb + chain + routing batch graph: the port against the JAX package
on the same numpy inputs.

`detect_tail_end` must give identical ``end_frame`` and ``terminated``;
calibration identical latency and cache key (noise floor within 1 dB,
peak within 1e-6); the graph identical ``out_frames`` and
``tail_terminated``, metrics within 1e-4 dB (measured <= 1.5e-5 dB) and
codes within 2 LSB at 24 bits (measured 2; the JAX package's own bound
between two of its SRC forms at small sizes,
`tests/test_resample_parity.py`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.ops import trim as jtrim  # noqa: E402
from f9tpu.pipeline import calibration as jcal  # noqa: E402
from f9tpu.pipeline import graph as jgraph  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops import trim as ttrim  # noqa: E402
from f9tpu_torch.pipeline import calibration as tcal  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402

RATE = 8000


def _tail_batch(seed: int, files: int = 3, chans: int = 2, frames: int = 6000):
    """Noise bursts that decay into silence at file-specific points, one
    file that never falls quiet, and a leading silence in file 0."""
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((files, chans, frames))
    t = np.arange(frames)
    for i in range(files):
        stop = 1500 + 1300 * i
        x[i, :, stop:] *= np.exp(-(t[stop:] - stop) / 120.0)
    x[0, :, :400] = 0.0
    x[-1] += 0.01 * rng.standard_normal((chans, frames))      # never quiet
    x[:, 1] *= 0.5                                          # a quieter channel
    return x.astype(np.float32)


@pytest.mark.parametrize("mode", ["peak", "rms"])
@pytest.mark.parametrize("case", [
    dict(),
    dict(margin=30.0, nf=-70.0),
    dict(nf=None),                                # -80 dB fallback
    dict(min_frames=np.array([5000, 0, 3000], np.int32)),
    dict(min_frames=2500),
    dict(window_ms=70, hop_ms=20),                # window not a hop multiple
    dict(window_ms=100, hop_ms=50, consecutive=1),
    dict(consecutive=5),
    dict(frames=700),                             # shorter than one window
    dict(two_d=True),
])
def test_detect_tail_end_matches_jax(mode, case):
    """Identical end frames and termination flags."""
    x = _tail_batch(seed=len(str(case)), frames=case.get("frames", 6000))
    if case.get("two_d"):
        x = x[:, 0]
    nf = case.get("nf", -60.0)
    kw = dict(rate=RATE, window_ms=case.get("window_ms", 100),
              hop_ms=case.get("hop_ms", 50), consecutive=case.get("consecutive", 3),
              mode=mode)
    mf = case.get("min_frames", 0)
    nf_arg = 1.0 if nf is None else nf
    margin = case.get("margin", 10.0)
    we, wt = jtrim.detect_tail_end(jnp.asarray(x), nf_arg, margin,
                                   min_frames=jnp.asarray(mf), **kw)
    ge, gt = ttrim.detect_tail_end(torch.from_numpy(x), nf_arg, margin,
                                   min_frames=torch.as_tensor(mf), **kw)
    assert ge.dtype == torch.int32 and gt.dtype == torch.bool
    assert np.array_equal(ge.numpy(), np.asarray(we)), (ge, we)
    assert np.array_equal(gt.numpy(), np.asarray(wt))
    if x.shape[-1] >= 800 and not case.get("consecutive") == 5:
        assert gt.numpy()[:-1].any() and not gt.numpy()[-1]


def test_detect_tail_end_refuses_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        ttrim.detect_tail_end(torch.zeros(1, 1, 900), -60.0, 10.0, rate=RATE,
                              mode="loud")


def test_pad_tail_and_interleaved_frames_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    assert np.array_equal(ttrim.pad_tail(torch.from_numpy(x), 5).numpy(),
                          np.asarray(jtrim.pad_tail(jnp.asarray(x), 5)))
    for lat in (7, np.array([6, -7, 0])):
        assert np.array_equal(ttrim.interleaved_to_frames(lat, 2).numpy(),
                              np.asarray(jtrim.interleaved_to_frames(lat, 2)))


# ------------------------------------------------------------- calibration

def _cal_chains():
    ir = (np.random.default_rng(3).standard_normal(3000)
          * np.exp(-np.arange(3000) / 400.0)).astype(np.float32) * 0.05
    jc = jchain.Chain(jchain.Delay(0.0021), jchain.Biquad("peaking", 1000.0, 1.0, 3.0),
                      jchain.Compressor(-18.0, 3.0, 1.0, 400.0),
                      jchain.ConvolutionReverb(ir, 0.5, 1.0), jchain.Limiter(-0.3))
    return jc, tchain.chain_from_jax(jc)


@pytest.mark.parametrize("with_chain", [False, True])
def test_calibration_through_chain_matches_jax(tmp_path, with_chain):
    """Identical latency and cache key; peak within 1e-6 and noise floor
    within 1 dB (or both numerically silent)."""
    rate_in, rate_out = 44100, 48000
    kw_j, kw_t, sig = {}, {}, ""
    if with_chain:
        jc, tc = _cal_chains()
        sig = tc.sig_str()
        assert sig == jc.sig_str()
        ring = tc.tail_frames(rate_out)
        cap = max(jcal.CAPTURE_FRAMES, -(-(3 * ring + (1 << 15)) * rate_in // rate_out))
        from f9tpu.ops.resample import resample_rates as jres
        from f9tpu_torch.ops.resample import resample_rates as tres

        kw_j = dict(chain_fn=lambda x: jc.apply(jres(x, rate_in, rate_out), rate_out),
                    chain_sig=sig, capture_frames=cap, ringout_frames=ring)
        kw_t = dict(chain_fn=lambda x: tc.apply(tres(x, rate_in, rate_out), rate_out),
                    chain_sig=sig, capture_frames=cap, ringout_frames=ring)
    want = jcal.CalibrationCache(str(tmp_path / "j.json")).get_or_measure(
        rate_in, rate_out, **kw_j)
    tpath = str(tmp_path / "t.json")
    got = tcal.CalibrationCache(tpath).get_or_measure(rate_in, rate_out,
                                                      device="cpu", **kw_t)
    assert got.latency_frames == want.latency_frames
    assert got.latency_frames == (101 + 72 if with_chain else 0)   # delay + lookahead
    assert abs(got.peak_amplitude - want.peak_amplitude) <= 1e-6
    assert (abs(got.noise_floor_db - want.noise_floor_db) <= 1.0
            or max(got.noise_floor_db, want.noise_floor_db) < -150.0)
    key = jcal.CalibrationCache.key(rate_in, rate_out, "high", "sinc", sig)
    assert tcal.CalibrationCache.key(rate_in, rate_out, "high", "sinc", sig) == key
    assert jcal.CalibrationCache(tpath)._data[key].latency_frames == got.latency_frames


def test_unsigned_chain_is_measured_uncached_and_invalidate(tmp_path):
    cache = tcal.CalibrationCache(str(tmp_path / "c.json"))
    calls = []

    def chain_fn(x):
        calls.append(1)
        return tchain.Delay(0.001).apply(
            tcal.resample_rates(x, 48000, 48000), 48000)

    for _ in range(2):
        res = cache.get_or_measure(48000, 48000, chain_fn=chain_fn, device="cpu")
        assert res.latency_frames == 48
    assert len(calls) == 2 and cache._data == {}
    cache.get_or_measure(48000, 48000, chain_fn=chain_fn, chain_sig="abc", device="cpu")
    cache.get_or_measure(44100, 48000, device="cpu")
    cache.get_or_measure(44100, 480000, quality="low", device="cpu")
    assert len(calls) == 3 and len(cache._data) == 3
    cache.invalidate("44100->48000")
    assert sorted(cache._data) == ["44100->480000:sinc:low:",
                                   "48000->48000:sinc:high:abc"]
    cache.invalidate()
    assert cache._data == {}
    assert tcal.CalibrationCache(str(tmp_path / "c.json"))._data == {}


# ------------------------------------------------------------------- graph

FILES, C, T = 3, 2, 6000
VALID = np.array([6000, 2500, 0], np.int32)
SEEDS = np.array([3, 5, 7], np.int32)


def _graph_chain(stereo_ir: bool):
    rng = np.random.default_rng(11)
    shape = (2, 2400) if stereo_ir else (2400,)
    ir = (rng.standard_normal(shape) * np.exp(-np.arange(2400) / 250.0)).astype(np.float32)
    ir *= 0.08
    return jchain.Chain(jchain.Delay(0.001), jchain.Biquad("peaking", 1000.0, 1.0, 3.0),
                        jchain.Compressor(-18.0, 3.0, 1.0, 400.0),
                        jchain.ConvolutionReverb(ir), jchain.Limiter(-0.3))


def _cfgs(**kw):
    jc = kw.pop("chain", None)
    return (ProcessingConfig(output_dir="/tmp/x", target_rate=48000, chain=jc, **kw),
            TConfig(output_dir="/tmp/x", target_rate=48000,
                    chain=None if jc is None else tchain.chain_from_jax(jc), **kw))


def _input(channels: int) -> np.ndarray:
    rng = np.random.default_rng(channels)
    t = np.arange(T) / 44100
    x = 0.3 * np.sin(2 * np.pi * 700.0 * t) + 0.05 * rng.standard_normal((FILES, channels, T))
    x = x.astype(np.float32)
    for i, n in enumerate(VALID):
        x[i, :, n:] = 0.0
    return x


def _check(got, want, codes_got, codes_want):
    assert np.array_equal(got.out_frames.numpy(), np.asarray(want.out_frames))
    assert np.array_equal(got.tail_terminated.numpy(), np.asarray(want.tail_terminated))
    for name in ("peak_db", "rms_db", "noise_floor_db"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.abs(g - w).max() <= 1e-4, (name, g, w)
    diff = np.abs(codes_got.astype(np.int64) - codes_want.astype(np.int64))
    assert diff.max() <= 2, f"{int((diff != 0).sum())} codes differ, max {diff.max()}"


@pytest.mark.parametrize("case", [
    "reverb_chain_routing", "reverb_stereo_ir", "reverb_rms_no_chain",
    "chain_no_reverb", "routing_mono_fanout", "reverb_measured_floor"])
def test_process_batch_insert_loop_matches_jax(case):
    routing, channels, kw, nf, lat = None, C, {}, None, 0
    if case == "reverb_chain_routing":
        routing, kw = [1, 0, -1], dict(reverb_mode=True, chain=_graph_chain(False))
        lat = 48 + 72
    elif case == "reverb_stereo_ir":
        routing, kw = [1, 0], dict(reverb_mode=True, chain=_graph_chain(True))
        lat = 48 + 72
    elif case == "reverb_rms_no_chain":
        kw = dict(reverb_mode=True, tail_mode="rms", noise_floor_margin_pct=20.0)
    elif case == "chain_no_reverb":
        kw = dict(chain=_graph_chain(False), gain_db=-1.0)
        lat = 48 + 72
    elif case == "routing_mono_fanout":
        channels, routing, kw = 1, [2, -1, 0], dict(output_channels=3)
    elif case == "reverb_measured_floor":
        kw, nf = dict(reverb_mode=True, chain=_graph_chain(False)), -96.0
    jcfg, tcfg = _cfgs(channel_routing=routing, **kw)
    x = _input(channels)
    want = jgraph.process_batch(jnp.asarray(x), VALID, jcfg, 44100, jnp.asarray(SEEDS),
                                latency_frames=lat, noise_floor_db=nf)
    got = tgraph.process_batch(torch.from_numpy(x), VALID, tcfg, 44100, SEEDS,
                               latency_frames=lat, noise_floor_db=nf)
    _check(got, want, got.codes.numpy(), np.asarray(want.codes))
    codes = got.codes.numpy()
    if routing is not None:
        assert codes.shape[1] == len(routing)
        for c, r in enumerate(routing):
            if r < 0:
                assert not codes[:, c].any()
    if kw.get("reverb_mode"):
        of = got.out_frames.numpy()
        assert of[2] == 0                                 # an empty file
        if "chain" in kw:
            # the reverb rings past the source
            assert (of[:2] > -(-VALID[:2] * 160 // 147)).all()
            assert got.tail_terminated.numpy()[:2].all()


def test_process_batch_raw_insert_loop_matches_jax():
    """The raw-bytes wire with reverb, a chain and routing."""
    x = _input(C)
    codes = np.round(x * (1 << 23)).astype(np.int64)
    inter = np.swapaxes(codes, 1, 2) & 0xFFFFFF
    raw = np.stack([(inter >> (8 * k)) & 0xFF for k in range(3)], -1)
    raw = raw.astype(np.uint8).reshape(FILES, -1)
    jcfg, tcfg = _cfgs(channel_routing=[1, 0, -1], reverb_mode=True,
                       chain=_graph_chain(False))
    want = jgraph.process_batch_raw(jnp.asarray(raw), VALID, jcfg, 44100,
                                    jnp.asarray(SEEDS), in_channels=C, in_bits=24,
                                    latency_frames=120, noise_floor_db=-90.0)
    got = tgraph.process_batch_raw(raw, VALID, tcfg, 44100, SEEDS, in_channels=C,
                                   in_bits=24, latency_frames=120,
                                   noise_floor_db=-90.0, device="cpu")

    def unpack(p):
        b = p.reshape(FILES, -1, 3).astype(np.int64)
        v = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
        return v - ((v >> 23) << 24)
    _check(got, want, unpack(got.codes.numpy()), unpack(np.asarray(want.codes)))


@pytest.mark.parametrize("kw", [
    dict(), dict(reverb_mode=True), dict(chain=True), dict(chain=True, reverb_mode=True),
    dict(chain=True, reverb_mode=True, latency=500), dict(reverb_mode=True, latency=-30),
    dict(chain=True, reverb_mode=True, max_tail_seconds=0.5)])
def test_default_pad_frames_matches_jax(kw):
    kw = dict(kw)
    lat = kw.pop("latency", 0)
    if kw.pop("chain", False):
        kw["chain"] = _graph_chain(False)
    jcfg, tcfg = _cfgs(**kw)
    for rate_in in (44100, 96000):
        assert (tgraph._default_pad_frames(tcfg, rate_in, lat)
                == jgraph._default_pad_frames(jcfg, rate_in, lat))


def test_graph_refuses_a_jax_chain():
    cfg = TConfig(output_dir="/tmp/x", target_rate=48000,
                  chain=jchain.Chain(jchain.Gain(1.0)))
    with pytest.raises(TypeError, match="chain_from_jax"):
        tgraph.process_batch(torch.zeros(1, 2, 100), [100], cfg, 48000, [1],
                             pad_frames=0)
