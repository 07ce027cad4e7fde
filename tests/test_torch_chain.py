"""The port's insert chain and routing against the JAX package's.

Every case feeds the same numpy input, made from a seed, through the JAX
function and its port on the CPU.  Each bound is set a little above what
these inputs measure (in brackets):

- exact: `route_channels`, `_window_max_past`, `Delay`, signatures and
  tail lengths;
- <= 2.5e-7 abs on unit-level signals (0, bitwise here): `_fir_fold` and
  `_uniform_ma_past`, which keep the JAX package's association;
- <= 5e-7 abs (<= 1.8e-7): `Gain`, `StereoWidth`, `Saturator` (XLA's tanh
  approximation against the port's);
- <= -130 dB RMS (-134.8 ... -138.8 dB): the FFT convolvers and the stages
  that use them (torch's CPU FFT is MKL's, JAX's is pocketfft);
- <= 1e-6 abs (<= 1.8e-7): `Compressor`, `Expander`, `Limiter` (log10 and
  pow round apart by an ulp); a whole stack <= 5e-6 (2.6e-6).

The streamed forms (`apply_stream`) are held to the same bounds against the
JAX package's streamed forms, and, within the port, chunked to the whole
signal's `apply` at 0 ULP."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.ops import routing as jrouting  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops import routing as trouting  # noqa: E402

RATE = 48000


def _sig(shape, seed, level=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / RATE
    x = (level * np.sin(2 * np.pi * 441.0 * t)
         + 0.3 * level * rng.standard_normal(shape))
    return x.astype(np.float32)


def _both(fn_j, fn_t, x):
    want = np.asarray(fn_j(jnp.asarray(x)))
    got = fn_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


def _db(got, want):
    e = np.sqrt(np.mean(np.square(got.astype(np.float64) - want)))
    r = np.sqrt(np.mean(np.square(want.astype(np.float64))))
    return 20.0 * np.log10(max(e, 1e-300) / r)


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("routing,num_out", [
    ([1, 0], None), ([1, 0, -1], None), ([0, 0, 2, -1], None),
    ([2, 1], 4), ([0, 1, 2], 2), ([-1, -1], None), ([], 2)])
def test_route_channels_matches_jax(routing, num_out):
    """Exact: a gather plus zeros."""
    x = _sig((2, 3, 300), seed=len(routing))
    got, want = _both(lambda a: jrouting.route_channels(a, routing, num_out),
                      lambda a: trouting.route_channels(a, routing, num_out), x)
    assert np.array_equal(got, want)


def test_route_channels_refuses_out_of_range():
    x = np.zeros((1, 2, 10), np.float32)
    for mod, arr in ((jrouting, jnp.asarray(x)), (trouting, torch.from_numpy(x))):
        with pytest.raises(ValueError, match="out of range"):
            mod.route_channels(arr, [0, 2])


def test_routing_helpers_match_jax():
    """Exact: fan-out, interleave and its inverse.  The monitor mixdown is
    a mean of three channels, which XLA divides differently: <= 1e-7."""
    x = _sig((2, 5, 64), seed=3)
    got, want = _both(jrouting.interleave, trouting.interleave, x)
    assert np.array_equal(got, want)
    got, want = _both(jrouting.mixdown_monitor, trouting.mixdown_monitor, x)
    assert np.abs(got - want).max() <= 1e-7
    for c in (1, 2):
        got, want = _both(jrouting.mixdown_monitor, trouting.mixdown_monitor, x[:, :c])
        assert np.array_equal(got, want)
    got, want = _both(lambda a: jrouting.fan_out_mono(a, 3),
                      lambda a: trouting.fan_out_mono(a, 3), x[:, 0])
    assert np.array_equal(got, want)
    inter = x.reshape(2, -1)
    got, want = _both(lambda a: jrouting.deinterleave(a, 5),
                      lambda a: trouting.deinterleave(a, 5), inter)
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="not a multiple"):
        trouting.deinterleave(torch.zeros(2, 7), 2)
    assert trouting.stereo_pairs(5) == jrouting.stereo_pairs(5)


# ------------------------------------------------------ device helpers

@pytest.mark.parametrize("W", [1, 2, 3, 7, 64, 351])
def test_fir_fold_matches_jax(W):
    """<= 2.5e-7 abs (measured 0): the same pairwise tree."""
    taps = _sig((W,), seed=W, level=1.0 / np.sqrt(W))
    x = _sig((2, 2, 1500), seed=W + 1)
    got, want = _both(lambda a: jchain._fir_fold(a, taps),
                      lambda a: tchain._fir_fold(a, taps), x)
    assert np.abs(got - want).max() <= 2.5e-7


def test_fir_fold_is_position_invariant():
    """Bitwise: the same window computed at two buffer offsets."""
    taps = _sig((301,), seed=5, level=0.05)
    x = torch.from_numpy(_sig((2, 4000), seed=6))
    a = tchain._fir_fold(x, taps)[..., 1000:3000]
    b = tchain._fir_fold(x[..., 537:], taps)[..., 1000 - 537:3000 - 537]
    assert torch.equal(a, b)


@pytest.mark.parametrize("win", [1, 2, 48, 241, 4801])
def test_uniform_ma_past_matches_jax(win):
    """<= 2.5e-7 abs (measured 0): the same sequential fold; above 4096
    taps the JAX package convolves and the port still folds (measured
    7.5e-8 at 4801)."""
    x = np.square(_sig((2, 1, 3000), seed=win))
    got, want = _both(lambda a: jchain._uniform_ma_past(a, win),
                      lambda a: tchain._uniform_ma_past(a, win), x)
    assert np.abs(got - want).max() <= 2.5e-7


@pytest.mark.parametrize("W", [1, 2, 3, 5, 8, 13, 73])
def test_window_max_past_matches_jax(W):
    """Exact: max is exact whatever the combine order."""
    x = np.abs(_sig((2, 1, 777), seed=W))
    got, want = _both(lambda a: jchain._window_max_past(a, W),
                      lambda a: tchain._window_max_past(a, W), x)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ir_len,block", [(1, 64), (300, 64), (1000, 128), (9000, 64)])
def test_fft_convolve_matches_jax(ir_len, block):
    """<= -130 dB RMS (measured -135.5 ... -137.8 dB); the last case
    doubles B."""
    ir = _sig((ir_len,), seed=ir_len, level=0.2) * np.exp(
        -np.arange(ir_len) / max(1.0, ir_len / 6)).astype(np.float32)
    x = _sig((2, 2, 3001), seed=1)
    got, want = _both(lambda a: jchain.fft_convolve(a, ir, block=block),
                      lambda a: tchain.fft_convolve(a, ir, block=block), x)
    assert _db(got, want) <= -130.0
    assert tchain._fft_block_size(ir_len, block) == jchain._fft_block_size(ir_len, block)


def test_fft_convolve_multi_matches_jax():
    """<= -130 dB RMS (measured -138.4 dB): two channels, one delay line
    each."""
    irs = _sig((2, 700), seed=9, level=0.2)
    x = _sig((3, 2, 2500), seed=10)
    got, want = _both(lambda a: jchain._fft_convolve_multi(a, irs, block=128),
                      lambda a: tchain._fft_convolve_multi(a, irs, block=128), x)
    assert _db(got, want) <= -130.0


def test_fft_convolve_against_direct_sum():
    """The port's UPOLS against numpy's float64 convolution: <= -130 dB
    (measured -138.6 dB)."""
    ir = _sig((500,), seed=4, level=0.1)
    x = _sig((2, 1800), seed=8)
    got = tchain.fft_convolve(torch.from_numpy(x), ir, block=64).numpy()
    want = np.stack([np.convolve(r.astype(np.float64), ir)[:1800] for r in x])
    assert _db(got, want) <= -130.0


# ------------------------------------------------------------------ stages

def _stage_pairs():
    """(id, JAX stage, port stage, tolerance kind)."""
    fir_long = _sig((1500,), seed=11, level=0.03)
    ir_mono = (_sig((5000,), seed=12, level=0.1)
               * np.exp(-np.arange(5000) / 800.0)).astype(np.float32)
    ir_st = (_sig((2, 3000), seed=13, level=0.1)
             * np.exp(-np.arange(3000) / 500.0)).astype(np.float32)
    J, T = jchain, tchain
    return [
        ("gain", J.Gain(-4.5), T.Gain(-4.5), "tight"),
        ("delay", J.Delay(0.0031), T.Delay(0.0031), "exact"),
        ("delay0", J.Delay(0.0), T.Delay(0.0), "exact"),
        ("width", J.StereoWidth(1.7), T.StereoWidth(1.7), "tight"),
        ("sat_tanh", J.Saturator("tanh", 9.0, 0.8, -2.0),
         T.Saturator("tanh", 9.0, 0.8, -2.0), "tight"),
        ("sat_soft", J.Saturator("soft", 6.0), T.Saturator("soft", 6.0), "tight"),
        ("sat_hard", J.Saturator("hard", 4.0, 0.5), T.Saturator("hard", 4.0, 0.5), "tight"),
        ("fir_fold", J.FIRInsert(fir_long[:200]), T.FIRInsert(fir_long[:200]), "tight"),
        ("fir_upols", J.FIRInsert(fir_long), T.FIRInsert(fir_long), "fft"),
        ("biquad_fold", J.Biquad("peaking", 1000.0, 1.0, 3.0),
         T.Biquad("peaking", 1000.0, 1.0, 3.0), "tight"),
        ("biquad_upols", J.Biquad("highpass", 80.0), T.Biquad("highpass", 80.0), "fft"),
        ("reverb_mono", J.ConvolutionReverb(ir_mono, 0.7, 0.4),
         T.ConvolutionReverb(ir_mono, 0.7, 0.4), "fft"),
        ("reverb_stereo", J.ConvolutionReverb(ir_st), T.ConvolutionReverb(ir_st), "fft"),
        ("comp", J.Compressor(-18.0, 3.0), T.Compressor(-18.0, 3.0), "dyn"),
        ("comp_hardknee", J.Compressor(-12.0, 8.0, 0.0, 300.0, 0.0, 2.0),
         T.Compressor(-12.0, 8.0, 0.0, 300.0, 0.0, 2.0), "dyn"),
        ("expander", J.Expander(-20.0, 3.0, 1.0, 400.0, 40.0),
         T.Expander(-20.0, 3.0, 1.0, 400.0, 40.0), "dyn"),
        ("limiter", J.Limiter(-3.0), T.Limiter(-3.0), "dyn"),
    ]


_STAGES = _stage_pairs()


def _check(kind, got, want):
    """Bounds of the module docstring; measured on these inputs: tight
    <= 1.8e-7, dyn <= 1.8e-7, fft -134.8 ... -138.8 dB."""
    if kind == "exact":
        assert np.array_equal(got, want)
    elif kind == "tight":
        d = np.abs(got - want)
        at = np.unravel_index(np.argmax(d), d.shape)
        assert d.max() <= 5e-7, (d.max(), at, got[at], want[at], int((d > 5e-7).sum()))
    elif kind == "dyn":
        assert np.abs(got - want).max() <= 1e-6, np.abs(got - want).max()
    else:
        assert _db(got, want) <= -130.0, _db(got, want)


@pytest.mark.parametrize("name,js,ts,kind", _STAGES, ids=[s[0] for s in _STAGES])
def test_stage_matches_jax(name, js, ts, kind):
    x = _sig((2, 2, 4800), seed=len(name), level=0.6)
    got, want = _both(lambda a: js.apply(a, RATE), lambda a: ts.apply(a, RATE), x)
    _check(kind, got, want)
    # the 1-D branch: the calibration impulse goes through every stage
    imp = np.zeros(3000, np.float32)
    imp[1000] = 0.9
    got, want = _both(lambda a: js.apply(a, RATE), lambda a: ts.apply(a, RATE), imp)
    _check(kind, got, want)
    assert ts.channel_local == js.channel_local


@pytest.mark.parametrize("cls", ["Compressor", "Expander", "Limiter"])
def test_dynamics_across_envelope_blocks(cls, monkeypatch):
    """<= 1e-6 abs (measured <= 1.8e-7) with the slanted cummax cut into
    256-frame blocks in both packages (the carried maximum crosses 18 block
    boundaries); the envelope itself is bitwise."""
    monkeypatch.setattr(jchain.Compressor, "_ENV_BLOCK", 256)
    monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", 256)
    args = {"Compressor": (-20.0, 4.0, 2.0, 200.0), "Expander": (-25.0, 2.0, 0.0, 300.0),
            "Limiter": (-4.0, 1.0, 250.0)}[cls]
    js, ts = getattr(jchain, cls)(*args), getattr(tchain, cls)(*args)
    x = _sig((2, 2, 4700), seed=7, level=0.8)
    x[..., 2000:3000] *= 0.01                  # a quiet stretch: release runs
    got, want = _both(lambda a: js.apply(a, RATE), lambda a: ts.apply(a, RATE), x)
    assert np.abs(got - want).max() <= 1e-6
    lv = _sig((2, 1, 1000), seed=3, level=20.0) - 30.0
    got, want = _both(lambda a: jchain.Compressor._slanted_cummax(a, 0.01),
                      lambda a: tchain.Compressor._slanted_cummax(a, 0.01), lv)
    assert np.array_equal(got, want)


def test_limiter_holds_its_ceiling():
    """The float32 round trip through dB (log10, then pow) lets the peak
    poke 1.1e-6 relative above the ceiling, in both packages alike."""
    lim = tchain.Limiter(ceiling_db=-6.0, lookahead_ms=1.0)
    x = _sig((2, 2, 9600), seed=2, level=1.5)
    y = lim.apply(torch.from_numpy(x), RATE)
    L = lim.lookahead_frames(RATE)
    ceiling = 10.0 ** (-6.0 / 20.0)
    assert float(y.abs().max()) <= ceiling * (1 + 2e-6)
    want = np.asarray(jchain.Limiter(-6.0, 1.0).apply(jnp.asarray(x), RATE))
    assert abs(float(y.abs().max()) - float(np.abs(want).max())) <= 1e-6
    # the lookahead is pure delay where nothing is limited
    quiet = torch.full((1, 100), 0.01)
    assert torch.equal(lim.apply(quiet, RATE)[:, L:], quiet[:, :-L])


def _chain_pair():
    """Every stage kind in one stack, levels kept near unity."""
    ir = (_sig((6000,), seed=21) * np.exp(-np.arange(6000) / 900.0)).astype(np.float32)
    ir /= np.sqrt(np.sum(np.square(ir.astype(np.float64))))
    taps = np.hanning(31).astype(np.float32)
    taps /= taps.sum()

    def build(m):
        return m.Chain(m.Gain(-6.0), m.Delay(0.002), m.Expander(-40.0, 2.0),
                       m.Biquad("peaking", 1000.0, 1.0, 3.0), m.Biquad("highpass", 80.0),
                       m.FIRInsert(taps), m.Compressor(-18.0, 3.0),
                       m.Saturator("soft", 3.0), m.StereoWidth(1.3),
                       m.ConvolutionReverb(ir, 0.6, 0.5), m.Limiter(-1.0))
    return build(jchain), build(tchain)


def test_chain_signature_and_tail_match_jax():
    """Exact: the calibration cache keys and the capture head-room agree."""
    for _name, js, ts, _k in _STAGES:
        assert ts.signature() == js.signature()
        for rate in (44100, 48000, 96000):
            assert ts.tail_frames(rate) == js.tail_frames(rate)
    jc, tc = (jchain.Chain(*[s[1] for s in _STAGES]),
              tchain.Chain(*[s[2] for s in _STAGES]))
    assert tc.sig_str() == jc.sig_str()
    assert tc.tail_frames(48000) == jc.tail_frames(48000)
    assert tc == tchain.chain_from_jax(jc) and hash(tc) == hash(tchain.chain_from_jax(jc))
    assert tc != tchain.Chain(tchain.Gain(1.0))
    assert repr(tchain.Chain(tchain.Gain(1.0), tchain.Delay(0.1))) == "Chain(Gain, Delay)"
    with pytest.raises(TypeError, match="lacks required method"):
        tchain.Chain(object())


def test_chain_from_jax_covers_every_stage():
    for _name, js, _ts, _k in _STAGES:
        got = tchain.chain_from_jax(jchain.Chain(js))
        assert type(got.stages[0]).__name__ == type(js).__name__

    class Odd:
        def signature(self):
            return ("odd",)

        def tail_frames(self, rate):
            return 0

        def apply(self, y, rate):
            return y

    with pytest.raises(TypeError, match="no port"):
        tchain.chain_from_jax(jchain.Chain(Odd()))


def test_chain_apply_matches_jax():
    """<= 5e-6 abs (measured 2.6e-6) over a stack of every stage kind."""
    jc, tc = _chain_pair()
    x = _sig((2, 2, 4000), seed=17, level=0.4)
    got, want = _both(lambda a: jc.apply(a, RATE), lambda a: tc.apply(a, RATE), x)
    assert np.abs(got - want).max() <= 5e-6


def test_stage_argument_checks():
    T = tchain
    for bad in (lambda: T.Delay(-1.0), lambda: T.FIRInsert([]),
                lambda: T.Biquad("notch", 100.0), lambda: T.Biquad("peaking", 0.0),
                lambda: T.Saturator("fuzz"), lambda: T.Saturator(mix=2.0),
                lambda: T.Saturator(drive_db=200.0), lambda: T.StereoWidth(5.0),
                lambda: T.Compressor(ratio=0.5), lambda: T.Compressor(release_db_per_s=0),
                lambda: T.Compressor(attack_ms=-1), lambda: T.Expander(range_db=0),
                lambda: T.Limiter(ceiling_db=1.0), lambda: T.Limiter(lookahead_ms=0),
                lambda: T.Limiter(release_db_per_s=0),
                lambda: T.ConvolutionReverb(np.zeros((2, 2, 2))),
                lambda: T.fft_convolve(torch.zeros(10), np.ones(3), block=0)):
        with pytest.raises(ValueError):
            bad()
    with pytest.raises(ValueError, match="stereo"):
        T.StereoWidth(1.0).apply(torch.zeros(1, 3, 10), RATE)
    with pytest.raises(ValueError, match="multichannel IR"):
        T.ConvolutionReverb(np.ones((2, 4), np.float32)).apply(torch.zeros(1, 3, 10), RATE)
    assert torch.equal(T.fft_convolve(torch.ones(5), np.zeros(0)), torch.zeros(5))


# ------------------------------------------------------------- streaming

@pytest.fixture
def one_thread():
    """torch on one CPU thread for a streaming test: the suite runs files in
    parallel processes, and an OpenMP pool that spin-waits after each
    parallel op starves them (ops slowed up to ~300x beside five busy
    processes).  Thread counts are the subject of
    `test_whole_vectors_is_position_invariant`."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _chunks(grid, sizes=(997, 4096, 45000)):
    """Chunk sizes for a stage of stream grid ``grid``: 997, 4096 and one
    that crosses the 2^17 envelope block at its third chunk, or for an FFT
    stage 1, 3 and 12 of its blocks (12 blocks of 4096 cross 2^17 too)."""
    return sizes if grid == 1 else (grid, 3 * grid, 12 * grid)


def _streamed(stage_or_chain, x, chunk, grid=1):
    """``x (channels, T)`` through ``apply_stream`` in chunks of ``chunk``
    (the last one zero-padded to the grid), cut back to T."""
    T = x.shape[-1]
    chain = stage_or_chain if isinstance(stage_or_chain, tchain.Chain) else tchain.Chain(
        stage_or_chain)
    st = chain.stream_init(RATE, x.shape[0], "cpu")
    outs, pos = [], 0
    while pos < T:
        seg = x[:, pos:pos + chunk]
        if seg.shape[-1] % grid:
            seg = torch.nn.functional.pad(seg, (0, grid - seg.shape[-1] % grid))
        o, st = chain.apply_stream(seg, st, RATE, pos)
        outs.append(o)
        pos += seg.shape[-1]
    return torch.cat(outs, dim=-1)[:, :T]


@pytest.mark.parametrize("name,js,ts,kind", _STAGES, ids=[s[0] for s in _STAGES])
def test_stage_streams_bitwise(name, js, ts, kind, one_thread):
    """0 ULP: each stage streamed equals its `apply` over the whole
    140,000-frame signal, which crosses the 2^17-frame envelope block; a
    quiet stretch makes the release envelope run.  The stream is causal, so
    the smaller chunkings run over a prefix: 997 frames over 30,000, 4096
    over 60,000, and the largest over the whole signal (an FFT stage's
    prefix ends on its block grid: its last block's transform sees the
    frames after it)."""
    x = torch.from_numpy(_sig((2, 140000), seed=len(name) + 40, level=0.5))
    x[:, 20000:90000] *= 0.01
    whole = ts.apply(x, RATE)
    grid = tchain.Chain(ts).stream_grid(RATE)
    assert grid == jchain.Chain(js).stream_grid(RATE)
    for chunk, n in zip(_chunks(grid),
                        (30000 // grid * grid, 60000 // grid * grid, x.shape[-1])):
        got = _streamed(ts, x[:, :n], chunk, grid)
        assert torch.equal(got, whole[:, :n]), (chunk, float((got - whole[:, :n]).abs().max()))


_STREAMED = [s for s in _STAGES if hasattr(s[1], "apply_stream")]


@pytest.mark.parametrize("name,js,ts,kind", _STREAMED, ids=[s[0] for s in _STREAMED])
def test_stage_stream_matches_jax(name, js, ts, kind, one_thread):
    """The port's `apply_stream` against the JAX package's over the same
    three chunks, within the stage's batch bound (module docstring)."""
    grid = max(1, tchain.Chain(ts).stream_grid(RATE))
    chunk = grid if grid > 1 else 1500
    x = _sig((2, 3 * chunk), seed=len(name) + 60, level=0.6)
    jst = jchain.Chain(js).stream_init(RATE, 2)
    tst = tchain.Chain(ts).stream_init(RATE, 2, "cpu")
    want, got = [], []
    for a in range(0, x.shape[-1], chunk):
        seg = x[:, a:a + chunk]
        o, jst = jchain.Chain(js).apply_stream(jnp.asarray(seg), jst, RATE, jnp.int32(a))
        want.append(np.asarray(o))
        o, tst = tchain.Chain(ts).apply_stream(torch.from_numpy(seg), tst, RATE, a)
        got.append(o.numpy())
    _check(kind, np.concatenate(got, axis=-1), np.concatenate(want, axis=-1))


@pytest.mark.parametrize("window", ["detector", "attack"])
def test_long_dynamics_window_folds(window, one_thread):
    """A 4801-frame moving average (100.02 ms at 48 kHz), which the JAX
    package convolves and the port folds: the compressor <= 1e-6 abs against
    JAX's on a unit-peak signal (measured 3.3e-7; 8.9e-7 at peak 1.5), and
    streamed == whole at 0 ULP."""
    kw = {"detector": dict(detector_ms=100.02), "attack": dict(attack_ms=100.02)}[window]
    js, ts = jchain.Compressor(-24.0, 4.0, **kw), tchain.Compressor(-24.0, 4.0, **kw)
    assert max(ts._windows(RATE)) == 4801
    x = _sig((2, 2, 9600), seed=9, level=0.6)
    got, want = _both(lambda a: js.apply(a, RATE), lambda a: ts.apply(a, RATE), x)
    assert np.abs(got - want).max() <= 1e-6
    xs = torch.from_numpy(_sig((2, 18000), seed=10, level=0.8))
    assert torch.equal(_streamed(ts, xs, 6000), ts.apply(xs, RATE))


def test_chain_streams_bitwise_and_matches_jax(one_thread):
    """Every stage kind in one stack: chunked on the chain's grid equals the
    whole signal at 0 ULP, and the port's stream is <= 5e-6 abs from the
    JAX package's (measured 3.7e-6)."""
    jc, tc = _chain_pair()
    grid = tc.stream_grid(RATE)
    assert grid == jc.stream_grid(RATE) == 4096
    x = _sig((2, 6 * grid), seed=23, level=0.4)
    xt = torch.from_numpy(x)
    whole = tc.apply(xt, RATE)
    for chunk in (grid, 3 * grid):
        assert torch.equal(_streamed(tc, xt, chunk, grid), whole), chunk
    jst = jc.stream_init(RATE, 2)
    want = []
    for a in range(0, x.shape[-1], 2 * grid):
        o, jst = jc.apply_stream(jnp.asarray(x[:, a:a + 2 * grid]), jst, RATE, jnp.int32(a))
        want.append(np.asarray(o))
    assert np.abs(whole.numpy() - np.concatenate(want, axis=-1)).max() <= 5e-6


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_whole_vectors_is_position_invariant(threads):
    """0 ULP: ``pow(10, v)``, ``log10`` and ``tanh`` through
    `_whole_vectors` give each element the same bits in a chunk of any size
    and offset as in the whole tensor, above torch's 32768-element grain and
    across thread counts (plain ``torch.pow`` on chunks of a 3 M-element
    tensor differed in ~500 elements on an 8-thread AVX-512 host)."""
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        rng = np.random.default_rng(threads)
        x = torch.from_numpy((rng.random(400_003) * 8 - 6).astype(np.float32))
        for fn in (lambda v: torch.pow(10.0, v), torch.tanh,
                   lambda v: torch.log10(v.abs() + 1e-3)):
            whole = tchain._whole_vectors(fn, x)
            for off, n in ((0, 997), (5, 40000), (13, 131073), (777, 299_999)):
                assert torch.equal(tchain._whole_vectors(fn, x[off:off + n]),
                                   whole[off:off + n]), (off, n)
    finally:
        torch.set_num_threads(before)


def test_stream_state_on_cpu_and_grid_errors():
    """`stream_init` puts every state on the device it is given; an FFT
    stage refuses a chunk off its block grid."""
    _, tc = _chain_pair()
    for st in tc.stream_init(RATE, 2, "cpu"):
        for t in (st if isinstance(st, tuple) else (st,)):
            assert t is None or t.device.type == "cpu"
    rev = tchain.ConvolutionReverb(np.ones(100, np.float32))
    with pytest.raises(ValueError, match="whole 4096-frame blocks"):
        rev.apply_stream(torch.zeros(2, 1000), rev.stream_state(RATE, 2, "cpu"), RATE, 0)


# ------------------------------------------- UPOLS against the batch width

_UPOLS_B = 1024


def _upols_case(form: str):
    """A K = 7 partitioned IR (mono, or one per channel) and 12 blocks of
    16 input rows: the delay-line product holds 7 x rows x 1025 complex
    numbers, several of torch's 32768-element grains from 5 rows on."""
    rng = np.random.default_rng(11)
    n = 7 * _UPOLS_B - 37
    decay = np.exp(-np.arange(n) / 2000.0)
    irs = (rng.standard_normal((2, n)) * decay).astype(np.float32)
    x = torch.from_numpy(_sig((16, 12 * _UPOLS_B + 100), seed=12))
    if form == "mono":
        H = tchain._spectrum([tchain._partition_ir(irs[0], _UPOLS_B)], "cpu")[:, 0]
        return x, 1, lambda v: tchain._upols_rows(v, H, _UPOLS_B)
    H = tchain._spectrum([tchain._partition_ir(r, _UPOLS_B) for r in irs], "cpu")
    T = x.shape[-1]
    return x, 2, lambda v: tchain._upols_channels(v.reshape(-1, 2, T), H, _UPOLS_B).reshape(-1, T)


@pytest.mark.parametrize("form", ["mono", "true_stereo"])
@pytest.mark.parametrize("rows", [1, 2, 3, 5, 8, 13, 16])
def test_upols_row_does_not_depend_on_the_row_count(form, rows):
    """0 ULP: each row of an N-row `_upols` (mono IR through `_upols_rows`,
    one IR per channel through `_upols_channels`) equals that row run
    alone, on 8 threads, K = 7.  The delay-line sum was a ``torch.sum``
    whose order followed the row count, and torch's CPU float32 complex
    product rounds apart in a thread's scalar tail: both moved a file's
    bytes with the batch width."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        x, step, fn = _upols_case(form)
        assert tchain._partition_ir(np.zeros(7 * _UPOLS_B - 37, np.float32),
                                    _UPOLS_B)[0].shape[0] == 7
        m = rows * step if rows * step <= 16 else 16
        y = fn(x[:m])
        for r in range(0, m, step):
            assert torch.equal(fn(x[r:r + step]), y[r:r + step]), (rows, r)
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("K", [1, 2, 5, 7, 8, 30])
def test_delay_line_sum_order(K):
    """The halving tree adds in an order set by K alone, and sums what
    ``torch.sum`` sums (exactly, on small integers)."""
    p = torch.arange(K * 3, dtype=torch.float64).reshape(K, 3) + 1
    want = p.sum(0)
    assert torch.equal(tchain._delay_line_sum(p.clone()), want)
    v = torch.arange(1, K + 1, dtype=torch.float64).reshape(K, 1).expand(K, 4).clone()
    assert torch.equal(tchain._delay_line_sum(v), torch.full((4,), K * (K + 1) / 2.0,
                                                             dtype=torch.float64))
