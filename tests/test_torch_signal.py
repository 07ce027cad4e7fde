"""The port's test signals, analysis reductions and loop self-test against
the JAX package's, on the same inputs, on the CPU.

Signals are made in float64 numpy and cast once in both packages, so they
are held bitwise.  Reductions: levels within 1e-6 relative, indices exact
(first index on ties, -1 where never), the DC removal within 2e-7 on
unit-scale input.  The loop test: the same verdict, the measured frequency
within 0.01 Hz and both levels within 0.01 dB."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu_torch import ops as tops  # noqa: E402
from f9tpu_torch.ops import analysis as tan  # noqa: E402
from f9tpu_torch.ops import signal as tsig  # noqa: E402
from f9tpu_torch.pipeline import selftest as tself  # noqa: E402

jan = importlib.import_module("f9tpu.ops.analysis")
jsig = importlib.import_module("f9tpu.ops.signal")
jself = importlib.import_module("f9tpu.pipeline.selftest")


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("frames, rate, freq, amp, phase0", [
    (48000, 48000, 1000.0, 0.5, 0.0),
    (44100 * 3 + 7, 44100, 997.3, 0.25, 1.234),
    (1, 96000, 19999.0, 1.0, 6.0),
])
def test_sine_is_bitwise_the_jax_tone(frames, rate, freq, amp, phase0):
    t, tph = tsig.sine(frames, rate, freq=freq, amp=amp, phase0=phase0, device="cpu")
    j, jph = jsig.sine(frames, rate, freq=freq, amp=amp, phase0=phase0)
    assert t.dtype == torch.float32 and t.shape == (frames,)
    np.testing.assert_array_equal(t.numpy(), _np(j))
    assert tph == jph


def test_sine_phase_continuity():
    """Two blocks joined through the returned phase are the whole tone
    (as `tests/test_ops.py` holds the JAX generator), and each block is
    bitwise the JAX block."""
    a, ph = tsig.sine(256, 44100, device="cpu")
    b, _ = tsig.sine(256, 44100, phase0=ph, device="cpu")
    whole, _ = tsig.sine(512, 44100, device="cpu")
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), whole.numpy(), atol=1e-3)
    ja, jph = jsig.sine(256, 44100)
    jb, _ = jsig.sine(256, 44100, phase0=jph)
    assert ph == jph
    np.testing.assert_array_equal(b.numpy(), _np(jb))
    assert tsig.DEFAULT_TEST_FREQ == jsig.DEFAULT_TEST_FREQ
    assert tsig.DEFAULT_TEST_AMP == jsig.DEFAULT_TEST_AMP


@pytest.mark.parametrize("frames, rate, f0, f1, amp", [
    (48000, 48000, 20.0, 20000.0, 0.5), (12345, 44100, 100.0, 8000.0, 0.9)])
def test_log_sweep_is_bitwise_the_jax_sweep(frames, rate, f0, f1, amp):
    t = tsig.log_sweep(frames, rate, f0=f0, f1=f1, amp=amp, device="cpu")
    np.testing.assert_array_equal(t.numpy(), _np(jsig.log_sweep(frames, rate, f0=f0,
                                                                f1=f1, amp=amp)))


@pytest.mark.parametrize("frames, amp, position", [(100, 0.9, 0), (4096, 0.5, 2047)])
def test_impulse_is_bitwise_the_jax_impulse(frames, amp, position):
    t = tsig.impulse(frames, amp=amp, position=position, device="cpu")
    np.testing.assert_array_equal(t.numpy(), _np(jsig.impulse(frames, amp=amp,
                                                              position=position)))


def test_package_exports():
    assert tops.sine is tsig.sine and tops.rms is tan.rms
    for name in ("rms", "rms_db", "peak", "peak_db", "noise_floor_db", "peak_position",
                 "first_above", "remove_dc_offset", "sine", "impulse", "log_sweep"):
        assert callable(getattr(tops, name)), name


def _levels_input(seed, shape, dc=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3 + dc).astype(np.float32)


@pytest.mark.parametrize("name", ["rms", "peak", "rms_db", "peak_db", "noise_floor_db"])
@pytest.mark.parametrize("shape, dim", [((3, 2, 5000), -1), ((4, 777), 0), ((70001,), -1)])
def test_level_reductions_match_jax(name, shape, dim):
    x = _levels_input(1, shape)
    x[..., :3] = 0.0
    got = getattr(tan, name)(torch.from_numpy(x), dim=dim).numpy()
    want = _np(getattr(jan, name)(x, axis=dim))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_levels_of_silence_hit_the_floor():
    """Mirrors `tests/test_ops.py`: a half-scale square wave reads 0.5 /
    -6.02 dB, silence the -200 dB floor (finite), as in JAX."""
    x = torch.tensor([[0.5, -0.5, 0.5, -0.5]])
    assert float(tan.rms(x)) == pytest.approx(0.5) and float(tan.peak(x)) == 0.5
    assert float(tan.rms_db(x)) == pytest.approx(20 * np.log10(0.5), abs=1e-5)
    z = torch.zeros((1, 8))
    for f in (tan.rms_db, tan.peak_db, tan.noise_floor_db):
        assert float(f(z)[0]) == tan.DB_FLOOR == float(_np(getattr(jan, f.__name__)(
            np.zeros((1, 8), np.float32))[0]))


def _index_cases():
    x = np.zeros((4, 1000), np.float32)
    x[0, 423] = -0.9                 # negative: |x| is what counts
    x[0, 500] = 0.3
    x[1, [17, 600]] = 0.7            # a tie: the first index
    x[1, 300] = -0.7
    x[2] = 0.05                      # flat: every index ties
    x[3, 999] = 0.2                  # the last index
    return x


@pytest.mark.parametrize("dim", [-1, 0])
def test_peak_position_and_first_above_match_jax_exactly(dim):
    x = _index_cases()
    xt = torch.from_numpy(x)
    pp = tan.peak_position(xt, dim=dim)
    assert pp.dtype == torch.int32
    np.testing.assert_array_equal(pp.numpy(), _np(jan.peak_position(x, axis=dim)))
    for thr in (0.1, 0.04, 0.69, 0.95):
        fa = tan.first_above(xt, thr, dim=dim)
        assert fa.dtype == torch.int32
        np.testing.assert_array_equal(fa.numpy(), _np(jan.first_above(x, thr, axis=dim)))
    if dim == -1:
        assert pp.tolist() == [423, 17, 0, 999]
        assert tan.first_above(xt, 0.1).tolist() == [423, 17, -1, 999]
        assert tan.first_above(xt, 0.95).tolist() == [-1, -1, -1, -1]


@pytest.mark.parametrize("shape, dc", [((2, 3, 512), 0.25), ((2, 48000), -0.5), ((5, 70001), 0.0)])
def test_remove_dc_offset_matches_jax(shape, dc):
    x = _levels_input(2, shape, dc)
    got = tan.remove_dc_offset(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jan.remove_dc_offset(x)), rtol=0, atol=2e-7)
    assert np.abs(got.astype(np.float64).mean(axis=-1)).max() < 1e-6


def test_remove_dc_offset_rounds_its_mean_once():
    """The mean accumulates in float64: every row's result is the same bits
    whatever rows sit beside it."""
    x = _levels_input(3, (16, 40001), 0.1)
    whole = tan.remove_dc_offset(torch.from_numpy(x))
    for r in (0, 5, 15):
        assert torch.equal(tan.remove_dc_offset(torch.from_numpy(x[r:r + 1]))[0], whole[r])


@pytest.mark.parametrize("rate_in, rate_out, seconds, quality", [
    (48000, 44100, 0.5, "medium"),     # tests/test_pipeline.py test_loop_selftest
    (48000, 44100, 1e-4, "low"),       # tests/test_pipeline.py, the short capture
    (44100, 48000, 0.5, "high"),
    (48000, 44100, 0.5, "ultra"),
])
def test_loop_test_matches_jax(rate_in, rate_out, seconds, quality):
    t = tself.run_loop_test(rate_in, rate_out, seconds=seconds, quality=quality,
                            device="cpu")
    j = jself.run_loop_test(rate_in, rate_out, seconds=seconds, quality=quality)
    assert t.verdict.value == j.verdict.value
    assert abs(t.measured_freq_hz - j.measured_freq_hz) <= 0.01
    assert abs(t.output_rms_db - j.output_rms_db) <= 0.01
    assert abs(t.input_rms_db - j.input_rms_db) <= 0.01
    if seconds >= 0.5:
        assert t.verdict is tself.LoopTestVerdict.LOOP_DETECTED
        assert abs(t.measured_freq_hz - 1000.0) < 10.0
    else:
        assert t.verdict is not tself.LoopTestVerdict.LOOP_DETECTED


def test_loop_test_needs_a_device():
    """Without a GPU the default device raises; the CPU runs only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tself.run_loop_test(48000, 44100, seconds=0.1)
