"""The port's twin of `tests/test_sweep.py`: every studio rate pair, ragged
lengths, the presets, stopband and passband, an arbitrary varispeed ratio,
the ultra preset, a round trip and the host-marshalled rows, plus every
pair at minphase high and at lagrange.

Each case sends the same numpy input, made from the same seed, through the
JAX package's function and the port's on the CPU (the port's kernel
wrappers run their plain twin there).  Bounds: the port within 2e-6 max abs
of JAX (`tests/test_torch_src.py`'s bound between SRC forms), at or below
-120 dB RMS against the JAX package's float64 oracle, and the same shape;
the round trip keeps its > 100 dB SNR.  The card runs the same matrix in
`chip_smoke.py` phase 12."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.models.filters import design_cycle_bank as jbank  # noqa: E402
from f9tpu.models.filters import resolve_ratio as jresolve  # noqa: E402
from f9tpu.models.oracle import resample_oracle  # noqa: E402
from f9tpu.ops import pallas_src  # noqa: E402
from f9tpu_torch.models.filters import STANDARD_RATES, design_cycle_bank, resolve_ratio  # noqa: E402
from f9tpu_torch.ops import resample as tres  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402

# the module, not the function `f9tpu.ops` re-exports under the same name
jres = importlib.import_module("f9tpu.ops.resample")

ALL_PAIRS = [(a, b) for a in STANDARD_RATES for b in STANDARD_RATES if a != b]
MAX_ABS = 2e-6


def rms_db(err, ref):
    return 20 * np.log10(
        np.sqrt((np.asarray(err, np.float64) ** 2).mean())
        / (np.sqrt((np.asarray(ref, np.float64) ** 2).mean()) + 1e-30)
        + 1e-30)


def _both(x: np.ndarray, rate_in: int, rate_out: int, quality: str = "high",
          kind: str = "sinc") -> tuple[np.ndarray, np.ndarray]:
    """(port, JAX) outputs of `resample_rates` on the same input."""
    want = np.asarray(jres.resample_rates(jnp.asarray(x), rate_in, rate_out,
                                          quality=quality, kind=kind))
    got = tres.resample_rates(torch.from_numpy(x), rate_in, rate_out,
                              quality=quality, kind=kind).numpy()
    return got, want


def _faults(got, want, ref, where) -> list:
    """What the port's output misses: JAX's shape, 2e-6 of JAX, -120 dB."""
    if got.shape != want.shape or got.shape != ref.shape:
        return [(where, "shape", got.shape, want.shape, ref.shape)]
    out = []
    err = float(np.abs(got - want).max(initial=0.0))
    if err > MAX_ABS:
        out.append((where, "vs JAX", err))
    db = rms_db(got - ref, ref)
    if db > -120.0:
        out.append((where, "accuracy", db))
    return out


@pytest.mark.parametrize("quality,kind", [("low", "sinc"), ("high", "minphase"),
                                          ("high", "lagrange")])
def test_all_rate_pairs_vs_oracle(quality, kind):
    """Every one of the 30 studio rate pairs, 4410 frames: the port against
    JAX and the oracle (the JAX test's case at low, and the two other filter
    kinds at their default preset)."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(4410)).astype(np.float32)
    failures = []
    for rate_in, rate_out in ALL_PAIRS:
        got, want = _both(x, rate_in, rate_out, quality, kind)
        ref = resample_oracle(x, rate_in, rate_out, quality=quality, kind=kind)
        failures += _faults(got, want, ref, (rate_in, rate_out))
    assert not failures, failures


def test_all_rate_pairs_exact_ratios():
    """Ratio resolution is exact for the whole family, and the JAX package's."""
    for rate_in, rate_out in ALL_PAIRS:
        L, M = resolve_ratio(rate_in, rate_out)
        assert (L, M) == jresolve(rate_in, rate_out)
        assert rate_in * L == rate_out * M, (rate_in, rate_out)


@pytest.mark.parametrize("length", [1, 17, 146, 147, 148, 4410, 44100])
def test_length_sweep(length):
    """Ragged lengths: exact output length, JAX's output and oracle parity."""
    rng = np.random.default_rng(length)
    x = (0.3 * rng.standard_normal(length)).astype(np.float32)
    got, want = _both(x, 44100, 48000, quality="low")
    assert got.shape == (design_cycle_bank(44100, 48000, quality="low").out_len(length),)
    ref = resample_oracle(x, 44100, 48000, quality="low")
    assert not _faults(got, want, ref, length)


@pytest.mark.parametrize("quality", ["low", "medium", "high"])
def test_quality_sweep(quality):
    rng = np.random.default_rng(3)
    x = (0.3 * rng.standard_normal(8192)).astype(np.float32)
    got, want = _both(x, 48000, 44100, quality=quality)
    ref = resample_oracle(x, 48000, 44100, quality=quality)
    assert not _faults(got, want, ref, quality)


def test_stopband_attenuation():
    """A 30 kHz tone into 96k -> 44.1k high must fall under -110 dB (the
    anti-alias filter), in the port as in JAX (the output is the stopband
    residue, so it is held to JAX's samples, not to the oracle's ratio)."""
    rate_in, rate_out = 96000, 44100
    n = 1 << 16
    t = np.arange(n) / rate_in
    x = np.sin(2 * np.pi * 30000.0 * t).astype(np.float32)
    got, want = _both(x, rate_in, rate_out)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MAX_ABS
    mid = got[len(got) // 4 : -len(got) // 4]
    level_db = 20 * np.log10(np.sqrt((mid.astype(np.float64) ** 2).mean()) + 1e-30)
    assert level_db < -110.0, level_db


def test_passband_flatness():
    """Tones across the passband keep unity gain within +-0.05 dB."""
    rate_in, rate_out = 44100, 48000
    n = 1 << 15
    t = np.arange(n) / rate_in
    for freq in (100.0, 1000.0, 5000.0, 10000.0, 15000.0, 19000.0):
        x = (0.5 * np.sin(2 * np.pi * freq * t)).astype(np.float32)
        got, want = _both(x, rate_in, rate_out)
        ref = resample_oracle(x, rate_in, rate_out)
        assert not _faults(got, want, ref, freq)
        mid = got[len(got) // 4 : -len(got) // 4].astype(np.float64)
        gain_db = 20 * np.log10(np.sqrt((mid**2).mean()) / (0.5 / np.sqrt(2)))
        assert abs(gain_db) < 0.05, (freq, gain_db)


def test_varispeed_arbitrary_ratio():
    """A 3.1 % pitch-down (44.1k -> 42735, L/M = 407/420)."""
    rng = np.random.default_rng(5)
    x = (0.3 * rng.standard_normal(8192)).astype(np.float32)
    got, want = _both(x, 44100, 42735, quality="low")
    ref = resample_oracle(x, 44100, 42735, quality="low")
    assert not _faults(got, want, ref, "42735")


def test_ultra_quality_pair():
    """The JUCE-crossing-count preset (Z = 100)."""
    rng = np.random.default_rng(6)
    x = (0.3 * rng.standard_normal(8192)).astype(np.float32)
    got, want = _both(x, 44100, 48000, quality="ultra")
    ref = resample_oracle(x, 44100, 48000, quality="ultra")
    assert not _faults(got, want, ref, "ultra")


def test_round_trip_snr():
    """44.1 -> 48 -> 44.1 at high through the port: > 100 dB SNR, each leg
    within 2e-6 of JAX on the same input."""
    n = 1 << 15
    t = np.arange(n) / 44100
    x = sum(0.2 * np.sin(2 * np.pi * f * t + i) for i, f in
            enumerate((440.0, 1337.0, 6000.0, 15000.0))).astype(np.float32)
    up, up_jax = _both(x, 44100, 48000)
    assert np.abs(up - up_jax).max() <= MAX_ABS
    back, back_jax = _both(up, 48000, 44100)
    assert np.abs(back - back_jax).max() <= MAX_ABS
    back = back[:n]
    sl = slice(4096, n - 4096)
    snr = -rms_db(back[sl].astype(np.float64) - x[sl], x[sl])
    assert snr > 100.0, snr


def test_all_rate_pairs_rows_pre_vs_oracle():
    """The rows layout's host-marshalled staging (`rows_pre_applicable`,
    `rows_marshal_plan`, `resample_staged`) against JAX's
    `resample_rows_pre` on the same buffer and the oracle, every pair it
    serves."""
    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal(4410)).astype(np.float32)
    failures = []
    served = 0
    for rate_in, rate_out in ALL_PAIRS:
        bank, jb = (design_cycle_bank(rate_in, rate_out, quality="low"),
                    jbank(rate_in, rate_out, quality="low"))
        assert tres.rows_pre_applicable(bank) == pallas_src.rows_pre_applicable(jb)
        if not tres.rows_pre_applicable(bank):
            continue
        served += 1
        n_rows, pf = tres.rows_marshal_plan(bank, len(x))
        assert (n_rows, pf) == pallas_src.rows_marshal_plan(jb, len(x))
        buf = np.zeros(n_rows * bank.M, np.float32)
        buf[pf : pf + len(x)] = x
        R = n_rows - -(-bank.out_len(len(x)) // bank.L)
        want = np.asarray(pallas_src.resample_rows_pre(
            jnp.asarray(buf.reshape(n_rows, bank.M)), jb)).reshape(-1)
        got = sk.resample_staged(torch.from_numpy(buf), bank, n_rows - R).numpy()
        out_len = bank.out_len(len(x))
        ref = resample_oracle(x, rate_in, rate_out, quality="low")
        failures += _faults(got[:out_len], want[:out_len], ref, (rate_in, rate_out))
        assert got.shape == want.shape
    assert not failures, failures
    assert served >= 18   # tiny-M pure-upsampling pairs take the flat staging
