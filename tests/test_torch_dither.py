"""The port's dither and quantizer against the JAX package's: bitwise.

Same integer hash, same float ops in the same order, so every noise value
and every PCM code must match bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.ops import dither as jd  # noqa: E402
from f9tpu_torch.ops import dither as td  # noqa: E402


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_round_is_half_to_even():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 8388607.5, -8388608.5],
                 np.float32)
    want = np.array([0, 2, 2, 0, -2, -2, 4, 8388608, -8388608], np.float32)
    assert np.array_equal(torch.round(torch.from_numpy(v)).numpy(), want)
    assert np.array_equal(np.asarray(jnp.round(jnp.asarray(v))), want)


def test_tpdf_noise_bitwise():
    rng = np.random.default_rng(11)
    seeds = rng.integers(-2**31, 2**31, size=(7, 1), dtype=np.int64).astype(np.int32)
    seeds[0, 0], seeds[1, 0] = -1, 2**31 - 1
    pos = np.concatenate([np.arange(64), rng.integers(0, 2**31, 192)]).astype(np.int32)[None, :]
    want = jd.tpdf_noise(jnp.asarray(seeds), jnp.asarray(pos))
    got = td.tpdf_noise(torch.from_numpy(seeds), torch.from_numpy(pos))
    assert got.dtype == torch.float32
    assert np.array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("channels", [1, 2, 6])
def test_channel_seeds_bitwise(channels):
    seeds = np.array([0, 1, -7, 2**31 - 1, 123456789], np.int32)
    want = np.asarray(jd.channel_seeds(jnp.asarray(seeds), channels))
    got = td.channel_seeds(torch.from_numpy(seeds), channels).numpy()
    assert np.array_equal(got.astype(np.uint32), want)
    cid = np.arange(channels, dtype=np.int32) + 5       # global channel ids
    want = np.asarray(jd.channel_seeds(jnp.asarray(seeds), jnp.asarray(cid)))
    got = td.channel_seeds(torch.from_numpy(seeds), torch.from_numpy(cid)).numpy()
    assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed", [0, 1, 77417, 2**31 - 1])
def test_file_seed_equal(seed):
    for path in ("a.wav", "/tmp/stems/kick 01.wav", "x" * 300):
        assert td.file_seed(seed, path) == jd.file_seed(seed, path)


def _quantize_inputs(bits: int) -> np.ndarray:
    rng = np.random.default_rng(bits)
    s = float(1 << (bits - 1))
    half = (np.arange(-40, 40) + 0.5) / s               # exact .5 LSB boundaries
    edges = np.array([1.0, -1.0, 1.0 - 1.0 / s, -1.0 + 1.0 / s, 0.0, -0.0,
                      1.5, -1.5, 0.5 / s, -0.5 / s])
    z = np.concatenate([half, edges, rng.uniform(-1.1, 1.1, 390)])
    return z.astype(np.float32).reshape(2, 3, -1)


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("dithered", [False, True])
def test_quantize_noise_bitwise(bits, dithered):
    z = _quantize_inputs(bits)
    if dithered:
        seeds = np.array([[5, -9, 2**30], [0, 1, 2]], np.int32)
        pos = (np.arange(z.shape[-1], dtype=np.int32) + 1000)[None, None, :]
        want = jd.quantize_noise(jnp.asarray(z), bits,
                                 jnp.asarray(seeds)[..., None], jnp.asarray(pos))
        got = td.quantize_noise(torch.from_numpy(z), bits,
                                torch.from_numpy(seeds)[..., None],
                                torch.from_numpy(pos))
    else:
        want = jd.quantize_noise(jnp.asarray(z), bits)
        got = td.quantize_noise(torch.from_numpy(z), bits)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_quantize_dequantize_bitwise(bits):
    z = _quantize_inputs(bits)
    q = td.quantize(torch.from_numpy(z), bits)
    assert np.array_equal(q.numpy(), np.asarray(jd.quantize(jnp.asarray(z), bits)))
    back = td.dequantize(q, bits).numpy()
    want = np.asarray(jd.dequantize(jnp.asarray(q.numpy()), bits))
    assert np.array_equal(_bits(back), _bits(want))


def test_noise_seeds_takes_only_int32_seed_vectors():
    s = torch.tensor([3, -1], dtype=torch.int32)
    assert td.noise_seeds(s, 2).tolist() == [3, 2**32 - 1]
    for bad in (torch.tensor([0, 42], dtype=torch.int64),   # not int32
                torch.tensor([3, 4, 5], dtype=torch.int32)):  # wrong length
        with pytest.raises(ValueError, match="int32 seed vector"):
            td.noise_seeds(bad, 2)
