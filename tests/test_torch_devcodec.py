"""The port's on-device PCM codec against the JAX package's: bitwise."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.ops import devcodec as jc  # noqa: E402
from f9tpu_torch.ops import devcodec as tc  # noqa: E402


def _raw(bits: int, channels: int, frames: int, extra: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = frames * channels * (bits // 8) + extra      # extra = trailing partial frame
    raw = rng.integers(0, 256, size=(3, n), dtype=np.uint8)
    raw[0, : bits // 8] = 0x80 if bits == 16 else 0   # extreme codes in frame 0
    raw[0, bits // 8 - 1] = 0x80
    return raw


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("channels,extra", [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_unpack_bitwise(bits, big_endian, channels, extra):
    raw = _raw(bits, channels, 257, extra, seed=bits + channels + extra)
    want = np.asarray(jc.unpack_pcm_interleaved(jnp.asarray(raw), channels, bits,
                                                big_endian=big_endian))
    got = tc.unpack_pcm_interleaved(torch.from_numpy(raw), channels, bits,
                                    big_endian=big_endian).numpy()
    assert got.shape == want.shape == (3, channels, 257)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("bits", [16, 24])
def test_pack_bitwise(bits):
    rng = np.random.default_rng(bits)
    s = 1 << (bits - 1)
    codes = rng.integers(-s, s, size=(2, 3, 301)).astype(np.int32)
    codes[0, 0, :4] = [-s, s - 1, 0, -1]
    want = np.asarray(jc.pack_interleaved(jnp.asarray(codes), bits))
    got = tc.pack_interleaved(torch.from_numpy(codes), bits)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)
    # and the round trip through the unpacker restores the codes
    back = tc.unpack_pcm_interleaved(got, 3, bits).numpy()
    assert np.array_equal(np.round(back * s).astype(np.int32), codes)


def test_pack_rejects_other_depths():
    with pytest.raises(ValueError, match="32-bit"):
        tc.pack_interleaved(torch.zeros((1, 1, 4), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="bit depth"):
        tc.unpack_pcm_interleaved(torch.zeros((1, 8), dtype=torch.uint8), 1, 8)
