"""Position-keyed TPDF dither + PCM quantization (port of
`f9tpu/ops/dither.py`).

Bitwise twin of the JAX functions: the noise is a pure integer function of
(seed, channel, absolute output frame), so the same file gets the same
codes on either package, any device, any batching.  torch's ``uint32`` has
few arithmetic ops, so the SplitMix32 hash runs in ``int64`` holding
unsigned 32-bit values: every multiply is masked back to 32 bits, and right
shifts act on non-negative values (logical shifts).  ``torch.round`` rounds
half to even, like ``jnp.round``.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

__all__ = ["tpdf_noise", "channel_seeds", "file_seed", "noise_seeds",
           "quantize_noise", "quantize", "dequantize"]

_U32 = 0xFFFFFFFF


def _scale(bits: int) -> float:
    return float(1 << (bits - 1))


def _as_u32(v: torch.Tensor) -> torch.Tensor:
    """Any integer tensor as int64 holding its value mod 2^32 (int32 -1 ->
    0xFFFFFFFF, as ``astype(uint32)`` does)."""
    return v.to(torch.int64) & _U32


def _splitmix32(h: torch.Tensor) -> torch.Tensor:
    """SplitMix32 finalizer on int64 values in [0, 2^32).  The products
    stay below 2^63 (h < 2^32, both constants < 2^31)."""
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & _U32
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & _U32
    h = h ^ (h >> 15)
    return h


def tpdf_noise(seeds: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """TPDF dither noise in LSB units (float32), a pure function of
    (seed, position); ``seeds`` and ``pos`` broadcast together."""
    seed_h = _splitmix32(_as_u32(seeds))
    h = _splitmix32(_as_u32(pos) ^ seed_h)
    u1 = (h & 0xFFFF).to(torch.float32) * (1.0 / 65536.0)
    u2 = (h >> 16).to(torch.float32) * (1.0 / 65536.0)
    return u1 - u2


def channel_seeds(seeds: torch.Tensor, channels) -> torch.Tensor:
    """Per-channel sub-seeds ``(..., channels)`` (int64 holding uint32) from
    per-file seeds; ``channels`` is a count or a tensor of GLOBAL channel
    indices."""
    if isinstance(channels, int):
        c = torch.arange(channels, dtype=torch.int64, device=seeds.device)
    else:
        c = _as_u32(channels)
    return _as_u32(seeds)[..., None] ^ ((c * 0x9E3779B9) & _U32)


def file_seed(base_seed: int, path: str) -> int:
    """Deterministic per-file noise seed from (run seed, file path)."""
    return (zlib.crc32(path.encode())
            ^ ((base_seed * 2654435761) & 0xFFFFFFFF)) & 0x7FFFFFFF


def noise_seeds(seeds: torch.Tensor, files: int) -> torch.Tensor:
    """The graph's per-file int32 seed vector as uint32 hash seeds.  The JAX
    package also takes a threefry PRNG key here; its bits cannot be
    reproduced in torch, so anything but an int32 ``(files,)`` vector
    raises."""
    if not (isinstance(seeds, torch.Tensor) and seeds.dtype == torch.int32
            and seeds.shape == (files,)):
        raise ValueError(
            f"noise_seeds takes the per-file int32 seed vector of shape "
            f"({files},); PRNG keys are not supported")
    return _as_u32(seeds)


def _clip_hi(s: float) -> np.float32:
    """Largest float32 clip bound strictly below ``s`` (= 2^(bits-1)); at 32
    bits ``s - 1`` rounds up to 2^31 in float32."""
    hi = np.float32(s - 1.0)
    if float(hi) >= s:
        hi = np.nextafter(np.float32(s), np.float32(0))
    return hi


def _round_clip(v: torch.Tensor, s: float) -> torch.Tensor:
    return torch.clamp(torch.round(v), -s, float(_clip_hi(s))).to(torch.int32)


def quantize(x: torch.Tensor, bits: int = 24) -> torch.Tensor:
    """Undithered round-half-even PCM quantization to int32 codes."""
    s = _scale(bits)
    return _round_clip(x * s, s)


def quantize_noise(z: torch.Tensor, bits: int,
                   seeds: torch.Tensor | None = None,
                   pos: torch.Tensor | None = None) -> torch.Tensor:
    """Scale -> optional position-keyed TPDF noise -> round -> clip -> int32
    codes (the one quantize epilogue of every pipeline path)."""
    s = _scale(bits)
    v = z * s
    if seeds is not None:
        if pos is None:
            raise ValueError(
                "quantize_noise: position-keyed noise needs BOTH seeds and pos")
        v = v + tpdf_noise(seeds, pos)
    return _round_clip(v, s)


def dequantize(q: torch.Tensor, bits: int = 24) -> torch.Tensor:
    """PCM codes back to float32 in [-1, 1)."""
    return q.to(torch.float32) / _scale(bits)
