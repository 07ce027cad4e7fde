"""On-device PCM codec: raw container bytes <-> float32 (port of
`f9tpu/ops/devcodec.py`).

The host uploads 2-3 bytes per sample of interleaved integer PCM and
downloads the packed 2-3 byte payload; unpack and pack run on the device.
Byte order matches the WAV wire format (little-endian, frame-major).
"""

from __future__ import annotations

import torch

__all__ = ["unpack_pcm_interleaved", "pack24_interleaved",
           "pack16_interleaved", "pack_interleaved", "bytes_per_frame"]


def bytes_per_frame(channels: int, bits: int) -> int:
    return channels * (bits // 8)


def unpack_pcm_interleaved(raw: torch.Tensor, channels: int, bits: int,
                           big_endian: bool = False) -> torch.Tensor:
    """uint8 ``(..., frames*channels*bits//8)`` -> float32
    ``(..., channels, frames)``; a trailing partial frame is dropped."""
    if bits not in (16, 24):
        raise ValueError(f"unsupported on-device bit depth {bits}")
    nbytes = bits // 8
    lead = raw.shape[:-1]
    frames = raw.shape[-1] // (channels * nbytes)
    b = raw[..., :frames * channels * nbytes].reshape(
        *lead, frames, channels, nbytes).to(torch.int32)
    lo, mid, hi = (nbytes - 1, 1, 0) if big_endian else (0, 1, nbytes - 1)
    if bits == 16:
        v = b[..., lo] | (b[..., hi] << 8)
        v = v - ((v & 0x8000) << 1)               # sign-extend 16 -> 32
        x = v.to(torch.float32) * (1.0 / 32768.0)
    else:
        v = b[..., lo] | (b[..., mid] << 8) | (b[..., hi] << 16)
        v = v - ((v & 0x800000) << 1)             # sign-extend 24 -> 32
        x = v.to(torch.float32) * (1.0 / 8388608.0)
    return x.transpose(-1, -2).contiguous()       # (..., channels, frames)


def _pack(codes: torch.Tensor, nbytes: int) -> torch.Tensor:
    inter = codes.transpose(-1, -2)               # (..., frames, channels)
    v = inter.to(torch.int64) & 0xFFFFFFFF
    b = torch.stack([((v >> (8 * k)) & 0xFF).to(torch.uint8)
                     for k in range(nbytes)], dim=-1)
    return b.reshape(*codes.shape[:-2], -1)


def pack24_interleaved(codes: torch.Tensor) -> torch.Tensor:
    """int32 codes ``(..., channels, frames)`` -> uint8
    ``(..., frames*channels*3)`` little-endian interleaved 24-bit payload."""
    return _pack(codes, 3)


def pack16_interleaved(codes: torch.Tensor) -> torch.Tensor:
    """int32 codes ``(..., channels, frames)`` -> uint8
    ``(..., frames*channels*2)`` little-endian interleaved 16-bit payload."""
    return _pack(codes, 2)


def pack_interleaved(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Dispatch to the 16- or 24-bit payload packer."""
    if bits == 24:
        return pack24_interleaved(codes)
    if bits == 16:
        return pack16_interleaved(codes)
    raise ValueError(f"no on-device payload packer for {bits}-bit output")
