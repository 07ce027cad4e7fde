"""The plain output stage: DC removal over each file's span, gain, the
statistics, position-keyed TPDF dither and 24-bit quantisation, in float64.

The dither is the published integer hash of (file seed, channel, output
frame): SplitMix32's finaliser of the position xored with the finalised
channel seed, whose low and high 16 bits give two uniform values whose
difference is the triangular noise in LSB.
"""

from __future__ import annotations

import torch

U32 = 0xFFFFFFFF
DB_FLOOR = -200.0


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = (h * 0x21F0AAAD) & U32
    h = h ^ (h >> 15)
    h = (h * 0x735A2D97) & U32
    return h ^ (h >> 15)


def tpdf(seed: int, channel: int, n: int, device) -> torch.Tensor:
    """``(n,)`` float64 TPDF noise in LSB of frames ``0 .. n-1``."""
    cs = (seed & U32) ^ ((channel * 0x9E3779B9) & U32)
    key = _mix32(torch.tensor(cs, dtype=torch.int64, device=device))
    h = _mix32(torch.arange(n, dtype=torch.int64, device=device) ^ key)
    return ((h & 0xFFFF).to(torch.float64) - (h >> 16).to(torch.float64)) / 65536.0


def to_db(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 0, 20.0 * torch.log10(torch.clamp(a, min=1e-300)),
                       torch.full_like(a, DB_FLOOR))


def finish(y: torch.Tensor, frames: int, seed: int, *, bits: int, dither: bool,
           remove_dc: bool, gain_db: float, floor_frames: int):
    """One file's ``y (C, T)`` float64 over its first ``frames`` outputs:
    ``(codes (C, frames) int64, peak_db, rms_db, floor_db, exact, noise)``,
    ``exact`` the scaled value before the dither and ``noise`` the dither
    (``(C, frames)`` float64 in LSB; None without dither).  The floor is
    the RMS over the last ``floor_frames`` frames of the loudest channel's
    ``|z|`` (fewer where the file is shorter)."""
    C = y.shape[0]
    z = y[:, :frames]
    if remove_dc and frames > 0:
        z = z - z.mean(dim=-1, keepdim=True)
    z = z * (10.0 ** (gain_db / 20.0) if gain_db else 1.0)
    n = max(frames, 1)
    peak = z.abs().max() if frames else torch.zeros((), dtype=z.dtype, device=z.device)
    rms = torch.sqrt((z * z).sum() / (n * C))
    tail = z[:, max(0, frames - floor_frames):].abs().amax(dim=0) if frames else z[:, :0]
    floor = torch.sqrt((tail * tail).sum() / max(1, min(frames, floor_frames)))
    s = float(1 << (bits - 1))
    v = z * s
    noise = torch.stack([tpdf(seed, c, frames, y.device) for c in range(C)]) if dither else None
    codes = torch.clamp(torch.round(v if noise is None else v + noise), -s, s - 1).to(torch.int64)
    return codes, float(to_db(peak)), float(to_db(rms)), float(to_db(floor)), v, noise
