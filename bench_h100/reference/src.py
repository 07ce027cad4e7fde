"""The plain SRC: the direct form of `design`, evaluated a block of cycles at
a time as a float64 product of input windows by the cycle matrix.

``tf32=True`` is the control: both operands rounded to TF32 (10 mantissa
bits, as the tensor cores read float32 with TF32 on), the products summed in
float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import design

#: window elements one block of cycles holds (float64: 256 MB)
_BLOCK_ELEMS = 1 << 25


@functools.lru_cache(maxsize=8)
def bank(rate_in: int, rate_out: int, quality: str, kind: str):
    """``(L, M, C (W, L) float64, lead)`` of the rate pair."""
    L, M, K, H, delay = design.design(rate_in, rate_out, quality, kind)
    C, lead = design.cycle_form(L, M, K, H, delay)
    return L, M, C, lead


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 ``t`` rounded to the nearest TF32 value (ties away from 0)."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def out_len(frames: int, rate_in: int, rate_out: int) -> int:
    """Outputs spanning ``frames`` inputs: ``ceil(frames * L / M)``."""
    L, M = design.ratio(rate_in, rate_out)
    return -(-frames * L // M)


def resample(x: torch.Tensor, rate_in: int, rate_out: int, n_out: int,
             quality: str = "high", kind: str = "sinc", tf32: bool = False) -> torch.Tensor:
    """``x (rows, T)`` (zero outside ``[0, T)``) -> ``(rows, n_out)`` float64."""
    L, M, C, lead = bank(rate_in, rate_out, quality, kind)
    rows, T = x.shape
    W = C.shape[0]
    Q = -(-n_out // L)
    need = (Q - 1) * M + W                     # padded inputs the cycles read
    xp = F.pad(x.to(torch.float64), (-lead, max(0, need + lead - T)))[:, :need]
    c = torch.from_numpy(C).to(x.device)
    if tf32:
        xp, c = to_tf32(xp), to_tf32(c)
    else:
        c = c.to(xp.dtype)
    y = torch.empty((rows, Q * L), dtype=torch.float64, device=x.device)
    step = max(1, _BLOCK_ELEMS // (rows * W))
    for q0 in range(0, Q, step):
        q1 = min(Q, q0 + step)
        win = xp[:, q0 * M:(q1 - 1) * M + W].unfold(-1, W, M)       # (rows, q, W)
        y[:, q0 * L:q1 * L] = (win.reshape(-1, W) @ c).reshape(rows, -1).to(torch.float64)
    return y[:, :n_out]


def taps_per_output(rate_in: int, rate_out: int, quality: str = "high",
                    kind: str = "sinc") -> np.ndarray:
    """``(L,)`` non-zero taps per output phase of the pair's bank."""
    L, M, K, H, delay = design.design(rate_in, rate_out, quality, kind)
    return design.taps_per_output(L, M, K, H, delay)
