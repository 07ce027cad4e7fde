"""Analysis reductions: RMS, peak, noise floor, peak position, DC removal
(port of `f9tpu/ops/analysis.py`).

Each reduces over ``dim`` (default the last, frames) and runs on the
tensor's own device.  Indices come back as int32, the first index on ties,
on either device.  `remove_dc_offset` accumulates its mean in float64 and
rounds once, as the batch graph does: a float32 sum's order follows the
tensor's shape and alignment on the card.
"""

from __future__ import annotations

import torch

__all__ = ["DB_FLOOR", "first_above", "noise_floor_db", "peak", "peak_db",
           "peak_position", "remove_dc_offset", "rms", "rms_db"]

#: dB value reported for exactly-zero signals.
DB_FLOOR = -200.0


def rms(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Root-mean-square over ``dim``."""
    return torch.sqrt(torch.mean(torch.square(x), dim=dim))


def _amp_to_db(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 0, 20.0 * torch.log10(torch.clamp(a, min=1e-30)),
                       torch.full_like(a, DB_FLOOR))


def rms_db(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """RMS level in dBFS over ``dim``."""
    return _amp_to_db(rms(x, dim=dim))


def peak(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Absolute peak over ``dim``."""
    return torch.amax(torch.abs(x), dim=dim)


def peak_db(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Absolute peak level in dBFS over ``dim``."""
    return _amp_to_db(peak(x, dim=dim))


def noise_floor_db(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Noise floor: the RMS level in dB of a capture window."""
    return rms_db(x, dim=dim)


def _first_max(v: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 index of the first maximum of ``v`` along ``dim``: the maximum
    is found, then the first index that holds it (``torch.argmax`` does not
    promise the first index on ties on every device)."""
    n = v.shape[dim]
    hit = v == torch.amax(v, dim=dim, keepdim=True)
    shape = [1] * v.dim()
    shape[dim] = n
    idx = torch.arange(n, dtype=torch.int32, device=v.device).reshape(shape)
    return torch.amin(torch.where(hit, idx, torch.full_like(idx, n)), dim=dim)


def peak_position(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the absolute peak (the first on ties), int32."""
    return _first_max(torch.abs(x), dim)


def first_above(x: torch.Tensor, threshold: float, dim: int = -1) -> torch.Tensor:
    """First index where ``|x| > threshold``, int32; -1 where never."""
    hit = torch.abs(x) > threshold
    idx = _first_max(hit.to(torch.int32), dim)
    return torch.where(torch.any(hit, dim=dim), idx, torch.full_like(idx, -1))


def remove_dc_offset(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Subtract the mean over ``dim``, accumulated in float64 and rounded
    to ``x``'s dtype once."""
    mean = torch.sum(x, dim=dim, keepdim=True, dtype=torch.float64) / x.shape[dim]
    return x - mean.to(x.dtype)
