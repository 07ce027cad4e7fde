"""Level reductions the batch graph reports (port of the part of
`f9tpu/ops/analysis.py` the graph uses)."""

from __future__ import annotations

import torch

__all__ = ["DB_FLOOR", "peak_db", "rms_db"]

#: dB value reported for exactly-zero signals.
DB_FLOOR = -200.0


def _amp_to_db(a: torch.Tensor) -> torch.Tensor:
    return torch.where(a > 0, 20.0 * torch.log10(torch.clamp(a, min=1e-30)),
                       torch.full_like(a, DB_FLOOR))


def rms_db(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """RMS level in dBFS over ``dim``."""
    return _amp_to_db(torch.sqrt(torch.mean(torch.square(x), dim=dim)))


def peak_db(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Absolute peak level in dBFS over ``dim``."""
    return _amp_to_db(torch.amax(torch.abs(x), dim=dim))
