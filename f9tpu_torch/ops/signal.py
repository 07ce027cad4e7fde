"""Calibration test signal (port of `impulse` from `f9tpu/ops/signal.py`)."""

from __future__ import annotations

import torch

from ..device import resolve_device

__all__ = ["IMPULSE_AMP", "impulse"]

#: Amplitude of the latency-measurement impulse.
IMPULSE_AMP = 0.9


def impulse(frames: int, amp: float = IMPULSE_AMP, position: int = 0,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Single-sample float32 impulse of ``amp`` at ``position`` on
    ``device`` (default CUDA, raising without a GPU)."""
    x = torch.zeros(frames, dtype=torch.float32, device=resolve_device(device))
    x[position] = amp
    return x
