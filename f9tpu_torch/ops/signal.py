"""Test-signal generators: sine, impulse, exponential sweep (port of
`f9tpu/ops/signal.py`).

As in the JAX package the samples are computed in float64 numpy on the
host (a float32 phase accumulator loses ~0.03 rad by minute three of a
48 kHz tone) and cast to float32 once; the port then moves that float32
array to ``device``, so its samples equal the JAX package's bit for bit.
Each generator defaults to CUDA (raising without a GPU); CPU runs pass
``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DEFAULT_TEST_AMP", "DEFAULT_TEST_FREQ", "IMPULSE_AMP", "impulse",
           "log_sweep", "sine"]

#: The loop test's tone: 1 kHz at half scale.
DEFAULT_TEST_FREQ = 1000.0
DEFAULT_TEST_AMP = 0.5
#: Amplitude of the latency-measurement impulse.
IMPULSE_AMP = 0.9


def sine(frames: int, rate: int, freq: float = DEFAULT_TEST_FREQ,
         amp: float = DEFAULT_TEST_AMP, phase0: float = 0.0,
         device: torch.device | str | None = None) -> tuple[torch.Tensor, float]:
    """``(samples (frames,) float32 on device, final_phase)``, phase in
    radians: a phase-accumulating generator whose blocks continue each
    other through ``phase0`` / ``final_phase``, exact for any length (the
    cycle count is reduced modulo 1 per sample index in float64)."""
    two_pi = 2.0 * np.pi
    n = np.arange(frames, dtype=np.float64)
    cycles = np.mod(float(phase0) / two_pi + n * (freq / rate), 1.0)
    samples = (amp * np.sin(two_pi * cycles)).astype(np.float32)
    final = float(np.mod(float(phase0) + two_pi * frames * (freq / rate), two_pi))
    return torch.from_numpy(samples).to(resolve_device(device)), final


def impulse(frames: int, amp: float = IMPULSE_AMP, position: int = 0,
            device: torch.device | str | None = None) -> torch.Tensor:
    """Single-sample float32 impulse of ``amp`` at ``position`` on
    ``device``."""
    x = torch.zeros(frames, dtype=torch.float32, device=resolve_device(device))
    x[position] = amp
    return x


def log_sweep(frames: int, rate: int, f0: float = 20.0, f1: float = 20000.0,
              amp: float = 0.5, device: torch.device | str | None = None) -> torch.Tensor:
    """Exponential sine sweep from ``f0`` to ``f1`` Hz over ``frames``,
    float32 on ``device``."""
    t = np.arange(frames, dtype=np.float64) / rate
    dur = frames / rate
    k = np.log(f1 / f0)
    phase = 2.0 * np.pi * f0 * dur / k * (np.exp(t / dur * k) - 1.0)
    x = (amp * np.sin(np.mod(phase, 2.0 * np.pi))).astype(np.float32)
    return torch.from_numpy(x).to(resolve_device(device))
