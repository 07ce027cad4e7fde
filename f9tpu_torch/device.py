"""Device selection for the port (no JAX counterpart: JAX picks its backend
globally, the port names a ``torch.device`` at each entry point).

`resolve_device` is the one place a device name becomes a ``torch.device``.
It also switches TF32 off for every float32 matmul and convolution: TF32
keeps ~10 mantissa bits, and the SRC's accuracy gate (<= -120 dB against
the float64 oracle) needs full float32 — on the TPU one reduced-precision
pass measured -53 dB (docs/PERF.md).

Importing this module also makes the first CPU call of each transcendental
the port uses (`_warm_cpu_transcendentals`).
"""

from __future__ import annotations

import torch

__all__ = ["NoDeviceError", "resolve_device"]


class NoDeviceError(RuntimeError):
    """CUDA was asked for and no GPU is present."""


def _warm_cpu_transcendentals() -> None:
    """Call each float32 transcendental the port's CPU path uses once, on a
    tensor below torch's parallel grain, so it runs on one thread.

    torch's CPU build sets up each vectorized transcendental kernel at its
    first call.  When that first call is split across threads, one thread
    can compute its whole chunk with a wrong approximation: in fresh
    processes on a loaded 8-core host, tanh, exp and log10 were off by up to
    8e-5 (700 codes at 24 bits) in 3-5 % of first calls, while the second
    call was right.  A first call on one thread never showed it (0 of 60)."""
    t = torch.linspace(0.1, 1.0, 64)
    for f in (torch.tanh, torch.exp, torch.log, torch.log10,
              lambda v: torch.pow(10.0, v)):
        f(t)


_warm_cpu_transcendentals()


def resolve_device(name: str | torch.device | None = "cuda") -> torch.device:
    """``name`` (default ``"cuda"``) as a ``torch.device``.

    Raises `NoDeviceError` (a RuntimeError) when CUDA is asked for and no
    GPU is present: the port never carries on quietly on the CPU.  CPU runs
    pass ``"cpu"``."""
    dev = torch.device("cuda" if name is None else name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoDeviceError(
            f"device {str(dev)!r} requested but no CUDA GPU is available "
            "(pass device='cpu' to run the plain PyTorch path)")
    return dev
