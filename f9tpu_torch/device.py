"""Device selection for the port (no JAX counterpart: JAX picks its backend
globally, the port names a ``torch.device`` at each entry point).

`resolve_device` is the one place a device name becomes a ``torch.device``.
It also switches TF32 off for every float32 matmul and convolution: TF32
keeps ~10 mantissa bits, and the SRC's accuracy gate (<= -120 dB against
the float64 oracle) needs full float32 — on the TPU one reduced-precision
pass measured -53 dB (docs/PERF.md).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name: str | torch.device | None = "cuda") -> torch.device:
    """``name`` (default ``"cuda"``) as a ``torch.device``.

    Raises RuntimeError when CUDA is asked for and no GPU is present: the
    port never carries on quietly on the CPU.  CPU runs pass ``"cpu"``."""
    dev = torch.device("cuda" if name is None else name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available "
            "(pass device='cpu' to run the plain PyTorch path)")
    return dev
