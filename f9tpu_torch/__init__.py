"""f9tpu_torch — the f9tpu batch resampler in PyTorch, for NVIDIA GPUs.

A port of the JAX package `f9tpu`, which stays beside it as the reference.
Module layout and names follow `f9tpu` so each function's counterpart is
easy to find; the port imports `torch` and never `jax`.  It reuses the JAX
package's jax-free modules as they are: `f9tpu.config`, `f9tpu.io` (every
codec), `f9tpu.models` (filter design, `CycleBank`, the float64 oracle) and
`f9tpu.native`.

What runs today is the default batch job (`python -m f9tpu_torch.cli
process`): integer-PCM or float files in, resampled 16/24/32-bit files out,
with the cycle-matrix SRC as a hand-written CUDA kernel
(`f9tpu_torch/csrc/cycle_src.cu`).  See ROADMAP.md for what is still to port.
"""

from .device import resolve_device  # noqa: F401
