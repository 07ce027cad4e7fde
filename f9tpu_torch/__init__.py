"""f9tpu_torch — the f9tpu batch resampler in PyTorch, for NVIDIA GPUs.

A port of the JAX package `f9tpu`, which stays beside it as the reference.
Module layout and names follow `f9tpu` so each function's counterpart is
easy to find; the port imports `torch` and never `jax`, and nothing of the
JAX package: it keeps its own copies of the JAX package's jax-free modules,
under the same names (`config`, `io` with every codec, `models` with filter
design, `CycleBank` and the float64 oracle, and `native`, the g++ twins).

What runs today is every subcommand of the JAX CLI on one device
(`python -m f9tpu_torch.cli`): the batch job (`process`: integer-PCM or
float files in, resampled 16/24/32-bit files out, the insert loop with
`--reverb`, `--routing` and `--chain-*`, varispeed rates, loudness
normalization), the constant-memory stream of files of any length
(`stream`), the playlist preview (`preview`), the drop-folder daemon
(`watch`), and `selftest`, `measure`, `probe`, `verify` and `devices`, with
the cycle-matrix SRC as a hand-written CUDA kernel
(`f9tpu_torch/csrc/cycle_src.cu`); and `process`, `watch` and `stream` over a
mesh of devices (`f9tpu_torch.parallel`: files, channels and frames
sharding, one process driving a thread and a CUDA stream per shard).  See ROADMAP.md
for what is still to port (the rows layout).
"""

from .device import resolve_device  # noqa: F401
