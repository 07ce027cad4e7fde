"""The cycle-matrix SRC kernel and its dispatch (port of
`f9tpu/ops/pallas_src.py`).

The JAX package runs its SRC through two Pallas TPU kernels, `_kernel_roll`
(overlap R = 1) and `_kernel` (R > 1).  The port replaces both with one
hand-written CUDA kernel, `f9tpu_torch/csrc/cycle_src.cu`, which computes

    y[b, q*L + l] = sum_{w < W} xpad[b, q*M + w] * G[w, l]

straight from the flat signal (no host or device retiling into (rows, M)).

The wrapper rule: on a CUDA tensor `resample_rows` / `resample_kernel`
launch the kernel or raise; on a CPU tensor they run the plain PyTorch twin
`resample_rows_reference` (the stacked-bank matmul plus R row-shifted adds
of `f9tpu.ops.pallas_src.resample_rows_pre`).  There is no fallback from
the kernel to the twin.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from f9tpu.models.filters import CycleBank

from .resample import _require_dense, bank_to_torch, cycle_matrix_f32, resample

__all__ = ["kernel_applicable", "resample_rows", "resample_rows_reference",
           "resample_kernel", "resample_auto", "rows_marshal_plan",
           "stacked_bank_f32", "launches"]

#: CUDA kernel launches since the count was last reset (a plain integer:
#: callers set it to 0 and read it back to prove a path ran the kernel).
launches = 0


def _overlap_rows(bank: CycleBank) -> int:
    """R: how many cycle rows past its own an output cycle reads."""
    return max(1, -(-(bank.taps_per_phase - 1) // bank.M))


def kernel_applicable(bank: CycleBank) -> bool:
    """Does the CUDA kernel take this bank?

    It needs the dense cycle matrix (varispeed banks have none) and L >= 8:
    a block computes 32 output phases, so below 8 (the integer-ratio banks,
    L in {1, 2, 4}) more than three quarters of every block would idle, and
    the unfold + matmul form serves them.  Unlike the Pallas gate
    (`pallas_applicable`: R <= 8, M >= 16, both TPU VMEM tiling rules) it
    bounds neither R nor M: the kernel contracts over W in 16-row chunks and
    reads the flat signal, so its shared memory does not grow with the bank.
    Every bank `pallas_applicable` accepts is accepted here."""
    return bank.dense_ok and bank.L >= 8


@functools.lru_cache(maxsize=64)
def _stacked_bank_cached(bank: CycleBank) -> np.ndarray:
    L, M, W = bank.L, bank.M, bank.W
    R = _overlap_rows(bank)
    g = np.zeros(((R + 1) * M, L), np.float32)
    g[:W] = cycle_matrix_f32(bank)
    # row-block transposes stacked on the OUTPUT dim: gs[r*L + p, m] = G[r*M + m, p]
    return np.ascontiguousarray(
        np.concatenate([g[r * M:(r + 1) * M].T for r in range(R + 1)], axis=0))


def stacked_bank_f32(bank: CycleBank) -> np.ndarray:
    """The cycle bank restructured for the shift-after-dot rows form:
    ``((R+1)*L, M)`` where block r holds ``G[r*M:(r+1)*M].T``."""
    return _stacked_bank_cached(bank)


def rows_marshal_plan(bank: CycleBank, frames: int) -> tuple[int, int]:
    """(n_rows, pad_front) for rows marshalling of a ``frames``-long signal:
    the samples sit at flat offset ``pad_front`` of a zero ``(n_rows, M)``
    buffer."""
    n_out = -(-bank.out_len(frames) // bank.L)
    return n_out + _overlap_rows(bank), bank.pad_front


@functools.lru_cache(maxsize=64)
def _stacked_bank_f64(bank: CycleBank, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(stacked_bank_f32(bank)).to(device, torch.float64)


@functools.lru_cache(maxsize=64)
def _band_table(bank: CycleBank, device: torch.device, tile_l: int) -> torch.Tensor:
    """Per ``tile_l``-column tile of G (the kernel's block width), the row
    range ``[w_lo, w_hi)`` outside which all its columns are zero, as int32
    ``(n_tiles, 2)`` on ``device``."""
    g = cycle_matrix_f32(bank)
    rows = []
    for l0 in range(0, bank.L, tile_l):
        nz = np.flatnonzero(np.any(g[:, l0:l0 + tile_l] != 0, axis=1))
        rows.append((int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0))
    return torch.tensor(rows, dtype=torch.int32).to(device)


def _launch(xf: torch.Tensor, bank: CycleBank, Q: int, out_len: int,
            out_stride: int) -> torch.Tensor:
    """One kernel launch over ``xf (bc, T)``: ``(bc, out_stride)`` float32 of
    which samples ``[0, out_len)`` are written."""
    global launches
    if xf.dtype != torch.float32:
        raise TypeError(f"cycle_src kernel takes float32, got {xf.dtype}")
    if xf.device.type != "cuda":
        raise ValueError(f"cycle_src kernel needs a CUDA tensor, got {xf.device}")
    if xf.dim() != 2 or not xf.is_contiguous():
        raise ValueError("cycle_src kernel needs a contiguous (signals, frames) tensor")
    bc, T = xf.shape
    if not 0 < bc <= 65535:
        raise ValueError(f"cycle_src kernel takes 1..65535 signals, got {bc}")
    if Q >= 2**31:
        raise ValueError(f"{Q} output cycles exceed the kernel's int32 grid")
    from ._build import load_library

    lib = load_library()
    g = bank_to_torch(bank, xf.device)
    band = _band_table(bank, xf.device, lib.f9_cycle_src_tile_l())
    y = torch.empty((bc, out_stride), dtype=torch.float32, device=xf.device)
    with torch.cuda.device(xf.device):
        stream = torch.cuda.current_stream(xf.device).cuda_stream
        err = lib.f9_cycle_src(
            ctypes.c_void_p(xf.data_ptr()), ctypes.c_void_p(g.data_ptr()),
            ctypes.c_void_p(band.data_ptr()), ctypes.c_void_p(y.data_ptr()),
            bc, T, T, bank.pad_front, bank.M, bank.L, Q, out_len, out_stride,
            ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cycle_src kernel launch failed: CUDA error {err}")
    launches += 1
    return y


def resample_rows_reference(x: torch.Tensor, bank: CycleBank,
                            out_len: int | None = None
                            ) -> tuple[torch.Tensor, int]:
    """Plain PyTorch twin of the kernel: ``(y (..., Q, L), out_len)`` with
    output sample ``t`` at ``y[..., t // L, t % L]``.  Marshals the signal
    into zero-padded ``(Q + R, M)`` cycle rows, multiplies by the stacked
    bank once and adds R row-shifted blocks (`resample_rows_pre`'s math).

    The float32 signal and bank are multiplied and summed in float64 and the
    result rounded to float32 once, so the twin is the exact sum to within
    half an output ulp: the reference the kernel (and the card's output
    against the CPU path's) is held to.  A float32 matmul would itself carry
    ~0.35 LSB RMS of summation error at 24 bits."""
    _require_dense(bank)
    L, M = bank.L, bank.M
    R = _overlap_rows(bank)
    T = x.shape[-1]
    lead = x.shape[:-1]
    if out_len is None:
        out_len = bank.out_len(T)
    Q = -(-out_len // L)
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, 0, L)), out_len
    bc = int(np.prod(lead)) if lead else 1
    n_rows = Q + R
    pf = bank.pad_front
    keep = max(0, min(T, n_rows * M - pf))
    xp = torch.zeros((bc, n_rows * M), dtype=torch.float64, device=x.device)
    xp[:, pf:pf + keep] = x.reshape(bc, T)[:, :keep]
    gs = _stacked_bank_f64(bank, x.device)            # ((R+1)*L, M)
    P = torch.matmul(xp.view(bc, n_rows, M), gs.T)     # (bc, Q+R, (R+1)*L)
    y = P[:, :Q, :L].clone()
    for r in range(1, R + 1):
        y += P[:, r:r + Q, r * L:(r + 1) * L]
    return y.to(x.dtype).reshape(*lead, Q, L), out_len


def resample_rows(x: torch.Tensor, bank: CycleBank,
                  out_len: int | None = None) -> tuple[torch.Tensor, int]:
    """``(y (..., Q, L), out_len)``, ``Q = ceil(out_len / L)``: the kernel on
    a CUDA tensor, the twin on a CPU tensor."""
    if x.device.type == "cpu":
        return resample_rows_reference(x, bank, out_len=out_len)
    _require_dense(bank)
    T = x.shape[-1]
    lead = x.shape[:-1]
    if out_len is None:
        out_len = bank.out_len(T)
    Q = -(-out_len // bank.L)
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, 0, bank.L)), out_len
    y = _launch(x.reshape(-1, T).contiguous(), bank, Q, Q * bank.L, Q * bank.L)
    return y.reshape(*lead, Q, bank.L), out_len


def resample_kernel(x: torch.Tensor, bank: CycleBank,
                    out_len: int | None = None) -> torch.Tensor:
    """Drop-in equivalent of `resample` through the kernel (flat output
    ``(..., out_len)``; the counterpart of `resample_pallas`).  The kernel
    writes the flat layout directly, so no reshape pass follows it."""
    T = x.shape[-1]
    lead = x.shape[:-1]
    if out_len is None:
        out_len = bank.out_len(T)
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, out_len))
    if x.device.type == "cpu":
        y, _ = resample_rows_reference(x, bank, out_len=out_len)
        bc = int(np.prod(lead)) if lead else 1
        return y.reshape(bc, -1)[:, :out_len].reshape(*lead, out_len)
    _require_dense(bank)
    Q = -(-out_len // bank.L)
    y = _launch(x.reshape(-1, T).contiguous(), bank, Q, out_len, out_len)
    return y.reshape(*lead, out_len)


def resample_auto(x: torch.Tensor, bank: CycleBank,
                  out_len: int | None = None) -> torch.Tensor:
    """The kernel where `kernel_applicable`, the unfold + matmul `resample`
    otherwise (the JAX package's dispatch)."""
    if kernel_applicable(bank):
        return resample_kernel(x, bank, out_len=out_len)
    return resample(x, bank, out_len=out_len)
