"""Rational sample-rate conversion by the dense cycle matrix (port of
`f9tpu/ops/resample.py`).

The whole polyphase resampler is folded at design time into one ``(W, L)``
cycle matrix ``G`` (`f9tpu_torch.models.filters.design_cycle_bank`), so

    y[b, q*L : (q+1)*L] = x_padded[b, q*M : q*M + W] @ G

`resample` here is the plain form for banks the CUDA kernel does not take
(`f9tpu_torch.ops.src_kernel.kernel_applicable`): a strided ``unfold`` of
the padded signal into cycle windows and one float32 ``torch.matmul``.
`resample_presliced` is the streamed form, on a chunk that carries its own
halos: the kernel on the card, a fixed-order float64 fold elsewhere.
Varispeed banks (``bank.G is None``) are not ported yet.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..models.filters import CycleBank, design_cycle_bank

__all__ = ["resample", "resample_rates", "resample_presliced", "cycle_matrix_f32",
           "bank_to_torch", "VARISPEED_TODO"]

#: ROADMAP item that varispeed banks (no dense matrix) wait for.
VARISPEED_TODO = "ROADMAP Queue 1 'Varispeed' (banded SRC forms)"

#: Cap on the (rows x W) window matrix `resample` materialises per matmul.
_WINDOW_ELEMS = 1 << 26


def _require_dense(bank: CycleBank) -> None:
    if bank.G is None:
        raise NotImplementedError(
            f"varispeed bank {bank.L}/{bank.M} has no dense cycle matrix; "
            f"the banded forms are not ported yet ({VARISPEED_TODO})")


@functools.lru_cache(maxsize=64)
def _g_f32_cached(bank: CycleBank) -> np.ndarray:
    _require_dense(bank)
    return np.ascontiguousarray(bank.G, dtype=np.float32)


def cycle_matrix_f32(bank: CycleBank) -> np.ndarray:
    """The bank's cycle matrix as float32 (cached) — the same array
    `f9tpu.ops.resample.cycle_matrix_f32` hands to JAX."""
    return _g_f32_cached(bank)


@functools.lru_cache(maxsize=64)
def bank_to_torch(bank: CycleBank, device: torch.device) -> torch.Tensor:
    """The bank's parameters on ``device``: its float32 ``(W, L)`` cycle
    matrix, cached per (bank, device)."""
    return torch.from_numpy(cycle_matrix_f32(bank)).to(device)


def _cycle_budget(T: int, bank: CycleBank, out_len: int | None):
    """out_len, the cycle count Q, how much input to keep, and the front/back
    zero pads reaching exactly ``(Q-1)*M + W`` total (as in the JAX
    package)."""
    L, M, W = bank.L, bank.M, bank.W
    if out_len is None:
        out_len = bank.out_len(T)
    Q = -(-out_len // L)
    padded = (Q - 1) * M + W
    pad_front = bank.pad_front
    keep_T = min(T, max(0, padded - pad_front))
    pad_back = padded - pad_front - keep_T
    return out_len, Q, keep_T, pad_front, pad_back


def resample(x: torch.Tensor, bank: CycleBank,
             out_len: int | None = None) -> torch.Tensor:
    """Resample the last axis of float32 ``x (..., T)`` by the bank's ratio:
    ``(..., out_len)`` with ``out_len`` defaulting to ``ceil(T*L/M)``.
    Output sample n estimates the input at position ``n*M/L``."""
    _require_dense(bank)
    L, M, W = bank.L, bank.M, bank.W
    T = x.shape[-1]
    lead = x.shape[:-1]
    out_len, Q, keep_T, pad_front, pad_back = _cycle_budget(T, bank, out_len)
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, out_len))
    bc = int(np.prod(lead)) if lead else 1
    xp = F.pad(x[..., :keep_T].reshape(bc, keep_T), (pad_front, pad_back))
    windows = xp.unfold(-1, W, M)                    # (bc, Q, W) strided view
    g = bank_to_torch(bank, x.device)
    y = x.new_empty((bc, Q, L))
    step = max(1, _WINDOW_ELEMS // max(1, bc * W))
    for s in range(0, Q, step):
        y[:, s:s + step] = torch.matmul(windows[:, s:s + step], g)
    return y.reshape(bc, Q * L)[:, :out_len].reshape(*lead, out_len)


@functools.lru_cache(maxsize=64)
def _fold_rows(bank: CycleBank) -> tuple[tuple[int, int, int], ...]:
    """``(w, lo, hi)`` for every row of G with a non-zero entry: the row's
    non-zero columns lie in ``[lo, hi)``."""
    g = cycle_matrix_f32(bank)
    rows = []
    for w in range(bank.W):
        nz = np.flatnonzero(g[w])
        if nz.size:
            rows.append((w, int(nz[0]), int(nz[-1]) + 1))
    return tuple(rows)


@functools.lru_cache(maxsize=64)
def _bank_f64(bank: CycleBank, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(cycle_matrix_f32(bank)).to(device, torch.float64)


def _presliced_fold(xp: torch.Tensor, bank: CycleBank, num_cycles: int) -> torch.Tensor:
    """``y[..., q*L + l] = sum_w xp[..., q*M + w] * G[w, l]`` in float64,
    one tap row after another (w ascending), rounded to float32 once.

    Each output's sum runs in the same order whatever the chunk's length or
    offset (a matmul's order follows the library's choice of kernel for the
    shape), and float64 keeps it within half an output ulp of the exact sum,
    like the kernel's twin `resample_rows_reference`."""
    L, M = bank.L, bank.M
    Q = num_cycles
    lead, T = xp.shape[:-1], xp.shape[-1]
    x64 = xp.reshape(-1, T).to(torch.float64)
    g = _bank_f64(bank, xp.device)
    y = torch.zeros((x64.shape[0], Q, L), dtype=torch.float64, device=xp.device)
    for w, lo, hi in _fold_rows(bank):
        y[:, :, lo:hi] += x64[:, w:w + (Q - 1) * M + 1:M, None] * g[w, lo:hi]
    return y.to(torch.float32).reshape(*lead, Q * L)


def resample_presliced(xp: torch.Tensor, bank: CycleBank, num_cycles: int) -> torch.Tensor:
    """The cycle conv on an already padded or haloed chunk ``xp (..., T)``,
    ``T >= (num_cycles - 1)*M + W``, with no implicit padding: output cycle
    q reads ``xp[..., q*M : q*M + W]``; returns ``(..., num_cycles * L)``.
    The streaming path's SRC (`f9tpu.ops.resample.resample_presliced`).

    On a CUDA tensor the `cycle_src` kernel runs where it takes the bank
    (`src_kernel.resample_presliced_kernel`); the fixed-order float64 fold
    `_presliced_fold` serves CPU tensors (the kernel's plain twin) and the
    banks the kernel does not take (L < 8).  Both compute each output from
    its own window in an order that does not depend on where the chunk
    starts, so chunked output equals whole output bit for bit."""
    _require_dense(bank)
    need = (num_cycles - 1) * bank.M + bank.W
    if xp.shape[-1] < need:
        raise ValueError(f"padded input too short: {xp.shape[-1]} < {need}")
    if xp.device.type == "cuda":
        from .src_kernel import kernel_applicable, resample_presliced_kernel

        if kernel_applicable(bank):
            return resample_presliced_kernel(xp, bank, num_cycles)
    return _presliced_fold(xp, bank, num_cycles)


def resample_rates(x: torch.Tensor, rate_in: int, rate_out: int,
                   quality: str = "high", kind: str = "sinc",
                   out_len: int | None = None) -> torch.Tensor:
    """Design (host, cached) + resample on ``x``'s device, dispatched like
    the JAX package: the CUDA kernel where it applies, `resample` otherwise."""
    from .src_kernel import resample_auto  # local import: avoids a cycle

    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    return resample_auto(x, bank, out_len=out_len)
