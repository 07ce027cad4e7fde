"""The cycle SRC of a dense bank with L < 8 phases as a hand-written CUDA
kernel (`csrc/cycle_fold.cu`, ``f9_cycle_fold`` and ``f9_cycle_fold_flat``),
plain or fused with the absolute maximum of its output.

The JAX package computes the SRC of a dense bank with L < 8 as an XLA
convolution at HIGHEST precision (`f9tpu/ops/resample.py:307
resample_presliced`) and a metering chunk's true peak as the maximum of the
absolute value of the 4x oversampled chunk (`f9tpu/ops/loudness.py:363
_tp_step`).  Its Pallas kernel needs L >= 8 and M >= 16, and the port's
`cycle_src` L >= 8, so the integer-ratio banks (2:1, 3:1, 4:1 and back), the
meter's conversions to 48 kHz from 8-32, 96 and 192 kHz and the 4x
true-peak oversampler (L = 4, M = 1) come here.

The three launch forms and their plain twins, each bit for bit:

- `resample_presliced_fold_kernel` = `resample._presliced_fold`: ``y[...,
  q*L + l] = sum_w xp[..., q*M + w] * G[w, l]`` in float64 over the
  non-zero rows of G (`resample._fold_rows`, w ascending), each output's sum
  from +0.0, rounded to float32 once.  The streamed SRC: its caller is
  `resample.resample_presliced`.
- `resample_fold_kernel`, the flat form, = ``_presliced_fold(F.pad(x[...,
  :keep_T], (pad_front, pad_back)), bank, Q)`` with `resample._cycle_budget`'s
  numbers: the same fold read from the unpadded signal, the pads read as
  +0.0 inside the kernel, no padded copy made.  The batch SRC of the dense
  banks with L = 1 (the integer-ratio downsamplings, `fold_batch_applicable`):
  its caller is `resample.resample`, and through it `src_kernel.resample_auto`
  (the batch graph, `resample_rates`) and `resample_staged` (the rows layout).
  Dense banks with L = 2 and 4 keep the float32 matmul there, which is JAX's
  conv bit for bit on upsampling.
- `presliced_absmax_kernel` = `presliced_absmax_reference`, ``torch.max(
  torch.abs(_presliced_fold(...)))``: a 0-d float32, NaN if any output is
  NaN.  The fused form writes no y.  Its caller is `loudness._tp_step`.

A float32 sample times a float32 tap is exact in float64, so the kernel's
FMA rounds where the twin's sum rounds; it walks the twin's table in its
order (columns outside a row's ``[lo, hi)`` skipped, zeros inside it added).
The wrapper rule, as for `src_kernel` and `chain_kernels`: the kernel
wrappers launch on the current stream or raise (a CPU tensor, a bank
`fold_kernel_applicable` refuses, a failed build or launch); the callers
send a CPU tensor to the twin and a CUDA tensor to the kernel, never one
for the other.  ``launches`` counts wrapper calls that launched, of every
form; ``launches_flat`` those of the flat form alone.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from ..models.filters import CycleBank
from .resample import _cycle_budget, _fold_rows, _presliced_fold, cycle_matrix_f32

__all__ = ["FOLD_CYCLES", "fold_table", "fold_form", "fold_smem", "fold_threads",
           "fold_kernel_applicable", "fold_batch_applicable", "resample_fold_kernel",
           "resample_presliced_fold_kernel", "presliced_absmax_kernel",
           "presliced_absmax_reference", "launches", "launches_flat"]

#: kernel launches since the count was last reset, of every form
launches = 0
#: those of the flat form (`resample_fold_kernel`), each also in ``launches``
launches_flat = 0
_launch_lock = threading.Lock()

#: cycles a thread takes (`csrc/cycle_fold.cu` FOLD_C, checked at the first
#: launch)
FOLD_CYCLES = 8
#: a block's threads, the most whose shared memory fits (`fold_threads`)
FOLD_THREADS = (128, 64, 32)
#: shared memory a block may use (H100: 227 KB)
SMEM_BLOCK_MAX = 227 * 1024
#: the kernel's largest L (a template instance each)
FOLD_MAX_L = 7


@functools.lru_cache(maxsize=256)
def fold_table(bank: CycleBank) -> tuple[np.ndarray, np.ndarray]:
    """The kernel's operands for ``bank``: the table ``(n_rows,)`` int32 of
    ``w << 6 | lo << 3 | hi`` for each row of `resample._fold_rows` (w
    ascending), and those rows of G, ``(n_rows, L)`` float64 (the float32
    taps widened)."""
    rows = _fold_rows(bank)
    if bank.W >= 1 << 25:
        raise ValueError(f"the fold kernel's table holds w < 2^25, got W = {bank.W}")
    tab = np.array([(w << 6) | (lo << 3) | hi for w, lo, hi in rows], np.int32)
    g = cycle_matrix_f32(bank)
    gr = np.ascontiguousarray(g[[w for w, _, _ in rows]], np.float64).reshape(len(rows), bank.L)
    return tab, gr


#: the slid form's strides, and the float64 registers its ring and
#: accumulators may take (`csrc/cycle_fold.cu` slide_ok)
FOLD_SLIDE_M = (1, 2, 4)
FOLD_SLIDE_DOUBLES = 64


@functools.lru_cache(maxsize=256)
def fold_form(bank: CycleBank) -> int:
    """The kernel's form for ``bank``: M (the slid form: a thread's
    FOLD_CYCLES consecutive cycles, each residue of w mod M a ring of samples
    in registers, one sample loaded and converted a row) where M is 1, 2 or 4,
    every row of G is non-zero and ``FOLD_CYCLES * (M + L)`` float64 values
    fit `FOLD_SLIDE_DOUBLES`; else 0 (the generic form: a thread's cycles
    ``threads`` apart, FOLD_CYCLES samples loaded a row)."""
    ok = (bank.M in FOLD_SLIDE_M and len(_fold_rows(bank)) == bank.W
          and FOLD_CYCLES * (bank.M + bank.L) <= FOLD_SLIDE_DOUBLES)
    return bank.M if ok else 0


def fold_smem(bank: CycleBank, threads: int) -> int:
    """Shared memory of a block of ``threads`` (`csrc/cycle_fold.cu`
    fold_smem): the bank's non-zero rows in float64, the table, and the span
    of ``FOLD_CYCLES * threads`` cycles split by phase (S phases of ``P =
    ceil(span / S)`` float32 words: S = M in the generic form, FOLD_CYCLES *
    M in the slid one), or the block's float32 outputs, one word of padding
    every 32, if those take more."""
    n_rows = len(_fold_rows(bank))
    span = (FOLD_CYCLES * threads - 1) * bank.M + bank.W
    S = FOLD_CYCLES * bank.M if fold_form(bank) else bank.M
    P = -(-span // S)
    outs = FOLD_CYCLES * threads * bank.L
    return max(8 * n_rows * bank.L + 4 * n_rows + 4 * S * P, 4 * (outs + outs // 32))


@functools.lru_cache(maxsize=256)
def fold_threads(bank: CycleBank) -> int | None:
    """A block's threads for ``bank``: the most of `FOLD_THREADS` whose
    shared memory fits `SMEM_BLOCK_MAX`, or None (the bank is not the
    kernel's: varispeed, L >= 8, no non-zero row, or too wide even at 32)."""
    if bank.G is None or not 1 <= bank.L <= FOLD_MAX_L or not _fold_rows(bank):
        return None
    if bank.W >= 1 << 25:
        return None
    return next((t for t in FOLD_THREADS if fold_smem(bank, t) <= SMEM_BLOCK_MAX), None)


def fold_kernel_applicable(bank: CycleBank) -> bool:
    """Does the fold kernel take ``bank``?  A dense bank (``bank.G is not
    None``) with L < 8 whose rows and span fit a block's shared memory
    (`fold_threads`): every such bank of the standard rates and presets, the
    widest (384 kHz -> 8 kHz ultra, W = 9,600) at 32 threads."""
    return fold_threads(bank) is not None


def fold_batch_applicable(bank: CycleBank) -> bool:
    """Does the batch SRC (`resample.resample` on the card) of ``bank`` run
    the fold kernel's flat form?  A dense bank with L = 1 that the kernel
    takes: every integer-ratio downsampling (96k -> 48k, 192k -> 48k, 48k ->
    16k, 384k -> 8k).  Dense banks with L = 2 and 4 keep the float32 matmul,
    bit for bit JAX's conv there, which the fold would leave by 5-8 LSB;
    L >= 8 runs `cycle_src`."""
    return bank.L == 1 and fold_kernel_applicable(bank)


@functools.lru_cache(maxsize=64)
def _device_operands(bank: CycleBank, device: torch.device):
    tab, gr = fold_table(bank)
    return torch.from_numpy(gr).to(device), torch.from_numpy(tab).to(device)


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _threads(x: torch.Tensor, bank: CycleBank) -> int:
    """The block's threads for ``bank``; raises for what the kernel does
    not take (a CPU tensor, the bank, float64 samples) before the library
    is asked for."""
    if x.device.type == "cpu":
        raise ValueError("the fold kernel takes a CUDA tensor; a CPU tensor runs the twin")
    threads = fold_threads(bank)
    if threads is None:
        raise ValueError(f"the fold kernel does not take bank L={bank.L} M={bank.M} "
                         f"W={bank.W} ({'varispeed' if bank.G is None else 'dense'})")
    if x.dtype != torch.float32:
        raise ValueError(f"the fold kernel takes float32, got {x.dtype}")
    return threads


def _rows(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` as ``(rows, T)`` with unit stride along T, and its row stride."""
    T = x.shape[-1]
    x2 = x.reshape(-1, T)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    return x2, (x2.stride(0) if x2.shape[0] > 1 else T)


def _library(device: torch.device):
    from ._build import load_library

    lib = load_library()
    if lib.f9_cycle_fold_cycles() != FOLD_CYCLES:
        raise RuntimeError(f"csrc/cycle_fold.cu takes {lib.f9_cycle_fold_cycles()} cycles a "
                           f"thread, ops/cycle_fold.py {FOLD_CYCLES}")
    return lib, ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _count(flat: bool) -> None:
    global launches, launches_flat
    with _launch_lock:
        launches += 1
        launches_flat += flat


def _launch(xp: torch.Tensor, bank: CycleBank, num_cycles: int, peak: bool,
            form: int | None = None):
    """The presliced and fused wrappers' launch; ``form`` overrides
    `fold_form` (0, the generic form, takes every bank: `chip_smoke.py` 15a
    holds both forms to the twin)."""
    threads = _threads(xp, bank)
    Q = int(num_cycles)
    T = xp.shape[-1]
    need = (Q - 1) * bank.M + bank.W
    if Q < 0 or T < need:
        raise ValueError(f"padded input too short: {T} < {need}")
    lead = tuple(xp.shape[:-1])
    x2, ld = _rows(xp)
    n_sig = x2.shape[0]
    if peak and (Q == 0 or n_sig == 0):
        raise ValueError("the true peak of an empty chunk is undefined")
    y = None if peak else torch.empty((n_sig, Q * bank.L), dtype=torch.float32,
                                      device=xp.device)
    out = torch.empty((), dtype=torch.int32, device=xp.device) if peak else None
    if Q == 0 or n_sig == 0:
        return y.reshape(*lead, 0)
    g, tab = _device_operands(bank, xp.device)
    lib, stream = _library(xp.device)
    with torch.cuda.device(xp.device):
        err = lib.f9_cycle_fold(_ptr(x2), _ptr(g), _ptr(tab), _ptr(y), _ptr(out), n_sig, ld, T,
                                Q, bank.L, bank.M, bank.W, int(tab.shape[0]), threads,
                                fold_form(bank) if form is None else form, stream)
    if err != 0:
        raise RuntimeError(f"cycle_fold kernel launch failed: CUDA error {err}")
    _count(False)
    return out.view(torch.float32) if peak else y.reshape(*lead, Q * bank.L)


def resample_fold_kernel(x: torch.Tensor, bank: CycleBank,
                         out_len: int | None = None) -> torch.Tensor:
    """The flat form: `resample.resample` of ``x (..., T)`` float32 on the
    card by a bank the kernel takes, ``(..., out_len)`` with ``out_len``
    defaulting to ``ceil(T*L/M)``, in one launch on the unpadded signal.
    Each output is bit for bit ``_presliced_fold(F.pad(x[..., :keep_T],
    (pad_front, pad_back)), bank, Q)`` with `resample._cycle_budget`'s
    numbers; rows may stand a stride apart wider than T.  Launches or
    raises."""
    threads = _threads(x, bank)
    T = x.shape[-1]
    lead = tuple(x.shape[:-1])
    out_len, Q, keep_T, pad_front, _pad_back = _cycle_budget(T, bank, out_len)
    n_sig = int(np.prod(lead))
    if T == 0 or out_len == 0 or n_sig == 0:
        return x.new_zeros((*lead, out_len))
    x2, ld = _rows(x)
    y = torch.empty((n_sig, Q * bank.L), dtype=torch.float32, device=x.device)
    g, tab = _device_operands(bank, x.device)
    lib, stream = _library(x.device)
    with torch.cuda.device(x.device):
        err = lib.f9_cycle_fold_flat(_ptr(x2), _ptr(g), _ptr(tab), _ptr(y), n_sig, ld, keep_T,
                                     pad_front, Q, bank.L, bank.M, bank.W, int(tab.shape[0]),
                                     threads, fold_form(bank), stream)
    if err != 0:
        raise RuntimeError(f"cycle_fold kernel launch failed: CUDA error {err}")
    _count(True)
    if Q * bank.L != out_len:
        y = y[:, :out_len]
    return y.reshape(*lead, out_len)


def resample_presliced_fold_kernel(xp: torch.Tensor, bank: CycleBank,
                                   num_cycles: int) -> torch.Tensor:
    """The fold kernel on a haloed chunk ``xp (..., T)`` float32 on the card,
    ``T >= (num_cycles - 1)*M + W``: ``(..., num_cycles * L)`` float32, bit
    for bit `resample._presliced_fold`.  Launches or raises."""
    return _launch(xp, bank, num_cycles, peak=False)


def presliced_absmax_kernel(xp: torch.Tensor, bank: CycleBank,
                            num_cycles: int) -> torch.Tensor:
    """The fold kernel fused with ``max |y|``: a 0-d float32 tensor on the
    card, bit for bit `presliced_absmax_reference` (NaN if any output is
    NaN).  One memset and one launch; no y is written.  Launches or
    raises."""
    return _launch(xp, bank, num_cycles, peak=True)


def presliced_absmax_reference(xp: torch.Tensor, bank: CycleBank,
                               num_cycles: int) -> torch.Tensor:
    """The plain twin of `presliced_absmax_kernel`: ``torch.max(torch.abs(
    _presliced_fold(xp, bank, num_cycles)))``."""
    need = (num_cycles - 1) * bank.M + bank.W
    if xp.shape[-1] < need:
        raise ValueError(f"padded input too short: {xp.shape[-1]} < {need}")
    return torch.max(torch.abs(_presliced_fold(xp, bank, num_cycles)))
