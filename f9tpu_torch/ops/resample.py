"""Rational sample-rate conversion by the cycle matrix (port of
`f9tpu/ops/resample.py`).

The whole polyphase resampler is folded at design time into one ``(W, L)``
cycle matrix ``G`` (`f9tpu_torch.models.filters.design_cycle_bank`), so

    y[b, q*L : (q+1)*L] = x_padded[b, q*M : q*M + W] @ G

`resample` here is the batch form for the dense banks the `cycle_src`
kernel does not take (`f9tpu_torch.ops.src_kernel.kernel_applicable`:
L < 8).  On the card a bank with L = 1 (the integer-ratio downsamplings,
`cycle_fold.fold_batch_applicable`) runs the `cycle_fold` kernel's flat
form, one launch on the unpadded signal, bit for bit the float64 fold
`_presliced_fold` of the padded signal; a bank with L = 2 or 4, and every
such bank on the CPU, runs a strided ``unfold`` of the padded signal into
cycle windows and float32 ``torch.matmul``.  `resample_presliced` is the
streamed form, on a chunk that carries its own halos: on the card the
`cycle_src` kernel (L >= 8) or the `cycle_fold` kernel (`ops/cycle_fold.py`,
a dense bank with L < 8), on the CPU their plain twins, among them
`_presliced_fold`.

Varispeed banks (``bank.G is None``: 44.1k -> 44056 reduces to L/M =
11014/11025, whose dense matrix would be 0.5 GB) run from the ``(L, K)``
phase bank.  The JAX package evaluates them as one matmul per 128-output
segment (`_banded_eval_rows`); a library matmul picks its summation order by
shape, which a streamed path must not depend on, so the port's forms are:
on a CUDA tensor the `cycle_src` kernel's windowed launch form (flat or
presliced), and on a CPU tensor the plain twin
`_gather_core`: K passes, k ascending, ``y += x[base(n) + k] * Hrev[ph(n),
k]`` in float64, rounded to float32 once.  Each output sums its own taps in
one fixed order, so chunked == whole bit for bit on either
device.  A varispeed bank whose window does not fit the kernel's shared
memory takes the twin on both devices.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..models.filters import CycleBank, _cycle_tables, design_cycle_bank

__all__ = ["resample", "resample_banded", "resample_gather", "resample_rates",
           "resample_presliced", "cycle_matrix_f32", "bank_to_torch",
           "rows_pre_applicable", "rows_marshal_plan", "banded_rows_applicable",
           "banded_rows_plan"]

#: Cap on the (rows x W) window matrix `resample` materialises per matmul.
_WINDOW_ELEMS = 1 << 26


def _require_dense(bank: CycleBank) -> None:
    if bank.G is None:
        raise RuntimeError(
            f"dense cycle matrix disabled for ratio {bank.L}/{bank.M} "
            f"(would be {bank.W}x{bank.L}); this bank runs via the banded "
            "forms (resample_banded / resample_presliced, dispatched "
            "by resample / resample_auto)")


@functools.lru_cache(maxsize=64)
def _g_f32_cached(bank: CycleBank) -> np.ndarray:
    _require_dense(bank)      # the one place a dense matrix is truly needed
    return np.ascontiguousarray(bank.G, dtype=np.float32)


def cycle_matrix_f32(bank: CycleBank) -> np.ndarray:
    """The bank's cycle matrix as float32 (cached) — the same array
    `f9tpu.ops.resample.cycle_matrix_f32` hands to JAX."""
    return _g_f32_cached(bank)


@functools.lru_cache(maxsize=64)
def _h_rev_f32_cached(bank: CycleBank) -> np.ndarray:
    """Phase bank with the tap axis reversed, float32 ``(L, K)``: tap k of
    the gather form multiplies ``x_padded[base + k]``."""
    return np.ascontiguousarray(bank.H[:, ::-1], dtype=np.float32)


@functools.lru_cache(maxsize=64)
def _phase_tables(bank: CycleBank) -> tuple[np.ndarray, np.ndarray]:
    """``(off, ph)`` int64 ``(L,)``: output phase p of a cycle starts at
    padded input ``off[p]`` and uses row ``ph[p]`` of the phase bank."""
    return _cycle_tables(bank.L, bank.M, bank.delay_upsamples % bank.L)


@functools.lru_cache(maxsize=64)
def bank_to_torch(bank: CycleBank, device: torch.device):
    """The bank's parameters on ``device``, cached per (bank, device): the
    float32 ``(W, L)`` cycle matrix of a dense bank, or, for a varispeed
    bank, ``(Hrev (L, K) float32, off (L,) int64, ph (L,) int64)``."""
    if bank.G is None:
        off, ph = _phase_tables(bank)
        return (torch.from_numpy(_h_rev_f32_cached(bank)).to(device),
                torch.from_numpy(off).to(device), torch.from_numpy(ph).to(device))
    return torch.from_numpy(cycle_matrix_f32(bank)).to(device)


@functools.lru_cache(maxsize=16)
def _phase_bank_f64(bank: CycleBank, device: torch.device):
    """The gather twin's operands: ``Hrev`` transposed to ``(K, L)`` float64
    (the float32 taps, widened), ``off`` and ``ph``."""
    off, ph = _phase_tables(bank)
    hrev_t = np.ascontiguousarray(_h_rev_f32_cached(bank).T.astype(np.float64))
    return (torch.from_numpy(hrev_t).to(device), torch.from_numpy(off).to(device),
            torch.from_numpy(ph).to(device))


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
    Output sample n estimates the input at position ``n*M/L``.  A varispeed
    bank goes to `resample_banded`.  A dense bank with L = 1 on the card
    goes to the `cycle_fold` kernel's flat form (`_fold_takes`); any other
    dense bank, and every one on the CPU, is the padded signal's cycle
    windows times G in float32 matmuls."""
    if bank.G is None:
        return resample_banded(x, bank, out_len=out_len)
    if _fold_takes(x, bank):
        from .cycle_fold import resample_fold_kernel

        return resample_fold_kernel(x, bank, out_len=out_len)
    return _unfold_matmul(x, bank, out_len)


def _unfold_matmul(x: torch.Tensor, bank: CycleBank, out_len: int | None) -> torch.Tensor:
    """`resample`'s library form for a dense bank, on ``x``'s device: the
    padded signal's ``(rows, Q, W)`` cycle windows, a strided ``unfold``,
    times G by float32 ``torch.matmul`` in chunks of `_WINDOW_ELEMS`."""
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
    (`src_kernel.resample_presliced_kernel`, dense or varispeed, L >= 8)
    and the `cycle_fold` kernel where that takes it
    (`cycle_fold.resample_presliced_fold_kernel`: a dense bank with L < 8),
    bit for bit the fold below.  CPU tensors, and the banks neither kernel
    takes, get the fixed-order float64 forms: `_presliced_fold` for a dense
    bank (L < 8), `_gather_core` for a varispeed bank.  All compute each
    output from its own window in an order that does not depend on where
    the chunk starts, so chunked output equals whole output bit for bit."""
    need = (num_cycles - 1) * bank.M + bank.W
    if xp.shape[-1] < need:
        raise ValueError(f"padded input too short: {xp.shape[-1]} < {need}")
    if xp.device.type == "cuda":
        from .cycle_fold import fold_kernel_applicable, resample_presliced_fold_kernel
        from .src_kernel import kernel_applicable, resample_presliced_kernel

        if kernel_applicable(bank):
            return resample_presliced_kernel(xp, bank, num_cycles)
        if fold_kernel_applicable(bank):
            return resample_presliced_fold_kernel(xp, bank, num_cycles)
    if bank.G is None:
        return _gather_core(xp, bank, num_cycles * bank.L)
    return _presliced_fold(xp, bank, num_cycles)


# --------------------------------------------------------------------------
# Varispeed banks: no dense matrix, executed from the (L, K) phase bank.
# --------------------------------------------------------------------------


def _pad_for_cycles(x: torch.Tensor, bank: CycleBank, out_len: int | None):
    """`_cycle_budget` + the explicit zero pad: ``(out_len, padded)``, with
    ``padded`` None for an empty input or output."""
    T = x.shape[-1]
    out_len, _Q, keep_T, pad_front, pad_back = _cycle_budget(T, bank, out_len)
    if T == 0 or out_len == 0:
        return out_len, None
    return out_len, F.pad(x[..., :keep_T], (pad_front, pad_back))


def _check_index_range(bank: CycleBank) -> None:
    # the JAX package's int32 gather limit, kept so both accept the same banks
    if bank.L * bank.M + bank.L >= 2**31:
        raise ValueError(
            f"ratio {bank.L}/{bank.M} too fine for int32 gather index math")


def _gather_core(xp: torch.Tensor, bank: CycleBank, n_out: int) -> torch.Tensor:
    """Phase-table resampling of an already padded signal, the plain twin of
    the kernel's windowed form (`f9tpu.ops.resample._gather_core`):

        y[n] = sum_k Hrev[ph(n), k] * xp[base(n) + k]

    with ``base(n) = (n // L)*M + off[n % L]`` and ``ph(n) = ph[n % L]``: the
    dense contract with ``G`` never built.  K passes, k ascending, each one
    gather and one multiply-add over the whole output, summed in float64 and
    rounded to float32 once: within half an output ulp of the exact sum, in
    an order that depends on nothing but the output's own taps."""
    L, M, K = bank.L, bank.M, bank.taps_per_phase
    _check_index_range(bank)
    lead, T_pad = xp.shape[:-1], xp.shape[-1]
    x64 = xp.reshape(-1, T_pad).to(torch.float64)
    hrev_t, off, ph = _phase_bank_f64(bank, xp.device)
    n = torch.arange(n_out, dtype=torch.int64, device=xp.device)
    b = n % L
    base = (n // L) * M + off[b]
    phb = ph[b]
    y = torch.zeros((x64.shape[0], n_out), dtype=torch.float64, device=xp.device)
    for k in range(K):
        x_k = x64.index_select(1, torch.clamp(base + k, max=T_pad - 1))
        y.addcmul_(x_k, hrev_t[k].index_select(0, phb))
    return y.to(xp.dtype).reshape(*lead, n_out)


def resample_gather(x: torch.Tensor, bank: CycleBank,
                    out_len: int | None = None) -> torch.Tensor:
    """Drop-in equivalent of `resample` through the phase-table gather form,
    for any bank, on ``x``'s device: the plain twin the kernel's windowed
    form is held to, and the form of the varispeed banks the kernel does not
    take."""
    out_len, xp = _pad_for_cycles(x, bank, out_len)
    if xp is None:
        return x.new_zeros((*x.shape[:-1], out_len))
    return _gather_core(xp, bank, out_len)


#: Outputs per banded segment and the alignment of a segment's first input
#: (the JAX package's MXU lane tile; kept so `_banded_plan` equals the JAX
#: package's).
_BAND_SEG = 128
_LANE = 128


@functools.lru_cache(maxsize=16)
def _banded_geometry(bank: CycleBank) -> tuple[tuple[int, ...], int, int, int]:
    """``(in0, w, seg, w_rows)``: the JAX package's banded decomposition of
    a cycle into S overlapping 128-output segments over lane-aligned input
    windows of ``w`` floats; ``w_rows`` is the width of the JAX package's
    marshalled cycle row, kept so the plan's tuple equals that package's."""
    L, K = bank.L, bank.taps_per_phase
    seg = min(_BAND_SEG, L)
    off, _ph = _phase_tables(bank)
    S = max(1, -(-L // seg))
    p0s = [s * seg for s in range(S - 1)] + [L - seg]
    in0 = [int(off[p0]) - int(off[p0]) % _LANE for p0 in p0s]
    w = int(max(int(off[p0 + seg - 1]) + K - in0[s] for s, p0 in enumerate(p0s)))
    w = -(-w // 8) * 8
    return tuple(in0), w, seg, int(max(in0)) + w


def _banded_plan(bank: CycleBank):
    """``(in0, w, seg, w_rows, G)``: `_banded_geometry` with each segment's
    small dense ``(w, 128)`` matrix (numpy, built on every call).  No path
    of the port contracts against ``G``: it is the JAX package's form, which
    the tests hold bitwise to that package's and the card's smoke test times
    as the library form."""
    in0, w, seg, w_rows = _banded_geometry(bank)
    L, K = bank.L, bank.taps_per_phase
    off, ph = _phase_tables(bank)
    hrev = _h_rev_f32_cached(bank)
    p0s = [s * seg for s in range(len(in0) - 1)] + [L - seg]
    G = np.zeros((len(in0), w, seg), np.float32)
    for s, p0 in enumerate(p0s):
        for c in range(seg):
            pp = p0 + c
            row = int(off[pp] - in0[s])
            G[s, row: row + K, c] = hrev[ph[pp]]
    return in0, w, seg, w_rows, G


def _overlap_rows(bank: CycleBank) -> int:
    """R: how many cycle rows past its own an output cycle reads."""
    return max(1, -(-(bank.taps_per_phase - 1) // bank.M))


def rows_pre_applicable(bank: CycleBank) -> bool:
    """Does a dense bank take the host-marshalled ``(n_rows, M)`` staging of
    the rows layout (`f9tpu.ops.pallas_src.rows_pre_applicable`)?  Tiny L or
    M and varispeed banks stage the flat bucket instead."""
    return bank.dense_ok and _overlap_rows(bank) <= 8 and bank.L >= 8 and bank.M >= 8


def rows_marshal_plan(bank: CycleBank, frames: int) -> tuple[int, int]:
    """(n_rows, pad_front) for rows marshalling of a ``frames``-long signal:
    the samples sit at flat offset ``pad_front`` of a zero ``(n_rows, M)``
    buffer, ``n_rows = ceil(out_len / L) + R``."""
    n_out = -(-bank.out_len(frames) // bank.L)
    return n_out + _overlap_rows(bank), bank.pad_front


def banded_rows_applicable(bank: CycleBank) -> bool:
    """Does a varispeed bank take the host-marshalled cycle rows of the rows
    layout (`f9tpu.ops.resample.banded_rows_applicable`)?"""
    return bank.G is None and bank.L >= 8 and bank.L * bank.M < 2**31


def banded_rows_plan(bank: CycleBank, frames: int) -> tuple[int, int, int]:
    """``(n_rows, row_width, pad_front)`` of the JAX package's overlapping
    cycle rows for a ``frames``-long signal: row ``q`` holds ``padded[q*M :
    q*M + row_width]`` of the zero-padded signal.  The flat staging they
    are cut from is ``(n_rows - 1)*M + row_width`` long."""
    w_rows = _banded_geometry(bank)[3]
    return -(-bank.out_len(frames) // bank.L), w_rows, bank.pad_front


def _fold_takes(t: torch.Tensor, bank: CycleBank) -> bool:
    """Does `resample` send ``t`` to the `cycle_fold` kernel's flat form?  A
    bank `cycle_fold.fold_batch_applicable` takes (dense, L = 1) on any
    device but the CPU, as `_kernel_takes` rules for `cycle_src`."""
    if t.device.type == "cpu":
        return False
    from .cycle_fold import fold_batch_applicable

    return fold_batch_applicable(bank)


def _kernel_takes(t: torch.Tensor, bank: CycleBank) -> bool:
    """Does ``t`` go to the kernel's wrapper?  Only a CPU tensor takes the
    plain twin of a bank the kernel takes; the wrapper raises on any other
    device than CUDA."""
    if t.device.type == "cpu":
        return False
    from .src_kernel import kernel_applicable

    return kernel_applicable(bank)


def resample_banded(x: torch.Tensor, bank: CycleBank,
                    out_len: int | None = None) -> torch.Tensor:
    """The production form for varispeed banks (``bank.G is None``), the
    same design and contract as `resample`: the kernel's windowed form on a
    CUDA tensor, `resample_gather` on a CPU tensor (and for a bank the
    kernel does not take)."""
    if _kernel_takes(x, bank):
        from .src_kernel import resample_kernel

        return resample_kernel(x, bank, out_len=out_len)
    return resample_gather(x, bank, out_len=out_len)


def resample_rates(x: torch.Tensor, rate_in: int, rate_out: int,
                   quality: str = "high", kind: str = "sinc",
                   out_len: int | None = None) -> torch.Tensor:
    """Design (host, cached) + resample on ``x``'s device, dispatched like
    the JAX package: the CUDA kernel where it applies, `resample` otherwise."""
    from .src_kernel import resample_auto  # local import: avoids a cycle

    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    return resample_auto(x, bank, out_len=out_len)
