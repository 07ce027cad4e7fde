"""The plain layer of the SRC, in PyTorch on the tensor's device: each
bank's operands, the cycle budget, the rows layout's plans, and the forms
`src_kernel.src_route` sends a bank to where no kernel runs.  It imports no
kernel module.

The polyphase resampler is folded at design time into one ``(W, L)`` cycle
matrix ``G`` (`f9tpu_torch.models.filters.design_cycle_bank`), so ``y[b,
q*L : (q+1)*L] = x_padded[b, q*M : q*M + W] @ G``.  `_unfold_matmul` is
that product in float32, bit for bit the JAX package's convolution.  The
fixed-order twins (`_presliced_fold`, `resample_rows_reference`,
`_gather_core`) sum each output from its own window in float64 and round
to float32 once, in an order that does not depend on where a chunk starts.
A varispeed bank (``bank.G is None``: 44.1k -> 44056 is L/M = 11014/11025,
whose dense G would take 0.5 GB) runs from its ``(L, K)`` phase bank.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..models.filters import CycleBank, _cycle_tables

#: Cap on the (rows x W) window matrix `_unfold_matmul` materialises per matmul.
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


def _unfold_matmul(x: torch.Tensor, bank: CycleBank, out_len: int | None) -> torch.Tensor:
    """A dense bank's library form: the padded signal's ``(rows, Q, W)``
    cycle windows, a strided ``unfold``, times G by float32 ``torch.matmul``
    in chunks of `_WINDOW_ELEMS`."""
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


def _plain_batch(x: torch.Tensor, bank: CycleBank, out_len: int | None = None) -> torch.Tensor:
    """The bank's plain batch form: `_unfold_matmul` of a dense bank,
    `resample_gather` of a varispeed one."""
    if bank.G is None:
        return resample_gather(x, bank, out_len)
    return _unfold_matmul(x, bank, out_len)


def _plain_presliced(xp: torch.Tensor, bank: CycleBank, num_cycles: int) -> torch.Tensor:
    """The bank's plain form on a haloed chunk: `_presliced_fold` of a dense
    bank, `_gather_core` of a varispeed one."""
    if bank.G is None:
        return _gather_core(xp, bank, num_cycles * bank.L)
    return _presliced_fold(xp, bank, num_cycles)


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


@functools.lru_cache(maxsize=64)
def _stacked_bank_f64(bank: CycleBank, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(stacked_bank_f32(bank)).to(device, torch.float64)



def _rows_marshal(x: torch.Tensor, bank: CycleBank, Q: int) -> torch.Tensor:
    """The twin's marshal step: ``x (bc, T)`` at flat offset ``pad_front`` of
    a float64 zero ``(bc, Q + R, M)`` cycle-row tiling (the samples past its
    end are dropped, as the kernel never reads them)."""
    bc, T = x.shape
    n_rows = Q + _overlap_rows(bank)
    pf = bank.pad_front
    keep = max(0, min(T, n_rows * bank.M - pf))
    xp = torch.zeros((bc, n_rows * bank.M), dtype=torch.float64, device=x.device)
    xp[:, pf:pf + keep] = x[:, :keep]
    return xp.view(bc, n_rows, bank.M)


def _rows_core(xp3: torch.Tensor, bank: CycleBank) -> torch.Tensor:
    """The twin's rows-input core (`f9tpu.ops.pallas_src.resample_rows_pre`'s
    math): float64 cycle rows ``(bc, n_rows, M)`` -> float64 ``(bc, n_rows -
    R, L)``, one matmul by the stacked bank plus R row-shifted adds (the
    callers round to float32 once)."""
    L = bank.L
    R = _overlap_rows(bank)
    Q = xp3.shape[1] - R
    gs = _stacked_bank_f64(bank, xp3.device)            # ((R+1)*L, M)
    P = torch.matmul(xp3, gs.T)                          # (bc, Q+R, (R+1)*L)
    y = P[:, :Q, :L].clone()
    for r in range(1, R + 1):
        y += P[:, r:r + Q, r * L:(r + 1) * L]
    return y


def resample_rows_reference(x: torch.Tensor, bank: CycleBank,
                            out_len: int | None = None
                            ) -> tuple[torch.Tensor, int]:
    """Plain PyTorch twin of the kernel: ``(y (..., Q, L), out_len)`` with
    output sample ``t`` at ``y[..., t // L, t % L]``.  Marshals the signal
    into zero-padded ``(Q + R, M)`` cycle rows (`_rows_marshal`), multiplies
    by the stacked bank once and adds R row-shifted blocks (`_rows_core`).

    The float32 signal and bank are multiplied and summed in float64 and the
    result rounded to float32 once, so the twin is the exact sum to within
    half an output ulp: the reference the kernel (and the card's output
    against the CPU path's) is held to.  A float32 matmul would itself carry
    ~0.35 LSB RMS of summation error at 24 bits.

    A varispeed bank has no stacked bank: its twin is the float64 gather
    form (`_gather_core`) over whole cycles."""
    lead = x.shape[:-1]
    if out_len is None:
        out_len = bank.out_len(x.shape[-1])
    Q = -(-out_len // bank.L)
    if bank.G is None:
        _, xp = _pad_for_cycles(x, bank, out_len)
        if xp is None:
            return x.new_zeros((*lead, Q, bank.L)), out_len
        return _gather_core(xp, bank, Q * bank.L).reshape(*lead, Q, bank.L), out_len
    T = x.shape[-1]
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, Q, bank.L)), out_len
    y = _rows_core(_rows_marshal(x.reshape(-1, T), bank, Q), bank)
    return y.to(x.dtype).reshape(*lead, Q, bank.L), out_len



def resample_kernel_reference(x: torch.Tensor, bank: CycleBank,
                              out_len: int | None = None) -> torch.Tensor:
    """The plain twin of `src_kernel.resample_kernel`: `resample_rows_reference`
    flat, cut to ``out_len``."""
    y, out_len = resample_rows_reference(x, bank, out_len=out_len)
    return y.flatten(-2)[..., :out_len]


def resample_fold_reference(x: torch.Tensor, bank: CycleBank,
                            out_len: int | None = None) -> torch.Tensor:
    """The plain twin of `cycle_fold.resample_fold_kernel`, on ``x``'s device:
    ``_presliced_fold(F.pad(x[..., :keep_T], (pad_front, pad_back)), bank,
    Q)`` with `_cycle_budget`'s numbers, cut to ``out_len``."""
    T = x.shape[-1]
    lead = tuple(x.shape[:-1])
    out_len, Q, keep_T, pad_front, pad_back = _cycle_budget(T, bank, out_len)
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, out_len))
    xp = F.pad(x[..., :keep_T], (pad_front, pad_back))
    return _presliced_fold(xp, bank, Q)[..., :out_len]


def presliced_absmax_reference(xp: torch.Tensor, bank: CycleBank,
                               num_cycles: int) -> torch.Tensor:
    """The plain twin of `cycle_fold.presliced_absmax_kernel`: ``torch.max(
    torch.abs(_presliced_fold(xp, bank, num_cycles)))``."""
    need = (num_cycles - 1) * bank.M + bank.W
    if xp.shape[-1] < need:
        raise ValueError(f"padded input too short: {xp.shape[-1]} < {need}")
    return torch.max(torch.abs(_presliced_fold(xp, bank, num_cycles)))
