"""The cycle-matrix SRC kernel and its dispatch (port of
`f9tpu/ops/pallas_src.py`).

The JAX package runs its SRC through two Pallas TPU kernels, `_kernel_roll`
(overlap R = 1) and `_kernel` (R > 1).  The port replaces both with one
hand-written CUDA kernel, `f9tpu_torch/csrc/cycle_src.cu`, which computes

    y[b, q*L + l] = sum_{w < W} xpad[b, q*M + w] * G[w, l]

straight from the flat signal (no host or device retiling into (rows, M)),
on the tensor cores in split TF32 with Kahan-joined k8 partials.

`kernel_plan` is the kernel's launch geometry for a bank (column-tile width,
warps, the span's skew and row order, each tile's band of G rows), and
`packed_bank_f32` the bank split into TF32 high and low parts in the order
the kernel's fragments read them.  Both are plain numpy, so the CPU tests
can replay the kernel's arithmetic on them.

Varispeed banks (``bank.G is None``, no dense matrix) take the kernel's
windowed form (`cycle_src_win`): a block owns a group of neighbouring
column tiles and a group of (signal, cycle) rows, a producer warp stages
each row's union window of the group's bands once by a TMA bulk copy, and
each tile reads its band's part of it; the packed bank is built from the
phase bank ``H`` and the cycle tables, never from a dense ``G``.
`_window_plan` picks the group and warps (two blocks per SM first),
`_win_launch` fits them to a launch's rows (fewer warps for few rows, a
smaller group while its grid still fits on the card at once), `window_traffic`
counts from the plan what a launch stages.  The JAX package has no kernel of its own for them (XLA
evaluates `_banded_eval_rows`, one matmul per 128-output segment).

The rule that picks the SRC implementation for a bank on a device is
`src_route`; `resample_auto` (the batch SRC) and `resample_staged` (the
rows layout's) run the implementation `_BATCH` gives for its answer.  The
wrapper rule: `resample_rows` / `resample_kernel` launch the kernel on a
CUDA tensor or raise; their plain twin `resample_rows_reference` lives in
`ops/src_plain.py`.  ``launches`` counts kernel launches; the count is a
plain integer raised under a lock, so launches made from several host
threads all count.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..models.filters import CycleBank
from .cycle_fold import fold_threads, resample_fold_kernel
from .src_plain import (  # noqa: F401  (the twin and the rows plan, named beside the kernel)
    _h_rev_f32_cached, _phase_tables, _plain_batch, _unfold_matmul, cycle_matrix_f32,
    resample_kernel_reference, resample_rows_reference, rows_marshal_plan, stacked_bank_f32)

__all__ = ["kernel_applicable", "kernel_plan", "packed_bank_f32", "tf32_rna",
           "resample_rows", "resample_rows_reference", "resample_kernel",
           "resample_auto", "resample_presliced_kernel", "resample_staged",
           "rows_marshal_plan", "src_route", "SrcRoute",
           "stacked_bank_f32", "window_traffic", "launches", "launches_windowed"]

#: CUDA kernel launches since the count was last reset (a plain integer:
#: callers set it to 0 and read it back to prove a path ran the kernel).
launches = 0
#: those of them that took the windowed form (varispeed banks)
launches_windowed = 0
_launch_lock = threading.Lock()

# The kernel's compile-time geometry (csrc/cycle_src.cu): k8 steps per ring
# stage, ring stages, 8-column n-tiles per block at most, warps (16 cycles
# each) per block at most.  `_launch` checks the library agrees.
KC8, STAGES, MAX_NT, MAX_WARPS = 2, 4, 5, 8
_GEOMETRY = 10 * KC8 + 100 * STAGES + 1000 * MAX_NT + 10000 * MAX_WARPS
#: span bytes up to which two blocks share an SM
_SPAN_BUDGET = 96 * 1024
#: shared memory one block may use on Hopper
_SMEM_MAX = 232448
_SKEWS = (0, 4)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """One bank's launch geometry.  Column tile c covers output phases
    ``[8*nt*c, 8*nt*(c+1))`` and contracts over G rows
    ``[bands[c][0], bands[c][0] + 8*bands[c][1])`` (``nk = bands[c][1]`` k8
    steps, a multiple of `KC8`); a block owns ``16*warps`` cycles.  The span
    in shared memory stores logical float ``j`` at ``j + skew*(j // 32)``;
    ``rowmap`` orders a warp's cycles (see `cycle_of`).

    ``pitch > 0`` is the windowed form of a varispeed bank (`_window_plan`):
    a block owns ``group`` neighbouring column tiles and ``16*warps``
    (signal, cycle) rows, and stages each row's union window (the group's
    bands) once, in ``16*warps`` slots of ``pitch`` floats; ``group`` and
    ``warps`` are the most a launch uses (`_win_launch` takes fewer for few
    rows) and ``ring_off`` / ``smem_bytes`` are those of a launch at both."""
    nt: int
    warps: int
    skew: int
    rowmap: int
    bands: tuple[tuple[int, int], ...]
    ring_off: int
    smem_bytes: int
    pitch: int = 0
    group: int = 0


def _choose_nt(L: int) -> int:
    """n-tiles per column tile: few tiles (each reloads the span) and little
    idle width in the last one; L = 40 -> one tile of 40, L = 160 -> four."""
    return min(range(1, MAX_NT + 1),
               key=lambda nt: (-(-L // (8 * nt)) * (8 * nt + 16), -nt))


def _span_floats(M: int, warps: int, rows: int, skew: int) -> int:
    """Shared-memory floats of a block's span: (16*warps - 1)*M + rows
    logical floats behind a shift of up to 3, in whole 16-byte chunks,
    skewed."""
    n = (16 * warps - 1) * M + rows + 8
    return 4 * -(-(n + skew * (n // 32 + 1)) // 4)


def cycle_of(rowmap: int, warp, h, g):
    """Block-local cycle of fragment row ``h*8 + g`` in ``warp`` (the
    kernel's `cycle_of`): rowmap 0 keeps a warp's 16 cycles in order,
    rowmap 1 interleaves a warp pair's 32 so one load's 8 cycles are 4
    apart."""
    if rowmap:
        return (warp >> 1) * 32 + 4 * g + 2 * h + (warp & 1)
    return warp * 16 + h * 8 + g


def _a_load_wavefronts(M: int, warps: int, skew: int, rowmap: int) -> float:
    """Mean shared-memory wavefronts per A-fragment load (1 = no bank
    conflict), over every warp, fragment half, span shift and k8 step
    phase."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    rows = [cycle_of(rowmap, w, h, g) * M + t for w in range(warps) for h in range(2)]
    base = np.array(rows)                                     # (loads, 32)
    off = (np.arange(4)[:, None] + 8 * np.arange(4)[None, :]).ravel()
    off = (off[:, None] + np.array([0, 4])[None, :]).ravel()  # shift, 8s, +4
    j = (base[None, :, :] + off[:, None, None]).reshape(-1, 32)
    p = np.sort(j + skew * (j >> 5), axis=1)
    new = np.ones_like(p, dtype=bool)
    new[:, 1:] = p[:, 1:] != p[:, :-1]
    cnt = np.zeros((p.shape[0], 32), np.int64)
    r, c = np.nonzero(new)
    np.add.at(cnt, (r, p[r, c] % 32), 1)
    return float(cnt.max(axis=1).mean())


@functools.lru_cache(maxsize=256)
def _bands(bank: CycleBank, nt: int) -> tuple[tuple[int, int], ...]:
    g = cycle_matrix_f32(bank)
    out = []
    for l0 in range(0, bank.L, 8 * nt):
        nz = np.flatnonzero(np.any(g[:, l0:l0 + 8 * nt] != 0, axis=1))
        if nz.size == 0:
            out.append((0, 0))
            continue
        k8 = -(-(int(nz[-1]) + 1 - int(nz[0])) // 8)
        out.append((int(nz[0]), KC8 * -(-k8 // KC8)))
    return tuple(out)


def _fits(bank: CycleBank, nt: int, warps: int, skew: int, rows: int):
    """(ring_off, smem_bytes): the span, which the block's output tile
    (pitch 8*nt + 1) reuses at the end, then the ring."""
    tile = 16 * warps * (8 * nt + 1)
    ring_off = max(_span_floats(bank.M, warps, rows, skew), 4 * -(-tile // 4))
    return ring_off, 4 * ring_off + STAGES * KC8 * nt * 32 * 16


@functools.lru_cache(maxsize=256)
def _bands_phase(bank: CycleBank, nt: int) -> tuple[tuple[int, int], ...]:
    """`_bands` of a varispeed bank, from the cycle tables alone: phase p's
    taps are rows ``[off[p], off[p] + K)`` and ``off`` never falls, so tile
    c's band runs from its first phase's ``off`` to its last's ``off + K``."""
    off, _ph = _phase_tables(bank)
    K = bank.taps_per_phase
    out = []
    for l0 in range(0, bank.L, 8 * nt):
        lo, hi = int(off[l0]), int(off[min(bank.L, l0 + 8 * nt) - 1]) + K
        out.append((lo, KC8 * -(-(-(-(hi - lo) // 8)) // KC8)))
    return tuple(out)


#: bytes of the windowed form's mbarrier at the start of shared memory
_WIN_BARRIERS = 16
#: the windowed form's sizes, tried in order: (tiles per group, consumer
#: warps).  Measured on the card (PERF.md): blocks per SM count most, then
#: fewer staged floats; more warps cost a block per SM and were slower.
_WIN_PREFS = ((4, 4), (2, 4), (1, 4), (1, 2), (1, 1))
#: shared memory up to which two blocks of the windowed form share an SM
_WIN_BUDGET = 113 * 1024


def _window_smem(nt: int, warps: int, pitch: int) -> tuple[int, int]:
    """(ring_off, smem_bytes) of the windowed form at ``warps``: the
    barrier, 16*warps windows of ``pitch`` floats, then the ring (the
    kernel's `win_smem_bytes`)."""
    ring_off = _WIN_BARRIERS // 4 + 16 * warps * pitch
    return ring_off, 4 * ring_off + STAGES * KC8 * nt * 32 * 16


def _union_floats(bands, group: int) -> int:
    """The longest union window of ``group`` neighbouring tiles' bands."""
    return max(max(lo + 8 * nk for lo, nk in bands[i:i + group]) - bands[i][0]
               for i in range(0, len(bands), group))


def _win_pitch(bands, group: int) -> int:
    """Window slot pitch: the longest union window behind a shift of up to
    3 floats, in whole float4s, rounded up to 4 mod 32 floats (a slot
    group's 8 rows x 4 taps then fall in 32 different banks)."""
    need = 4 * -(-(3 + _union_floats(bands, group)) // 4)
    return need + (4 - need) % 32


def _window_plan(bank: CycleBank) -> KernelPlan | None:
    """The windowed form's geometry: the first of `_WIN_PREFS` whose
    windows and ring leave room for two blocks per SM, else the first that
    fits a block's shared memory at all; None if none does."""
    if bank.L * bank.M >= 2**31:
        return None
    nt = _choose_nt(bank.L)
    bands = _bands_phase(bank, nt)
    if any(b[0] < a[0] for a, b in zip(bands, bands[1:])):
        raise AssertionError("a varispeed band starts before its left neighbour's")
    for budget in (_WIN_BUDGET, _SMEM_MAX):
        for g, w in _WIN_PREFS:
            pitch = _win_pitch(bands, g)
            ring_off, smem = _window_smem(nt, w, pitch)
            if smem <= budget:
                return KernelPlan(nt, w, 0, int(w > 1), bands, ring_off, smem, pitch, g)
    return None


#: shared memory of one SM that blocks can take, and what the card keeps
#: per block beside its own (Hopper)
_SM_SMEM, _BLOCK_SMEM_RESERVED = 233472, 1024


def _win_blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes one SM holds by shared memory alone."""
    return _SM_SMEM // (smem + _BLOCK_SMEM_RESERVED)


@functools.lru_cache(maxsize=256)
def _win_launch(plan: KernelPlan, n_rows: int, sms: int) -> tuple[int, int, int, int, int]:
    """(warps, rowmap, group, pitch, smem_bytes) of one windowed launch of
    ``n_rows`` rows on a card of ``sms`` SMs: fewer warps while half of them
    hold every row, then half the group while the smaller group's grid (row
    blocks x tile groups) still fits on the card at once, so a launch of
    few rows spreads its tiles over every SM rather than walking them in a
    few blocks (a grid past one wave measured slower, PERF.md).  A smaller
    group stages a shorter union window per row; no output's order changes."""
    warps = plan.warps
    while warps > 1 and 16 * (warps // 2) >= n_rows:
        warps //= 2
    row_blocks = -(-n_rows // (16 * warps))
    group, pitch = plan.group, plan.pitch
    while group > 1:
        half_pitch = _win_pitch(plan.bands, group // 2)
        slots = sms * _win_blocks_per_sm(_window_smem(plan.nt, warps, half_pitch)[1])
        if row_blocks * -(-len(plan.bands) // (group // 2)) > slots:
            break
        group, pitch = group // 2, half_pitch
    return warps, int(warps > 1), group, pitch, _window_smem(plan.nt, warps, pitch)[1]


def _win_slot_row(rowmap: int, s):
    """Block-local row held by window slot ``s = warp*16 + h*8 + g``."""
    return cycle_of(rowmap, s >> 4, (s >> 3) & 1, s & 7)


def _win_a_load_wavefronts(stride: int, warps: int, pitch: int, rowmap: int,
                           offsets=range(4)) -> float:
    """Mean shared-memory wavefronts per A-fragment load of the windowed
    form (1 = no bank conflict), over every warp, fragment half, alignment
    of the first row's window (its shift), the tile's offset inside the
    union window, k8 step phase and the +4 half: row ``rho``'s window sits
    in its slot behind a shift of ``(s0 + rho*stride) % 4`` floats."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    loads = []
    for s0 in range(4):
        for w in range(warps):
            for h in range(2):
                slot = w * 16 + h * 8 + g
                shift = (s0 + _win_slot_row(rowmap, slot) * stride) % 4
                loads.append(slot * pitch + shift + t)
    base = np.array(loads)                                    # (loads, 32)
    off = np.array([o + 8 * k + e for o in offsets for k in range(4) for e in (0, 4)])
    j = (base[None, :, :] + off[:, None, None]).reshape(-1, 32)
    p = np.sort(j, axis=1)
    new = np.ones_like(p, dtype=bool)
    new[:, 1:] = p[:, 1:] != p[:, :-1]
    cnt = np.zeros((p.shape[0], 32), np.int64)
    r, c = np.nonzero(new)
    np.add.at(cnt, (r, p[r, c] % 32), 1)
    return float(cnt.max(axis=1).mean())


def window_traffic(bank: CycleBank, signals: int, frames: int, sms: int) -> dict:
    """What one windowed launch over ``signals`` x ``frames`` on a card of
    ``sms`` SMs stages from L2 into shared memory, counted from the plan
    (no counter of the card's): ``windows`` (each row block's union windows,
    in whole float4s behind a mean shift of 1.5 floats) and ``band`` (each
    tile's packed band, once per row block), in MB, with the launch's warps
    and group."""
    plan = kernel_plan(bank)
    out_len = bank.out_len(frames)
    n_rows = signals * -(-out_len // bank.L)
    warps, _, group, _, _ = _win_launch(plan, n_rows, sms)
    row_blocks = -(-n_rows // (16 * warps))
    win = sum(16 * warps * 4 * -(-(2 + _union_floats(plan.bands[i:i + group], group)) // 4) * 4
              for i in range(0, len(plan.bands), group))
    band = sum(nk * plan.nt * 32 * 16 for _, nk in plan.bands)
    return {"windows": row_blocks * win / 1e6, "band": row_blocks * band / 1e6,
            "warps": warps, "group": group}


@functools.lru_cache(maxsize=256)
def kernel_plan(bank: CycleBank) -> KernelPlan | None:
    """The kernel's geometry for ``bank``, or None when it does not take it
    (L < 8, or a span too long for shared memory even at one warp: a dense
    bank with M in the thousands, a varispeed bank whose window passes
    ~3,500 floats).  A varispeed bank gets the windowed form
    (`_window_plan`).  Dense banks: warps: the most (8, 4, 2, 1) whose span
    fits `_SPAN_BUDGET`; skew and row order: the fewest bank conflicts on
    the A loads among those that fit (the interleaved order needs a warp
    pair)."""
    if bank.L < 8:
        return None
    if bank.G is None:
        return _window_plan(bank)
    nt = _choose_nt(bank.L)
    bands = _bands(bank, nt)
    rows = 8 * max(nk for _, nk in bands) if bands else 0
    for warps in (8, 4, 2, 1):
        if 4 * _span_floats(bank.M, warps, rows, 0) <= _SPAN_BUDGET:
            break
    if _fits(bank, nt, warps, 0, rows)[1] > _SMEM_MAX:
        return None
    opts = sorted((_a_load_wavefronts(bank.M, warps, sk, rm), sk, rm)
                  for sk in _SKEWS for rm in ((0, 1) if warps > 1 else (0,)))
    for _, skew, rowmap in opts:
        ring_off, smem = _fits(bank, nt, warps, skew, rows)
        if smem <= _SMEM_MAX:
            return KernelPlan(nt, warps, skew, rowmap, bands, ring_off, smem)
    raise AssertionError("unreachable: skew 0 fits")


def kernel_applicable(bank: CycleBank) -> bool:
    """Does the CUDA kernel take this bank?  `kernel_plan` is not None: L >=
    8 (a block computes 8 to 40 output phases) and, for a dense bank, a
    signal span of 16 cycles that fits a block's shared memory (M up to
    ~3,000), for a varispeed bank 16 union windows of one column tile and the
    ring that do.  Unlike the Pallas gate (`pallas_applicable`: R <= 8, M >=
    16, both TPU VMEM tiling rules) it does not bound R: G streams through
    the ring in 16-row chunks.  Every bank `pallas_applicable` accepts at the
    standard rates is accepted here."""
    return kernel_plan(bank) is not None


def tf32_rna(a: np.ndarray) -> np.ndarray:
    """float32 ``a`` rounded to TF32 (10 stored mantissa bits) to nearest,
    ties away from zero: PTX ``cvt.rna.tf32.f32``, as a float32 array."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@functools.lru_cache(maxsize=64)
def _packed_cached(bank: CycleBank) -> tuple[np.ndarray, np.ndarray]:
    plan = kernel_plan(bank)
    if plan is None:
        raise ValueError(f"the cycle_src kernel does not take bank L={bank.L} "
                         f"M={bank.M} W={bank.W}")
    W, L, nt = bank.W, bank.L, plan.nt
    if bank.G is not None:
        g = cycle_matrix_f32(bank)

        def values(w, col):
            return g[w, col]
    else:
        # G[w, l] = Hrev[ph[l], w - off[l]] inside the phase's K taps
        hrev, (p_off, p_ph) = _h_rev_f32_cached(bank), _phase_tables(bank)
        K = bank.taps_per_phase

        def values(w, col):
            k = w - p_off[col]
            inside = (k >= 0) & (k < K)
            return np.where(inside, hrev[p_ph[col], np.clip(k, 0, K - 1)], np.float32(0))
    lane = np.arange(32)
    gi, ti = lane >> 2, lane & 3
    parts, tiles, off = [], [], 0
    for c, (w_lo, nk) in enumerate(plan.bands):
        s = np.arange(nk)[:, None, None]
        n = np.arange(nt)[None, :, None]
        w0 = w_lo + 8 * s + ti                               # (nk, 1, 32)
        col = 8 * nt * c + 8 * n + gi                        # (1, nt, 32)
        quad = np.zeros((nk, nt, 32, 4), np.float32)
        for k, w in ((0, w0), (1, w0 + 4)):
            ok = (w < W) & (col < L)
            v = np.where(ok, values(np.minimum(w, W - 1), np.minimum(col, L - 1)), 0)
            hi = tf32_rna(v)
            quad[..., k] = hi
            quad[..., k + 2] = tf32_rna(v - hi)
        parts.append(quad.reshape(-1, 4))
        tiles.append((w_lo, nk, off))
        off += nk * nt * 32
    packed = np.concatenate(parts) if parts else np.zeros((0, 4), np.float32)
    return packed, np.asarray(tiles, np.int32).reshape(-1, 3)


def packed_bank_f32(bank: CycleBank) -> tuple[np.ndarray, np.ndarray]:
    """``(packed, tiles)``: the bank split into TF32 high and low parts in
    the kernel's fragment order, ``packed (N, 4)`` float32 where row
    ``tiles[c, 2] + (s*nt + n)*32 + lane`` holds the high parts of
    ``G[w, l]`` and ``G[w + 4, l]``, then their low parts, for
    ``w = w_lo + 8s + lane % 4``,
    ``l = 8*nt*c + 8n + lane // 4`` (zero outside G), and ``tiles (n, 3)``
    int32 rows ``(w_lo, nk, offset)``."""
    return _packed_cached(bank)


@functools.lru_cache(maxsize=64)
def _device_bank(bank: CycleBank, device: torch.device):
    packed, tiles = packed_bank_f32(bank)
    return torch.from_numpy(packed).to(device), torch.from_numpy(tiles).to(device)


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(xf: torch.Tensor, bank: CycleBank, Q: int, out_len: int,
            out_stride: int, pad_front: int | None = None) -> torch.Tensor:
    """One kernel launch over ``xf (bc, T)``: ``(bc, out_stride)`` float32 of
    which samples ``[0, out_len)`` are written.  Output cycle q reads
    ``xf[:, q*M - pad_front + w]`` (zero outside ``[0, T)``); ``pad_front``
    defaults to the bank's, 0 reads an already haloed chunk.

    A varispeed bank launches the windowed form: a launch of few rows takes
    fewer warps or a smaller group than the plan's (`_win_launch`); neither
    moves an output's summation order."""
    global launches, launches_windowed
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
    plan = kernel_plan(bank)
    if plan is None:
        raise ValueError(f"the cycle_src kernel does not take bank L={bank.L} "
                         f"M={bank.M} W={bank.W}")
    from ._build import load_library

    lib = load_library()
    if lib.f9_cycle_src_geometry() != _GEOMETRY:
        raise RuntimeError("cycle_src library geometry differs from the wrapper's")
    gp, tiles = _device_bank(bank, xf.device)
    y = torch.empty((bc, out_stride), dtype=torch.float32, device=xf.device)
    pf = bank.pad_front if pad_front is None else pad_front
    with torch.cuda.device(xf.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(xf.device).cuda_stream)
        ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (xf, gp, tiles, y)]
        if plan.pitch:
            n_rows = bc * Q
            if n_rows > 2**31 - 256:
                raise ValueError(f"{n_rows} (signal, cycle) rows exceed the kernel's grid")
            warps, rowmap, group, pitch, smem = _win_launch(plan, n_rows,
                                                            _sm_count(xf.device))
            err = lib.f9_cycle_src_win(
                *ptrs, bc, T, T, pf, bank.M, bank.L, Q, out_len, out_stride, plan.nt,
                len(plan.bands), warps, pitch, group, rowmap, smem, stream)
        else:
            err = lib.f9_cycle_src(
                *ptrs, bc, T, T, pf, bank.M, bank.L, Q, out_len, out_stride,
                plan.nt, len(plan.bands), plan.warps, plan.skew, plan.rowmap,
                plan.ring_off, plan.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"cycle_src kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches += 1
        launches_windowed += bool(plan.pitch)
    return y


def resample_rows(x: torch.Tensor, bank: CycleBank,
                  out_len: int | None = None) -> tuple[torch.Tensor, int]:
    """``(y (..., Q, L), out_len)``, ``Q = ceil(out_len / L)``, through the
    kernel (its twin: `resample_rows_reference`).  Launches or raises."""
    T = x.shape[-1]
    lead = x.shape[:-1]
    if out_len is None:
        out_len = bank.out_len(T)
    Q = -(-out_len // bank.L)
    if T == 0 or out_len == 0:
        return x.new_zeros((*lead, Q, bank.L)), out_len
    y = _launch(x.reshape(-1, T).contiguous(), bank, Q, Q * bank.L, Q * bank.L)
    return y.reshape(*lead, Q, bank.L), out_len


def resample_kernel(x: torch.Tensor, bank: CycleBank,
                    out_len: int | None = None) -> torch.Tensor:
    """Drop-in equivalent of `resample` through the kernel (flat output
    ``(..., out_len)``; the counterpart of `resample_pallas`, its twin
    `resample_kernel_reference`).  The kernel writes the flat layout
    directly, so no reshape pass follows it.  Launches or raises."""
    return _kernel_flat(x, bank, out_len, 0)


def _kernel_flat(xs: torch.Tensor, bank: CycleBank, out_len: int | None,
                 front: int) -> torch.Tensor:
    """`resample_kernel` of the signal ``xs[..., front:]``: one launch on
    ``xs`` whose output cycle q reads ``xs[..., q*M - pad_front + front +
    w]``, so the ``front`` samples before the signal are read in place."""
    T = xs.shape[-1] - front
    lead = xs.shape[:-1]
    if out_len is None:
        out_len = bank.out_len(T)
    if T == 0 or out_len == 0:
        return xs.new_zeros((*lead, out_len))
    Q = -(-out_len // bank.L)
    y = _launch(xs.reshape(-1, xs.shape[-1]).contiguous(), bank, Q, out_len, out_len,
                pad_front=bank.pad_front - front)
    return y.reshape(*lead, out_len)


def resample_presliced_kernel(xp: torch.Tensor, bank: CycleBank,
                              num_cycles: int) -> torch.Tensor:
    """The kernel on a CUDA chunk that carries its own halos (the streamed
    form of `f9tpu_torch.ops.resample.resample_presliced`): ``xp (..., T)``
    with ``T >= (num_cycles - 1)*M + W`` -> ``(..., num_cycles * L)``, one
    launch with ``pad_front = 0``.  Each output sums its window in the same
    k8 order wherever the chunk starts; where a cycle's window sits in the
    block's span (or which row of a windowed launch it is) moves only the
    shared-memory address."""
    return _kernel_flat(xp, bank, num_cycles * bank.L, bank.pad_front)


# --------------------------------------------------------------------------
# Which SRC implementation runs, and the batch forms that ask.
# --------------------------------------------------------------------------


class SrcRoute(NamedTuple):
    """`src_route`'s answer: the implementation, and whether the tensor is
    off the CPU."""
    impl: str       # "cycle_src", "cycle_fold" or "plain"
    card: bool


def src_route(bank: CycleBank, device: torch.device) -> SrcRoute:
    """Which SRC implementation runs for ``bank`` on ``device``: the one
    rule, which every SRC entry looks up in a table of its own.
    ``cycle_src`` where `kernel_plan` takes the bank (L >= 8, dense or
    varispeed); else ``cycle_fold`` where `cycle_fold.fold_threads` does (a
    dense bank with L < 8); else ``plain``, a library matmul of the cycle
    windows or the float64 gather of a varispeed bank (of the common rates
    only 384k -> 11,025 Hz, L = 147, M = 5,120).  ``card`` is ``device.type
    != "cpu"``: the kernel launches, and its wrapper raises on anything but
    a CUDA tensor.  On the CPU its fixed-order twin runs, except in the
    batch SRC of a ``cycle_fold`` bank: the float32 matmul there, the JAX
    package's convolution bit for bit, where the card answers to the
    float64 oracle."""
    if kernel_plan(bank) is not None:
        impl = "cycle_src"
    elif fold_threads(bank) is not None:
        impl = "cycle_fold"
    else:
        impl = "plain"
    return SrcRoute(impl, device.type != "cpu")


def _on_signal(form):
    """The batch entry of a form that pads the signal itself: ``form`` of
    ``xs[..., front:]``."""
    return lambda xs, bank, out_len, front: form(xs[..., front:] if front else xs, bank, out_len)


#: the batch SRC of the signal ``xs[..., front:]``, zero before it, by
#: `src_route`'s answer: ``(xs, bank, out_len, front) -> (..., out_len)``
_BATCH = {("cycle_src", True): _kernel_flat,
          ("cycle_src", False): _on_signal(resample_kernel_reference),
          ("cycle_fold", True): _on_signal(resample_fold_kernel),
          ("cycle_fold", False): _on_signal(_unfold_matmul),
          ("plain", True): _on_signal(_plain_batch),
          ("plain", False): _on_signal(_plain_batch)}


def resample_auto(x: torch.Tensor, bank: CycleBank,
                  out_len: int | None = None) -> torch.Tensor:
    """The batch SRC (the JAX package's `pallas_src.resample_auto`):
    ``x (..., T)`` -> ``(..., out_len)``, ``out_len`` defaulting to
    ``ceil(T*L/M)``, by `_BATCH`'s entry for `src_route`'s answer."""
    return _BATCH[src_route(bank, x.device)](x, bank, out_len, 0)


def resample_staged(xs: torch.Tensor, bank: CycleBank, num_cycles: int) -> torch.Tensor:
    """SRC of the rows layout's host-marshalled staging: ``xs (..., T)``, the
    signal at offset ``pad_front`` of a zero buffer that holds every input
    the first ``num_cycles`` output cycles read (``(num_cycles + R)*M`` floats
    for a dense bank, `rows_marshal_plan`; ``(num_cycles - 1)*M + row_width``
    for a varispeed bank, `banded_rows_plan`) -> ``(..., num_cycles * L)``:
    the batch SRC of ``xs[..., pad_front:]`` with ``out_len = num_cycles *
    L``, bit for bit `resample_auto` of the signal, the `cycle_src` kernel
    reading the staging in place."""
    return _BATCH[src_route(bank, xs.device)](xs, bank, num_cycles * bank.L, bank.pad_front)
