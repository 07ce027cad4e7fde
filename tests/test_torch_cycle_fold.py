"""The L < 8 cycle fold (`f9tpu_torch/ops/cycle_fold.py`, `csrc/cycle_fold.cu`)
on the CPU.

- The twin the kernel equals, `resample._presliced_fold`, against the JAX
  package's `resample_presliced` (an XLA convolution at HIGHEST) on every
  dense L < 8 bank of the standard rates at the four sinc presets (48) and
  on the meter's conversions to 48 kHz from 8, 16, 24 and 32 kHz: <= 2e-6
  max abs, the bound of `tests/test_torch_src.py` between two SRC forms,
  and <= -120 dB against the float64 oracle.
- The true-peak twin (`loudness._tp_step` on the CPU) against JAX's
  `_tp_step` on haloed chunks at 44.1, 48 and 96 kHz: <= 1e-6 abs (JAX's
  float32 convolution against the float64 fold, measured <= 3.6e-7 at
  peaks near 1.7).
- A numpy replay of the kernel's indexing in both its forms (`_replay`:
  block tiles, the staged span split by phase, the table's offsets or the
  slid form's rings of samples, a thread's cycles, a partial last tile, one
  cycle, rows off the 16-byte grid and a row stride past the row) equals
  the twin bit for bit, the samples and the
  bit-pattern maximum, also with +-inf, NaN, -0.0, subnormals and silence.
  Its FMA is numpy's exact float64 product then one rounded sum: a float32
  sample times a float32 tap is exact in float64, so it is the card's
  ``fma`` bit for bit.
- The CUDA source itself, built by g++ against `tests/cuda_emu.h` (a
  thread per CUDA thread, a barrier for ``__syncthreads``, shared memory
  filled with NaNs), equals the twin bit for bit in both forms, and its
  flat launch form (the batch SRC of the L = 1 banks, read from the
  unpadded signal) equals the twin of the padded signal.
- Dispatch: a CPU tensor never launches or loads the library, the kernel
  wrappers refuse a CPU tensor and every bank and input the kernel does not
  take before the library is asked for, `fold_kernel_applicable` is true on
  exactly the dense L < 8 banks, and `cycle_src`'s `kernel_applicable` on
  exactly the others; the batch form each bank takes off the CPU: the flat
  fold for dense L = 1, the matmul for dense L = 2-6, `cycle_src` for L >= 8.
- `cuda`-marked tests hold the kernel to its twin on the card; they skip
  without one (`chip_smoke.py --cycle-fold` runs them at full size)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.models import design_cycle_bank as jbank  # noqa: E402
from f9tpu_torch.models import design_cycle_bank, resample_oracle  # noqa: E402
from f9tpu_torch.models.filters import QUALITY_PRESETS, STANDARD_RATES  # noqa: E402
from f9tpu_torch.ops import _build  # noqa: E402
from f9tpu_torch.ops import cycle_fold as cf  # noqa: E402
from f9tpu_torch.ops import loudness as tloud  # noqa: E402
from f9tpu_torch.ops import resample as tres  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402

# the modules, not the functions `f9tpu.ops` re-exports under the same names
jres = importlib.import_module("f9tpu.ops.resample")
jloud = importlib.import_module("f9tpu.ops.loudness")

#: every dense L < 8 bank of the standard rates (the 12 integer-ratio pairs)
#: at the four sinc presets
STANDARD_FOLD_BANKS = [(ri, ro, q) for ri in STANDARD_RATES for ro in STANDARD_RATES
                       for q in QUALITY_PRESETS
                       if ri != ro and design_cycle_bank(ri, ro, quality=q).L < 8]
#: the meter's conversions to 48 kHz that are not among them
METER_BANKS = [(8000, 48000, "high"), (16000, 48000, "high"), (24000, 48000, "high"),
               (32000, 48000, "high")]
#: the grid of the dispatch rule: the standard rates, the meter's and 384 kHz
GRID_RATES = (8000, 16000, 24000, 32000, 44100, 48000, 88200, 96000, 176400, 192000, 384000)


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite runs files in parallel processes; one OpenMP thread each
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _db(err, ref) -> float:
    e = np.sqrt(np.mean(np.square(np.asarray(err, np.float64))))
    r = np.sqrt(np.mean(np.square(np.asarray(ref, np.float64))))
    return 20.0 * np.log10(max(e, 1e-300) / r)


def _signal(channels: int, frames: int, seed: int, level: float = 0.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(frames)
    f = rng.uniform(0.01, 0.4, size=(channels, 1))
    x = level * np.sin(2 * np.pi * f * t) + 0.3 * level * rng.standard_normal((channels, frames))
    return x.astype(np.float32)


def _haloed(x: np.ndarray, bank, Q: int) -> np.ndarray:
    """``x`` behind the bank's front pad, zero-filled to the span of Q
    cycles: the padded signal `resample` convolves."""
    xp = np.zeros((x.shape[0], (Q - 1) * bank.M + bank.W), np.float32)
    keep = min(x.shape[-1], xp.shape[-1] - bank.pad_front)
    xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
    return xp


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """float32 arrays equal bit for bit outside their NaNs, NaN where the
    other is NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    if a.shape != b.shape:
        return False
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb)
                and np.array_equal(a[~na].view(np.uint32), b[~nb].view(np.uint32)))


# ------------------------------------------------ the twin against JAX

@pytest.mark.parametrize("ri,ro,q", STANDARD_FOLD_BANKS + METER_BANKS,
                         ids=[f"{ri}-{ro}-{q}" for ri, ro, q in STANDARD_FOLD_BANKS + METER_BANKS])
def test_fold_twin_matches_jax_and_oracle(ri, ro, q):
    bank = design_cycle_bank(ri, ro, quality=q)
    assert bank.L < 8 and bank.G is not None and cf.fold_kernel_applicable(bank)
    T = 1500 + (ri // 1000) % 7
    x = _signal(2, T, seed=ri % 89 + ro % 61 + len(q))
    out_len = bank.out_len(T)
    Q = -(-out_len // bank.L)
    xp = _haloed(x, bank, Q)
    got = tres._presliced_fold(torch.from_numpy(xp), bank, Q).numpy()
    want = np.asarray(jres.resample_presliced(jnp.asarray(xp), jbank(ri, ro, quality=q), Q))
    assert got.shape == want.shape == (2, Q * bank.L)
    assert np.abs(got.astype(np.float64) - want).max() <= 2e-6
    ref = resample_oracle(x, ri, ro, quality=q)
    assert ref.shape == (2, out_len)
    assert _db(got[:, :out_len] - ref, ref) <= -120.0


@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_true_peak_twin_matches_jax(rate):
    """Haloed chunks as `meter_source_streamed` cuts them, a signal whose
    inter-sample peaks pass its sample peak (near 1.7 at the chunk's
    loudest): port and JAX within 1e-6, each peak above the samples'."""
    tp = design_cycle_bank(rate, 4 * rate, quality="high")
    h_l, h_r = tloud._halos(tp)
    chunk = 3001
    rng = np.random.default_rng(rate % 1009)
    x = np.sign(rng.standard_normal((2, 3 * chunk))).astype(np.float32) * np.float32(0.89)
    for start in range(0, x.shape[-1], chunk):
        xp = tloud._read_span(tloud.array_reader(x), 2, x.shape[-1], start - h_l,
                              h_l + chunk + h_r)
        got = float(tloud._tp_step(torch.from_numpy(xp), cycles=chunk, rate_in=rate,
                                   oversample=4))
        want = float(jloud._tp_step(jnp.asarray(xp), cycles=chunk, rate_in=rate, oversample=4))
        assert abs(got - want) <= 1e-6
        assert got > 0.89
        assert got == float(cf.presliced_absmax_reference(torch.from_numpy(xp), tp, chunk))


# -------------------------------------------- the kernel's indexing in numpy

def _replay(flat: np.ndarray, off: int, ld: int, T: int, n_sig: int, bank, Q: int,
            threads: int, form: int):
    """The kernel's arithmetic and indexing in numpy: (y (n_sig, Q * L)
    float32, the bit-pattern maximum of |y| as a float32).  Row r of the
    input is ``flat[off + r*ld : off + r*ld + T]``.  Block (row, tile) takes
    cycles ``[q0, q0 + FOLD_CYCLES * threads)`` and stages its span split by
    S phases.  The generic form (``form`` 0, S = M): the table's w turned
    into the span's offsets, thread t folds cycles ``t + threads * i`` over
    the table's rows in order.  The slid form (``form`` = M, S = FOLD_CYCLES
    * M): thread t folds cycles ``FOLD_CYCLES * t + i``, each residue r of w
    mod M a ring of FOLD_CYCLES samples filled and read at the kernel's
    slots.  Outputs past Q are dropped and the block's maximum joins the
    others'."""
    L, M, W = bank.L, bank.M, bank.W
    tab, g = cf.fold_table(bank)
    C = cf.FOLD_CYCLES
    tq = C * threads
    span = (tq - 1) * M + W
    S = C * M if form else M
    P = -(-span // S)
    tiles = -(-Q // tq)
    w = tab >> 6
    lo, hi = (tab >> 3) & 7, tab & 7
    xoff = (w % M) * P + w // M
    t = np.arange(threads)[:, None]
    i = np.arange(C)[None, :]
    y = np.zeros((n_sig, Q * L), np.float32)
    peak = np.uint32(0)
    with np.errstate(invalid="ignore", over="ignore"):
        for row in range(n_sig):
            for tile in range(tiles):
                q0 = tile * tq
                n = np.arange(span)
                src = q0 * M + n
                xs = np.zeros(S * P, np.float32)
                vals = np.where(src < T, flat[off + row * ld + np.minimum(src, T - 1)], 0.0)
                xs[(n % S) * P + n // S] = vals
                acc = np.zeros((threads, C, L), np.float64)

                def fold(r, xv):
                    for col in range(L):
                        if lo[r] <= col < hi[r]:
                            acc[:, :, col] = xv * g[r, col] + acc[:, :, col]

                if form == 0:
                    q = q0 + t + threads * i
                    for r in range(tab.shape[0]):
                        fold(r, xs[xoff[r] + t + threads * i].astype(np.float64))
                else:
                    assert tab.shape[0] == W and np.array_equal(w, np.arange(W))
                    q = q0 + C * t + i
                    ring = np.zeros((M, threads, C), np.float64)

                    def sample(j, res):
                        return xs[((j % C) * M + res) * P + j // C + t[:, 0]].astype(np.float64)

                    for res in range(M):
                        for j in range(C - 1):
                            ring[res, :, j] = sample(j, res)
                    for wr in range(W):
                        k, res = divmod(wr, M)
                        ring[res, :, (k + C - 1) % C] = sample(k + C - 1, res)
                        fold(wr, ring[res][:, (k + np.arange(C)) % C])
                ok = q < Q                                          # (threads, C)
                v = acc.astype(np.float32)                          # (threads, C, L)
                y[row, (q[ok][:, None] * L + np.arange(L)).ravel()] = v[ok].ravel()
                pat = v[ok].view(np.uint32) & np.uint32(0x7FFFFFFF)
                peak = max(peak, pat.max(initial=0))
    return y, np.array([peak], np.uint32).view(np.float32)[0]


def _twin(flat, off, ld, T, n_sig, bank, Q):
    rows = np.stack([flat[off + r * ld: off + r * ld + T] for r in range(n_sig)])
    xt = torch.from_numpy(rows)
    y = tres._presliced_fold(xt, bank, Q).numpy()
    pk = cf.presliced_absmax_reference(xt, bank, Q).numpy() if Q else None
    return y, pk


def _flat(n_sig: int, T: int, off: int, ld: int, seed: int, level: float = 0.89):
    rng = np.random.default_rng(seed)
    flat = rng.uniform(-level, level, off + n_sig * ld + 5).astype(np.float32)
    return flat


_REPLAY_BANKS = [(44100, 176400, "high", "sinc"), (96000, 48000, "high", "sinc"),
                 (32000, 48000, "high", "sinc"), (8000, 48000, "high", "sinc"),
                 (48000, 96000, "high", "lagrange"), (192000, 48000, "low", "sinc"),
                 (48000, 16000, "low", "sinc")]


@pytest.mark.parametrize("ri,ro,q,kind", _REPLAY_BANKS,
                         ids=[f"{ri}-{ro}-{q}-{k}" for ri, ro, q, k in _REPLAY_BANKS])
@pytest.mark.parametrize("threads", [32, 128])
@pytest.mark.parametrize("slid", [False, True], ids=["generic", "slid"])
def test_replay_of_the_kernel_equals_the_twin(ri, ro, q, kind, threads, slid):
    """Both forms (the slid one where `fold_form` gives it), tiles of
    FOLD_CYCLES x threads cycles: one cycle, a tile less one, a whole tile, a
    tile and one (a partial last tile), two and a half; rows 1 and 3 floats
    off the 16-byte grid with a stride past the row."""
    bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
    form = cf.fold_form(bank) if slid else 0
    assert form == (0 if bank.M == 3 or not slid else bank.M)
    tq = cf.FOLD_CYCLES * threads
    for Q in (1, tq - 1, tq, tq + 1, 2 * tq + tq // 2):
        T = (Q - 1) * bank.M + bank.W + 2
        for off, ld in ((1, T + 3), (3, T)):
            flat = _flat(3, T, off, ld, seed=Q + off)
            y, pk = _replay(flat, off, ld, T, 3, bank, Q, threads, form)
            yt, pt = _twin(flat, off, ld, T, 3, bank, Q)
            assert _same_bits(y, yt), (Q, off)
            assert _same_bits(pk, pt), (Q, off)


def test_replay_with_special_values():
    """+-inf, NaN, -0.0 (outputs that underflow to -0.0 from below),
    subnormals and silence: the samples bit for bit (NaN where the twin's
    are) and the bit-pattern maximum as `torch.max(torch.abs(.))` gives it:
    NaN wins over +inf, silence and -0.0 give +0.0."""
    bank = design_cycle_bank(44100, 176400, quality="high")
    Q, threads = 300, 32
    T = (Q - 1) * bank.M + bank.W
    tiny = np.float32(1e-45)                       # the smallest subnormal
    cases = {
        "silence": np.zeros(T, np.float32),
        "-0.0": np.full(T, -0.0, np.float32),
        "subnormals": (np.where(np.arange(T) % 3 == 0, -1.0, 1.0) * (np.arange(T) % 7)
                       * float(tiny)).astype(np.float32),
        "+inf": None, "-inf": None, "NaN": None, "inf and NaN": None,
    }
    base = _flat(1, T, 0, T, seed=5)[:T]
    for name in ("+inf", "-inf", "NaN", "inf and NaN"):
        v = base.copy()
        if "inf" in name:
            v[200] = -np.inf if name == "-inf" else np.inf
        if "NaN" in name:
            v[350] = np.nan
        cases[name] = v
    for (name, row), form in zip(cases.items(), [0, 1] * len(cases)):
        flat = np.concatenate([row, _flat(1, T, 0, T, seed=7)[:T]]).astype(np.float32)
        y, pk = _replay(flat, 0, T, T, 2, bank, Q, threads, form)
        yt, pt = _twin(flat, 0, T, T, 2, bank, Q)
        assert _same_bits(y, yt), name
        assert _same_bits(pk, pt), name
        if name in ("silence", "-0.0"):
            assert not np.any(yt[0]) and not np.signbit(yt[0]).any()
        if name == "subnormals":
            assert np.any(np.signbit(yt[0]) & (yt[0] == 0)), "no output rounded to -0.0"
        if "NaN" in name:
            assert np.isnan(pk) and np.isnan(pt)
        elif "inf" in name:
            assert np.isnan(yt[0]).any() or np.isinf(yt[0]).any()
    # silence alone: +0.0
    z = np.zeros(2 * T, np.float32)
    _, pk = _replay(z, 0, T, T, 2, bank, Q, threads, 1)
    assert pk.view(np.uint32) == 0 and float(cf.presliced_absmax_reference(
        torch.from_numpy(z.reshape(2, T)), bank, Q)) == 0.0


def test_table_and_geometry():
    """The table is the twin's rows in order with their column ranges; G's
    rows are the float32 taps widened; every block's shared memory fits."""
    for ri, ro, q in STANDARD_FOLD_BANKS + METER_BANKS:
        bank = design_cycle_bank(ri, ro, quality=q)
        tab, g = cf.fold_table(bank)
        rows = tres._fold_rows(bank)
        assert [(int(e) >> 6, (int(e) >> 3) & 7, int(e) & 7) for e in tab] == list(rows)
        gf = tres.cycle_matrix_f32(bank)
        assert np.array_equal(g, gf[[w for w, _, _ in rows]].astype(np.float64))
        threads = cf.fold_threads(bank)
        assert threads == 128 and cf.fold_smem(bank, threads) <= cf.SMEM_BLOCK_MAX
        # every one of them has every row of G and M in (1, 2, 4): the slid form
        assert cf.fold_form(bank) == bank.M
    wide = design_cycle_bank(384000, 8000, quality="ultra")
    assert wide.W == 9600 and cf.fold_threads(wide) == 32 and cf.fold_form(wide) == 0
    assert cf.fold_form(design_cycle_bank(48000, 16000)) == 0         # M = 3
    assert cf.fold_smem(wide, 64) > cf.SMEM_BLOCK_MAX >= cf.fold_smem(wide, 32)


# ------------------------------------- the kernel's source, emulated on the CPU

def _emulated_kernel(tmp_dir: str):
    """`csrc/cycle_fold.cu` itself built by g++ against `tests/cuda_emu.h`
    (a thread per CUDA thread, a barrier for ``__syncthreads``), its launch
    and shared declarations rewritten to the emulation's; returns the
    library with ``f9_cycle_fold`` declared."""
    import ctypes
    import os
    import re
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source against the emulation")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(os.path.dirname(_build.CSRC), "csrc", "cycle_fold.cu")) as f:
        src = f.read()
    cuts = [("#include <cuda_runtime.h>", '#include "cuda_emu.h"'),
            ("extern __shared__ double fold_sm[];", "double* fold_sm = emu_dynamic_smem();"),
            ("__shared__ unsigned warp_max[FOLD_MAX_THREADS / 32];",
             "unsigned* warp_max = emu_static_smem();")]
    for old, new in cuts:
        assert old in src, old
        src = src.replace(old, new)
    src, n = re.subn(r"(cycle_fold_kernel<[^>]*>)<<<([^,]+), ([^,]+), [^>]+>>>\((.*?)\);",
                     r"emu_launch(\2, \3, [&] { \1(\4); });", src, flags=re.S)
    assert n == 1 and "<<<" not in src
    cpp = os.path.join(tmp_dir, "cycle_fold_emu.cpp")
    so = os.path.join(tmp_dir, "libcycle_fold_emu.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-I", here, "-I", _build.CSRC,
                    "-o", so, cpp, "-lpthread"], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f9_cycle_fold.argtypes = [vp] * 5 + [i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, vp]
    lib.f9_cycle_fold.restype = i32
    lib.f9_cycle_fold_flat.argtypes = [vp] * 4 + [i64] * 5 + [i32] * 6 + [vp]
    lib.f9_cycle_fold_flat.restype = i32
    lib.f9_cycle_fold_cycles.restype = i32
    return lib


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return _emulated_kernel(str(tmp_path_factory.mktemp("cycle_fold_emu")))


def test_kernel_source_emulated_equals_the_twin(tmp_path):
    """The CUDA source, run on the CPU a thread per CUDA thread: both forms
    on the replay's banks at 32 and 128 threads, one cycle, a partial tile
    and a tile and one, rows a float off the grid with a stride past the row
    and a NaN and an inf in the second; the samples (staged back through
    shared memory) and the fused peak bit for bit the twin's, and a form or
    block the kernel does not take refused."""
    lib = _emulated_kernel(str(tmp_path))
    assert lib.f9_cycle_fold_cycles() == cf.FOLD_CYCLES
    rng = np.random.default_rng(11)
    for ri, ro, q, kind in _REPLAY_BANKS:
        bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
        tab, g = cf.fold_table(bank)
        for threads in (32, 128):
            tq = cf.FOLD_CYCLES * threads
            for form in sorted({0, cf.fold_form(bank)}):
                for Q in (1, tq - 5, tq + 1):
                    T = (Q - 1) * bank.M + bank.W
                    ld = T + 3
                    flat = rng.uniform(-0.89, 0.89, 1 + 2 * ld).astype(np.float32)
                    flat[1 + ld + min(7, T - 1)] = np.nan
                    flat[1 + ld + T // 2] = np.inf
                    y = np.zeros((2, Q * bank.L), np.float32)
                    pk = np.zeros(1, np.uint32)
                    common = (2, ld, T, Q, bank.L, bank.M, bank.W, len(tab), threads, form, None)
                    ptrs = (flat[1:].ctypes.data, g.ctypes.data, tab.ctypes.data)
                    assert lib.f9_cycle_fold(*ptrs, y.ctypes.data, None, *common) == 0
                    assert lib.f9_cycle_fold(*ptrs, None, pk.ctypes.data, *common) == 0
                    yt, pt = _twin(flat, 1, ld, T, 2, bank, Q)
                    assert _same_bits(y, yt), (ri, ro, q, kind, threads, form, Q)
                    assert _same_bits(pk.view(np.float32)[0], pt), (ri, ro, q, kind, threads, Q)
    bank = design_cycle_bank(48000, 16000, quality="low")          # M = 3: no slid form
    tab, g = cf.fold_table(bank)
    x = np.zeros(bank.W, np.float32)
    y = np.zeros(bank.L, np.float32)
    for threads, form in ((128, 3), (96, 0)):
        assert lib.f9_cycle_fold(x.ctypes.data, g.ctypes.data, tab.ctypes.data, y.ctypes.data,
                                 None, 1, bank.W, bank.W, 1, bank.L, bank.M, bank.W, len(tab),
                                 threads, form, None) != 0


#: the flat form's cases: (rate_in, rate_out, quality, rows, frames, cycles
#: cut from the default count, row stride past the row)
_FLAT_BANKS = [(96000, 48000, "high"), (96000, 48000, "ultra"), (48000, 16000, "high"),
               (48000, 16000, "ultra"), (192000, 48000, "high"), (192000, 48000, "ultra")]
_FLAT_CASES = [(ri, ro, q, rows, frames, cut, extra)
               for ri, ro, q in _FLAT_BANKS
               for rows, frames, cut, extra in ((1, 6 * 4096 + 37, 0, 0), (3, 2500, 0, 7),
                                                (16, 3001, 700, 5))]


@pytest.mark.parametrize("ri,ro,q,rows,frames,cut,extra", _FLAT_CASES,
                         ids=[f"{ri}-{ro}-{q}-{rows}x{frames}-cut{cut}-ld+{extra}"
                              for ri, ro, q, rows, frames, cut, extra in _FLAT_CASES])
def test_flat_form_emulated_equals_the_twin(emulated, ri, ro, q, rows, frames, cut, extra):
    """The flat launch form of the CUDA source, run on the CPU a thread per
    CUDA thread, on the L = 1 banks (M = 2, 3, 4 at high and ultra): from
    the unpadded rows, the bank's front pad (``pad_front`` > 0) and the
    cycle budget `resample` computes, the output equals
    ``_presliced_fold(F.pad(x[..., :keep_T], (pad_front, pad_back)))`` bit
    for bit, in the form `fold_form` picks and in the generic form.  The
    cases: one row whose last cycles read past ``keep_T``, several tiles and
    a partial last one, a stretch of -0.0 longer than two blocks' spans
    (blocks that fold nothing and must give +0.0); rows a stride wider than
    T whose last cycles read past ``keep_T`` into the stride's gap (data
    there, read as zeros); 16 such rows with fewer outputs asked for than
    the default (``keep_T`` shorter than the rows), a row of silence, one
    of -0.0 but a single subnormal (2.1e-44, which no block may take for
    silence), and a NaN and an inf."""
    import torch.nn.functional as F

    bank = design_cycle_bank(ri, ro, quality=q)
    assert bank.L == 1 and cf.fold_batch_applicable(bank) and bank.pad_front > 0
    tab, g = cf.fold_table(bank)
    threads = cf.fold_threads(bank)
    out_len = bank.out_len(frames) - cut
    out_len, Q, keep_T, pad_front, pad_back = tres._cycle_budget(frames, bank, out_len)
    assert (keep_T < frames) == (cut > 0)
    assert (pad_back > 0) == (cut == 0)              # the last cycle reads past keep_T
    ld = frames + extra
    rng = np.random.default_rng(ri % 997 + rows + cut)
    flat = rng.uniform(-0.89, 0.89, 1 + rows * ld).astype(np.float32)
    x = flat[1:].reshape(rows, ld)                                # a float off the grid
    x[0, frames // 4: frames // 4 + 12000] = -0.0
    if rows > 3:
        x[1, :] = 0.0
        x[2, :] = -0.0
        x[2, 100] = np.uint32(15).view(np.float32)
        x[-1, 17], x[-1, frames // 2] = np.nan, np.inf
    xt = torch.from_numpy(np.ascontiguousarray(x[:, :frames]))
    want = tres._presliced_fold(F.pad(xt[:, :keep_T], (pad_front, pad_back)), bank, Q)
    want = want[:, :out_len].numpy()
    for form in sorted({0, cf.fold_form(bank)}):
        y = np.full((rows, Q * bank.L), np.nan, np.float32)
        assert emulated.f9_cycle_fold_flat(
            x.ctypes.data, g.ctypes.data, tab.ctypes.data, y.ctypes.data, rows, ld, keep_T,
            pad_front, Q, bank.L, bank.M, bank.W, len(tab), threads, form, None) == 0
        assert _same_bits(y[:, :out_len], want), (form, rows, cut)
    if rows > 3:
        assert not np.any(want[1]) and not np.signbit(want[1]).any()
        assert np.any(want[2])


def test_flat_form_emulated_refuses(emulated):
    """The flat entry refuses a geometry the kernel cannot read: pads and
    kept samples past the span of Q cycles, a negative pad or length, a row
    stride shorter than the kept samples, and a form the bank does not take."""
    bank = design_cycle_bank(96000, 48000)
    tab, g = cf.fold_table(bank)
    x = np.zeros(4 * 4096, np.float32)
    y = np.zeros(4 * 4096, np.float32)
    Q = 1000
    span = (Q - 1) * bank.M + bank.W

    def call(rows=2, ld=4096, keep=2000, pad_front=bank.pad_front, form=2, threads=128):
        return emulated.f9_cycle_fold_flat(x.ctypes.data, g.ctypes.data, tab.ctypes.data,
                                           y.ctypes.data, rows, ld, keep, pad_front, Q, bank.L,
                                           bank.M, bank.W, len(tab), threads, form, None)

    assert call() == 0
    for bad in (dict(keep=span - bank.pad_front + 1), dict(keep=-1), dict(pad_front=-1),
                dict(ld=1999), dict(form=1), dict(threads=96)):
        assert call(**bad) != 0, bad
    assert call(rows=1, ld=1) == 0                   # one row: its stride is not read


# --------------------------------------------------------------- dispatch

def test_dispatch_rule_over_the_grid():
    """`fold_kernel_applicable` takes exactly the dense banks with L < 8,
    `cycle_src` exactly the banks with L >= 8 (dense or varispeed): one
    kernel for every bank of the grid, never two."""
    n_fold = n_src = 0
    for ri in GRID_RATES:
        for ro in GRID_RATES:
            # minphase banks have the sinc banks' geometry (and take 10 s to design)
            for q, kind in [(p, "sinc") for p in QUALITY_PRESETS] + [("high", "lagrange")]:
                bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
                fold, src = cf.fold_kernel_applicable(bank), sk.kernel_applicable(bank)
                assert fold == (bank.G is not None and bank.L < 8), (ri, ro, q, kind)
                assert src == (bank.L >= 8), (ri, ro, q, kind)
                assert fold != src, (ri, ro, q, kind)
                n_fold += fold
                n_src += src
    assert (n_fold, n_src) == (320, 285)


#: the batch form off the CPU, by `_batch_form`, over the grid of
#: `test_dispatch_rule_over_the_grid`
BATCH_FORMS = {"cycle_fold": 195, "matmul": 125, "cycle_src": 285}


def _batch_form(bank, monkeypatch) -> str:
    """The form `src_kernel.resample_auto` sends a batch of ``bank`` to off
    the CPU: the kernels' wrappers replaced by recorders, the rest run on a
    meta tensor (shapes only)."""
    taken = []

    def record(name):
        def wrapper(x, bank, out_len=None):
            taken.append(name)
            n = bank.out_len(x.shape[-1]) if out_len is None else out_len
            return x.new_empty((*x.shape[:-1], n))
        return wrapper

    monkeypatch.setattr(sk, "resample_kernel", record("cycle_src"))
    monkeypatch.setattr(cf, "resample_fold_kernel", record("cycle_fold"))
    x = torch.empty((2, 4099), device="meta")
    y = sk.resample_auto(x, bank)
    assert tuple(y.shape) == (2, bank.out_len(4099)) and len(taken) <= 1
    return taken[0] if taken else ("matmul" if bank.G is not None else "gather")


def test_batch_form_over_the_grid(monkeypatch):
    """The batch SRC each bank of the grid takes off the CPU, read from
    `resample_auto`'s own dispatch: the fold kernel's flat form for exactly
    the dense L = 1 banks (`fold_batch_applicable`), the float32 matmul for
    the dense L = 2-6 banks, `cycle_src` for L >= 8; counted."""
    counts = {}
    for ri in GRID_RATES:
        for ro in GRID_RATES:
            for q, kind in [(p, "sinc") for p in QUALITY_PRESETS] + [("high", "lagrange")]:
                bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
                form = _batch_form(bank, monkeypatch)
                want = ("cycle_src" if bank.L >= 8 else "cycle_fold" if bank.L == 1
                        else "matmul")
                assert form == want, (ri, ro, q, kind)
                assert cf.fold_batch_applicable(bank) == (form == "cycle_fold")
                counts[form] = counts.get(form, 0) + 1
    assert counts == BATCH_FORMS
    assert cf.launches_flat == 0 and _build._lib is None


def test_cpu_tensor_never_launches():
    """On the CPU `resample_presliced`, `resample` and `_tp_step` run the
    twins and the kernel's counts stay 0; the library is never loaded."""
    cf.launches = cf.launches_flat = 0
    bank = design_cycle_bank(96000, 48000)
    xp = torch.from_numpy(_haloed(_signal(2, 900, seed=3), bank, 400))
    y = tres.resample_presliced(xp, bank, 400)
    assert torch.equal(y, tres._presliced_fold(xp, bank, 400))
    assert tres.resample(xp, bank).shape == (2, bank.out_len(xp.shape[-1]))
    tp = design_cycle_bank(48000, 192000)
    pk = tloud._tp_step(torch.from_numpy(_haloed(_signal(2, 500, seed=4), tp, 500)), cycles=500,
                        rate_in=48000, oversample=4)
    assert pk.dim() == 0 and pk.dtype == torch.float32
    assert cf.launches == cf.launches_flat == 0 and _build._lib is None


def test_wrappers_refuse_before_loading_the_library():
    """A CPU tensor, and on another device a bank the kernel does not take
    (L >= 8, varispeed), float64 samples, a chunk too short for its cycles
    and an empty chunk's peak: each raises before the library is asked
    for; the flat form of an empty signal returns before it too."""
    fold_bank = design_cycle_bank(44100, 176400)
    cpu = torch.zeros(2, 2000)
    for fn in (cf.resample_presliced_fold_kernel, cf.presliced_absmax_kernel,
               cf.resample_fold_kernel):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(cpu, fold_bank, 100)
    meta = torch.empty((2, 200000), device="meta")
    refused = [(meta, design_cycle_bank(44100, 48000), 100, "does not take"),
               (meta, design_cycle_bank(44100, 44056), 2, "does not take"),
               (meta.to(torch.float64), fold_bank, 100, "float32")]
    for x, bank, n, msg in refused + [(torch.empty((2, 127), device="meta"), fold_bank, 1,
                                       "too short")]:
        for fn in (cf.resample_presliced_fold_kernel, cf.presliced_absmax_kernel):
            with pytest.raises(ValueError, match=msg):
                fn(x, bank, n)
    for x, bank, n, msg in refused:
        with pytest.raises(ValueError, match=msg):
            cf.resample_fold_kernel(x, bank, n)
    # an empty signal, or no row, resamples to nothing without a launch
    l1 = design_cycle_bank(96000, 48000)
    for shape, n in (((2, 0), None), ((0, 3000), None), ((2, 3000), 0)):
        y = cf.resample_fold_kernel(torch.empty(shape, device="meta"), l1, n)
        assert tuple(y.shape) == (shape[0], l1.out_len(shape[1]) if n is None else n)
    with pytest.raises(ValueError, match="empty"):
        cf.presliced_absmax_kernel(torch.empty((0, 2000), device="meta"), fold_bank, 100)
    assert _build._lib is None and cf.launches == cf.launches_flat == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(card):
    """Bit for bit, samples and peak, on the replay's banks and edges, and
    through `resample_presliced` and `_tp_step`."""
    for ri, ro, q, kind in _REPLAY_BANKS:
        bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
        for Q in (1, 511, 512, 513, 5000):
            T = (Q - 1) * bank.M + bank.W
            x = torch.from_numpy(_flat(3, T, 1, T + 3, seed=Q)).to(card)
            xs = x[1:1 + 3 * (T + 3)].reshape(3, T + 3)[:, :T]
            n0 = cf.launches
            y = tres.resample_presliced(xs, bank, Q)
            pk = cf.presliced_absmax_kernel(xs, bank, Q)
            assert cf.launches == n0 + 2
            assert _same_bits(y.cpu().numpy(), tres._presliced_fold(xs, bank, Q).cpu().numpy())
            assert _same_bits(pk.cpu().numpy(),
                              cf.presliced_absmax_reference(xs, bank, Q).cpu().numpy())


@pytest.mark.cuda
def test_flat_form_on_card(card):
    """A 96 kHz stereo file through `resample` (the batch SRC) on the card:
    one flat launch a call, bit for bit the twin of the padded signal and
    `resample_presliced` (the streamed form) of the same padded signal; at
    the default length and at a shorter one, from a row stride past the
    row."""
    import torch.nn.functional as F

    bank = design_cycle_bank(96000, 48000)
    frames = 96000 * 3 + 17
    x = torch.from_numpy(_signal(2, frames + 9, seed=23)).to(card)[:, :frames]
    for out_len in (None, bank.out_len(frames) - 1000):
        n_all, n_flat = cf.launches, cf.launches_flat
        y = tres.resample(x, bank, out_len=out_len)
        assert (cf.launches, cf.launches_flat) == (n_all + 1, n_flat + 1)
        n, Q, keep_T, pad_front, pad_back = tres._cycle_budget(frames, bank, out_len)
        xp = F.pad(x[:, :keep_T], (pad_front, pad_back))
        want = tres._presliced_fold(xp, bank, Q)[:, :n]
        streamed = tres.resample_presliced(xp, bank, Q)[:, :n]
        assert y.shape == (2, n)
        assert torch.equal(_bits_of(y), _bits_of(want))
        assert torch.equal(_bits_of(y), _bits_of(streamed))


def _bits_of(t):
    return t.contiguous().view(torch.int32).cpu()
