"""The batch graph's epilogue as one kernel pair, and its plain twin.

Everything between the SRC (or chain) output ``y (files, C, out_total)``
and the PCM the host downloads: the masked DC mean, gain, the per-file sum
of squares and peak of the result ``z``, TPDF dither keyed by (seed,
position), round, clip, routed-silent channels and, where asked, the
interleaved 16- or 24-bit payload.  The JAX package gets this from two XLA
fusions of `f9tpu/pipeline/graph.py:188-271` (plus `f9tpu/ops/devcodec.py`'s
pack) and never writes ``z``; no Pallas kernel computes it.  On the card it
is `f9tpu_torch/csrc/epilogue.cu`: pass 1 reads ``y`` once for the DC tile
sums, pass 2 reads it once more and writes the codes or the payload.

**The reductions have one order, a function of a row's own valid samples.**
A row (one file's channel) is cut into tiles of `TILE` samples anchored at
sample 0 and zero-padded to whole tiles.  Inside a tile the values are
converted to float64 exactly (a square of a float32 is exact in float64)
and summed by a halving tree: element i is added to element i + TILE/2,
then i + TILE/4, ... (`_tile_sums`; on the card each thread first halves
its own registers, then shared memory over thread index, then warp
shuffles).  The tile sums are added in ascending tile order from +0.0
(`_fold`), and a file's channels in ascending order; a float32 result is
rounded once.  A tile past a file's end adds +0.0, so a file's mean, RMS
and codes do not depend on the bucket length, its row or the batch width.

The wrapper rule, as for `src_kernel`: on a CUDA tensor `epilogue` launches
the kernel pair or raises; on a CPU tensor it runs `epilogue_reference`,
which the kernel is held to bit for bit.  ``launches`` counts the calls
that launched the pair; it is a plain integer raised under a lock.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch
import torch.nn.functional as F

from . import dither
from .devcodec import pack_interleaved

__all__ = ["TILE", "epilogue", "epilogue_reference", "gain_factor", "launches"]

#: samples per reduction tile (a power of two: the halving tree's width)
TILE = 4096
#: kernel pair launches since the count was last reset
launches = 0
_launch_lock = threading.Lock()
#: (device, C, silent channels) -> the kernel's (C,) uint8 mask on the device
_mute_masks: dict = {}
#: the most (row, tile) units the kernel indexes (32-bit ints)
_MAX_UNITS = 2**31 - 1

#: the kernel's output forms: planar int32 / int16 codes, interleaved payload
_OUT_MODES = {(None, torch.int32): 0, (None, torch.int16): 1, (16, None): 2, (24, None): 3}


def gain_factor(gain: float, gain_lin: torch.Tensor | None):
    """The gain ``z = (y - mean) * g`` applies: ``float32(gain)`` as a
    Python float (exact in float32, so torch's scalar rounding cannot move
    it), times the per-file ``gain_lin (files,)`` in float32 when given, as
    ``(files, 1, 1)``."""
    g = float(np.float32(gain))
    if gain_lin is None:
        return g
    return g * gain_lin.reshape(-1, 1, 1)


def _tile_sums(v: torch.Tensor) -> torch.Tensor:
    """float64 ``(..., n)`` -> ``(..., ceil(n / TILE))``: each tile's sum by
    the halving tree, the row zero-padded to whole tiles."""
    n = v.shape[-1]
    nt = -(-n // TILE)
    v = F.pad(v, (0, nt * TILE - n)).reshape(*v.shape[:-1], nt, TILE)
    h = TILE // 2
    while h:
        v = v[..., :h] + v[..., h:]
        h //= 2
    return v[..., 0]


def _fold(t: torch.Tensor) -> torch.Tensor:
    """``(..., n)`` float64 -> ``(...)``: ``((0 + t0) + t1) + ...``."""
    acc = torch.zeros(t.shape[:-1], dtype=torch.float64, device=t.device)
    for j in range(t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def epilogue_reference(y, out_frames, seeds_c, *, bits, remove_dc, gain, gain_lin=None,
                       keep=None, silent=(), packed=None, pos0=0, stats=True,
                       codes_dtype=torch.int32):
    """The plain PyTorch twin of `epilogue` (same arguments and results)."""
    files, C, total = y.shape
    keep = total if keep is None else keep
    dev = y.device
    yk = y[..., :keep]
    vmask = None
    if out_frames is not None:
        vmask = (torch.arange(keep, dtype=torch.int32, device=dev)[None, None, :]
                 < out_frames[:, None, None])
    mean = None
    if remove_dc:
        ym = torch.where(vmask, yk, torch.zeros((), device=dev))
        s = _fold(_tile_sums(ym.to(torch.float64)))
        mean = (s / torch.clamp(out_frames, min=1)[:, None]).to(torch.float32)
        yk = yk - mean[..., None]
    z = yk * gain_factor(gain, gain_lin)
    if vmask is not None:
        z = torch.where(vmask, z, torch.zeros((), device=dev))
    sumsq = peak = None
    if stats:
        z64 = z.to(torch.float64)
        per_ch = _fold(_tile_sums(z64 * z64))
        sumsq = torch.zeros((files,), dtype=torch.float64, device=dev)
        for c in range(C):
            sumsq = sumsq + per_ch[:, c]
        peak = (torch.amax(torch.abs(z).reshape(files, -1), dim=-1) if keep
                else torch.zeros((files,), device=dev))
    if seeds_c is not None:
        pos = pos0 + torch.arange(keep, dtype=torch.int64, device=dev)
        codes = dither.quantize_noise(z, bits, seeds_c[:, :, None], pos[None, None, :])
    else:
        codes = dither.quantize_noise(z, bits)
    kept = vmask
    if silent:
        loud = torch.ones((1, C, 1), dtype=torch.bool, device=dev)
        loud[:, list(silent)] = False
        kept = loud if kept is None else kept & loud
    if kept is not None:
        codes = torch.where(kept, codes, torch.zeros((), dtype=torch.int32, device=dev))
    if packed is not None:
        codes = pack_interleaved(codes, packed)
    elif codes_dtype != torch.int32:
        codes = codes.to(codes_dtype)
    return codes, sumsq, peak, mean


def _check(y, out_frames, seeds_c, gain_lin, keep, silent, packed, bits, remove_dc,
           codes_dtype):
    files, C, total = y.shape
    if y.dtype != torch.float32 or not y.is_contiguous():
        raise ValueError(f"epilogue takes a contiguous float32 (files, C, frames) "
                         f"tensor, got {y.dtype} contiguous={y.is_contiguous()}")
    if not 0 <= keep <= total:
        raise ValueError(f"keep {keep} outside [0, {total}]")
    if (packed, None if packed else codes_dtype) not in _OUT_MODES:
        raise ValueError(f"no epilogue output for packed={packed} dtype={codes_dtype}")
    if packed is not None and packed != bits:
        raise ValueError(f"a {packed}-bit payload of {bits}-bit codes")
    if remove_dc and out_frames is None:
        raise ValueError("the DC mean is taken over out_frames: pass them")
    for name, t, dtype, shape in (("out_frames", out_frames, torch.int32, (files,)),
                                  ("seeds", seeds_c, torch.int64, (files, C)),
                                  ("gain_lin", gain_lin, torch.float32, (files,))):
        if t is None:
            continue
        if t.device != y.device or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"epilogue {name}: expected contiguous {dtype} {shape} on "
                             f"{y.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if any(not 0 <= c < C for c in silent):
        raise ValueError(f"silent channels {silent} outside 0..{C - 1}")


def _mute_mask(dev, C: int, silent: tuple) -> torch.Tensor:
    """The (C,) uint8 mask of the silent channels on ``dev``, built and
    copied once per (device, C, channels) and kept (the copy is synchronous,
    so any stream may read it)."""
    key = (dev, C, silent)
    with _launch_lock:
        mask = _mute_masks.get(key)
    if mask is None:
        mask = torch.zeros((C,), dtype=torch.uint8)
        mask[list(silent)] = 1
        mask = mask.to(dev)
        with _launch_lock:
            mask = _mute_masks.setdefault(key, mask)
    return mask


def _launch(y, out_frames, seeds_c, *, bits, remove_dc, gain, gain_lin, keep, silent,
            packed, pos0, stats, codes_dtype):
    """One launch of the pair on ``y``'s device and current stream."""
    global launches
    files, C, total = y.shape
    n_tiles = -(-keep // TILE)
    if files * C * n_tiles > _MAX_UNITS:
        raise ValueError(f"{files} x {C} rows of {n_tiles} tiles exceed the kernel's "
                         f"{_MAX_UNITS} units")
    dev = y.device
    if packed is not None:
        codes = torch.empty((files, keep * C * (packed // 8)), dtype=torch.uint8, device=dev)
    else:
        codes = torch.empty((files, C, keep), dtype=codes_dtype, device=dev)
    mean = (torch.empty((files, C), dtype=torch.float32, device=dev)
            if remove_dc else None)
    sumsq = torch.empty((files,), dtype=torch.float64, device=dev) if stats else None
    peak = torch.empty((files,), dtype=torch.float32, device=dev) if stats else None
    if keep == 0 or files * C == 0:
        # no sample to reduce or write: the results of an empty span
        for t in (mean, sumsq, peak):
            if t is not None:
                t.zero_()
        return codes, sumsq, peak, mean
    rows = files * C
    # float64 tile sums of pass 1 and of the statistics, float32 tile peaks,
    # and one ticket per row (pass 1) and per file (pass 2) for the last
    # block's fold
    dc_tiles = torch.empty((rows, n_tiles) if remove_dc else (1,), dtype=torch.float64,
                           device=dev)
    sq_tiles = torch.empty((rows, n_tiles) if stats else (1,), dtype=torch.float64,
                           device=dev)
    pk_tiles = torch.empty((rows, n_tiles) if stats else (1,), dtype=torch.float32,
                           device=dev)
    tickets = torch.zeros((rows + files,), dtype=torch.int32, device=dev)
    s = float(1 << (bits - 1))
    mute = _mute_mask(dev, C, silent) if silent else None
    from ._build import load_library

    lib = load_library()

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.f9_epilogue(
            ptr(y), ptr(out_frames), ptr(seeds_c), ptr(gain_lin), ptr(mute), ptr(codes),
            ptr(sumsq), ptr(peak), ptr(mean), ptr(dc_tiles), ptr(sq_tiles), ptr(pk_tiles),
            ptr(tickets), files, C, total, keep, n_tiles, s, float(dither._clip_hi(s)),
            float(np.float32(gain)), int(pos0),
            _OUT_MODES[(packed, None if packed else codes_dtype)], int(remove_dc),
            int(stats), stream)
    if err != 0:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches += 1
    return codes, sumsq, peak, mean


def epilogue(y, out_frames, seeds_c, *, bits, remove_dc, gain, gain_lin=None, keep=None,
             silent=(), packed=None, pos0=0, stats=True, codes_dtype=torch.int32):
    """The epilogue over ``y (files, C, total)`` float32: returns ``(codes,
    sumsq, peak, mean)``.

    ``out_frames (files,)`` int32 is each file's valid length: positions at
    or past it are masked (``z = 0``) and write code 0; None masks nothing.
    ``seeds_c (files, C)`` int64 holds the per-(file, global channel)
    uint32 dither seeds (`dither.channel_seeds`); None quantizes without
    dither.  The noise of position t is keyed by ``pos0 + t``.
    ``remove_dc`` subtracts each row's mean over its valid span (float64,
    rounded to float32 once).  ``gain`` is a float rounded to float32, times
    ``gain_lin (files,)`` float32 when given.  ``keep`` (default ``total``)
    positions are written; ``silent`` lists channels written as zeros.

    ``codes`` is ``(files, C, keep)`` of ``codes_dtype`` (int32 or int16),
    or with ``packed`` (16 or 24, = ``bits``) the interleaved little-endian
    payload ``(files, keep * C * packed // 8)`` uint8.  With ``stats``,
    ``sumsq (files,)`` float64 is the sum of ``z**2`` over the file's
    channels and ``peak (files,)`` float32 the largest ``|z|``; ``mean
    (files, C)`` float32 is the DC mean when ``remove_dc``; the others are
    None."""
    keep = y.shape[-1] if keep is None else keep
    kw = dict(bits=bits, remove_dc=remove_dc, gain=gain, gain_lin=gain_lin, keep=keep,
              silent=tuple(silent), packed=packed, pos0=pos0, stats=stats,
              codes_dtype=codes_dtype)
    _check(y, out_frames, seeds_c, gain_lin, keep, kw["silent"], packed, bits, remove_dc,
           codes_dtype)
    if y.device.type == "cpu":
        return epilogue_reference(y, out_frames, seeds_c, **kw)
    return _launch(y, out_frames, seeds_c, **kw)
