"""The insert chain's convolutions as hand-written CUDA kernels, and their
plain twins.

The JAX package runs the chain's long convolution as one on-device
``lax.scan`` (`f9tpu/ops/chain.py:128 _upols`, `:160 _upols_stream`) and
lets XLA fuse the short FIR's W shifted products (`:85 _fir_fold`) and the
moving average's window (`:873 _uniform_ma_past`) into one pass each.  The
port runs three kernels in their place:

- `upols_mac` (`csrc/upols.cu`, ``f9_upols_mac``): the delay-line
  multiply-sum of a group of G UPOLS blocks in one launch, in float64 in
  `_delay_line_sum`'s halving-tree order, each component rounded to float32
  once; up to 32 taps a block stages H and the spectra in shared memory as
  float64 and a lane walks the tree in registers for 2 outputs.  Its twin
  `upols_mac_reference` is that formula per block;
- `fir_fold` (``f9_fir_fold``: 8 consecutive outputs a thread, their
  window of samples slid through registers) and `ma_past` (``f9_ma_past``:
  one thread an output), in `csrc/fold.cu`, the eager forms' float32 ops in
  their order.  Their twins are `chain._fir_fold_reference` and
  `chain._uniform_ma_past_reference`, and `chain._fir_fold` /
  `chain._uniform_ma_past` dispatch between twin and kernel.

The wrapper rule, as for `src_kernel` and `epilogue`: on a CPU tensor the
twin runs; on any other tensor the kernel is launched on the current
stream, or the call raises (a failed build with nvcc's output, a refused
launch with CUDA's error); nothing falls back.  Each kernel is held to its
twin bit for bit.  ``launches_mac``, ``launches_fold`` and ``launches_ma``
count launches; each is a plain integer raised under a lock.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

__all__ = ["MAC_MAX_K", "upols_mac", "upols_mac_reference", "fir_fold", "ma_past",
           "launches_mac", "launches_fold", "launches_ma"]

#: kernel launches since the counts were last reset
launches_mac = 0
launches_fold = 0
launches_ma = 0
_launch_lock = threading.Lock()

#: the deepest delay line the MAC kernel takes (`csrc/upols.cu` MAC_MAX_K)
MAC_MAX_K = 64
#: the widest fold the kernel takes (`csrc/fold.cu` FOLD_MAX_W: its counter's
#: depth and, past 2,559 taps, a shared-memory limit raised above 48 KB)
FOLD_MAX_W = 5632


def _delay_line_sum(p: torch.Tensor) -> torch.Tensor:
    """``p.sum(0)`` in a fixed order: a halving tree, in place.  While n
    rows remain, rows ``[0, n - h)`` add rows ``[h, n)``, ``h = ceil(n /
    2)``; an odd n leaves row ``h - 1`` as it is for the next level.  The
    order depends on K alone, never on the rows behind it."""
    n = p.shape[0]
    while n > 1:
        h = (n + 1) // 2
        p[:n - h].add_(p[h:n])
        n = h
    return p[0]


def upols_mac_reference(buf: torch.Tensor, H: torch.Tensor, G: int) -> torch.Tensor:
    """The plain twin of `upols_mac`: for each block g of the group,
    ``_delay_line_sum(X * H)`` in complex128 over the delay line ``X =
    buf[g + K - 1], buf[g + K - 2], ..., buf[g]`` (newest first), rounded to
    complex64 once.  Every product of two float32 numbers is exact in
    float64, so each component of a product is rounded once whatever code
    forms it."""
    K = H.shape[0]
    H128 = H.to(torch.complex128)
    Y = torch.empty((G, *buf.shape[1:]), dtype=torch.complex64, device=buf.device)
    for g in range(G):
        Y[g] = _delay_line_sum(torch.flip(buf[g:g + K], (0,)) * H128).to(torch.complex64)
    return Y


def _h_rows(lead: tuple, hlead: tuple) -> int:
    """How many rows of H the flat signal rows of ``lead`` map onto (row r
    takes H's row ``r // (rows / Hrows)``): H's leading axes, right-aligned,
    must be ``lead``'s first axes followed by ones, or all ones."""
    hlead = (1,) * (len(lead) - len(hlead)) + tuple(hlead)
    if len(hlead) != len(lead):
        raise ValueError(f"H's rows {hlead} do not broadcast against {lead}")
    j = max((i for i, n in enumerate(hlead) if n != 1), default=-1)
    if tuple(hlead[:j + 1]) != tuple(lead[:j + 1]):
        raise ValueError(f"the MAC kernel maps signal rows {lead} onto H's rows {hlead} "
                         f"only as a leading block")
    return int(np.prod(hlead, dtype=np.int64))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _mac_launch(buf: torch.Tensor, H: torch.Tensor, G: int) -> torch.Tensor:
    global launches_mac
    K = H.shape[0]
    lead, Nf = tuple(buf.shape[1:-1]), buf.shape[-1]
    if not 1 <= K <= MAC_MAX_K:
        raise ValueError(f"the MAC kernel takes 1 <= K <= {MAC_MAX_K}, got {K}")
    if buf.shape[0] != K - 1 + G or G < 1:
        raise ValueError(f"a group of {G} blocks needs {K - 1 + G} spectra, got {buf.shape[0]}")
    for name, t in (("spectra", buf), ("H", H)):
        if t.dtype != torch.complex64 or not t.is_contiguous() or t.device != buf.device:
            raise ValueError(f"the MAC kernel takes contiguous complex64 {name} on "
                             f"{buf.device}, got {t.dtype} on {t.device}")
    if H.shape[-1] != Nf:
        raise ValueError(f"H has {H.shape[-1]} bins, the spectra {Nf}")
    rows = int(np.prod(lead, dtype=np.int64))
    Y = torch.empty((G, *lead, Nf), dtype=torch.complex64, device=buf.device)
    if rows == 0:
        return Y
    h_rows = _h_rows(lead, tuple(H.shape[1:-1]))
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(buf.device):
        err = lib.f9_upols_mac(_ptr(buf), _ptr(H), _ptr(Y), rows, rows // h_rows, h_rows, Nf,
                               K, G, _stream(buf.device))
    if err != 0:
        raise RuntimeError(f"upols_mac kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches_mac += 1
    return Y


def upols_mac(buf: torch.Tensor, H: torch.Tensor, G: int) -> torch.Tensor:
    """``Y (G, *lead, Nf)`` complex64, ``Y[g] = sum_k buf[K - 1 + g - k] *
    H[k]`` for the spectra ``buf (K - 1 + G, *lead, Nf)`` complex64 (the K -
    1 carried from earlier blocks first, then the group's G, oldest first)
    and the partitioned IR ``H (K, *Hlead, Nf)``, which broadcasts over
    ``lead`` from its first axes.  On a CPU tensor the twin; otherwise the
    kernel (H complex64, both contiguous) or an exception."""
    if buf.device.type == "cpu":
        return upols_mac_reference(buf, H, G)
    return _mac_launch(buf, H, G)


def _rows_of(x: torch.Tensor, what: str) -> tuple[int, int]:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"the {what} kernel takes a contiguous float32 tensor, "
                         f"got {x.dtype} contiguous={x.is_contiguous()}")
    T = x.shape[-1]
    return (x.numel() // T if T else 0), T


def fir_fold(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The fold kernel: ``out[n] = sum_k taps[k] * x[n-k]`` along the last
    axis of a float32 tensor off the CPU, with 2 <= W <= `FOLD_MAX_W`
    float32 taps on the same device, in `chain._fir_fold_reference`'s
    order.  Launches or raises."""
    global launches_fold
    W = int(taps.shape[-1]) if taps.dim() == 1 else -1
    if not 2 <= W <= FOLD_MAX_W:
        raise ValueError(f"the fold kernel takes 2 <= W <= {FOLD_MAX_W} taps in one axis, "
                         f"got {tuple(taps.shape)}")
    if taps.dtype != torch.float32 or not taps.is_contiguous() or taps.device != x.device:
        raise ValueError(f"the fold kernel takes contiguous float32 taps on {x.device}, "
                         f"got {taps.dtype} on {taps.device}")
    rows, T = _rows_of(x, "fold")
    y = torch.empty_like(x)
    if rows == 0 or T == 0:
        return y
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.f9_fir_fold(_ptr(x), _ptr(taps), _ptr(y), rows, T, W, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"fir_fold kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches_fold += 1
    return y


def ma_past(x: torch.Tensor, win: int) -> torch.Tensor:
    """The moving-average kernel: ``out[n] = (x[n] + x[n-1] + ... +
    x[n-win+1]) * f32(1 / win)`` along the last axis of a float32 tensor
    off the CPU, summed newest first, ``win >= 2``.  Launches or raises."""
    global launches_ma
    win = int(win)
    if win < 2 or win >= 1 << 31:
        raise ValueError(f"the moving-average kernel takes 2 <= win < 2^31, got {win}")
    rows, T = _rows_of(x, "moving-average")
    y = torch.empty_like(x)
    if rows == 0 or T == 0:
        return y
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(x.device):
        err = lib.f9_ma_past(_ptr(x), _ptr(y), rows, T, win, float(np.float32(1.0 / win)),
                             _stream(x.device))
    if err != 0:
        raise RuntimeError(f"ma_past kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches_ma += 1
    return y
