"""The insert chain's convolutions and dynamics as hand-written CUDA
kernels, and their plain twins.

The JAX package runs the chain's long convolution as one on-device
``lax.scan`` (`f9tpu/ops/chain.py:128 _upols`, `:160 _upols_stream`), lets
XLA fuse the short FIR's W shifted products (`:85 _fir_fold`), the moving
average's window (`:873 _uniform_ma_past`) and the windowed maximum's
shifted maxima (`:902 _window_max_past`), and compiles the release
envelope's ``cummax`` and block scan (`:733
Compressor._slanted_cummax_stream`, `:703 _slanted_cummax`).  The port runs
five kernels in their place:

- `upols_mac` (`csrc/upols.cu`, ``f9_upols_mac``): the delay-line
  multiply-sum of a group of G UPOLS blocks in one launch, in float64 in
  `_delay_line_sum`'s halving-tree order, each component rounded to float32
  once; up to 32 taps a block stages H and the spectra in shared memory as
  float64 and a lane walks the tree in registers for 2 outputs.  Its twin
  `upols_mac_reference` is that formula per block;
- `fir_fold` (``f9_fir_fold``) and `ma_past` (``f9_ma_past``), in
  `csrc/fold.cu`: a thread computes 8 consecutive outputs and slides their
  window of samples through registers, the eager forms' float32 ops in
  their order.  Their twins are `chain._fir_fold_reference` and
  `chain._uniform_ma_past_reference`;
- `slanted_cummax` (``f9_slanted_cummax``, `csrc/dynamics.cu`): the release
  envelope of a chunk on the absolute `Compressor._ENV_BLOCK` grid, with
  its carried state, in one pass (a memset of its flags, then one launch:
  tiles claimed from a ticket, decoupled look-back inside an envelope block,
  each block's carry folded by its tiles); twin
  `chain.Compressor._slanted_cummax_stream_reference`;
- `window_max` (``f9_window_max``, the same file): the causal windowed
  maximum, the twin's doubling levels in registers (a warp streams a
  segment of a row, `wmax_segment_steps`) up to `WMAX_REG_MAX_W`, in shared
  memory up to `WMAX_STAGED_MAX_W`; twin `chain._window_max_past_reference`.

`chain._fir_fold`, `chain._uniform_ma_past`, `chain._window_max_past` and
`chain.Compressor._slanted_cummax_stream` dispatch between twin and kernel.
The wrapper rule, as for `src_kernel` and `epilogue`: on a CPU tensor the
twin runs; on any other tensor the kernel is launched on the current
stream, or the call raises (a failed build with nvcc's output, a refused
launch with CUDA's error, an input the kernel does not take); nothing falls
back.  Each kernel is held to its twin bit for bit.  ``launches_mac``,
``launches_fold``, ``launches_ma``, ``launches_env`` and ``launches_wmax``
count wrapper calls that launched; each is a plain integer raised under a
lock.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

__all__ = ["MAC_MAX_K", "upols_mac", "upols_mac_reference", "fir_fold", "ma_past",
           "slanted_cummax", "window_max", "env_tile_frames", "wmax_segment_steps", "launches_mac", "launches_fold", "launches_ma",
           "launches_env", "launches_wmax"]

#: kernel launches since the counts were last reset
launches_mac = 0
launches_fold = 0
launches_ma = 0
launches_env = 0
launches_wmax = 0
_launch_lock = threading.Lock()

#: the deepest delay line the MAC kernel takes (`csrc/upols.cu` MAC_MAX_K)
MAC_MAX_K = 64
#: the widest fold the kernel takes (`csrc/fold.cu` FOLD_MAX_W: its counter's
#: depth and, past 2,559 taps, a shared-memory limit raised above 48 KB)
FOLD_MAX_W = 5632
#: the envelope kernel's tiles, the frames one look-back publishes
#: (`csrc/dynamics.cu` ENV_Q_WIDE and ENV_Q_NARROW quads a thread): the wide
#: one where a call has at least `ENV_WIDE_MIN_TILES` of them (4 blocks for
#: each of an H100's 132 SMs), else the narrow one; and the longest block
#: (its in-block index j stays exact in float32)
ENV_TILE = 16384
ENV_TILE_NARROW = 2048
ENV_WIDE_MIN_TILES = 4 * 132
ENV_MAX_BLOCK = 1 << 24
#: the widest window the windowed maximum runs in registers (`csrc/dynamics.cu`
#: WMAX_REG_MAX_W: every shift within one warp step of `WMAX_STEP` positions),
#: and the warps its segments aim for (16 on each of an H100's 132 SMs)
WMAX_REG_MAX_W = 512
WMAX_STEP = 256
WMAX_REG_WARPS = 16 * 132
#: the widest window the windowed maximum stages in shared memory
#: (`csrc/dynamics.cu` WMAX_STAGED_MAX_W: two spans of 2048 + W - 1 floats in
#: a block's 227 KB); past it each level is a launch over device memory
#: through a scratch row
WMAX_STAGED_MAX_W = 27009


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


def _state_of(t: torch.Tensor, lead: tuple, device, what: str) -> None:
    if (t.dtype != torch.float32 or not t.is_contiguous() or t.device != device
            or tuple(t.shape) != lead):
        raise ValueError(f"the envelope kernel takes a contiguous float32 {what} of shape "
                         f"{lead} on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def env_tile_frames(rows: int, T: int, p0: int, B: int) -> int:
    """The envelope kernel's tile for ``rows`` rows of ``T`` frames from
    index ``p0`` of a ``B``-frame block: `ENV_TILE` where the rows hold at
    least `ENV_WIDE_MIN_TILES` such tiles (every block busy with few
    look-backs), else `ENV_TILE_NARROW`; never longer than B."""
    wide = -(-(p0 + T) // ENV_TILE) - p0 // ENV_TILE
    return min(ENV_TILE if rows * wide >= ENV_WIDE_MIN_TILES else ENV_TILE_NARROW, B)


def slanted_cummax(level: torch.Tensor, c: float, pos: int, m: torch.Tensor,
                   env_carry: torch.Tensor, block: int):
    """The envelope kernel: ``(env, m', env_carry')`` of
    `chain.Compressor._slanted_cummax_stream_reference` for the chunk
    ``level (..., T)`` float32 starting at absolute frame ``pos``, on the grid
    of ``block``-frame blocks (a power of two <= `ENV_MAX_BLOCK`), from the
    state ``m``, ``env_carry`` (shape ``level.shape[:-1]``, float32, on the
    same device).  The new state comes back as device tensors (no host
    sync); an empty chunk returns the state it was given.  Launches or
    raises."""
    global launches_env
    B = int(block)
    if B < 1 or B & (B - 1) or B > ENV_MAX_BLOCK:
        raise ValueError(f"the envelope kernel takes a block length that is a power of two "
                         f"<= {ENV_MAX_BLOCK}, got {block}")
    rows, T = _rows_of(level, "envelope")
    lead = tuple(level.shape[:-1])
    _state_of(m, lead, level.device, "m")
    _state_of(env_carry, lead, level.device, "env_carry")
    env = torch.empty_like(level)
    if rows == 0 or T == 0:
        return env, m, env_carry
    p0 = int(pos) % B
    tile = env_tile_frames(rows, T, p0, B)
    ntiles = -(-(p0 + T) // tile) - p0 // tile
    # the ticket, then one (status, value) word a tile; the kernel zeroes them
    scratch = torch.empty(2 * (1 + rows * ntiles), dtype=torch.float32, device=level.device)
    m_out, c_out = torch.empty_like(m), torch.empty_like(env_carry)
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(level.device):
        err = lib.f9_slanted_cummax(_ptr(level), _ptr(m), _ptr(env_carry), _ptr(env),
                                    _ptr(m_out), _ptr(c_out), _ptr(scratch), scratch.numel(),
                                    rows, T, p0, B, tile, float(np.float32(c)),
                                    _stream(level.device))
    if err != 0:
        raise RuntimeError(f"slanted_cummax kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches_env += 1
    return env, m_out, c_out


def wmax_segment_steps(rows: int, T: int) -> int:
    """Steps of `WMAX_STEP` positions a warp of the windowed maximum's
    register form streams: the rows' steps (``ceil((T + 3) / WMAX_STEP)`` a
    row, the grid starting up to 3 positions before the row on its 16-byte
    grid) spread over `WMAX_REG_WARPS` warps, at least 2 (each segment
    starts ``ceil((W - 1) / WMAX_STEP)`` steps early to warm its levels)."""
    steps = -(-(T + 3) // WMAX_STEP)
    return max(2, -(-rows * steps // WMAX_REG_WARPS))


def window_max(a: torch.Tensor, W: int) -> torch.Tensor:
    """The windowed-maximum kernel: ``out[m] = max a[m-W+1..m]`` along the
    last axis of a float32 tensor off the CPU, +0.0 read before the start,
    in `chain._window_max_past_reference`'s order, ``W >= 2``.  Launches or
    raises."""
    global launches_wmax
    W = int(W)
    if W < 2 or W >= 1 << 31:
        raise ValueError(f"the windowed-maximum kernel takes 2 <= W < 2^31, got {W}")
    rows, T = _rows_of(a, "windowed-maximum")
    y = torch.empty_like(a)
    if rows == 0 or T == 0:
        return y
    scratch = torch.empty_like(a) if W > WMAX_STAGED_MAX_W else None
    seg = wmax_segment_steps(rows, T) if W <= WMAX_REG_MAX_W else 0
    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(a.device):
        err = lib.f9_window_max(_ptr(a), _ptr(y),
                                ctypes.c_void_p(None if scratch is None else scratch.data_ptr()),
                                rows, T, W, seg, _stream(a.device))
    if err != 0:
        raise RuntimeError(f"window_max kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches_wmax += 1
    return y
