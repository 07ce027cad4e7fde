"""The insert chain (port of `f9tpu/ops/chain.py`), batch and streamed.

A :class:`Chain` is an ordered stack of in-graph stages applied to the
resampled signal at the output rate, before latency trimming: the
external-processor loop of the original application (play out through
outboard gear, record back) as device code.  It has real group delay, which
calibration measures and trim removes, and real ring-out, which sizes the
reverb-mode capture.

Stages are built from host numpy data.  A chain hashes and compares by its
content signature, and `Chain.sig_str()` / `tail_frames()` equal the JAX
package's for the same stages, so the calibration cache keys agree between
the two packages.  `chain_from_jax` builds the port's chain from a JAX one.

Numerics, as in the JAX package:

- short FIR inserts (FIR taps, truncated biquad IRs up to `FIR_FOLD_MAX`
  taps) run as `_fir_fold`, a shifted-multiply fold with a fixed pairwise
  association, so each output's float32 op sequence does not depend on its
  position in the buffer;
- long convolutions (reverb IRs, long FIR/biquad IRs) run as
  uniform-partitioned overlap-save (`_upols`) on ``torch.fft``: groups of
  `UPOLS_GROUP` 2B-frame blocks, each group one batched rFFT, one launch of
  the K-deep frequency-domain multiply-sum and one batched irFFT, so memory
  is O((K + G) * N) whatever the capture length;
- dynamics (compressor, expander, limiter) use causal moving averages
  (`_uniform_ma_past`, a fixed-order fold for every window), a slanted
  running maximum for the linear-in-dB release (`Compressor._slanted_cummax`,
  blocks on an absolute grid with a carried state) and a windowed maximum
  (`_window_max_past`, doubling): no per-sample recurrence.

Streaming (`Chain.stream_grid`, `stream_init`, `apply_stream`): each stage
carries its own state from chunk to chunk, so the chunked output equals the
whole signal's `apply` bit for bit on either device.  Fold stages carry
their last input frames (`_ring_stream`); FFT stages carry the UPOLS delay
line on the absolute block grid (chunks are multiples of `stream_grid`);
dynamics carry their moving-average tails and the release envelope's state
on the absolute `_ENV_BLOCK` grid.  No library convolution runs anywhere in
the chain: a convolution's algorithm, and so its rounding, is picked by
shape.  On the CPU the transcendentals go through `_whole_vectors`, which
keeps torch's scalar loop tails out of every call.

On a card the fold, the moving average, UPOLS's multiply-sum, the release
envelope and the windowed maximum are hand-written CUDA kernels
(`ops/chain_kernels.py`, `csrc/fold.cu`, `csrc/upols.cu`,
`csrc/dynamics.cu`), each equal bit for bit to the plain form the CPU runs
(the `*_reference` functions).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..spans import span
from . import chain_kernels
from .chain_kernels import _delay_line_sum  # noqa: F401  (the tree's one definition)

__all__ = [
    "Chain",
    "Gain",
    "Delay",
    "FIRInsert",
    "Biquad",
    "Saturator",
    "StereoWidth",
    "Compressor",
    "Expander",
    "Limiter",
    "ConvolutionReverb",
    "fft_convolve",
    "chain_from_jax",
]


def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float: a scalar operand of a
    float32 tensor op then carries exactly the JAX package's np.float32."""
    return float(np.float32(v))


def _array_sig(a: np.ndarray) -> tuple:
    """Content signature of a host array: shape + 128-bit blake2b of the raw
    bytes (a CRC's collision odds would serve the wrong chain's calibration
    in a long-lived cache)."""
    a = np.ascontiguousarray(a)
    return (a.shape, hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest())


#: FIR-type stages fold up to this many taps and run UPOLS above it.
FIR_FOLD_MAX = 1024

#: torch's grain: an elementwise CPU loop of more elements than this is split
#: into one contiguous range per thread (`at::parallel_for`)
_CPU_GRAIN = 32768
#: elements per step of torch's vectorized CPU loops, rounded up: two
#: AVX-512 vectors of float32 are 32
_CPU_STEP = 64


def _whole_vectors(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise float32 transcendental (``log10``,
    ``pow``, ``tanh``), each element's value independent of the tensor's
    size.

    torch's CPU loop gives each thread ``ceil(n / threads)`` elements once
    ``n`` passes the grain and runs each range in steps of two SIMD vectors,
    the ragged end in scalar code, whose ``pow`` rounds apart from the
    vector code by an ulp.  So one sample could take two values in a chunk
    and in the whole signal.  Here the flat tensor is zero-padded until every
    thread's range is a whole number of `_CPU_STEP` steps, which leaves no
    scalar tail anywhere.  On CUDA every element runs one device function,
    and ``fn`` is called as it is."""
    if x.device.type != "cpu":
        return fn(x)
    n = x.numel()
    threads = max(1, torch.get_num_threads())
    m = -(-n // _CPU_STEP) * _CPU_STEP
    while True:
        parts = 1 if m <= _CPU_GRAIN else min(threads, -(-m // _CPU_GRAIN))
        m2 = -(-m // (_CPU_STEP * parts)) * (_CPU_STEP * parts)
        if m2 == m:
            break
        m = m2
    if m == n and x.is_contiguous():
        return fn(x)
    flat = F.pad(x.reshape(-1), (0, m - n))
    return fn(flat)[:n].reshape(x.shape)


def _fir_fold(x: torch.Tensor, taps: np.ndarray,
              device_taps: torch.Tensor | None = None) -> torch.Tensor:
    """Causal FIR along the last axis, ``out[n] = sum_k taps[k] * x[n-k]``:
    one multiply for a single tap; else `_fir_fold_reference` on a CPU
    tensor and the fold kernel (`chain_kernels.fir_fold`, bitwise the same)
    on any other, with ``device_taps`` (the same taps on ``x``'s device, as
    a stage keeps them: `_FIRStage._fold_taps`) or a copy made for the
    call."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    if taps.shape[0] == 1:
        return x * float(taps[0])
    if x.device.type == "cpu":
        return _fir_fold_reference(x, taps)
    if device_taps is None:
        device_taps = torch.from_numpy(taps.copy()).to(x.device)
    return chain_kernels.fir_fold(x.contiguous(), device_taps)


def _fir_fold_reference(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Causal FIR along the last axis, ``out[n] = sum_k taps[k] * x[n-k]``,
    with position-invariant numerics: W shifted scalar products combined in
    a fixed pairwise tree.  The node at level l, index i sums taps
    ``[i*2^l, min((i+1)*2^l, W))`` as left + right; a node without a right
    sibling is carried up unchanged.  That is the JAX package's association,
    and it keeps rounding at O(eps*log2 W).

    The JAX form lists all W full-size terms and lets XLA fuse them; eager
    PyTorch would materialise every one (about 300 GB at W = 1024 on an
    8-file stereo 60 s capture).  Here the taps are walked in order with a
    stack of complete subtrees, merging two equal-sized ones as soon as
    both exist, so at most log2(W) + 2 full-size tensors are live.  The
    leftover stack, sizes strictly decreasing, is merged right to left,
    which is exactly how the carried-up nodes meet in the level-wise tree."""
    taps = np.asarray(taps, np.float32).reshape(-1)
    W = int(taps.shape[0])
    if W == 1:
        return x * float(taps[0])
    T = x.shape[-1]
    xp = F.pad(x, (W - 1, 0))
    stack: list[tuple[int, torch.Tensor]] = []
    for k in range(W):
        node = xp[..., W - 1 - k:W - 1 - k + T] * float(taps[k])
        size = 1
        while stack and stack[-1][0] == size:
            node = stack.pop()[1].add_(node)         # left + right, in place
            size *= 2
        stack.append((size, node))
    acc = stack.pop()[1]
    while stack:
        acc = stack.pop()[1].add_(acc)
    return acc


def _fft_block_size(ir_len: int, block: int = 4096) -> int:
    """The block B the UPOLS convolvers pick for an IR of ``ir_len``: the
    delay line stays at most 64 blocks deep."""
    B = int(block)
    while ir_len > 64 * B:
        B *= 2
    return B


def _partition_ir(ir: np.ndarray, B: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side IR partitioning: (K, N//2+1) float32 real/imag planes."""
    ir_len = int(ir.shape[0])
    N = 2 * B
    K = -(-ir_len // B)
    irp = np.pad(ir.astype(np.float64), (0, K * B - ir_len)).reshape(K, B)
    H = np.fft.rfft(irp, n=N, axis=-1)
    return (np.ascontiguousarray(H.real, np.float32),
            np.ascontiguousarray(H.imag, np.float32))


def _spectrum(parts: list[tuple[np.ndarray, np.ndarray]], device) -> torch.Tensor:
    """Partitioned spectra of C IRs as one ``(K, C, 1, Nf)`` tensor on
    ``device`` (the trailing 1 broadcasts over signal rows): complex64 on
    the card, where the multiply-sum kernel reads it, complex128 on the
    CPU, where its plain twin forms the products (the values are the same
    float32 numbers)."""
    re = np.stack([p[0] for p in parts], axis=1)[:, :, None, :]
    im = np.stack([p[1] for p in parts], axis=1)[:, :, None, :]
    H = torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)
    return H.to(torch.complex128) if H.device.type == "cpu" else H


def _cached_spectrum(cache: dict, key, irs, B: int, device) -> torch.Tensor:
    """`_spectrum` of the rows of ``irs`` made once per (key, B, device) and
    kept in a stage's ``cache``: a streamed stage would otherwise partition
    its IR and copy it to the card again for every chunk."""
    k = (key, B, str(device))
    H = cache.get(k)
    if H is None:
        H = cache[k] = _spectrum(
            [_partition_ir(np.asarray(r, np.float32), B) for r in irs], device)
    return H


#: UPOLS blocks transformed together and summed by one kernel launch
UPOLS_GROUP = 32
#: signal rows of one FFT call off the CPU: every transform there is of
#: ``(UPOLS_GROUP, UPOLS_FFT_ROWS)`` windows (8 stereo files fill it)
UPOLS_FFT_ROWS = 16


def _fft_rows(rows: int, device: torch.device) -> int:
    """Rows of one UPOLS FFT call: all of them on the CPU, where MKL gives a
    row the same bits in a batch of ``G x rows`` whatever ``rows`` is
    (`tests/test_torch_chain_kernels.py`), and `UPOLS_FFT_ROWS` elsewhere:
    cuFFT at n = 32768 rounds a row in a batch of 32 x 1 or 32 x 2 apart
    from one of 32 x 16 (`chip_smoke.py` 14a), so a fixed batch keeps a
    file's bytes off the rows beside it."""
    return rows if device.type == "cpu" else UPOLS_FFT_ROWS


def _upols_core(wins: torch.Tensor, carried: torch.Tensor, H: torch.Tensor, B: int):
    """Uniform-partitioned overlap-save over the windows ``wins (*lead, nb,
    2B)`` (each the previous and the current B-frame input block) with the
    partitioned IR spectrum ``H (K, ..., Nf)``, broadcast against ``lead``.
    ``carried (K - 1, *lead, Nf)`` complex64 holds the spectra of the K - 1
    blocks before the first window, oldest first.  Returns ``(y (*lead, nb *
    B), carried')``, ``carried'`` the last K - 1 spectra, newest last.

    The JAX package scans the blocks one at a time; the only state the scan
    carries is the delay line, and a block's spectrum depends on its input
    alone.  So a group of `UPOLS_GROUP` blocks runs as one batched rFFT of
    its windows, written behind the K - 1 carried spectra in one buffer; one
    `chain_kernels.upols_mac` for every block's ``Y_g = sum_k X[g-k] *
    H[k]``; one batched irFFT; and the K - 1 newest spectra are copied to
    the front of the next group's buffer.

    Every FFT call has one shape, ``(G, R, 2B)`` with R = `_fft_rows`: the
    last group is padded with windows that are never read back, and off the
    CPU the rows are cut into tiles of R, the last padded.  The FFT
    libraries pick their algorithm by the batch (MKL at n >= 16384 on
    several threads, and at an n with a large prime factor, rounds a batch
    of one row apart from one of two; cuFFT at n = 32768 a batch of 32 or 64
    apart from one of 512), so a batch that followed the group's length or
    the row count would make the streamed form depend on the chunk size and
    a file's bytes on the files beside it.  What is left to rest on is that
    a row's transform does not depend on where in the batch it sits
    (`chip_smoke.py` 14a holds cuFFT to it).  The multiply-sum is formed in
    float64 in `_delay_line_sum`'s order, fixed by K, on either device.
    cuFFT, MKL and pocketfft round apart, so the card, the CPU and the JAX
    package agree to a bound, not bitwise.  A float64 signal is transformed
    in float64 (complex128 spectra, which the card's kernel refuses)."""
    lead, nb = wins.shape[:-2], wins.shape[-2]
    K, Nf, G = H.shape[0], B + 1, UPOLS_GROUP
    rows = math.prod(lead)
    R = max(1, _fft_rows(rows, wins.device))
    whole = R == rows                # one tile: the FFTs read and write the buffers
    if H.device.type != "cpu":
        H = H.contiguous()
    spec = torch.promote_types(wins.dtype, torch.complex64)
    bufs = [torch.empty((K - 1 + G, rows, Nf), dtype=spec, device=wins.device)
            for _ in range(2 if nb > G else 1)]
    bufs[0][:K - 1] = carried.reshape(K - 1, rows, Nf)
    win = wins.new_zeros((G, R, 2 * B))
    Yt = None if whole else torch.zeros((G, R, Nf), dtype=torch.complex64, device=wins.device)
    y = wins.new_empty((rows, nb, B))
    for n, i0 in enumerate(range(0, nb, G)):
        buf = bufs[n % len(bufs)]
        g = min(G, nb - i0)
        src = torch.movedim(wins[..., i0:i0 + g, :], -2, 0)          # (g, *lead, 2B)
        if whole:
            win[:g].view(g, *lead, 2 * B).copy_(src)
            torch.fft.rfft(win, n=2 * B, dim=-1, out=buf[K - 1:])
        else:
            src = src.reshape(g, rows, 2 * B)
            for r0 in range(0, rows, R):
                r = min(R, rows - r0)
                win[:g, :r] = src[:, r0:r0 + r]
                buf[K - 1:, r0:r0 + r] = torch.fft.rfft(win, n=2 * B, dim=-1)[:, :r]
        Y = chain_kernels.upols_mac(buf[:K - 1 + g].view(K - 1 + g, *lead, Nf), H, g)
        Y = Y.view(g, rows, Nf)
        for r0 in range(0, rows, R):
            r = min(R, rows - r0)
            if whole:
                Yp = Y if g == G else torch.cat([Y, Y.new_zeros((G - g, rows, Nf))])
            else:
                Yt[:g, :r] = Y[:, r0:r0 + r]
                Yp = Yt
            z = torch.fft.irfft(Yp, n=2 * B, dim=-1)                 # (G, R, 2B)
            y[r0:r0 + r, i0:i0 + g] = torch.movedim(z[:g, :r, B:], 0, 1)
        if i0 + g < nb:
            bufs[(n + 1) % len(bufs)][:K - 1] = buf[g:g + K - 1]
    return (y.view(*lead, nb * B),
            buf[g:g + K - 1].view(K - 1, *lead, Nf).clone())


def _upols(x: torch.Tensor, H: torch.Tensor, B: int) -> torch.Tensor:
    """Causal convolution of ``x (..., T)`` with the partitioned IR ``H
    (K, ..., Nf)`` (broadcast against ``x``'s leading axes), truncated to
    T: `_upols_core` over ceil(T/B) blocks from zero state, one zero block
    in front.  Work O(T/B * K * N log N), memory O((K + G) * N) beside the
    signal."""
    T = x.shape[-1]
    nb = max(1, -(-T // B))
    lead = torch.broadcast_shapes(x.shape[:-1], H.shape[1:-1])
    xp = F.pad(x, (B, nb * B - T)).expand(*lead, (nb + 1) * B)
    carried, _ = _upols_state(lead, H.shape[0], B, x.device)
    return _upols_core(xp.unfold(-1, 2 * B, B), carried, H, B)[0][..., :T]


def _upols_state(lead, K: int, B: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The zero UPOLS state for rows ``lead``: the spectra of the K - 1
    blocks before the stream's start ``(K - 1, *lead, B + 1)`` complex64,
    oldest first and newest last, and the previous input block ``(*lead,
    B)``."""
    return (torch.zeros((K - 1, *lead, B + 1), dtype=torch.complex64, device=device),
            torch.zeros((*lead, B), dtype=torch.float32, device=device))


def _upols_stream(x: torch.Tensor, state, H: torch.Tensor, B: int):
    """Streaming form of `_upols`, bitwise equal to it when the chunk ``x
    (..., T)`` starts on the absolute block grid and T is a multiple of B:
    each block's window holds the values the whole signal's window holds
    and goes through the same rFFT, multiply-sum and irFFT on the same rows,
    however the blocks fall into groups.  ``state`` is (the last K - 1
    spectra, previous input block); returns ``(y, state')``."""
    carried, prev = state
    T = x.shape[-1]
    if T % B:
        raise ValueError(f"a streamed FFT stage takes chunks of whole "
                         f"{B}-frame blocks, got {T} frames")
    if T == 0:
        return torch.empty_like(x), state
    lead = torch.broadcast_shapes(x.shape[:-1], H.shape[1:-1])
    z = torch.cat([prev.expand(*lead, B), x.expand(*lead, T)], dim=-1)
    y, carried = _upols_core(z.unfold(-1, 2 * B, B), carried, H, B)
    return y, (carried, z[..., T:].clone())


def _upols_rows(x: torch.Tensor, H: torch.Tensor, B: int) -> torch.Tensor:
    """`_upols` of every row of ``x (..., T)`` with one IR spectrum ``H
    (K, 1, Nf)``, rows flattened as `fft_convolve` flattens them."""
    lead, T = x.shape[:-1], x.shape[-1]
    return _upols(x.reshape(-1, T), H, B).reshape(*lead, T)


def _upols_channels(x: torch.Tensor, H: torch.Tensor, B: int) -> torch.Tensor:
    """`_upols` of ``x (..., C, T)`` with one IR per channel, ``H (K, C, 1,
    Nf)``: the C spectra ride a channel axis of the delay line, so the input
    is transformed once."""
    C = H.shape[1]
    lead, T = x.shape[:-2], x.shape[-1]
    y = _upols(torch.movedim(x, -2, 0).reshape(C, -1, T), H, B)
    return torch.movedim(y.reshape(C, *lead, T), 0, -2)


def fft_convolve(x: torch.Tensor, ir: np.ndarray, block: int = 4096) -> torch.Tensor:
    """Causal convolution of the last axis with a long IR, truncated to
    ``x``'s length (uniform-partitioned overlap-save, `_upols`)."""
    ir = np.asarray(ir, np.float32).reshape(-1)
    ir_len = int(ir.shape[0])
    if ir_len == 0:
        return torch.zeros_like(x)
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    B = _fft_block_size(ir_len, block)
    H = _spectrum([_partition_ir(ir, B)], x.device)[:, 0]        # (K, 1, Nf)
    return _upols_rows(x, H, B).to(x.dtype)


def _fft_convolve_multi(x: torch.Tensor, irs: np.ndarray,
                        block: int = 4096) -> torch.Tensor:
    """Per-channel FFT convolution in one block loop: ``x (..., C, T)``
    with ``irs (C, ir_len)`` -> ``(..., C, T)``."""
    C, ir_len = irs.shape
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    B = _fft_block_size(ir_len, block)
    H = _spectrum([_partition_ir(np.asarray(irs[c], np.float32), B)
                   for c in range(C)], x.device)                 # (K, C, 1, Nf)
    return _upols_channels(x, H, B).to(x.dtype)


def _ring_stream(stage, x: torch.Tensor, ring: torch.Tensor, rate: int):
    """Exact continuation of a causal, position-invariant stage whose whole
    state is its last ``tail_frames`` input frames: apply the stage to the
    ring and the chunk, keep the chunk's span, and keep the new last frames
    as the ring.  The fold and the delay compute each output from the same
    inputs in the same order wherever it sits, so this is bitwise."""
    if ring.shape[-1] == 0:
        return stage.apply(x, rate), ring
    z = torch.cat([ring, x], dim=-1)
    y = stage.apply(z, rate)[..., ring.shape[-1]:]
    return y, z[..., z.shape[-1] - ring.shape[-1]:].clone()


def _uniform_ma_past(x: torch.Tensor, win: int) -> torch.Tensor:
    """Causal moving average ``out[n] = (sum_{k<win} x[n-k]) / win``:
    ``x`` itself for ``win <= 1``; else `_uniform_ma_past_reference` on a
    CPU tensor and the moving-average kernel (`chain_kernels.ma_past`,
    bitwise the same) on any other."""
    if win <= 1:
        return x
    if x.device.type == "cpu":
        return _uniform_ma_past_reference(x, win)
    return chain_kernels.ma_past(x.contiguous(), win)


def _uniform_ma_past_reference(x: torch.Tensor, win: int) -> torch.Tensor:
    """Causal moving average ``out[n] = (sum_{k<win} x[n-k]) / win`` as a
    fixed-order fold of ``win`` shifted copies (k = 0 first), so each
    output's float32 op sequence is independent of its position: the
    streamed dynamics rest on it.  One accumulator is added into in place.
    Every window folds; the JAX package convolves windows above 4096 (an
    85 ms attack at 48 kHz), and a convolution's rounding follows the
    algorithm the library picks for the shape, which would make the
    streamed form depend on the chunk size there."""
    if win <= 1:
        return x
    xp = F.pad(x, (win - 1, 0))
    T = x.shape[-1]
    acc = xp[..., win - 1:win - 1 + T].clone()
    for k in range(1, win):
        acc.add_(xp[..., win - 1 - k:win - 1 - k + T])
    return acc * _f32(1.0 / win)


def _window_max_past(a: torch.Tensor, W: int) -> torch.Tensor:
    """Causal windowed maximum ``out[m] = max a[m-W+1..m]`` (positions
    before the start read as 0): ``a`` itself for ``W <= 1``; else
    `_window_max_past_reference` on a CPU tensor and the windowed-maximum
    kernel (`chain_kernels.window_max`, bitwise the same) on any other."""
    if W <= 1:
        return a
    if a.device.type == "cpu":
        return _window_max_past_reference(a, W)
    return chain_kernels.window_max(a.contiguous(), W)


def _window_max_past_reference(a: torch.Tensor, W: int) -> torch.Tensor:
    """Causal windowed maximum ``out[m] = max a[m-W+1..m]`` (positions
    before the start read as 0, the neutral element for the non-negative
    attenuation streams it is fed).  log2(W) shifted maxima by doubling;
    max is exact, so any combine order gives the same bits."""
    if W <= 1:
        return a
    T = a.shape[-1]
    f, s = a, 1
    while s * 2 <= W:
        f = torch.maximum(f, F.pad(f, (s, 0))[..., :T])
        s *= 2
    rem = W - s
    if rem:
        f = torch.maximum(f, F.pad(f, (rem, 0))[..., :T])
    return f


class Gain:
    """Scalar gain stage."""

    channel_local = True

    def __init__(self, db: float):
        self.db = float(db)

    def signature(self) -> tuple:
        return ("gain", round(self.db, 9))

    def tail_frames(self, rate: int) -> int:
        return 0

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        return y * _f32(10.0 ** (self.db / 20.0))


class Delay:
    """Pure delay (an outboard unit's transport latency, which calibration
    measures)."""

    channel_local = True

    def __init__(self, seconds: float):
        if seconds < 0:
            raise ValueError("delay must be non-negative")
        self.seconds = float(seconds)

    def frames(self, rate: int) -> int:
        return int(round(self.seconds * rate))

    def signature(self) -> tuple:
        return ("delay", round(self.seconds, 9))

    def tail_frames(self, rate: int) -> int:
        return self.frames(rate)

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        d = self.frames(rate)
        if d == 0:
            return y
        return F.pad(y, (d, 0))[..., :y.shape[-1]]


class _FIRStage:
    """What FIRInsert and Biquad share: their taps (`_taps`) fold up to
    `FIR_FOLD_MAX` and run UPOLS above it, batch and streamed alike."""

    channel_local = True

    def _taps(self, rate: int) -> np.ndarray:
        raise NotImplementedError

    def _block(self, rate: int) -> tuple[np.ndarray, int]:
        """(float32 taps, UPOLS block B, or 0 where they fold)."""
        h = self._taps(rate)
        return h, (0 if h.shape[0] <= FIR_FOLD_MAX else _fft_block_size(h.shape[0]))

    def _spectrum(self, rate: int, B: int, device) -> torch.Tensor:
        return _cached_spectrum(self._spectra, rate, [self._taps(rate)], B, device)[:, 0]

    def _fold_taps(self, rate: int, device) -> torch.Tensor | None:
        """The fold kernel's taps on ``device``, copied once per (rate,
        device) and kept beside the stage's spectra; None on the CPU, where
        the fold reads them from the host."""
        if torch.device(device).type == "cpu":
            return None
        k = ("fold", rate, str(device))
        t = self._spectra.get(k)
        if t is None:
            t = self._spectra[k] = torch.from_numpy(self._taps(rate).copy()).to(device)
        return t

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        h, B = self._block(rate)
        if not B:
            return _fir_fold(y, h, self._fold_taps(rate, y.device))
        return _upols_rows(y, self._spectrum(rate, B, y.device), B)

    def stream_grid(self, rate: int) -> int:
        return max(1, self._block(rate)[1])

    def stream_state(self, rate: int, channels: int, device=None):
        """The fold's input ring ``(channels, taps - 1)``, or the UPOLS
        state (delay line, previous block) for ``channels`` rows."""
        dev = resolve_device(device)
        h, B = self._block(rate)
        if not B:
            return torch.zeros((channels, h.shape[0] - 1), device=dev)
        return _upols_state((channels,), -(-h.shape[0] // B), B, dev)

    def apply_stream(self, x: torch.Tensor, state, rate: int, pos: int):
        """One chunk ``x (channels, T)`` with exact continuation; an UPOLS
        stage needs T and ``pos`` on its block grid (`stream_grid`)."""
        _, B = self._block(rate)
        if not B:
            return _ring_stream(self, x, state, rate)
        return _upols_stream(x, state, self._spectrum(rate, B, x.device), B)


class FIRInsert(_FIRStage):
    """A causal FIR processor with its uncompensated group delay (a
    linear-phase FIR delays by (W-1)/2 frames; calibration trims it)."""

    def __init__(self, taps):
        self.taps = np.asarray(taps, np.float32).reshape(-1)
        if self.taps.size == 0:
            raise ValueError("FIR needs at least one tap")
        self._spectra: dict = {}

    def signature(self) -> tuple:
        return ("fir", _array_sig(self.taps))

    def tail_frames(self, rate: int) -> int:
        return int(self.taps.shape[0]) - 1

    def _taps(self, rate: int) -> np.ndarray:
        return self.taps


class Biquad(_FIRStage):
    """A second-order IIR EQ section (RBJ audio-EQ-cookbook forms) run as
    its impulse response, truncated where the float32 quantum is reached;
    the IR is sampled for the actual session rate at apply time."""

    TYPES = ("lowpass", "highpass", "peaking", "lowshelf", "highshelf")

    def __init__(self, kind: str, freq_hz: float, q: float = 0.70710678,
                 gain_db: float = 0.0, max_ir_seconds: float = 2.0):
        if kind not in self.TYPES:
            raise ValueError(f"kind must be one of {self.TYPES}, got {kind!r}")
        if freq_hz <= 0 or q <= 0:
            raise ValueError("freq_hz and q must be positive")
        self.kind = kind
        self.freq_hz = float(freq_hz)
        self.q = float(q)
        self.gain_db = float(gain_db)
        self.max_ir_seconds = float(max_ir_seconds)
        self._ir_cache: dict[int, np.ndarray] = {}
        self._spectra: dict = {}

    def signature(self) -> tuple:
        return ("biquad", self.kind, round(self.freq_hz, 6), round(self.q, 9),
                round(self.gain_db, 9), round(self.max_ir_seconds, 6))

    def coefficients(self, rate: int) -> tuple[np.ndarray, np.ndarray]:
        """Normalised (b, a) with a[0] == 1 (RBJ audio EQ cookbook)."""
        A = 10.0 ** (self.gain_db / 40.0)
        w0 = 2.0 * np.pi * min(self.freq_hz, 0.49 * rate) / rate
        cw, sw = np.cos(w0), np.sin(w0)
        alpha = sw / (2.0 * self.q)
        k = self.kind
        if k == "lowpass":
            b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
            a = np.array([1 + alpha, -2 * cw, 1 - alpha])
        elif k == "highpass":
            b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
            a = np.array([1 + alpha, -2 * cw, 1 - alpha])
        elif k == "peaking":
            b = np.array([1 + alpha * A, -2 * cw, 1 - alpha * A])
            a = np.array([1 + alpha / A, -2 * cw, 1 - alpha / A])
        elif k == "lowshelf":
            s = 2.0 * np.sqrt(A) * alpha
            b = A * np.array([(A + 1) - (A - 1) * cw + s,
                              2 * ((A - 1) - (A + 1) * cw),
                              (A + 1) - (A - 1) * cw - s])
            a = np.array([(A + 1) + (A - 1) * cw + s,
                          -2 * ((A - 1) + (A + 1) * cw),
                          (A + 1) + (A - 1) * cw - s])
        else:  # highshelf
            s = 2.0 * np.sqrt(A) * alpha
            b = A * np.array([(A + 1) + (A - 1) * cw + s,
                              -2 * ((A - 1) + (A + 1) * cw),
                              (A + 1) + (A - 1) * cw - s])
            a = np.array([(A + 1) - (A - 1) * cw + s,
                          2 * ((A - 1) - (A + 1) * cw),
                          (A + 1) - (A - 1) * cw - s])
        return (b / a[0]).astype(np.float64), (a / a[0]).astype(np.float64)

    def impulse_response(self, rate: int) -> np.ndarray:
        """float64 IR truncated where the remaining envelope is below the
        float32 quantum (1e-10).  The render window is sized from the pole
        radius r: the envelope decays ~ r^n, so it needs log(1e-10)/log(r)
        frames (``max_ir_seconds`` is a floor, 64 s the hard bound), and
        truncation follows a pole-radius envelope tracker, not small
        samples, which a high-Q low section passes through every
        half-period."""
        cached = self._ir_cache.get(rate)
        if cached is not None:
            return cached
        b, a = self.coefficients(rate)
        r = min(0.999999, float(np.sqrt(max(a[2], 0.0))))
        need = (int(np.log(1e-10) / np.log(r)) + 16 if 0.0 < r < 1.0 else 16)
        n_max = max(16, int(self.max_ir_seconds * rate),
                    min(need, 64 * rate))
        try:
            from scipy.signal import lfilter

            imp = np.zeros(n_max)
            imp[0] = 1.0
            h = lfilter(b, a, imp)
            env = np.maximum.accumulate(np.abs(h)[::-1])[::-1]
            past = np.nonzero(env < 1e-10)[0]
            if past.size and past[0] > 8:
                h = h[: past[0] + 1]
        except ImportError:       # pragma: no cover - scipy is present here
            h = np.zeros(n_max)
            x1 = x2 = y1 = y2 = 0.0
            env = 0.0
            for n in range(n_max):
                xn = 1.0 if n == 0 else 0.0
                yn = b[0] * xn + b[1] * x1 + b[2] * x2 - a[1] * y1 - a[2] * y2
                h[n] = yn
                x2, x1 = x1, xn
                y2, y1 = y1, yn
                env = max(abs(yn), env * r)
                if n > 8 and env < 1e-10:
                    h = h[: n + 1]
                    break
        self._ir_cache[rate] = h
        return h

    def tail_frames(self, rate: int) -> int:
        return int(self.impulse_response(rate).shape[0]) - 1

    def _taps(self, rate: int) -> np.ndarray:
        return self.impulse_response(rate).astype(np.float32)


class Saturator:
    """Memoryless waveshaper: ``out = (1-mix)*y + mix * shape(drive*y) *
    10^(trim_db/20)`` with ``tanh`` (tanh(g*x)/tanh(g)), ``soft`` (cubic
    1.5u - 0.5u^3 on u = clip(g*x, -1, 1)) or ``hard`` (clip(g*x, -1, 1))."""

    KINDS = ("tanh", "soft", "hard")
    channel_local = True

    def __init__(self, kind: str = "tanh", drive_db: float = 0.0,
                 mix: float = 1.0, trim_db: float = 0.0):
        if kind not in self.KINDS:
            raise ValueError(f"kind must be one of {self.KINDS}, got {kind!r}")
        if not 0.0 <= mix <= 1.0:
            raise ValueError(f"mix must be in [0, 1], got {mix}")
        if not -100.0 <= drive_db <= 100.0:
            raise ValueError(f"drive_db out of range [-100, 100]: {drive_db}")
        self.kind = kind
        self.drive_db = float(drive_db)
        self.mix = float(mix)
        self.trim_db = float(trim_db)

    def signature(self) -> tuple:
        return ("sat", self.kind, round(self.drive_db, 9),
                round(self.mix, 9), round(self.trim_db, 9))

    def tail_frames(self, rate: int) -> int:
        return 0

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        g = np.float32(10.0 ** (self.drive_db / 20.0))
        if self.kind == "tanh":
            # normalisation 1/tanh(g) in float64; for tiny drive tanh(g) ~ g
            denom = float(np.tanh(np.float64(g))) or float(g)
            shaped = _whole_vectors(torch.tanh, y * float(g)) * _f32(1.0 / denom)
        elif self.kind == "soft":
            u = torch.clamp(y * float(g), -1.0, 1.0)
            shaped = 1.5 * u - 0.5 * u * u * u
        else:  # hard
            shaped = torch.clamp(y * float(g), -1.0, 1.0)
        shaped = shaped * _f32(10.0 ** (self.trim_db / 20.0))
        if self.mix >= 1.0:
            return shaped
        return _f32(1.0 - self.mix) * y + _f32(self.mix) * shaped


class StereoWidth:
    """Mid/side width on a stereo pair: side scales by ``width``.  A 1-D
    signal (the calibration impulse) is pure mid and passes unchanged."""

    channel_local = False

    def __init__(self, width: float):
        if not 0.0 <= width <= 4.0:
            raise ValueError(f"width must be in [0, 4], got {width}")
        self.width = float(width)

    def signature(self) -> tuple:
        return ("width", round(self.width, 9))

    def tail_frames(self, rate: int) -> int:
        return 0

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        if y.ndim < 2:
            return y
        if y.shape[-2] != 2:
            raise ValueError(
                f"StereoWidth needs a stereo channel axis, got shape {tuple(y.shape)}")
        l, r = y[..., 0, :], y[..., 1, :]
        m = 0.5 * (l + r)
        s = _f32(0.5 * self.width) * (l - r)
        return torch.stack([m + s, m - s], dim=-2)


class Compressor:
    """Feed-forward, channel-linked compressor without serial recurrence.

    Detector: causal moving mean square over ``detector_ms``, maximum over
    channels.  Envelope: instant attack, linear-in-dB release,
    ``env[n] = max_{k<=n}(level_db[k] - c*(n-k))`` (`_slanted_cummax`).
    Gain computer: soft knee of ``knee_db`` around ``threshold_db`` with
    slope ``1 - 1/ratio``, smoothed by a causal ``attack_ms`` moving average.
    Zero signal latency."""

    channel_local = False

    def __init__(self, threshold_db: float = -24.0, ratio: float = 4.0,
                 attack_ms: float = 5.0, release_db_per_s: float = 80.0,
                 knee_db: float = 6.0, makeup_db: float = 0.0,
                 detector_ms: float = 1.0):
        if ratio < 1.0:
            raise ValueError(f"ratio must be >= 1, got {ratio}")
        if release_db_per_s <= 0:
            raise ValueError("release_db_per_s must be positive")
        if attack_ms < 0 or detector_ms < 0 or knee_db < 0:
            raise ValueError("attack_ms/detector_ms/knee_db must be >= 0")
        self.threshold_db = float(threshold_db)
        self.ratio = float(ratio)
        self.attack_ms = float(attack_ms)
        self.release_db_per_s = float(release_db_per_s)
        self.knee_db = float(knee_db)
        self.makeup_db = float(makeup_db)
        self.detector_ms = float(detector_ms)

    def signature(self) -> tuple:
        return ("comp", round(self.threshold_db, 9), round(self.ratio, 9),
                round(self.attack_ms, 9), round(self.release_db_per_s, 9),
                round(self.knee_db, 9), round(self.makeup_db, 9),
                round(self.detector_ms, 9))

    def tail_frames(self, rate: int) -> int:
        # release horizon: frames for 120 dB of gain recovery, plus windows
        horizon = int(np.ceil(120.0 / self.release_db_per_s * rate))
        win_det = max(1, int(round(self.detector_ms * rate / 1000.0)))
        win_att = max(1, int(round(self.attack_ms * rate / 1000.0)))
        return horizon + win_det + win_att

    #: block length of the slanted cummax: c*B stays ~1e2, so float32 keeps
    #: ~1e-5 dB of envelope resolution for any file length
    _ENV_BLOCK = 1 << 17

    @staticmethod
    def _slanted_cummax(level_db: torch.Tensor, c: float) -> torch.Tensor:
        """``env[n] = max_{k<=n}(level[k] - c*(n-k))`` exactly: the streamed
        form over the whole signal from position 0."""
        init = torch.full(level_db.shape[:-1], -1e9, dtype=torch.float32,
                          device=level_db.device)
        return Compressor._slanted_cummax_stream(level_db, c, 0, init, init)[0]

    @staticmethod
    def _slanted_cummax_stream(level_db: torch.Tensor, c: float, pos: int,
                               m: torch.Tensor, env_carry: torch.Tensor):
        """``(env, m', env_carry')`` of the chunk ``level_db`` starting at
        absolute position ``pos``, on the grid of `_ENV_BLOCK` (read at call
        time): `_slanted_cummax_stream_reference` on a CPU tensor and the
        envelope kernel (`chain_kernels.slanted_cummax`, bitwise the same)
        on any other."""
        if level_db.device.type == "cpu":
            return Compressor._slanted_cummax_stream_reference(level_db, c, pos, m, env_carry)
        return chain_kernels.slanted_cummax(level_db.contiguous(), c, pos, m.contiguous(),
                                            env_carry.contiguous(), Compressor._ENV_BLOCK)

    @staticmethod
    def _slanted_cummax_stream_reference(level_db: torch.Tensor, c: float, pos: int,
                                         m: torch.Tensor, env_carry: torch.Tensor):
        """The slanted cummax of a chunk starting at absolute position
        ``pos``, on the absolute grid of `_ENV_BLOCK`-frame blocks: within a
        block ``cummax(level + c*j) - c*j`` (j the frame's index in its
        block), then the maximum with the previous block's last value
        decayed by ``c*(j+1)``.  The state is ``m``, the running maximum of
        ``level + c*j`` over the part of the current block already seen
        (-1e9 at a block's start), and ``env_carry``, the envelope at the
        end of the previous block.  The chunk is walked in pieces that end
        on the grid; maximum is exact, so a block cut anywhere gives the
        whole block's bits.  Returns ``(env, m', env_carry')``."""
        B = Compressor._ENV_BLOCK
        cf = _f32(c)
        out = torch.empty_like(level_db)
        T = level_db.shape[-1]
        a = 0
        while a < T:
            j0 = (pos + a) % B
            n = min(T - a, B - j0)
            # the piece's in-block indices j (exact in float32 below 2^24)
            j = torch.arange(j0, j0 + n, dtype=torch.float32, device=level_db.device)
            r = j * cf
            s = torch.maximum(
                torch.cummax(level_db[..., a:a + n] + r, dim=-1).values, m[..., None])
            env = torch.maximum(s - r, env_carry[..., None] - cf * (j + 1.0))
            out[..., a:a + n] = env
            if j0 + n == B:
                env_carry = env[..., -1]
                m = torch.full_like(m, -1e9)
            else:
                m = s[..., -1]
            a += n
        return out, m, env_carry

    def _gr_from_env(self, env_db: torch.Tensor) -> torch.Tensor:
        """Unsmoothed gain reduction (dB, <= 0): the soft-knee computer."""
        over = env_db - _f32(self.threshold_db)
        slope = _f32(1.0 - 1.0 / self.ratio)
        zero = torch.zeros((), dtype=torch.float32, device=env_db.device)
        if self.knee_db > 0:
            k2 = _f32(self.knee_db / 2.0)
            knee_gr = -slope * torch.square(over + k2) / _f32(2.0 * self.knee_db)
            return torch.where(over <= -k2, zero,
                               torch.where(over >= k2, -slope * over, knee_gr))
        return torch.clamp(-slope * over, max=0.0)

    def _windows(self, rate: int) -> tuple[int, int]:
        """(detector window, attack window) in frames at ``rate``."""
        return (max(1, int(round(self.detector_ms * rate / 1000.0))),
                max(1, int(round(self.attack_ms * rate / 1000.0))))

    def _state(self, rate: int, lead: tuple, device) -> tuple:
        """Zero state for a signal with leading axes ``lead`` (``(...,
        channels)``, or ``()`` for a 1-D signal): the detector's input tail,
        the unsmoothed gain's tail on the linked axis, and the envelope's
        running maximum and carry (-1e9, the batch form's virgin carry).
        The zero tails are the batch form's front padding."""
        win, win_a = self._windows(rate)
        link = (*lead[:-1], 1) if lead else ()
        return (torch.zeros((*lead, win - 1), device=device),
                torch.zeros((*link, win_a - 1), device=device),
                torch.full(link, -1e9, device=device),
                torch.full(link, -1e9, device=device))

    def stream_state(self, rate: int, channels: int, device=None) -> tuple:
        return self._state(rate, (channels,), resolve_device(device))

    def apply_stream(self, y: torch.Tensor, state: tuple, rate: int,
                     pos: int) -> tuple:
        """One chunk starting at absolute position ``pos``, bitwise equal to
        that span of `apply` over the whole signal: the moving averages
        carry their input tails and the release envelope its state on the
        absolute block grid."""
        x_tail, gr_tail, m, env_carry = state
        win, win_a = self._windows(rate)
        T = y.shape[-1]
        xin = torch.cat([x_tail, y], dim=-1) if win > 1 else y
        p = _uniform_ma_past(torch.square(xin), win)[..., xin.shape[-1] - T:]
        if y.ndim >= 2:
            p = torch.amax(p, dim=-2, keepdim=True)      # stereo/bus link
        level_db = 10.0 * _whole_vectors(torch.log10, torch.clamp(p, min=1e-20))
        env_db, m, env_carry = self._slanted_cummax_stream(
            level_db, self.release_db_per_s / rate, pos, m, env_carry)
        gr = self._gr_from_env(env_db)
        if win_a > 1:
            gc = torch.cat([gr_tail, gr], dim=-1)
            gr = _uniform_ma_past(gc, win_a)[..., gc.shape[-1] - T:]
            gr_tail = gc[..., gc.shape[-1] - (win_a - 1):].clone()
        if win > 1:
            x_tail = xin[..., xin.shape[-1] - (win - 1):].clone()
        gain = _whole_vectors(lambda v: torch.pow(10.0, v),
                              (gr + _f32(self.makeup_db)) * _f32(1.0 / 20.0))
        return y * gain, (x_tail, gr_tail, m, env_carry)

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        """The whole signal: the streamed form from a zero state at 0."""
        return self.apply_stream(y, self._state(rate, tuple(y.shape[:-1]), y.device),
                                 rate, 0)[0]


class Expander(Compressor):
    """Downward expander / noise gate on the Compressor's machinery (the
    release envelope doubles as the gate's hold).  Below ``threshold_db``
    the gain falls ``ratio - 1`` dB per dB of shortfall, floored at
    ``-range_db``.  ``attack_ms`` defaults to 0: a slow attack can hold the
    calibration impulse under the detection threshold."""

    def __init__(self, threshold_db: float = -50.0, ratio: float = 2.0,
                 attack_ms: float = 0.0, release_db_per_s: float = 200.0,
                 range_db: float = 60.0, makeup_db: float = 0.0,
                 detector_ms: float = 5.0):
        if range_db <= 0:
            raise ValueError(f"range_db must be positive, got {range_db}")
        super().__init__(threshold_db=threshold_db, ratio=ratio,
                         attack_ms=attack_ms,
                         release_db_per_s=release_db_per_s, knee_db=0.0,
                         makeup_db=makeup_db, detector_ms=detector_ms)
        self.range_db = float(range_db)

    def signature(self) -> tuple:
        return ("expand", round(self.threshold_db, 9), round(self.ratio, 9),
                round(self.attack_ms, 9), round(self.release_db_per_s, 9),
                round(self.range_db, 9), round(self.makeup_db, 9),
                round(self.detector_ms, 9))

    def tail_frames(self, rate: int) -> int:
        horizon = int(np.ceil((120.0 + self.range_db)
                              / self.release_db_per_s * rate))
        win_det = max(1, int(round(self.detector_ms * rate / 1000.0)))
        win_att = max(1, int(round(self.attack_ms * rate / 1000.0)))
        return horizon + win_det + win_att

    def _gr_from_env(self, env_db: torch.Tensor) -> torch.Tensor:
        under = torch.clamp(env_db - _f32(self.threshold_db), max=0.0)
        return torch.clamp(under * _f32(self.ratio - 1.0),
                           -_f32(self.range_db), 0.0)


class Limiter:
    """Lookahead brickwall limiter, channel-linked.  The signal is delayed
    by ``lookahead_ms`` (L frames, real group delay that calibration trims);
    the gain comes from the undelayed peak:

    - ``atten = max(0, level_db - ceiling_db)``,
    - release by the Compressor's slanted cummax at ``release_db_per_s``,
    - spread over the lookahead by a windowed maximum of L+1,
    - ramped by a moving average of L+1,
    - ``out[n] = x[n-L] * 10^(-S[n]/20)``.

    Each ramp window contains position n-L, so the played sample stays at
    the ceiling (in exact arithmetic; rounding can poke ~1 ulp above)."""

    channel_local = False

    def __init__(self, ceiling_db: float = -0.3, lookahead_ms: float = 1.5,
                 release_db_per_s: float = 300.0):
        if not -60.0 <= ceiling_db <= 0.0:
            raise ValueError(f"ceiling_db out of range [-60, 0]: {ceiling_db}")
        if lookahead_ms <= 0:
            raise ValueError("lookahead_ms must be positive")
        if release_db_per_s <= 0:
            raise ValueError("release_db_per_s must be positive")
        self.ceiling_db = float(ceiling_db)
        self.lookahead_ms = float(lookahead_ms)
        self.release_db_per_s = float(release_db_per_s)

    def signature(self) -> tuple:
        return ("limit", round(self.ceiling_db, 9),
                round(self.lookahead_ms, 9),
                round(self.release_db_per_s, 9))

    def lookahead_frames(self, rate: int) -> int:
        return max(1, int(round(self.lookahead_ms * rate / 1000.0)))

    def tail_frames(self, rate: int) -> int:
        L = self.lookahead_frames(rate)
        horizon = int(np.ceil(120.0 / self.release_db_per_s * rate))
        return 3 * L + horizon

    def _state(self, rate: int, lead: tuple, device) -> tuple:
        """Zero state for leading axes ``lead``: the signal's delay ring, the
        release output's and the spread attenuation's rings on the linked
        axis, and the envelope's running maximum and carry."""
        L = self.lookahead_frames(rate)
        link = (*lead[:-1], 1) if lead else ()
        return (torch.zeros((*lead, L), device=device),
                torch.zeros((*link, L), device=device),
                torch.zeros((*link, L), device=device),
                torch.full(link, -1e9, device=device),
                torch.full(link, -1e9, device=device))

    def stream_state(self, rate: int, channels: int, device=None) -> tuple:
        return self._state(rate, (channels,), resolve_device(device))

    def apply_stream(self, x: torch.Tensor, state: tuple, rate: int,
                     pos: int) -> tuple:
        """One chunk starting at absolute position ``pos``, bitwise equal to
        that span of `apply`; the zero rings are the batch form's front
        padding (0 is neutral for the non-negative attenuation)."""
        L = self.lookahead_frames(rate)
        x_tail, ar_tail, b_tail, m, env_carry = state
        T = x.shape[-1]
        lvl = torch.amax(torch.abs(x), dim=-2, keepdim=True) if x.ndim >= 2 else torch.abs(x)
        level_db = 20.0 * _whole_vectors(torch.log10, torch.clamp(lvl, min=1e-20))
        atten = torch.clamp(level_db - _f32(self.ceiling_db), min=0.0)
        atten_rel, m, env_carry = Compressor._slanted_cummax_stream(
            atten, self.release_db_per_s / rate, pos, m, env_carry)
        ac = torch.cat([ar_tail, atten_rel], dim=-1)
        b = _window_max_past(ac, L + 1)[..., L:]
        bc = torch.cat([b_tail, b], dim=-1)
        s_db = _uniform_ma_past(bc, L + 1)[..., L:]
        xc = torch.cat([x_tail, x], dim=-1)
        out = xc[..., :T] * _whole_vectors(lambda v: torch.pow(10.0, v),
                                           s_db * _f32(-1.0 / 20.0))
        return out, (xc[..., T:].clone(), ac[..., T:].clone(),
                     bc[..., T:].clone(), m, env_carry)

    def apply(self, x: torch.Tensor, rate: int) -> torch.Tensor:
        """The whole signal: the streamed form from a zero state at 0."""
        return self.apply_stream(x, self._state(rate, tuple(x.shape[:-1]), x.device),
                                 rate, 0)[0]


class ConvolutionReverb:
    """Convolution with a measured impulse response: ``out = dry*y +
    wet*(y*ir)``.  ``ir`` is ``(ir_len,)`` (shared by all channels) or
    ``(channels, ir_len)``, matched positionally to the signal's channels."""

    channel_local = True

    def __init__(self, ir, wet: float = 1.0, dry: float = 0.0):
        ir = np.asarray(ir, np.float32)
        if ir.ndim == 1:
            ir = ir[None]
        if ir.ndim != 2 or ir.shape[-1] == 0:
            raise ValueError("ir must be (ir_len,) or (channels, ir_len)")
        self.ir = ir
        self.wet = float(wet)
        self.dry = float(dry)
        self._spectra: dict = {}

    def signature(self) -> tuple:
        return ("convreverb", _array_sig(self.ir),
                round(self.wet, 9), round(self.dry, 9))

    def tail_frames(self, rate: int) -> int:
        return int(self.ir.shape[-1]) - 1

    def _spectrum(self, B: int, device) -> torch.Tensor:
        """``(K, IR channels, 1, Nf)``, made once per device."""
        return _cached_spectrum(self._spectra, None, self.ir, B, device)

    def _check_channels(self, y: torch.Tensor) -> None:
        if y.shape[-2] != self.ir.shape[0]:
            raise ValueError(
                f"multichannel IR has {self.ir.shape[0]} channels but the "
                f"signal's channel axis is {y.shape[-2]}")

    def _mix(self, wet: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        out = _f32(self.wet) * wet
        if self.dry:
            out = out + _f32(self.dry) * y
        return out

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        B = self.stream_grid(rate)
        H = self._spectrum(B, y.device)
        if self.ir.shape[0] == 1 or y.ndim < 2:
            # a 1-D signal (the calibration impulse) is measured through
            # the first IR channel: group delay is per unit, not per channel
            wet = _upols_rows(y, H[:, 0], B)
        else:
            self._check_channels(y)
            wet = _upols_channels(y, H, B)
        return self._mix(wet, y)

    def stream_grid(self, rate: int) -> int:
        return _fft_block_size(int(self.ir.shape[-1]))

    def stream_state(self, rate: int, channels: int, device=None):
        """UPOLS state for ``channels`` rows sharing a mono IR, or for one
        row per IR channel (the layout of `_upols_channels`)."""
        B = self.stream_grid(rate)
        K = -(-int(self.ir.shape[-1]) // B)
        lead = (channels,) if self.ir.shape[0] == 1 else (self.ir.shape[0], 1)
        return _upols_state(lead, K, B, resolve_device(device))

    def apply_stream(self, x: torch.Tensor, state, rate: int, pos: int):
        """One chunk ``x (channels, T)`` on the block grid."""
        B = self.stream_grid(rate)
        H = self._spectrum(B, x.device)
        if self.ir.shape[0] == 1:
            wet, state = _upols_stream(x, state, H[:, 0], B)
        else:
            self._check_channels(x)
            wet, state = _upols_stream(x[:, None, :], state, H, B)
            wet = wet[:, 0, :]
        return self._mix(wet, x), state


class Chain:
    """An ordered stack of stages, hashable by content (a calibration-cache
    key component)."""

    def __init__(self, *stages):
        for s in stages:
            for attr in ("signature", "tail_frames", "apply"):
                if not callable(getattr(s, attr, None)):
                    raise TypeError(
                        f"stage {s!r} lacks required method {attr}()")
        self.stages = tuple(stages)
        self._sig = tuple(s.signature() for s in self.stages)
        self._spans = tuple("f9.chain." + type(s).__name__.lower() for s in self.stages)

    def signature(self) -> tuple:
        return self._sig

    def sig_str(self) -> str:
        """Compact signature for persistent cache keys (the JAX package's
        digest, so both packages share calibration entries)."""
        return hashlib.blake2b(repr(self._sig).encode(),
                               digest_size=16).hexdigest()

    def tail_frames(self, rate: int) -> int:
        """Worst-case ring-out of the whole chain at ``rate``."""
        return sum(s.tail_frames(rate) for s in self.stages)

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        with span("f9.chain"):
            for s, name in zip(self.stages, self._spans):
                with span(name):
                    y = s.apply(y, rate)
        return y

    def stream_grid(self, rate: int) -> int:
        """Chunk-length granule of exact streaming: the lcm of the stages'
        UPOLS blocks (1 when no stage convolves by FFT).  Chunks that are
        multiples of it start on every FFT stage's block grid."""
        return math.lcm(1, *(int(s.stream_grid(rate)) for s in self.stages
                             if hasattr(s, "stream_grid")))

    def stream_init(self, rate: int, channels: int, device=None) -> tuple:
        """Each stage's zero streaming state on ``device`` (default CUDA):
        its own (`stream_state`) where it has one, else a zero ring of its
        ``tail_frames`` input frames (a delay), or None (memoryless)."""
        dev = resolve_device(device)
        states = []
        for s in self.stages:
            if hasattr(s, "apply_stream"):
                states.append(s.stream_state(rate, channels, dev))
            else:
                t = int(s.tail_frames(rate))
                states.append(torch.zeros((channels, t), device=dev) if t else None)
        return tuple(states)

    def apply_stream(self, y: torch.Tensor, states: tuple, rate: int,
                     pos: int) -> tuple:
        """One chunk ``y (channels, T)`` starting at absolute position
        ``pos`` of the chain's input, each stage threading its state:
        bitwise equal to that span of `apply` over the whole signal.  With
        `stream_grid` > 1, T and ``pos`` must be multiples of it.  Returns
        ``(out, states')``."""
        new = []
        for s, st in zip(self.stages, states):
            if hasattr(s, "apply_stream"):
                y, st = s.apply_stream(y, st, rate, pos)
            elif st is not None:
                y, st = _ring_stream(s, y, st, rate)
            else:
                y = s.apply(y, rate)
            new.append(st)
        return y, tuple(new)

    def __hash__(self):
        return hash(self._sig)

    def __eq__(self, other):
        return isinstance(other, Chain) and self._sig == other._sig

    def __repr__(self):
        return f"Chain({', '.join(type(s).__name__ for s in self.stages)})"


#: how each JAX stage's attributes map onto the port's constructor
_FROM_JAX = {
    "Gain": lambda s: Gain(s.db),
    "Delay": lambda s: Delay(s.seconds),
    "FIRInsert": lambda s: FIRInsert(np.asarray(s.taps)),
    "Biquad": lambda s: Biquad(s.kind, s.freq_hz, q=s.q, gain_db=s.gain_db,
                               max_ir_seconds=s.max_ir_seconds),
    "Saturator": lambda s: Saturator(s.kind, drive_db=s.drive_db, mix=s.mix,
                                     trim_db=s.trim_db),
    "StereoWidth": lambda s: StereoWidth(s.width),
    "Compressor": lambda s: Compressor(
        threshold_db=s.threshold_db, ratio=s.ratio, attack_ms=s.attack_ms,
        release_db_per_s=s.release_db_per_s, knee_db=s.knee_db,
        makeup_db=s.makeup_db, detector_ms=s.detector_ms),
    "Expander": lambda s: Expander(
        threshold_db=s.threshold_db, ratio=s.ratio, attack_ms=s.attack_ms,
        release_db_per_s=s.release_db_per_s, range_db=s.range_db,
        makeup_db=s.makeup_db, detector_ms=s.detector_ms),
    "Limiter": lambda s: Limiter(ceiling_db=s.ceiling_db,
                                 lookahead_ms=s.lookahead_ms,
                                 release_db_per_s=s.release_db_per_s),
    "ConvolutionReverb": lambda s: ConvolutionReverb(np.asarray(s.ir),
                                                     wet=s.wet, dry=s.dry),
}


def chain_from_jax(chain) -> Chain:
    """The port's :class:`Chain` for a JAX ``f9tpu.ops.chain.Chain``, built
    from the stages' attributes (host numpy taps and IRs, floats, kinds)
    without importing the JAX package.  The result's signature equals the
    source's; a stage kind the port lacks raises TypeError."""
    stages = []
    for s in chain.stages:
        make = _FROM_JAX.get(type(s).__name__)
        if make is None:
            raise TypeError(f"no port of chain stage {type(s).__name__}")
        stages.append(make(s))
    out = Chain(*stages)
    if out.signature() != tuple(chain.signature()):
        raise ValueError(f"ported chain's signature differs from {chain!r}")
    return out
