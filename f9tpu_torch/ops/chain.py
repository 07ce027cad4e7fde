"""The insert chain's batch forms (port of `f9tpu/ops/chain.py`).

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
  uniform-partitioned overlap-save (`_upols`): a loop over 2B-frame blocks
  on ``torch.fft`` with a K-deep frequency-domain delay line, so memory is
  O(K*N) whatever the capture length;
- dynamics (compressor, expander, limiter) use causal moving averages
  (`_uniform_ma_past`), a slanted running maximum for the linear-in-dB
  release (`Compressor._slanted_cummax`) and a windowed maximum
  (`_window_max_past`): no per-sample recurrence.

PyTorch runs all of it eagerly.  Only the batch forms are ported; the
streaming forms (`stream_grid`, `stream_state`, `apply_stream`,
`Chain.stream_init`) wait for the streaming slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.nn.functional as F

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

#: `_uniform_ma_past` folds up to this window and convolves above it.
_MA_FOLD_MAX = 4096


def _fir_fold(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
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


def _direct_convolve(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Causal direct-form convolution along the last axis, same length
    (``F.conv1d`` is a correlation: the taps are flipped and the front is
    padded).  float32 throughout: cuDNN runs in full float32 here whatever
    the global TF32 flag (which `resolve_device` switches off anyway)."""
    W = int(taps.shape[-1])
    lead, T = x.shape[:-1], x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, T), (W - 1, 0))
    w = torch.from_numpy(np.ascontiguousarray(taps[::-1], np.float32)).to(
        x.device).reshape(1, 1, W)
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        y = F.conv1d(xb, w)
    return y.reshape(*lead, T)


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
    """Partitioned spectra of C IRs as one complex64 ``(K, C, 1, Nf)``
    tensor on ``device`` (the trailing 1 broadcasts over signal rows)."""
    re = np.stack([p[0] for p in parts], axis=1)[:, :, None, :]
    im = np.stack([p[1] for p in parts], axis=1)[:, :, None, :]
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


def _upols_step(fdl: torch.Tensor, win: torch.Tensor, H: torch.Tensor, B: int):
    """One block of uniform-partitioned overlap-save.  ``win (..., 2B)`` is
    the previous and the current input block; ``fdl (K, ..., Nf)`` the
    frequency-domain delay line, newest block first; ``H (K, ..., Nf)`` the
    partitioned IR spectrum.  Returns the new delay line and the block's B
    alias-free output frames.

    The K-deep sum ``sum_k fdl[k] * H[k]`` is one ``torch.sum`` over the
    delay-line axis (k = 0, the newest block, first in memory), in the
    order the backend picks for that shape.  Every block of a run has the
    same shape and so rounds alike, as does a streamed form that calls this
    step with the same rows; with another row count the CPU picks another
    order (a file's output moves by an ulp between an 8-file and a 2-file
    batch).  cuFFT, MKL and pocketfft round apart, so the card, the CPU and
    the JAX package agree to a bound, not bitwise."""
    Xi = torch.fft.rfft(win, n=2 * B, dim=-1)
    fdl = torch.cat([Xi[None], fdl[:-1]], dim=0)
    Y = torch.sum(fdl * H, dim=0)
    return fdl, torch.fft.irfft(Y, n=2 * B, dim=-1)[..., B:]


def _upols(x: torch.Tensor, H: torch.Tensor, B: int) -> torch.Tensor:
    """Causal convolution of ``x (..., T)`` with the partitioned IR ``H
    (K, ..., Nf)`` (broadcast against ``x``'s leading axes), truncated to
    T.  A Python loop over ceil(T/B) blocks of `_upols_step`: work
    O(T/B * K * N log N), memory O(K*N) beside the signal."""
    T = x.shape[-1]
    nb = max(1, -(-T // B))
    xp = F.pad(x, (B, nb * B - T))                  # one zero block in front
    lead = torch.broadcast_shapes(x.shape[:-1], H.shape[1:-1])
    fdl = torch.zeros((H.shape[0], *lead, B + 1), dtype=torch.complex64,
                      device=x.device)
    y = x.new_empty((*lead, nb * B))
    for i in range(nb):
        fdl, y[..., i * B:(i + 1) * B] = _upols_step(
            fdl, xp[..., i * B:i * B + 2 * B], H, B)
    return y[..., :T]


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
    lead, T = x.shape[:-1], x.shape[-1]
    y = _upols(x.reshape(-1, T), H, B)
    return y.reshape(*lead, T).to(x.dtype)


def _fft_convolve_multi(x: torch.Tensor, irs: np.ndarray,
                        block: int = 4096) -> torch.Tensor:
    """Per-channel FFT convolution in one block loop: ``x (..., C, T)``
    with ``irs (C, ir_len)`` -> ``(..., C, T)``; the C spectra ride a
    channel axis of the delay line, so the input is transformed once."""
    C, ir_len = irs.shape
    if int(block) < 1:
        raise ValueError(f"block must be >= 1, got {block}")
    B = _fft_block_size(ir_len, block)
    H = _spectrum([_partition_ir(np.asarray(irs[c], np.float32), B)
                   for c in range(C)], x.device)                 # (K, C, 1, Nf)
    lead, T = x.shape[:-2], x.shape[-1]
    xr = torch.movedim(x, -2, 0).reshape(C, -1, T)
    y = _upols(xr, H, B)
    return torch.movedim(y.reshape(C, *lead, T), 0, -2).to(x.dtype)


def _uniform_ma_past(x: torch.Tensor, win: int) -> torch.Tensor:
    """Causal moving average ``out[n] = (sum_{k<win} x[n-k]) / win`` as a
    fixed-order fold of ``win`` shifted copies (k = 0 first), so each
    output's float32 op sequence is independent of its position.  One
    accumulator is added into in place.  Windows above `_MA_FOLD_MAX` fall
    back to `_direct_convolve`, as in the JAX package."""
    if win <= 1:
        return x
    if win > _MA_FOLD_MAX:
        return _direct_convolve(x, np.full(win, 1.0 / win, np.float32))
    xp = F.pad(x, (win - 1, 0))
    T = x.shape[-1]
    acc = xp[..., win - 1:win - 1 + T].clone()
    for k in range(1, win):
        acc.add_(xp[..., win - 1 - k:win - 1 - k + T])
    return acc * _f32(1.0 / win)


def _window_max_past(a: torch.Tensor, W: int) -> torch.Tensor:
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


class FIRInsert:
    """A causal FIR processor with its uncompensated group delay (a
    linear-phase FIR delays by (W-1)/2 frames; calibration trims it)."""

    channel_local = True

    def __init__(self, taps):
        self.taps = np.asarray(taps, np.float32).reshape(-1)
        if self.taps.size == 0:
            raise ValueError("FIR needs at least one tap")

    def signature(self) -> tuple:
        return ("fir", _array_sig(self.taps))

    def tail_frames(self, rate: int) -> int:
        return int(self.taps.shape[0]) - 1

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        if self.taps.shape[0] <= FIR_FOLD_MAX:
            return _fir_fold(y, self.taps)
        return fft_convolve(y, self.taps)


class Biquad:
    """A second-order IIR EQ section (RBJ audio-EQ-cookbook forms) run as
    its impulse response, truncated where the float32 quantum is reached;
    the IR is sampled for the actual session rate at apply time."""

    TYPES = ("lowpass", "highpass", "peaking", "lowshelf", "highshelf")

    channel_local = True

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

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        h = self.impulse_response(rate).astype(np.float32)
        if h.shape[0] <= FIR_FOLD_MAX:
            return _fir_fold(y, h)
        return fft_convolve(y, h)


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
            shaped = torch.tanh(y * float(g)) * _f32(1.0 / denom)
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
        """``env[n] = max_{k<=n}(level[k] - c*(n-k))`` exactly: per block of
        `_ENV_BLOCK` frames ``cummax(level + c*j) - c*j``, then the maximum
        with the previous block's last value decayed by ``c*(j+1)``; a
        Python loop over the blocks carries that value."""
        T = level_db.shape[-1]
        B = Compressor._ENV_BLOCK
        cf = _f32(c)
        dev = level_db.device
        if T <= B:
            n = torch.arange(T, dtype=torch.float32, device=dev)
            return torch.cummax(level_db + cf * n, dim=-1).values - cf * n
        nb = -(-T // B)
        lv = F.pad(level_db, (0, nb * B - T), value=-1e9)
        ramp = torch.arange(B, dtype=torch.float32, device=dev) * cf
        decay = cf * (torch.arange(B, dtype=torch.float32, device=dev) + 1.0)
        carry = torch.full(level_db.shape[:-1], -1e9, dtype=torch.float32,
                           device=dev)
        out = torch.empty_like(lv)
        for b in range(nb):
            blk = lv[..., b * B:(b + 1) * B]
            slant = torch.cummax(blk + ramp, dim=-1).values - ramp
            env = torch.maximum(slant, carry[..., None] - decay)
            out[..., b * B:(b + 1) * B] = env
            carry = env[..., -1]
        return out[..., :T]

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

    def _gain_db(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        win = max(1, int(round(self.detector_ms * rate / 1000.0)))
        p = _uniform_ma_past(torch.square(y), win)
        if y.ndim >= 2:
            p = torch.amax(p, dim=-2, keepdim=True)      # stereo/bus link
        level_db = 10.0 * torch.log10(torch.clamp(p, min=1e-20))
        env_db = self._slanted_cummax(level_db, self.release_db_per_s / rate)
        gr = self._gr_from_env(env_db)
        win_a = max(1, int(round(self.attack_ms * rate / 1000.0)))
        if win_a > 1:
            gr = _uniform_ma_past(gr, win_a)
        return gr + _f32(self.makeup_db)

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        gain = torch.pow(10.0, self._gain_db(y, rate) * _f32(1.0 / 20.0))
        return y * gain


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

    def _atten_db(self, x: torch.Tensor, rate: int) -> torch.Tensor:
        """The smoothed attenuation stream S (dB >= 0), channel-linked."""
        L = self.lookahead_frames(rate)
        if x.ndim >= 2:
            lvl = torch.amax(torch.abs(x), dim=-2, keepdim=True)
        else:
            lvl = torch.abs(x)
        level_db = 20.0 * torch.log10(torch.clamp(lvl, min=1e-20))
        atten = torch.clamp(level_db - _f32(self.ceiling_db), min=0.0)
        atten_rel = Compressor._slanted_cummax(
            atten, self.release_db_per_s / rate)
        b = _window_max_past(atten_rel, L + 1)
        return _uniform_ma_past(b, L + 1)

    def apply(self, x: torch.Tensor, rate: int) -> torch.Tensor:
        L = self.lookahead_frames(rate)
        s_db = self._atten_db(x, rate)
        xd = F.pad(x, (L, 0))[..., :x.shape[-1]]
        return xd * torch.pow(10.0, s_db * _f32(-1.0 / 20.0))


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

    def signature(self) -> tuple:
        return ("convreverb", _array_sig(self.ir),
                round(self.wet, 9), round(self.dry, 9))

    def tail_frames(self, rate: int) -> int:
        return int(self.ir.shape[-1]) - 1

    def apply(self, y: torch.Tensor, rate: int) -> torch.Tensor:
        n_ir = self.ir.shape[0]
        if n_ir == 1 or y.ndim < 2:
            # a 1-D signal (the calibration impulse) is measured through
            # the first IR channel: group delay is per unit, not per channel
            wet = fft_convolve(y, self.ir[0])
        else:
            if y.shape[-2] != n_ir:
                raise ValueError(
                    f"multichannel IR has {n_ir} channels but the signal's "
                    f"channel axis is {y.shape[-2]}")
            wet = _fft_convolve_multi(y, self.ir)
        out = _f32(self.wet) * wet
        if self.dry:
            out = out + _f32(self.dry) * y
        return out


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
        for s in self.stages:
            y = s.apply(y, rate)
        return y

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
