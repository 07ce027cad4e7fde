"""EBU R128 / ITU-R BS.1770-4 metering (port of `f9tpu/ops/loudness.py`):
integrated loudness (LUFS), loudness range (LRA) and true peak (dBTP).

Pipeline, all on the tensors' device, no recurrences:

1. Non-48 kHz input is resampled to 48 kHz with the framework's own SRC
   (the K-filter coefficients below are the standard's published 48 kHz
   set).
2. K-weighting = the standard's two biquads (high shelf + high-pass),
   realised as one truncated float64 impulse response driven through the
   partitioned FFT convolver of `ops.chain` (the cascade's poles give
   geometric decay, truncated far below the gating resolution).
3. ONE pass of 100 ms hop energies feeds BOTH statistics: integrated
   loudness uses 400 ms / 75 %-overlap blocks (4 consecutive hops) with
   -70 LUFS absolute + -10 LU relative gating; LRA (EBU Tech 3342) uses
   3 s windows at 1 s stride (30 hops, stride 10) with -70 / -20 LU gates
   and p95 - p10 of the survivors.
4. True peak (Annex 2) oversamples 4x with the framework's windowed-sinc
   SRC, which is the standard's reference method (a polyphase
   interpolator).

Where the port differs from the JAX module, with the same results to
within 0.01 LU / 0.01 dB (the tests hold them):

- `k_weight` runs the FFT convolver at every length.  The JAX module uses
  a direct float32 convolution below 2^16 frames; the port has no direct
  convolution (a library convolution picks its algorithm by shape).
- The JAX module pads signals and hop counts to powers of two (`_bucket`)
  so that XLA compiles one graph per size class.  Eager PyTorch compiles
  nothing, and the padded and the trimmed forms give the same statistics
  (the windows that reach into padding are masked out by ``n_valid``), so
  the port computes on the trimmed signal.
- The 4x true-peak oversampler is the bank ``rate -> 4*rate`` (L = 4,
  M = 1).  The whole-file form runs the batch SRC (`resample_rates`); the
  streamed form (`_tp_step`) runs the `cycle_fold` kernel fused with the
  peak (one memset and one launch a chunk, no oversampled signal written)
  or its twin, as `src_route` says: the same bits either way.

Every public function takes ``device`` (default: the input tensor's device,
else CUDA through `resolve_device`; CPU runs pass ``"cpu"``).

Reference coefficients: ITU-R BS.1770-4 Table 1/2 (48 kHz).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..device import resolve_device
from ..models.filters import design_cycle_bank
from .cycle_fold import presliced_absmax_kernel, presliced_absmax_reference
from .resample import resample_presliced, resample_rates
from .src_kernel import src_route

__all__ = ["integrated_lufs", "k_weighting_ir", "block_loudness",
           "true_peak_db", "loudness_range", "r128_stats",
           "meter_source_streamed", "array_reader", "surround_weights",
           "normalization_gain_db"]

#: BS.1770-4 stage 1: high-shelf (+~4 dB above ~1.5 kHz), 48 kHz.
K_STAGE1_B = (1.53512485958697, -2.69169618940638, 1.19839281085285)
K_STAGE1_A = (1.0, -1.69065929318241, 0.73248077421585)
#: BS.1770-4 stage 2: high-pass (~38 Hz), 48 kHz.
K_STAGE2_B = (1.0, -2.0, 1.0)
K_STAGE2_A = (1.0, -1.99004745483398, 0.99007225036621)

_RATE = 48000
_HOP = 4800                 # 100 ms
_I_BLOCK_HOPS = 4           # integrated: 400 ms blocks, 100 ms hop
_ST_BLOCK_HOPS = 30         # short-term: 3 s windows...
_ST_STRIDE_HOPS = 10        # ...at 1 s stride
_ABS_GATE_LUFS = -70.0
_REL_GATE_LU = -10.0
_LRA_REL_GATE_LU = -20.0
_OFFSET = -0.691


def _iir_response(b, a, n: int) -> np.ndarray:
    """First ``n`` samples of a biquad's impulse response, float64 exact."""
    h = np.zeros(n)
    x1 = x2 = y1 = y2 = 0.0
    for i in range(n):
        xn = 1.0 if i == 0 else 0.0
        yn = b[0] * xn + b[1] * x1 + b[2] * x2 - a[1] * y1 - a[2] * y2
        h[i] = yn
        x2, x1 = x1, xn
        y2, y1 = y1, yn
    return h


@functools.lru_cache(maxsize=1)
def k_weighting_ir() -> np.ndarray:
    """Truncated float64 IR of the K-weighting cascade at 48 kHz.

    The high-pass pole radius is ~0.995 -> the tail falls below 1e-9 within
    ~6000 samples (125 ms); truncation error is ~-180 dB on block energies,
    far beyond the gating resolution."""
    n = 8192
    h1 = _iir_response(K_STAGE1_B, K_STAGE1_A, n)
    h2 = _iir_response(K_STAGE2_B, K_STAGE2_A, n)
    h = np.convolve(h1, h2)[:n]
    # trim the negligible tail (keeps the device conv small)
    mag = np.abs(h)
    keep = int(np.max(np.nonzero(mag > mag.max() * 1e-9))) + 1
    return h[:keep]


#: the K-weighting IR's partitioned spectrum, per (block, device)
_KW_SPECTRA: dict = {}


def k_weight(x: torch.Tensor) -> torch.Tensor:
    """Apply the 48 kHz K-weighting cascade along the last axis: the
    partitioned FFT convolver (`ops.chain._upols`) with the ~5k-tap IR, at
    every length; the IR's spectrum is made once per device."""
    from .chain import _cached_spectrum, _fft_block_size, _upols_rows

    h = k_weighting_ir().astype(np.float32)
    B = _fft_block_size(int(h.shape[0]))
    H = _cached_spectrum(_KW_SPECTRA, "k", [h], B, x.device)[:, 0]
    return _upols_rows(x, H, B).to(x.dtype)


def surround_weights(channels: int):
    """BS.1770-4 channel weights G_i for the standard 5.1 / 7.1 layouts the
    EXTENSIBLE writer emits (L R C LFE [BL BR] SL SR): fronts 1.0, surrounds
    1.41 (+1.5 dB), LFE excluded (weight 0).  Returns None for layouts the
    spec does not define (mono/stereo need no weighting; discrete buses are
    not 5.1 beds, which is why weighting is opt-in via
    ``cfg.surround_weights``)."""
    if channels == 6:
        return (1.0, 1.0, 1.0, 0.0, 1.41, 1.41)
    if channels == 8:
        return (1.0, 1.0, 1.0, 0.0, 1.41, 1.41, 1.41, 1.41)
    return None


def _on_device(x, device) -> torch.Tensor:
    """``x`` (tensor or array) as a float32 ``(C, T)`` tensor on ``device``
    (default: a tensor's own device, else CUDA)."""
    if device is None and isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = resolve_device(device)
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
    t = t.to(device=dev, dtype=torch.float32)
    return t[None] if t.dim() == 1 else t


def _apply_weights(hop_sq: torch.Tensor, weights):
    """Scale per-channel hop energies by the BS.1770 G_i weights (weighting
    mean-square energies post-hoc is algebraically identical to weighting
    the channels before summation)."""
    if weights is None:
        return hop_sq
    w = torch.tensor(weights, dtype=torch.float32, device=hop_sq.device).reshape(-1, 1)
    if w.shape[0] != hop_sq.shape[0]:
        raise ValueError(
            f"{w.shape[0]} channel weights for {hop_sq.shape[0]} channels")
    return hop_sq * w


def _hop_energies(x: torch.Tensor, rate: int):
    """The shared statistic base: SRC to 48 kHz if needed, K-weight, then
    per-channel 100 ms hop energy sums.  Returns ``(hop_sq (C, n_hops),
    n_hops)``; the sub-hop tail (< 100 ms) is dropped."""
    if rate != _RATE:
        x = resample_rates(x, int(rate), _RATE, quality="high")
    C, T = x.shape
    n_hops = T // _HOP
    if n_hops == 0:
        return x.new_zeros((C, 0)), 0
    xk = k_weight(x[:, : n_hops * _HOP])
    hop_sq = torch.sum(torch.square(xk).reshape(C, n_hops, _HOP), dim=-1)
    return hop_sq, n_hops


def _loudness_db(z: torch.Tensor) -> torch.Tensor:
    return _OFFSET + 10.0 * torch.log10(torch.clamp(z, min=1e-30))


def _windows_db(hop_sq: torch.Tensor, block_hops: int, stride_hops: int,
                n_valid_hops: int):
    """Channel-summed mean squares + loudness (dB) of sliding windows of
    ``block_hops`` hops at ``stride_hops`` stride, plus the validity mask
    for windows that end within the first ``n_valid_hops`` hops."""
    n_hops = hop_sq.shape[-1]
    n_blocks = max(0, (n_hops - block_hops) // stride_hops + 1)
    starts = torch.arange(n_blocks, device=hop_sq.device) * stride_hops
    idx = starts[:, None] + torch.arange(block_hops, device=hop_sq.device)[None, :]
    z = torch.sum(torch.sum(hop_sq[:, idx], dim=-1), dim=0) / (block_hops * _HOP)
    in_valid = (starts + block_hops) <= n_valid_hops
    return z, _loudness_db(z), in_valid


def block_loudness(x48, weights=None, device=None) -> torch.Tensor:
    """Per-block loudness (LUFS) of a 48 kHz signal ``(C, T)``: 400 ms
    blocks at 100 ms hop.  Returns ``(n_blocks,)``; blocks are summed over
    channels with unity weights unless ``weights`` are given."""
    hop_sq, n_valid = _hop_energies(_on_device(x48, device), _RATE)
    hop_sq = _apply_weights(hop_sq, weights)
    if n_valid < _I_BLOCK_HOPS:
        return hop_sq.new_zeros((0,))
    _, lb, _ = _windows_db(hop_sq, _I_BLOCK_HOPS, 1, n_valid)
    return lb[: n_valid - _I_BLOCK_HOPS + 1]


def _gated_mean(z: torch.Tensor, mask: torch.Tensor):
    """(count, mean of z over mask with the count floored at 1)."""
    n = torch.sum(mask)
    zero = torch.zeros((), dtype=z.dtype, device=z.device)
    return n, torch.sum(torch.where(mask, z, zero)) / torch.clamp(n, min=1)


def _integrated_from_hops(hop_sq: torch.Tensor, n_valid: int) -> torch.Tensor:
    floor = torch.tensor(-200.0, dtype=torch.float32, device=hop_sq.device)
    if hop_sq.shape[-1] < _I_BLOCK_HOPS or n_valid < _I_BLOCK_HOPS:
        return floor
    z, lb, in_valid = _windows_db(hop_sq, _I_BLOCK_HOPS, 1, n_valid)
    abs_mask = in_valid & (lb > _ABS_GATE_LUFS)
    _, z_abs = _gated_mean(z, abs_mask)
    mask = abs_mask & (lb > _loudness_db(z_abs) + _REL_GATE_LU)
    n, z_gated = _gated_mean(z, mask)
    return torch.where(n > 0, _loudness_db(z_gated), floor)


def _lra_from_hops(hop_sq: torch.Tensor, n_valid: int) -> torch.Tensor:
    zero = torch.tensor(0.0, dtype=torch.float32, device=hop_sq.device)
    if hop_sq.shape[-1] < _ST_BLOCK_HOPS or n_valid < _ST_BLOCK_HOPS:
        return zero
    z, st, in_valid = _windows_db(hop_sq, _ST_BLOCK_HOPS, _ST_STRIDE_HOPS, n_valid)
    n_blocks = st.shape[0]
    abs_mask = in_valid & (st > _ABS_GATE_LUFS)
    _, z_abs = _gated_mean(z, abs_mask)
    mask = abs_mask & (st > _loudness_db(z_abs) + _LRA_REL_GATE_LU)
    # gated percentiles: sort with masked values pushed to +inf, index by
    # the count of surviving blocks
    n = torch.sum(mask)
    st_sorted = torch.sort(torch.where(mask, st, torch.full_like(st, math.inf))).values
    # rank policy: round-to-nearest (libebur128 / EBU reference meters);
    # plain floor biased p95 one rank low whenever frac(0.95*(n-1)) >= 0.5
    lo_i = torch.clamp((0.10 * (n - 1) + 0.5).to(torch.int32), 0, n_blocks - 1)
    hi_i = torch.clamp((0.95 * (n - 1) + 0.5).to(torch.int32), 0, n_blocks - 1)
    lra = st_sorted[hi_i.long()] - st_sorted[lo_i.long()]
    return torch.where(n > 1, lra, zero)


def integrated_lufs(x, rate: int, weights=None, device=None) -> torch.Tensor:
    """BS.1770-4 integrated loudness of ``x`` (C, T) float32 at ``rate``.

    Returns a scalar tensor (LUFS); silence/too-short input returns a -200
    floor.  Non-48 kHz input rides the framework's own SRC first."""
    hop_sq, n_valid = _hop_energies(_on_device(x, device), rate)
    return _integrated_from_hops(_apply_weights(hop_sq, weights), n_valid)


def loudness_range(x, rate: int, weights=None, device=None) -> torch.Tensor:
    """Loudness range (LRA, LU) per EBU Tech 3342: short-term loudness
    (3 s windows, 1 s stride), absolute gate at -70 LUFS, relative gate at
    -20 LU below the gated mean, LRA = p95 - p10 of what survives."""
    hop_sq, n_valid = _hop_energies(_on_device(x, device), rate)
    return _lra_from_hops(_apply_weights(hop_sq, weights), n_valid)


def r128_stats(x, rate: int, weights=None, device=None) -> tuple[float, float]:
    """(integrated LUFS, LRA) from ONE resample + K-weighting pass: both
    statistics derive from the same 100 ms hop energies."""
    hop_sq, n_valid = _hop_energies(_on_device(x, device), rate)
    hop_sq = _apply_weights(hop_sq, weights)
    return (float(_integrated_from_hops(hop_sq, n_valid)),
            float(_lra_from_hops(hop_sq, n_valid)))


#: above this many input frames, true-peak scanning switches to fixed-size
#: chunks so device memory stays bounded (the whole-file form materialises
#: the 4x-oversampled signal, ~8x the input bytes)
_TP_CHUNK_THRESHOLD = 1 << 21


def true_peak_db(x, rate: int, oversample: int = 4, device=None) -> torch.Tensor:
    """True-peak level (dBTP, BS.1770-4 Annex 2): inter-sample peaks exposed
    by 4x oversampling with the framework's own windowed-sinc SRC.  Long
    signals scan in fixed overlap-save chunks (same halo math as
    `pipeline.stream`), so device memory is bounded whatever the file's
    length; max is order-independent, so the chunked scan is exact."""
    x = _on_device(x, device)
    T = x.shape[-1]
    if T > _TP_CHUNK_THRESHOLD:
        # the chunks are sliced on x's own device: nothing goes back to the host
        pk_db = _true_peak_chunked(x, x.shape[0], T, int(rate), int(oversample),
                                   device=x.device)
        return torch.tensor(pk_db, dtype=torch.float32, device=x.device)
    y = resample_rates(x, int(rate), int(rate) * int(oversample), quality="high")
    pk = torch.max(torch.abs(y)) if y.numel() else y.new_zeros(())
    return 20.0 * torch.log10(torch.clamp(pk, min=1e-30))


# --------------------------------------------------------------------------
# Streamed (chunk-exact) metering: the ONE measurement path used by BOTH the
# batch scheduler and the streaming pipeline when computing normalization
# gains, so a file processed either way on one device receives the
# bit-identical gain.  Chunks ride the same overlap-save halo machinery as
# `pipeline.stream`.
# --------------------------------------------------------------------------


def array_reader(x: np.ndarray):
    """Adapter: an in-memory (C, T) array exposed with the `WavReader.read`
    contract (clipped at the ends, shorter at EOF)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None]

    def read(start: int, count: int) -> np.ndarray:
        start = max(0, start)
        return x[:, start : start + max(0, count)]

    return read


def _read_span(read, C: int, T: int, lo: int, length: int) -> np.ndarray:
    """(C, length) float32, zero-padded outside [0, T)."""
    out = np.zeros((C, length), np.float32)
    a, b = max(0, lo), min(T, lo + length)
    if b > a:
        blk = np.asarray(read(a, b - a), np.float32)
        out[:, a - lo : a - lo + blk.shape[1]] = blk
    return out


def _halos(bank) -> tuple[int, int]:
    left = bank.pad_front
    return left, max(0, bank.W - bank.M - left)


def _meter48_step(xp: torch.Tensor, carry: torch.Tensor, *, cycles: int,
                  rate_in: int, ctx: int):
    """One metering chunk: SRC to 48 kHz (exact overlap-save), K-weight with
    carried context, 100 ms hop energies.  Returns (hop_sq (C, n), carry)."""
    if rate_in != _RATE:
        bank = design_cycle_bank(rate_in, _RATE, quality="high")
        y = resample_presliced(xp, bank, cycles)
    else:
        y = xp
    z = torch.cat([carry, y], dim=-1)
    kw = k_weight(z)[:, ctx:]
    C = kw.shape[0]
    hop_sq = torch.sum(torch.square(kw).reshape(C, -1, _HOP), dim=-1)
    return hop_sq, z[:, -ctx:]


#: the true peak of a haloed chunk by `src_route`'s answer for the oversampler
_TP_PEAK = {("cycle_fold", True): presliced_absmax_kernel,
            ("cycle_fold", False): presliced_absmax_reference}


def _tp_step(xp: torch.Tensor, *, cycles: int, rate_in: int, oversample: int):
    """One true-peak chunk: the 4x oversampler on a haloed chunk, then the
    absolute maximum (NaN propagates), by `_TP_PEAK`."""
    bank = design_cycle_bank(rate_in, rate_in * oversample, quality="high")
    return _TP_PEAK[src_route(bank, xp.device)](xp, bank, cycles)


def _meter_chunk_plan(rate: int, chunk_seconds: float, ctx: int):
    """(chunk_in_frames, cycles, bank48|None): chunk grid whose 48 kHz output
    span is a whole number of 100 ms hops and >= the K-weight context."""
    if rate == _RATE:
        chunk48 = max(1, int(chunk_seconds * _RATE) // _HOP) * _HOP
        while chunk48 < ctx + _HOP:
            chunk48 += _HOP
        return chunk48, chunk48, None
    bank = design_cycle_bank(rate, _RATE, quality="high")
    cyc_align = _HOP // math.gcd(bank.L, _HOP)   # cycles per hop boundary
    base_in = cyc_align * bank.M
    blocks = max(1, int(chunk_seconds * rate) // base_in)
    while blocks * cyc_align * bank.L < ctx + _HOP:
        blocks += 1
    return blocks * base_in, blocks * cyc_align, bank


def _peak_to_db(peaks: list[float]) -> float:
    # np.max propagates NaN (corrupt decode) exactly like the whole-file
    # path; Python's max(pk, nan) silently keeps the finite value
    pk = float(np.max(peaks))
    return float(20.0 * np.log10(max(pk, 1e-30))) if not np.isnan(pk) else float("nan")


def _true_peak_chunked(read, C: int, T: int, rate: int, oversample: int = 4,
                       chunk_seconds: float = 20.0, device=None) -> float:
    """True peak (dBTP) over haloed chunks of a source: ``read`` is a
    ``read(start, count)`` function, or a ``(C, T)`` tensor on ``device``
    whose chunks are then sliced there."""
    dev = resolve_device(device)
    tp_bank = design_cycle_bank(rate, rate * oversample, quality="high")
    h_l, h_r = _halos(tp_bank)
    chunk_in = max(1, int(chunk_seconds * rate) // tp_bank.M) * tp_bank.M
    peaks = [0.0]
    start = 0
    while start < T:
        lo, hi = start - h_l, start + chunk_in + h_r
        if isinstance(read, torch.Tensor):
            xp = torch.nn.functional.pad(read[:, max(0, lo): min(T, hi)],
                                         (max(0, -lo), max(0, hi - T)))
        else:
            xp = torch.from_numpy(_read_span(read, C, T, lo, hi - lo)).to(dev)
        peaks.append(float(_tp_step(xp, cycles=chunk_in // tp_bank.M,
                                    rate_in=rate, oversample=oversample)))
        start += chunk_in
    return _peak_to_db(peaks)


def normalization_gain_db(target_lufs: float, source_lufs: float,
                          static_gain_db: float = 0.0,
                          tp_ceiling_db: float | None = None,
                          source_tp_db: float | None = None):
    """The ONE normalization-gain rule both the batch scheduler and the
    streaming pre-pass apply: per-file gain composing with the static
    cfg.gain_db so the NET output hits the target, clamped at +-40 dB, then
    reduced so (source true peak + net gain) respects the dBTP ceiling.
    Returns ``(gain_db, note)``; note is a human-readable clamp/cap tag."""
    want = target_lufs - source_lufs - static_gain_db
    gain_db = float(np.clip(want, -40.0, 40.0))
    note = ("" if gain_db == want else
            ", clamped at +-40 dB — target missed by "
            f"{abs(want - gain_db):.1f} LU")
    if tp_ceiling_db is not None and source_tp_db is not None:
        over = source_tp_db + gain_db + static_gain_db - tp_ceiling_db
        if over > 0:
            gain_db -= over
            # append: a clamp note must survive when the cap also engages
            note += f", capped at {tp_ceiling_db:+.1f} dBTP"
    return gain_db, note


def meter_source_streamed(read, channels: int, frames: int, rate: int,
                          want_tp: bool = False,
                          chunk_seconds: float = 20.0,
                          weights=None, device=None) -> dict:
    """Integrated LUFS (and optionally true peak) of a source exposed via a
    ``read(start, count) -> (C, n)`` function, in constant memory, on
    ``device`` (default CUDA).

    Chunk grid and device steps are fixed per (rate, chunk_seconds), so the
    result is a pure function of the samples and the device: the batch
    scheduler (with `array_reader`) and the streaming pre-pass (with the
    file reader's ``read``) get bit-identical floats, which keeps
    normalization gains, and therefore emitted bytes, identical across the
    two paths.  The audio path's chunk size must never be passed in here.

    ``want_tp`` shares the SAME host reads as the loudness pass.  The
    true-peak value is exact whatever the chunk grid: overlap-save chunks
    reproduce the oversampled samples exactly and max is order-independent.
    ``weights``: optional BS.1770 G_i per-channel weights (see
    :func:`surround_weights`)."""
    dev = resolve_device(device)
    ctx = int(k_weighting_ir().shape[0]) - 1
    chunk_in, cycles, bank = _meter_chunk_plan(rate, chunk_seconds, ctx)
    if bank is not None:
        h_l, h_r = _halos(bank)
        out48_total = bank.out_len(frames)
    else:
        h_l = h_r = 0
        out48_total = frames
    th_l = th_r = 0
    if want_tp:
        tp_bank = design_cycle_bank(rate, rate * 4, quality="high")
        th_l, th_r = _halos(tp_bank)
        tp_cycles = chunk_in // tp_bank.M      # tp_bank.M == 1
        peaks = [0.0]
    total_hops = out48_total // _HOP
    hops: list[torch.Tensor] = []
    carry = torch.zeros((channels, ctx), dtype=torch.float32, device=dev)
    start = 0
    got_hops = 0
    while start < frames:
        meter_more = got_hops < total_hops
        if not (meter_more or want_tp):
            break
        lo = start - max(h_l, th_l)
        hi = start + chunk_in + max(h_r, th_r)
        span = torch.from_numpy(_read_span(read, channels, frames, lo, hi - lo)).to(dev)
        if meter_more:
            a = (start - h_l) - lo
            hop_sq, carry = _meter48_step(span[:, a: a + h_l + chunk_in + h_r], carry,
                                          cycles=cycles, rate_in=rate, ctx=ctx)
            hops.append(hop_sq)
            got_hops += hop_sq.shape[1]
        if want_tp:
            a = (start - th_l) - lo
            peaks.append(float(_tp_step(span[:, a: a + th_l + chunk_in + th_r],
                                        cycles=tp_cycles, rate_in=rate, oversample=4)))
        start += chunk_in
    out = {"lufs": -200.0, "true_peak_db": None}
    if total_hops >= _I_BLOCK_HOPS and hops:
        hop_all = torch.cat(hops, dim=1)[:, :total_hops]
        out["lufs"] = float(_integrated_from_hops(
            _apply_weights(hop_all, weights), total_hops))
    if want_tp:
        out["true_peak_db"] = _peak_to_db(peaks)
    return out
