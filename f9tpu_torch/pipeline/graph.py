"""The per-batch device graph: decode buffers in, PCM codes + metrics out
(port of `f9tpu/pipeline/graph.py`, flat "packed" layout).

One fixed-shape batch ``(files, channels, frames)`` runs, in order:

    on-device unpack -> mono fan-out -> channel routing -> mask ->
    [capture head-room pad] -> SRC (CUDA kernel) -> [insert chain] ->
    [latency trim] -> [reverb-tail detection] -> masked DC/gain epilogue ->
    peak/RMS/tail-floor metrics -> position-keyed TPDF dither + quantize ->
    routed-silent channels to zero -> byte packing

PyTorch runs it eagerly on the tensors' device; there is no jit.  Per-file
lengths ride through as masks, as in the JAX graph, and the per-file
loudness-normalization gains as a device vector.  Varispeed rates reach the
SRC through the same dispatch (`resample_auto`).

Under channel-axis sharding (`f9tpu_torch.parallel.process_batch_channels_sharded`)
each shard runs this graph on its channels, ``channel_axis`` carries the
shard's collectives, and the per-file reductions over channels (the reverb
detector's and the tail floor's loudest-channel envelopes, the peak and the
sum of squares) span every shard; dither is keyed by the global channel.
Not ported yet, raising NotImplementedError that names its ROADMAP item:
the rows layout.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ProcessingConfig, recording_length
from ..models.filters import design_cycle_bank

from ..device import resolve_device
from ..ops import analysis, dither
from ..ops.chain import Chain
from ..ops.devcodec import pack_interleaved, unpack_pcm_interleaved
from ..ops.routing import route_channels
from ..ops.src_kernel import resample_auto
from ..ops.trim import detect_tail_end, mask_beyond, trim_latency
from . import link

__all__ = ["ProcessResult", "process_batch", "process_batch_raw", "not_ported"]

#: Options of the JAX package the port does not have yet, with the ROADMAP
#: item each waits for (the graph's and the scheduler's).
NOT_PORTED = {
    "rows_layout": "ROADMAP Queue 1, the rows layout (_process_impl_rows)",
    "native_loader": "left out of the port (measured slower than Python decode)",
}


def not_ported(what: str) -> NotImplementedError:
    """The error an unported option raises, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported to f9tpu_torch yet: {NOT_PORTED[what]}")


@dataclasses.dataclass
class ProcessResult:
    """Device outputs for one batch (tensors on the batch's device)."""

    codes: Any          # int32 codes (files, channels, out_total), or the uint8
                        # payload (files, out_total * channels * bits // 8)
    out_frames: Any     # (files,) int32 — valid output length per file
    tail_terminated: Any  # (files,) bool
    peak_db: Any        # (files,) float32, pre-quantize
    rms_db: Any         # (files,) float32
    noise_floor_db: Any  # (files,) float32 (tail window RMS)


def _metrics(y: torch.Tensor, out_frames: torch.Tensor):
    # RMS over each file's valid length, not the padded bucket
    flat = y.reshape(y.shape[0], -1)
    n_valid = (out_frames.to(torch.float32) * y.shape[1]).clamp(min=1.0)
    rms = torch.sqrt(torch.sum(torch.square(flat), dim=-1) / n_valid)
    return analysis.peak_db(flat), analysis._amp_to_db(rms)


def _front_end(x, frames_valid, routing, out_channels, raw_in):
    """On-device raw decode, mono fan-out, channel routing (after the
    fan-out, as in the JAX graph) and zeroing beyond each file's true
    length."""
    if raw_in is not None:
        in_channels, in_bits, in_big = raw_in
        x = unpack_pcm_interleaved(x, in_channels, in_bits, big_endian=in_big)
    files = x.shape[0]
    if out_channels is not None and x.shape[1] == 1 and out_channels != 1:
        x = x.expand(files, out_channels, x.shape[-1])
    if routing is not None:
        x = route_channels(x, list(routing))
    return mask_beyond(x, frames_valid)


def _exact_out_valid(frames_valid: torch.Tensor, bank, out_total: int) -> torch.Tensor:
    """ceil(n*L/M) per file in exact integer arithmetic (float32 would drop
    frames once n*L passes 2^24).  The L*M guard is the JAX graph's int32
    limit, kept so both packages accept the same banks."""
    if bank.L * bank.M >= 2**31:
        raise ValueError(
            f"ratio {bank.L}/{bank.M} too fine for the batch graph's int32 "
            f"length math; re-resolve with a smaller max_denominator")
    n = frames_valid.to(torch.int64)
    out_valid = (n // bank.M) * bank.L + ((n % bank.M) * bank.L + bank.M - 1) // bank.M
    return torch.clamp(out_valid, max=out_total).to(torch.int32)


def _process_impl(x, frames_valid, latency_frames, noise_floor_db, seeds, *,
                  rate_in, rate_out, cfg_key, static_zero_latency=False,
                  raw_in=None, packed_out=False, chain=None, channel_axis=None,
                  gain_lin=None):
    (quality, kind, bits, do_dither, remove_dc, gain_db, trim_enabled,
     reverb_mode, margin_pct, tail_mode, tail_window_ms, tail_hop_ms,
     tail_consecutive, pad_frames, routing, out_channels) = cfg_key
    if chain is not None and not isinstance(chain, Chain):
        raise TypeError(
            f"cfg.chain must be an f9tpu_torch.ops.chain.Chain, got "
            f"{type(chain).__name__} (convert a JAX chain with chain_from_jax)")

    dev = x.device
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    files = x.shape[0]
    x = _front_end(x, frames_valid, routing, out_channels, raw_in)
    if pad_frames:
        # capture head-room for the chain's delay and ring-out and for the
        # reverb tail detector, as explicit silence
        x = F.pad(x, (0, pad_frames))

    y = resample_auto(x, bank)

    if chain is not None:
        # the insert loop: the processor stack runs on the resampled signal,
        # adding its group delay (trimmed below) and ring-out (into the pad)
        y = chain.apply(y, rate_out)

    out_total = y.shape[-1]
    if trim_enabled and not static_zero_latency:
        y = trim_latency(y, latency_frames, out_total)
    out_valid = _exact_out_valid(frames_valid, bank, out_total)

    if reverb_mode:
        # loudest-channel envelope; quiet windows count only once each
        # file's source span has played (min_frames = out_valid)
        mono_detect = torch.amax(torch.abs(y), dim=1)
        if channel_axis is not None:
            # the loudest channel may live on another shard: every shard
            # reaches the same per-file verdict
            mono_detect = channel_axis.pmax(mono_detect)
        end_frame, terminated = detect_tail_end(
            mono_detect, noise_floor_db, margin_pct,
            rate=rate_out, window_ms=tail_window_ms, hop_ms=tail_hop_ms,
            consecutive=tail_consecutive, min_frames=out_valid, mode=tail_mode)
        # the tail may run past the source but not past the capture; a tail
        # that never fell quiet keeps the whole capture
        out_frames = torch.maximum(torch.clamp(end_frame, max=out_total), out_valid)
        # an empty file has no tail to ring
        out_frames = torch.where(out_valid > 0, out_frames, torch.zeros_like(out_frames))
    else:
        terminated = torch.ones((files,), dtype=torch.bool, device=dev)
        out_frames = out_valid

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    vmask = (torch.arange(out_total, dtype=torch.int32, device=dev)[None, None, :]
             < out_frames[:, None, None])
    ym = torch.where(vmask, y, zero)
    if remove_dc:
        # mean over each file's valid span only (masked samples add 0),
        # accumulated in float64 and rounded once: a float32 reduction's
        # order follows the row's alignment in the batch, and that moved a
        # file's mean by an ulp, and a few of its samples by 1 LSB, with its
        # place in the batch (which follows the decode threads' timing)
        mean = (torch.sum(ym, dim=-1, keepdim=True, dtype=torch.float64)
                / torch.clamp(out_frames, min=1).reshape(files, 1, 1)).to(torch.float32)
    else:
        mean = torch.zeros((files, 1, 1), dtype=torch.float32, device=dev)
    g = 10.0 ** (gain_db / 20.0) if gain_db else 1.0
    if gain_lin is not None:
        # per-file loudness-normalization gain: float32(static) * float32
        # per file, the product the stream composes for the same file
        g = float(np.float32(g)) * gain_lin.reshape(files, 1, 1)
    z = torch.where(vmask, (ym - mean) * g, zero)

    if channel_axis is None:
        pk_db, level_db = _metrics(z, out_frames)
    else:
        # per-file metrics over every shard's channels
        flat = z.reshape(files, -1)
        c_total = z.shape[1] * channel_axis.size
        sumsq = channel_axis.psum(torch.sum(torch.square(flat), dim=-1))
        n_valid = (out_frames.to(torch.float32) * c_total).clamp(min=1.0)
        level_db = analysis._amp_to_db(torch.sqrt(sumsq / n_valid))
        pk_db = analysis._amp_to_db(channel_axis.pmax(torch.amax(torch.abs(flat), dim=-1)))
    # noise floor: RMS of the last tail window of each file's valid span
    win = max(1, rate_out * tail_window_ms // 1000)
    mono = torch.amax(torch.abs(z), dim=1)                       # (files, out_total)
    if channel_axis is not None:
        mono = channel_axis.pmax(mono)
    raw_pos = (out_frames[:, None].to(torch.int64) - win
               + torch.arange(win, dtype=torch.int64, device=dev)[None, :])
    in_range = raw_pos >= 0            # short files have < win valid samples
    gathered = torch.gather(mono, -1, raw_pos.clamp(0, out_total - 1))
    n_tail = torch.clamp(torch.clamp(out_frames, max=win).to(torch.float32), min=1.0)
    tail_rms = torch.sqrt(torch.sum(torch.square(gathered) * in_range, dim=-1) / n_tail)
    nf_est = analysis._amp_to_db(tail_rms)

    if do_dither:
        # noise keyed by (file seed, global channel, absolute output frame):
        # bytes do not depend on batching, sharding, devices or the package
        # that made them; a channel shard offsets its local channel index
        cid = torch.arange(z.shape[1], dtype=torch.int64, device=dev)
        if channel_axis is not None:
            cid = cid + channel_axis.index * z.shape[1]
        cs = dither.channel_seeds(dither.noise_seeds(seeds, files), cid)
        pos_t = torch.arange(out_total, dtype=torch.int64, device=dev)[None, None, :]
        codes = dither.quantize_noise(z, bits, cs[:, :, None], pos_t)
    else:
        codes = dither.quantize_noise(z, bits)
    codes = torch.where(vmask, codes, torch.zeros((), dtype=torch.int32, device=dev))
    if routing is not None and any(r < 0 for r in routing):
        # routed-silent channels stay digital zero even under dither
        silent = torch.tensor([r < 0 for r in routing], device=dev).reshape(1, -1, 1)
        codes = torch.where(silent, torch.zeros((), dtype=torch.int32, device=dev), codes)
    if packed_out:
        codes = pack_interleaved(codes, bits)
    return codes, out_frames, terminated, pk_db, level_db, nf_est


def _cfg_key(cfg: ProcessingConfig, pad_frames: int) -> tuple:
    return (
        cfg.quality, cfg.kind, cfg.bits, cfg.dither, cfg.remove_dc,
        float(cfg.gain_db), cfg.trim_enabled, cfg.reverb_mode,
        float(cfg.noise_floor_margin_pct), cfg.tail_mode, cfg.tail_window_ms,
        cfg.tail_hop_ms, cfg.tail_consecutive, pad_frames,
        tuple(cfg.channel_routing) if cfg.channel_routing is not None else None,
        cfg.output_channels,
    )


def _default_pad_frames(cfg: ProcessingConfig, rate_in: int, latency_frames) -> int:
    """Capture head-room in input frames: latency + 4 * latency
    (`recording_length`) plus the chain's ring-out; reverb mode adds room
    for one whole detection run (window + consecutive hops) after it.  All
    capped at ``max_tail_seconds``.  A chain needs head-room without reverb
    too: the trim shifts the capture left by the measured delay.

    Latency is in output frames and is converted to input frames; a
    negative (acausal) latency shifts right and needs no head-room."""
    lat_out = max(0, int(latency_frames)) if isinstance(latency_frames, int) else 0
    lat_in = -(-lat_out * rate_in // max(cfg.target_rate, 1))
    tail_in = 0
    if cfg.chain is not None:
        tail_out = int(cfg.chain.tail_frames(cfg.target_rate))
        tail_in = -(-tail_out * rate_in // max(cfg.target_rate, 1))
    cap = int(cfg.max_tail_seconds * rate_in)
    if not cfg.reverb_mode:
        if cfg.chain is None:
            return 0
        return min(recording_length(0, lat_in) + tail_in + 4096, cap)
    detect_ms = (cfg.tail_window_ms
                 + (cfg.tail_consecutive + 1) * cfg.tail_hop_ms + 100)
    detect_frames = detect_ms * rate_in // 1000
    # the detection run fits after the chain's ring-out
    return min(recording_length(0, lat_in) + tail_in + detect_frames + 4096, cap)


def _pick_device(a, device) -> torch.device:
    if device is not None:
        return resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.device
    return resolve_device("cuda")


def _as_tensor(a, dtype, device) -> torch.Tensor:
    """``a`` as a ``dtype`` tensor on ``device``; host data goes up through
    `link.upload` (a pinned buffer, or ``a`` itself when the caller built it
    in one, as the scheduler does), converted on the host first."""
    if isinstance(a, torch.Tensor) and a.device.type != "cpu":
        return a.to(device=device, dtype=dtype)
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return link.upload(t.to(dtype), device)


def _seed_vector(seeds, files: int, device) -> torch.Tensor:
    s = _as_tensor(seeds, torch.int32, device)
    if s.shape != (files,):
        raise ValueError(f"expected ({files},) per-file seeds, got {tuple(s.shape)}")
    return s


def _latency(latency_frames, device):
    static_zero = isinstance(latency_frames, int) and latency_frames == 0
    return _as_tensor(latency_frames, torch.int64, device), static_zero


def gain_lin_f32(gain_db) -> np.ndarray:
    """Per-file dB -> ``(n,)`` float32 linear gains: ``10 ** (float32 dB /
    20)`` evaluated in float32 on the host, as the JAX graph evaluates it.
    The batch graph and the stream both come here (the stream with one
    element), so a file's factor is the same float32 on either path."""
    db = np.atleast_1d(np.asarray(gain_db, np.float32))
    return np.power(np.float32(10.0), db / np.float32(20.0)).astype(np.float32)


def _gain_vector(per_file_gain_db, files: int, device):
    """``(files,)`` float32 linear gains on ``device`` (None stays None)."""
    if per_file_gain_db is None:
        return None
    lin = gain_lin_f32(per_file_gain_db)
    if lin.shape != (files,):
        raise ValueError(f"expected ({files},) per-file gains, got {lin.shape}")
    return link.upload(lin, device)


def _noise_floor(cfg: ProcessingConfig, noise_floor_db, device) -> torch.Tensor:
    """The tail detector's noise floor: the argument, else the config's,
    else 1.0 (any value >= 0 selects the -80 dB fallback threshold)."""
    if noise_floor_db is None:
        noise_floor_db = cfg.noise_floor_db
    return link.upload(np.array(noise_floor_db if noise_floor_db is not None else 1.0,
                                np.float32), device)


def process_batch(x, frames_valid, cfg: ProcessingConfig, rate_in: int, seeds,
                  latency_frames=0, pad_frames: int | None = None,
                  noise_floor_db: float | None = None, rows_layout: bool = False,
                  per_file_gain_db=None, device=None) -> ProcessResult:
    """Run one fixed-shape batch of float32 ``x (files, channels, frames)``
    (zero-padded per file to the bucket length; ``frames_valid`` holds the
    true lengths) on ``device`` (default: ``x``'s device if it is a tensor,
    else CUDA).  ``seeds`` is the per-file int32 dither seed vector.
    ``pad_frames`` overrides the capture head-room (`_default_pad_frames`);
    ``noise_floor_db`` overrides ``cfg.noise_floor_db`` for the reverb-tail
    threshold.  ``per_file_gain_db``: optional ``(files,)`` per-file output
    gain in dB (loudness normalization), composed with ``cfg.gain_db``."""
    if rows_layout:
        raise not_ported("rows_layout")
    dev = _pick_device(x, device)
    x = _as_tensor(x, torch.float32, dev)
    if pad_frames is None:
        pad_frames = _default_pad_frames(cfg, rate_in, latency_frames)
    lat, static_zero = _latency(latency_frames, dev)
    codes, out_frames, terminated, pk, level, nf_est = _process_impl(
        x, _as_tensor(frames_valid, torch.int32, dev), lat,
        _noise_floor(cfg, noise_floor_db, dev), _seed_vector(seeds, x.shape[0], dev),
        rate_in=rate_in, rate_out=cfg.target_rate,
        cfg_key=_cfg_key(cfg, pad_frames), static_zero_latency=static_zero,
        chain=cfg.chain, gain_lin=_gain_vector(per_file_gain_db, x.shape[0], dev))
    return ProcessResult(codes=codes, out_frames=out_frames,
                         tail_terminated=terminated, peak_db=pk, rms_db=level,
                         noise_floor_db=nf_est)


def process_batch_raw(raw, frames_valid, cfg: ProcessingConfig, rate_in: int,
                      seeds, in_channels: int, in_bits: int,
                      in_big_endian: bool = False, latency_frames=0,
                      noise_floor_db: float | None = None,
                      rows_layout: bool = False, per_file_gain_db=None,
                      device=None) -> ProcessResult:
    """Raw-bytes path: uint8 interleaved PCM ``(files, bucket_frames *
    in_channels * in_bits // 8)`` in, packed payload out.  ``codes`` holds
    the uint8 payload ``(files, out_total * out_channels * cfg.bits // 8)``;
    slice each file to ``out_frames[i] * out_channels * cfg.bits // 8``."""
    if cfg.bits not in (16, 24):
        raise ValueError("packed output path requires bits in (16, 24)")
    if rows_layout:
        raise not_ported("rows_layout")
    dev = _pick_device(raw, device)
    raw = _as_tensor(raw, torch.uint8, dev)
    pad_frames = _default_pad_frames(cfg, rate_in, latency_frames)
    lat, static_zero = _latency(latency_frames, dev)
    payload, out_frames, terminated, pk, level, nf_est = _process_impl(
        raw, _as_tensor(frames_valid, torch.int32, dev), lat,
        _noise_floor(cfg, noise_floor_db, dev), _seed_vector(seeds, raw.shape[0], dev),
        rate_in=rate_in, rate_out=cfg.target_rate,
        cfg_key=_cfg_key(cfg, pad_frames), static_zero_latency=static_zero,
        raw_in=(in_channels, in_bits, in_big_endian), packed_out=True,
        chain=cfg.chain, gain_lin=_gain_vector(per_file_gain_db, raw.shape[0], dev))
    return ProcessResult(codes=payload, out_frames=out_frames,
                         tail_terminated=terminated, peak_db=pk, rms_db=level,
                         noise_floor_db=nf_est)
