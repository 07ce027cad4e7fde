"""The per-batch device graph: decode buffers in, PCM codes + metrics out
(port of `f9tpu/pipeline/graph.py`).

One fixed-shape batch ``(files, channels, frames)`` runs, in order:

    the front end (one kernel on the card: on-device unpack -> mono fan-out
    -> channel routing -> mask) -> [capture head-room pad] -> SRC (CUDA
    kernel) -> [insert chain] -> [latency trim] -> [reverb-tail detection]
    -> the epilogue kernel pair (masked DC mean and gain, peak/RMS,
    position-keyed TPDF dither + quantize, routed-silent channels to zero,
    byte packing) -> tail floor

PyTorch runs it eagerly on the tensors' device; there is no jit.  Per-file
lengths ride through as masks, as in the JAX graph, and the per-file
loudness-normalization gains as a device vector.  Varispeed rates reach the
SRC through the same dispatch (`resample_auto`).

Under channel-axis sharding (`f9tpu_torch.parallel.process_batch_channels_sharded`)
each shard runs this graph on its channels, ``channel_axis`` carries the
shard's collectives, and the per-file reductions over channels (the reverb
detector's and the tail floor's loudest-channel envelopes, the peak and the
sum of squares) span every shard; dither is keyed by the global channel.

The rows layout (``rows_layout=True``; no reverb, no chain, zero latency)
returns int32 codes ``(files, channels, Q, L)``, output sample ``t`` at
``[..., t // L, t % L]`` (`_process_impl_rows`).  On the card the kernel
reads the flat signal and writes whole cycles, so the tiling is a view of
a contiguous ``(files, channels, Q*L)`` tensor and the layout is not a
second graph: the front end, the SRC dispatch and the epilogue
(`_epilogue`) are the packed path's.  Its input may be the bucket, the raw
wire (packed on the card, so ``layout == "flat"``), or the JAX package's
host-marshalled rows: dense ``(files, C, n_rows, M)`` (`rows_marshal_plan`)
or varispeed overlapping cycle rows ``(files, C, Q, row_width)``
(`banded_rows_plan`), which the SRC reads as the flat staging they were cut
from (`resample_staged`).

Rows and packed give the same codes, ``out_frames`` and metrics bit for
bit.  A packed batch that the rows layout would admit also computes whole
cycles and runs its epilogue over ``Q*L`` samples, keeping the first
``out_len`` codes.  The epilogue (`f9tpu_torch.ops.epilogue`: a CUDA kernel
pair on the card, its plain twin on the CPU) sums in an order set by each
file's own valid samples, so neither the layout, the bucket length, the
file's row nor the batch width moves a file's mean, RMS or codes.
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
from ..ops import analysis, dither, epilogue, frontend
from ..ops.chain import Chain
from ..ops.routing import route_channels
from ..ops.resample import (_banded_geometry, _overlap_rows, banded_rows_plan,
                            rows_marshal_plan)
from ..ops.src_kernel import resample_auto, resample_staged
from ..ops.trim import detect_tail_end, trim_latency
from . import link

__all__ = ["ProcessResult", "build_process_fn", "process_batch", "process_batch_raw",
           "not_ported"]

#: Options of the JAX package the port leaves out, with the reason (the
#: scheduler's).
NOT_PORTED = {
    "native_loader": "left out of the port (measured slower than Python decode)",
}


def not_ported(what: str) -> NotImplementedError:
    """The error an unported option raises, naming its ROADMAP item."""
    return NotImplementedError(
        f"{what} is not ported to f9tpu_torch yet: {NOT_PORTED[what]}")


@dataclasses.dataclass
class ProcessResult:
    """Device outputs for one batch (tensors on the batch's device)."""

    codes: Any          # layout "flat": int32 codes (files, channels, out_total),
                        # or the uint8 payload (files, out_total * channels * bits // 8);
                        # layout "rows": int32 (files, channels, Q, L), sample t at
                        # [..., t // L, t % L] (a view of whole cycles)
    out_frames: Any     # (files,) int32 — valid output length per file
    tail_terminated: Any  # (files,) bool
    peak_db: Any        # (files,) float32, pre-quantize
    rms_db: Any         # (files,) float32
    noise_floor_db: Any  # (files,) float32 (tail window RMS)
    layout: str = "flat"


def _channels(x, routing, out_channels):
    """Mono fan-out, then channel routing, as in the JAX graph."""
    if out_channels is not None and x.shape[1] == 1 and out_channels != 1:
        x = x.expand(x.shape[0], out_channels, x.shape[-1])
    if routing is not None:
        x = route_channels(x, list(routing))
    return x


def _front_end(x, frames_valid, routing, out_channels, raw_in):
    """On-device raw decode, fan-out and routing and zeroing beyond each
    file's true length, for the raw wire and the float bucket alike: one
    call of `ops.frontend` (the kernel on the card, its twin on the CPU)."""
    return frontend.front_end(x, frames_valid, raw=raw_in, routing=routing,
                              out_channels=out_channels)


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

    out_len = bank.out_len(x.shape[-1])
    # a batch the rows layout would admit (nothing reads the SRC past the
    # source: no chain, no trim, no tail detection) computes whole cycles
    # and keeps the first out_len codes, so that its epilogue reduces over
    # the rows layout's shape
    whole = chain is None and not reverb_mode and (static_zero_latency or not trim_enabled)
    y = resample_auto(x, bank, out_len=-(-out_len // bank.L) * bank.L if whole else None)

    if chain is not None:
        # the insert loop: the processor stack runs on the resampled signal,
        # adding its group delay (trimmed below) and ring-out (into the pad)
        y = chain.apply(y, rate_out)

    out_total = y.shape[-1]
    keep = out_len if whole else out_total
    if trim_enabled and not static_zero_latency:
        y = trim_latency(y, latency_frames, out_total)
    out_valid = _exact_out_valid(frames_valid, bank, keep)

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

    codes, pk_db, level_db, nf_est = _epilogue(
        y, out_frames, seeds, bits=bits, do_dither=do_dither, remove_dc=remove_dc,
        gain_db=gain_db, gain_lin=gain_lin, rate_out=rate_out,
        tail_window_ms=tail_window_ms, routing=routing, keep=keep,
        channel_axis=channel_axis, packed=bits if packed_out else None)
    return codes, out_frames, terminated, pk_db, level_db, nf_est


def _epilogue(y, out_frames, seeds, *, bits, do_dither, remove_dc, gain_db, gain_lin,
              rate_out, tail_window_ms, routing, keep, channel_axis=None, packed=None):
    """The graph's epilogue over the SRC (or chain) output ``y (files, C,
    out_total)`` and each file's valid length, shared by both layouts: one
    call of `ops.epilogue` (the kernel pair on the card, its twin on the
    CPU; never one for the other) does the mask, the float64 DC mean, gain,
    the sum of squares and peak, dither keyed by (file, global channel,
    absolute frame) and quantize.  Returns ``(codes, peak_db, rms_db,
    noise_floor_db)`` with int32 codes ``(files, C, keep)``, zero past each
    file's end and on routed-silent channels, or with ``packed`` (16 or 24)
    their interleaved payload.  Out of the kernel stays only what is per
    file and tiny: the dB conversions, the channel axis's collectives and
    the tail floor."""
    files, C, _ = y.shape
    g = 10.0 ** (gain_db / 20.0) if gain_db else 1.0
    cs = None
    if do_dither:
        # noise keyed by (file seed, global channel, absolute output frame):
        # bytes do not depend on batching, sharding, devices, the layout or
        # the package that made them; a channel shard offsets its local
        # channel index
        cid = torch.arange(C, dtype=torch.int64, device=y.device)
        if channel_axis is not None:
            cid = cid + channel_axis.index * C
        cs = dither.channel_seeds(dither.noise_seeds(seeds, files), cid)
    # routed-silent channels stay digital zero even under dither
    silent = [c for c, r in enumerate(routing or ()) if r < 0]
    codes, sumsq, peak, mean = epilogue.epilogue(
        y.contiguous(), out_frames, cs, bits=bits, remove_dc=remove_dc, gain=g,
        gain_lin=gain_lin, keep=keep, silent=silent, packed=packed)
    c_total = C
    if channel_axis is not None:
        # per-file metrics over every shard's channels
        sumsq = channel_axis.psum(sumsq)
        peak = channel_axis.pmax(peak)
        c_total *= channel_axis.size
    n_valid = (out_frames.to(torch.float32) * c_total).clamp(min=1.0)
    level_db = analysis._amp_to_db(torch.sqrt(sumsq.to(torch.float32) / n_valid))
    pk_db = analysis._amp_to_db(peak)
    nf_est = _tail_floor(y, out_frames, mean, epilogue.gain_factor(g, gain_lin),
                         max(1, rate_out * tail_window_ms // 1000), channel_axis)
    return codes, pk_db, level_db, nf_est


def _tail_floor(y, out_frames, mean, g, win: int, channel_axis=None):
    """Noise floor: the RMS of the loudest channel's ``|z|`` over the last
    ``win`` samples of each file's valid span, ``z = (y - mean) * g``
    recomputed at those positions only (the kernel never writes ``z``)."""
    dev = y.device
    files, C, out_total = y.shape
    raw_pos = (out_frames[:, None].to(torch.int64) - win
               + torch.arange(win, dtype=torch.int64, device=dev)[None, :])
    in_range = raw_pos >= 0            # short files have < win valid samples
    pos = raw_pos.clamp(0, out_total - 1)
    yw = torch.gather(y, -1, pos[:, None, :].expand(files, C, win))
    if mean is not None:
        yw = yw - mean[..., None]
    valid = (pos < out_frames[:, None].to(torch.int64))[:, None, :]
    zw = torch.where(valid, yw * g, torch.zeros((), device=dev))
    mono = torch.amax(torch.abs(zw), dim=1)                      # (files, win)
    if channel_axis is not None:
        mono = channel_axis.pmax(mono)
    n_tail = torch.clamp(torch.clamp(out_frames, max=win).to(torch.float32), min=1.0)
    tail_rms = torch.sqrt(torch.sum(torch.square(mono) * in_range, dim=-1) / n_tail)
    return analysis._amp_to_db(tail_rms)


def _process_impl_rows(x, frames_valid, seeds, *, rate_in, rate_out, cfg_key,
                       raw_in=None, packed_out=False, gain_lin=None, num_cycles=None):
    """The rows layout (no reverb, no chain, zero latency): int32 codes
    ``(files, C, Q, L)``, a view of whole cycles, with the out_frames and
    metrics of the packed path bit for bit.

    ``x`` is the bucket ``(files, C, frames)`` (or the raw wire with
    ``raw_in``), or with ``num_cycles`` the flat staging of the JAX
    package's host-marshalled rows (`_rows_staging`): the signal at offset
    ``pad_front`` of a buffer zero outside each file's valid samples, read
    by `resample_staged` (no front-end mask: the staging is the contract).
    With ``packed_out`` the codes are packed on the device, as the packed
    path packs them."""
    (quality, kind, bits, do_dither, remove_dc, gain_db, _trim_enabled,
     _reverb_mode, _margin_pct, _tail_mode, tail_window_ms, _tail_hop_ms,
     _tail_consecutive, _pad_frames, routing, out_channels) = cfg_key
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    files = x.shape[0]
    if num_cycles is not None:
        Q = num_cycles
        y = resample_staged(_channels(x, routing, out_channels), bank, Q)
    else:
        x = _front_end(x, frames_valid, routing, out_channels, raw_in)
        Q = -(-bank.out_len(x.shape[-1]) // bank.L)
        y = resample_auto(x, bank, out_len=Q * bank.L)
    out_total = Q * bank.L
    out_valid = _exact_out_valid(frames_valid, bank, out_total)
    codes, pk_db, level_db, nf_est = _epilogue(
        y, out_valid, seeds, bits=bits, do_dither=do_dither, remove_dc=remove_dc,
        gain_db=gain_db, gain_lin=gain_lin, rate_out=rate_out,
        tail_window_ms=tail_window_ms, routing=routing, keep=out_total,
        packed=bits if packed_out else None)
    terminated = torch.ones((files,), dtype=torch.bool, device=x.device)
    if not packed_out:
        codes = codes.view(files, codes.shape[1], Q, bank.L)
    return codes, out_valid, terminated, pk_db, level_db, nf_est


def rows_staging_plan(bank, frames: int) -> tuple[int, int]:
    """``(length, pad_front)`` of the flat staging the JAX package's
    host-marshalled rows of a ``frames``-long signal are cut from: the
    signal at ``pad_front`` of a zero buffer of ``length`` floats, which
    holds every input the rows' output cycles read (`rows_marshal_plan`'s
    ``n_rows * M`` for a dense bank, ``(Q - 1)*M + row_width`` for a
    varispeed bank, `banded_rows_plan`)."""
    if bank.G is None:
        q, w_rows, pf = banded_rows_plan(bank, frames)
        return (q - 1) * bank.M + w_rows, pf
    n_rows, pf = rows_marshal_plan(bank, frames)
    return n_rows * bank.M, pf


def marshalled_rows(xs: torch.Tensor, bank) -> torch.Tensor:
    """The JAX package's 4-D host-marshalled rows as a view of their flat
    staging ``xs (files, C, length)`` (`rows_staging_plan`): dense ``(n_rows,
    M)`` tiles, or varispeed cycle rows ``row_width`` wide every M floats,
    overlapping.  `_rows_staging` reads them back without a copy."""
    files, C, total = xs.shape
    if bank.G is not None:
        return xs.view(files, C, total // bank.M, bank.M)
    w_rows = _banded_geometry(bank)[3]
    return xs.as_strided((files, C, (total - w_rows) // bank.M + 1, w_rows),
                         (xs.stride(0), xs.stride(1), bank.M, 1))


def _rows_staging(x: torch.Tensor, bank) -> tuple[torch.Tensor, int]:
    """The JAX package's host-marshalled rows as the flat staging they were
    cut from, and the output cycle count.  Dense ``(files, C, n_rows, M)``
    rows are the staging (a view; ``Q = n_rows - R``).  Varispeed rows
    ``(files, C, Q, row_width)`` overlap: row q is ``staging[q*M : q*M +
    row_width]``, so the staging is the first M floats of every row but the
    last, then the last whole: a view where the rows are a window view of it
    (`marshalled_rows`, the scheduler's), one copy otherwise."""
    files, C, n_rows, width = x.shape
    M = bank.M
    if bank.G is not None:
        if width != M:
            raise ValueError(f"rows width {width} != M {M}")
        Q = n_rows - _overlap_rows(bank)
        if Q <= 0:
            raise ValueError(f"need more than R={_overlap_rows(bank)} rows, got {n_rows}")
        return x.reshape(files, C, n_rows * M), Q
    w_rows = _banded_geometry(bank)[3]
    if width != w_rows:
        raise ValueError(f"cycle-row width {width} != plan {w_rows}")
    if w_rows < M:
        raise ValueError(f"cycle-row width {w_rows} < M {M}: the rows leave gaps")
    total = (n_rows - 1) * M + w_rows
    if (x.stride(-1) == 1 and x.stride(-2) == M and x.stride(1) >= total
            and x.stride(0) >= C * total):
        return x.as_strided((files, C, total), (x.stride(0), x.stride(1), 1)), n_rows
    flat = x.new_empty((files, C, total))
    head = (n_rows - 1) * M
    flat[..., :head].view(files, C, n_rows - 1, M).copy_(x[..., :n_rows - 1, :M])
    flat[..., head:].copy_(x[..., n_rows - 1, :])
    return flat, n_rows


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


def _rows_ok(cfg: ProcessingConfig, rows_layout: bool, latency_frames) -> bool:
    """The JAX package's rule: the rows layout applies with no reverb, no
    chain and a static zero latency; anything else runs packed."""
    return (rows_layout and not cfg.reverb_mode and cfg.chain is None
            and isinstance(latency_frames, int) and latency_frames == 0)


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
    gain in dB (loudness normalization), composed with ``cfg.gain_db``.

    ``rows_layout=True`` (no reverb, no chain, zero latency; otherwise the
    batch runs packed) returns the rows layout (`_process_impl_rows`), and
    then ``x`` may also be the JAX package's 4-D host-marshalled rows
    (`rows_marshal_plan`, `banded_rows_plan`), zero outside each file's
    valid samples; a 4-D ``x`` anywhere else raises ValueError."""
    rows_ok = _rows_ok(cfg, rows_layout, latency_frames)
    if getattr(x, "ndim", 0) == 4 and not rows_ok:
        raise ValueError(
            "4-D rows-marshalled input requires the rows layout "
            "(rows_layout=True, no reverb/chain, zero latency)")
    dev = _pick_device(x, device)
    gain_lin = _gain_vector(per_file_gain_db, len(x), dev)
    if rows_ok:
        num_cycles = None
        if x.ndim == 4:
            # the staging is found where the rows are, before the upload: a
            # window view of host staging goes up as the staging itself
            bank = design_cycle_bank(rate_in, cfg.target_rate, quality=cfg.quality,
                                     kind=cfg.kind)
            t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
            x, num_cycles = _rows_staging(t, bank)
        x = _as_tensor(x, torch.float32, dev)
        codes, out_frames, terminated, pk, level, nf_est = _process_impl_rows(
            x, _as_tensor(frames_valid, torch.int32, dev),
            _seed_vector(seeds, x.shape[0], dev), rate_in=rate_in,
            rate_out=cfg.target_rate, cfg_key=_cfg_key(cfg, 0), gain_lin=gain_lin,
            num_cycles=num_cycles)
        return ProcessResult(codes=codes, out_frames=out_frames,
                             tail_terminated=terminated, peak_db=pk, rms_db=level,
                             noise_floor_db=nf_est, layout="rows")
    x = _as_tensor(x, torch.float32, dev)
    if pad_frames is None:
        pad_frames = _default_pad_frames(cfg, rate_in, latency_frames)
    lat, static_zero = _latency(latency_frames, dev)
    codes, out_frames, terminated, pk, level, nf_est = _process_impl(
        x, _as_tensor(frames_valid, torch.int32, dev), lat,
        _noise_floor(cfg, noise_floor_db, dev), _seed_vector(seeds, x.shape[0], dev),
        rate_in=rate_in, rate_out=cfg.target_rate,
        cfg_key=_cfg_key(cfg, pad_frames), static_zero_latency=static_zero,
        chain=cfg.chain, gain_lin=gain_lin)
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
    slice each file to ``out_frames[i] * out_channels * cfg.bits // 8``.
    With ``rows_layout`` (where it applies) the rows layout's whole cycles
    are packed on the device, so the result's layout is "flat" as well and
    its first ``out_len`` frames are the packed path's bytes."""
    if cfg.bits not in (16, 24):
        raise ValueError("packed output path requires bits in (16, 24)")
    dev = _pick_device(raw, device)
    raw = _as_tensor(raw, torch.uint8, dev)
    frames = _as_tensor(frames_valid, torch.int32, dev)
    sd = _seed_vector(seeds, raw.shape[0], dev)
    gain_lin = _gain_vector(per_file_gain_db, raw.shape[0], dev)
    raw_in = (in_channels, in_bits, in_big_endian)
    if _rows_ok(cfg, rows_layout, latency_frames):
        payload, out_frames, terminated, pk, level, nf_est = _process_impl_rows(
            raw, frames, sd, rate_in=rate_in, rate_out=cfg.target_rate,
            cfg_key=_cfg_key(cfg, 0), raw_in=raw_in, packed_out=True, gain_lin=gain_lin)
    else:
        lat, static_zero = _latency(latency_frames, dev)
        payload, out_frames, terminated, pk, level, nf_est = _process_impl(
            raw, frames, lat, _noise_floor(cfg, noise_floor_db, dev), sd,
            rate_in=rate_in, rate_out=cfg.target_rate,
            cfg_key=_cfg_key(cfg, _default_pad_frames(cfg, rate_in, latency_frames)),
            static_zero_latency=static_zero, raw_in=raw_in, packed_out=True,
            chain=cfg.chain, gain_lin=gain_lin)
    return ProcessResult(codes=payload, out_frames=out_frames,
                         tail_terminated=terminated, peak_db=pk, rms_db=level,
                         noise_floor_db=nf_est)


def build_process_fn(cfg: ProcessingConfig, rate_in: int, device=None):
    """A `process_batch` for one config and input rate:
    ``fn(x, frames_valid, seeds, latency_frames=0)``."""
    def fn(x, frames_valid, seeds, latency_frames=0):
        return process_batch(x, frames_valid, cfg, rate_in, seeds, latency_frames,
                             device=device)
    return fn
