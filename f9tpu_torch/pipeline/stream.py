"""Streaming SRC for files of any length (port of `f9tpu/pipeline/stream.py`):
chunked overlap-save through the device in constant memory.

A file flows through fixed-size chunks of whole cycles (multiples of M input
frames), each read from the file with the filter's halo on both sides.  Per
chunk, on the device: the raw-PCM decode (integer WAV/AIFF/FLAC sources ship
their container bytes), mono fan-out, routing and DC removal, the SRC
(`resample_presliced`, with no implicit padding), the
insert chain's streamed form with its carried state, then gain, dither keyed
by absolute output position and the 24-bit packing in one pass (the epilogue
kernel's second pass, `ops.epilogue`).  The host writes each
chunk as it comes, so memory is one chunk whatever the file's length, and
the output is byte-identical across chunk sizes.

The loop runs one chunk ahead: chunk k is read, copied up and queued on the
device before chunk k-1's bytes are written, and chunk k-1's copy to the host
is queued before chunk k's work, so the host's read and write overlap the
device.  The chain's state threads from chunk to chunk in the CUDA stream's
order.

DC removal subtracts the source's whole-file mean, taken in a host pre-pass
on a fixed grid, before the SRC and the chain; the batch path removes the
output's mean after the chain.  For a linear chain the two agree; a
nonlinear stage sees the offset one way and not the other (as in the JAX
package).

Loudness normalization (``cfg.normalize_lufs``) runs a pre-pass before the
DC pre-pass: the source goes through the chunk-exact streamed meter
(`ops.loudness.meter_source_streamed`, on its own fixed grid, never the
audio path's chunk size) and the shared gain rule, the functions the batch
scheduler uses, so a file gets the same gain, bit for bit, on either path.

Varispeed banks stream like any other: the card takes the flat haloed chunk
(`resample_presliced`), as it does for dense banks.  The JAX package marshals varispeed chunks into cycle rows on the
host to spare its device a retiling pass that this kernel never makes.

On a mesh with a frames axis (``mesh=``) each step is a super-chunk of
n_shards chunks split over the frames axis (`run_sharded`): each shard
decodes its part of the container bytes, trades filter halos with its
neighbours (`f9tpu_torch.parallel.sharding.frames_local`; the super-chunk's
outer halos are read from the file), resamples, and, without a chain, runs
the finish with its positions offset; varispeed banks too, as on one
device.  A chain's state is sequential over frames, so with a chain the
super-chunk's SRC output is gathered on the first device and finished
there.  The host writes the super-chunks in file order through the same
`_Emitter`, so the bytes equal the one-device stream's.
"""

from __future__ import annotations

import collections
import math
import os
import time

import numpy as np
import torch

from ..config import ProcessingConfig
from ..io.aiff import AiffWriter
from ..io.flac import FlacWriter
from ..io.wav import WavWriter
from ..models.filters import design_cycle_bank, resolve_ratio

from ..device import resolve_device
from ..ops import dither, epilogue, frontend
from ..ops.chain import Chain
from ..ops.resample import resample_presliced
from .graph import gain_lin_f32
from .link import Download, upload

__all__ = ["stream_resample_file", "stream_chunk_plan", "streaming_exclusions"]

#: output container -> incremental writer (one open/append/close shape)
_WRITERS = {"aiff": AiffWriter, "flac": FlacWriter}
#: the DC pre-pass's block: fixed, so the mean (and every byte after it)
#: does not depend on the chunk size
DC_GRID = 1 << 20


def streaming_exclusions(cfg: ProcessingConfig, in_path: str | None = None) -> list[str]:
    """Reasons this config cannot run on the streaming path (empty = it
    can): the one source of the streaming path's coverage, which the
    scheduler consults before routing an oversized file here.  The one gate
    is the JAX package's: byte-exact streaming of an FFT chain needs chunks
    that are multiples of both L and the chain's `stream_grid`, which for a
    varispeed ratio (L in the ten-thousands) would reach tens of megaframes."""
    if cfg.chain is not None and in_path is not None:
        g = int(cfg.chain.stream_grid(cfg.target_rate))
        if g > 1:
            from ..io import codec

            try:
                rate_in = codec.probe(in_path).sample_rate
            except (OSError, ValueError):
                return []     # unreadable input fails later, with its own error
            L, _M = resolve_ratio(rate_in, cfg.target_rate)
            m = g // math.gcd(L, g)
            if m * L > (1 << 23):
                return [
                    f"chain FFT-grid alignment needs {m * L}-frame chunks "
                    f"for ratio L={L} (over the 2^23 budget); this "
                    "varispeed + FFT-chain config cannot stream — use the "
                    "batch path"]
    return []


def stream_chunk_plan(bank, chunk_seconds: float, rate_in: int) -> int:
    """Chunk length in input frames: whole cycles, ~chunk_seconds long."""
    cycles = max(1, int(chunk_seconds * rate_in) // bank.M)
    return cycles * bank.M


def _chunk_cycles(bank, cfg: ProcessingConfig, chunk_seconds: float,
                  rate_in: int) -> int:
    """Cycles per chunk: ~chunk_seconds, grown to cover the chain's
    ring-out (a ring much longer than the chunk would re-convolve its
    context every chunk) and rounded up to a whole number of the chain's
    FFT blocks, so every chunk starts on the absolute block grid."""
    cycles = stream_chunk_plan(bank, chunk_seconds, rate_in) // bank.M
    if cfg.chain is not None:
        ring = int(cfg.chain.tail_frames(cfg.target_rate))
        if ring >= cycles * bank.L:
            cycles = ring // bank.L + 1
        g = int(cfg.chain.stream_grid(cfg.target_rate))
        m = g // math.gcd(bank.L, g)   # smallest granule of cycles
        cycles = -(-cycles // m) * m
    return cycles


class _TailDetector:
    """Host-side incremental twin of `ops.trim.detect_tail_end`: the same
    hop-aligned windows, threshold rule (nf + nf*margin%, -80 dB fallback)
    and N-consecutive-quiet-windows termination, evaluated as the emitted
    stream flows past, so reverb-mode tails stream in constant memory.  A
    window's verdict is known once its last frame has been fed, so detection
    never lags the write position.

    It sees the post-gain signal (the batch graph detects pre-gain), so the
    threshold is shifted by the applied gain."""

    def __init__(self, rate_out: int, min_frames: int, cfg,
                 gain_db_total: float, noise_floor_db: float | None):
        win = max(1, rate_out * cfg.tail_window_ms // 1000)
        self.hop = max(1, rate_out * cfg.tail_hop_ms // 1000)
        self.factor = -(-win // self.hop)
        self.consecutive = int(cfg.tail_consecutive)
        nf = noise_floor_db
        thr = (nf + nf * float(cfg.noise_floor_margin_pct) / 100.0
               if (nf is not None and nf < 0) else -80.0)
        self.threshold_db = thr + gain_db_total
        self.mode = cfg.tail_mode
        self.min_frames = int(min_frames)
        self._stats = collections.deque(maxlen=self.factor)
        self._n_chunks = 0
        self._run = 0
        self._rem = np.zeros(0, np.float32)

    def feed(self, env: np.ndarray) -> int | None:
        """Feed the next per-frame statistics (loudest-channel |envelope| in
        peak mode, channel-mean square in rms mode); returns the absolute
        end frame the moment termination is confirmed."""
        buf = (np.concatenate([self._rem, env])
               if self._rem.size else np.asarray(env))
        n_complete = len(buf) // self.hop
        for k in range(n_complete):
            seg = buf[k * self.hop:(k + 1) * self.hop]
            self._stats.append(float(seg.max()) if self.mode == "peak"
                               else float(seg.sum(dtype=np.float64)))
            self._n_chunks += 1
            if len(self._stats) < self.factor:
                continue
            w = self._n_chunks - self.factor        # window index
            if self.mode == "peak":
                level = max(self._stats)
                level_db = (20.0 * np.log10(max(level, 1e-30))
                            if level > 0 else -200.0)
            else:
                e = sum(self._stats) / (self.factor * self.hop)
                level_db = (10.0 * np.log10(max(e, 1e-30))
                            if e > 0 else -200.0)
            end_w = (w + self.factor) * self.hop
            quiet = level_db < self.threshold_db and end_w >= self.min_frames
            self._run = self._run + 1 if quiet else 0
            if self._run >= self.consecutive:
                return end_w
        self._rem = buf[n_complete * self.hop:]
        return None


def _finish_chunk(y, carry, seeds_c, pos0: int, gain: float, *, rate_out, bits,
                  do_dither, chain=None, chain_pos=0, silent=(),
                  want_env=False, env_rms=False, wire=None):
    """Everything after the SRC for one chunk: the chain's streamed form
    (``carry`` its state, ``chain_pos`` the chunk's absolute pre-trim
    position), the tail detector's statistic of the post-gain float
    signal, then one call of `ops.epilogue` with no mask and no statistics
    (the kernel's pass 2 on the card): gain, dither keyed by absolute output
    position ``pos0 + j`` (so the bytes do not depend on the chunk size),
    routed-silent channels (``silent``, their indices) to zero, and the
    download wire: ``"pack24"`` the interleaved 24-bit payload, ``"i16"``
    int16 codes.  Returns ``(codes, env or None, carry)``."""
    if chain is not None:
        y, carry = chain.apply_stream(y, carry, rate_out, chain_pos)
    env = None
    if want_env:
        # detecting on the float signal, not the codes: at 16 bits the TPDF
        # floor's window peak sits near -90 dBFS, above usable thresholds
        yg = y * gain
        env = (torch.mean(torch.square(yg), dim=0) if env_rms
               else torch.amax(torch.abs(yg), dim=0))
    codes = epilogue.epilogue(
        y.contiguous()[None], None, seeds_c[None] if do_dither else None, bits=bits,
        remove_dc=False, gain=gain, silent=silent, packed=24 if wire == "pack24" else None,
        pos0=pos0, stats=False,
        codes_dtype=torch.int16 if wire == "i16" else torch.int32)[0][0]
    return codes, env, carry


def _raw_front(raw, *, in_wire, in_channels, fanout=0, routing=None,
               mean=None, valid=(0, 0), idx_offset=0):
    """The on-device input front of the raw wire: container bytes ->
    float32 ``(channels, frames)``, mono fan-out, the routing gather
    (``routing``, -1 silent) and the DC mean subtracted over the real span
    ``valid`` only (zero-padded halos stay exactly zero, as on the float
    wire's host path): one call of `ops.frontend` (the kernel on the card,
    its twin on the CPU).  Integer to float scaling is a power of two, so
    the floats equal the host decode's.  ``idx_offset`` is the frame of
    ``raw``'s first byte in ``valid``'s coordinates (a frames shard's place
    in its super-chunk)."""
    in_bits, in_be = in_wire
    return frontend.front_end(raw, raw=(in_channels, in_bits, in_be), routing=routing,
                              out_channels=fanout or None, mean=mean, span=valid,
                              idx_offset=idx_offset)


class _Emitter:
    """The stream's host tail: latency-drop accounting, the output-limit
    clamp, the tail detector's feed with truncation where it fires, the
    incremental write and progress.  ``codes`` arrive as int codes
    ``(channels, n)`` or, on the ``"pack24"`` wire, interleaved bytes."""

    def __init__(self, writer, detector, *, lat, out_limit, out_total,
                 progress_cb=None, wire=None, channels=0):
        self.writer = writer
        self.detector = detector
        self.lat = int(lat)
        self.out_limit = int(out_limit)
        self.out_total = int(out_total)
        self.progress_cb = progress_cb
        self.written = 0
        self.g0 = 0          # pre-trim output frame index of the next chunk
        self.wire = wire
        self._stride = channels * 3

    def _frames(self, codes: np.ndarray) -> int:
        return (codes.shape[0] // self._stride if self.wire == "pack24"
                else codes.shape[1])

    def _append(self, codes: np.ndarray, drop: int, take: int) -> None:
        if self.wire == "pack24":
            self.writer.append_payload(
                codes[drop * self._stride:(drop + take) * self._stride])
        else:
            self.writer.append_codes(codes[:, drop:drop + take])

    def _progress(self, p: float) -> None:
        if self.progress_cb:
            self.progress_cb(p)

    def emit_head(self, codes: np.ndarray, env) -> bool:
        """Write the acausal-latency head (dithered digital silence at
        output positions 0..|lat|) before the first chunk, the streaming
        twin of `trim_latency`'s right shift.  ``g0`` does not move: chunk
        k's noise keying already lands past the head."""
        take = min(self._frames(codes), self.out_limit - self.written)
        if self.detector is not None and take > 0:
            self.detector.feed(np.asarray(env)[:take].astype(np.float32))
        self._append(codes, 0, take)
        self.written += take
        self._progress(min(1.0, self.written / max(self.out_total, 1)))
        return self.written >= self.out_limit

    def emit(self, codes: np.ndarray, env) -> bool:
        """Consume one chunk; True when the stream is finished (tail
        detected or ``out_limit`` reached)."""
        n = self._frames(codes)
        drop = min(max(0, self.lat - self.g0), n)
        take = min(n - drop, self.out_limit - self.written)
        if self.detector is not None and take > 0:
            fire = self.detector.feed(
                np.asarray(env)[drop:drop + take].astype(np.float32))
            if fire is not None:
                self._append(codes, drop, max(0, fire - self.written))
                self.written = max(self.written, fire)
                self._progress(1.0)
                return True
        self._append(codes, drop, take)
        self.written += take
        self.g0 += n
        self._progress(min(1.0, self.written / max(self.out_total, 1)))
        return self.written >= self.out_limit


def _emit_acausal_head(em: _Emitter, lat: int, out_ch: int, seeds_c, gain, cfg,
                       want_env: bool, env_rms: bool, wire, silent, dev) -> bool:
    """Negative latency (an acausal chain, or a caller's compensation):
    ``|lat|`` frames of dithered digital silence at output positions
    0..|lat|, through the same `_finish_chunk` as the chunks.  Returns True
    if that already completes the stream."""
    codes, env, _ = _finish_chunk(
        torch.zeros((out_ch, -int(lat)), device=dev), None, seeds_c, 0, gain,
        rate_out=cfg.target_rate, bits=cfg.bits, do_dither=cfg.dither,
        silent=silent, want_env=want_env, env_rms=env_rms, wire=wire)
    codes, env = Download(codes, env).get()
    return em.emit_head(codes, env)


def stream_resample_file(
    in_path: str,
    out_path: str,
    cfg: ProcessingConfig,
    chunk_seconds: float = 20.0,
    progress_cb=None,
    mesh=None,
    latency_frames: int | None = None,
    noise_floor_db: float | None = None,
    device: torch.device | str | None = None,
    norm_info: dict | None = None,
) -> int:
    """Resample ``in_path`` -> ``out_path`` at ``cfg.target_rate`` in
    constant memory on ``device`` (default: the mesh's first device, else
    CUDA, raising without a GPU); returns the output frames written.  See
    `_stream_resample_impl`.  ``mesh`` (with a frames axis of 2 or more)
    splits each step over its frames axis.
    Under ``cfg.normalize_lufs`` a ``norm_info`` dict receives the measured
    ``source_lufs`` and the ``applied_gain_db`` (and ``gain_note``).

    Refuses out == in before any pre-pass reads the file, and owns the
    ``.part`` file: any failure (device error, Ctrl-C) removes it."""
    if os.path.realpath(out_path) == os.path.realpath(in_path):
        raise ValueError(
            f"output path equals the input path ({in_path}); refusing "
            "to destroy the source")
    try:
        return _stream_resample_impl(
            in_path, out_path, cfg, chunk_seconds, progress_cb, mesh,
            latency_frames, noise_floor_db,
            resolve_device(device if device is not None or mesh is None
                           else mesh.devices.flat[0]), norm_info)
    except BaseException:
        try:
            os.unlink(out_path + ".part")
        except OSError:
            pass
        raise


def _stream_resample_impl(in_path, out_path, cfg, chunk_seconds, progress_cb,
                          mesh, latency_frames, noise_floor_db, dev,
                          norm_info=None) -> int:
    """The output has exactly ``ceil(in_frames * L / M)`` frames, as the
    whole-file path (plus the tail in reverb mode).

    - ``cfg.chain`` streams exactly (`Chain.apply_stream`); chunks grow to
      at least the chain's ring-out and to a multiple of its `stream_grid`.
    - Latency (``latency_frames``, else ``cfg.latency_frames``; under
      ``cfg.trim_enabled``): the first ``lat`` emitted frames are dropped
      and chunks flow past the input's end until the whole output is
      written; a negative latency writes a dithered head.  Dither is keyed
      by the post-trim position, as in the batch path.
    - Routing and mono fan-out apply per chunk before the SRC.
    - Reverb mode: `_TailDetector` follows the emitted stream; the input is
      unbounded, only the tail is capped at ``max_tail_seconds``.
    - Per-file dither seeds come from ``(cfg.seed, in_path)`` as in the
      batch scheduler, so a file streamed or batched carries the same noise.
    """
    if mesh is not None and mesh.shape["frames"] < 2:
        raise ValueError("mesh has no frames axis to shard over")
    if cfg.chain is not None and not isinstance(cfg.chain, Chain):
        raise TypeError(
            "cfg.chain must be an f9tpu_torch.ops.chain.Chain (convert a "
            "JAX chain with f9tpu_torch.ops.chain.chain_from_jax)")
    excl = streaming_exclusions(cfg, in_path)
    if excl:
        raise ValueError(excl[0])
    lat = 0
    if cfg.trim_enabled:
        lat = int(latency_frames if latency_frames is not None
                  else (cfg.latency_frames or 0))
    from ..io import codec

    with codec.open_reader(in_path) as reader:
        rate_in = reader.sample_rate
        bank = design_cycle_bank(rate_in, cfg.target_rate,
                                 quality=cfg.quality, kind=cfg.kind)
        M, W = bank.M, bank.W
        halo_left = bank.pad_front
        halo_right = max(0, W - M - halo_left)
        cycles = _chunk_cycles(bank, cfg, chunk_seconds, rate_in)
        chunk_in = cycles * M
        chunk_out = cycles * bank.L
        T = reader.num_frames
        C_in = reader.num_channels
        out_total = bank.out_len(T)

        bound_err = cfg.routing_channel_bound_error(C_in)
        if bound_err:
            raise ValueError(bound_err)   # before any output is written
        routing = (tuple(cfg.channel_routing)
                   if cfg.channel_routing is not None else None)
        fanout = (cfg.output_channels
                  if (cfg.output_channels and C_in == 1
                      and cfg.output_channels != 1) else 0)

        def routed(x: np.ndarray) -> np.ndarray:
            if fanout:
                x = np.broadcast_to(x, (fanout, x.shape[1]))
            if routing is not None:
                r = np.asarray(routing, np.int32)
                x = np.where((r < 0)[:, None], np.float32(0.0),
                             x[np.where(r < 0, 0, r)])
            return np.ascontiguousarray(x, dtype=np.float32)

        out_ch = (len(routing) if routing is not None
                  else (cfg.output_channels
                        if (cfg.output_channels and C_in == 1) else C_in))
        silent = tuple(i for i, r in enumerate(routing or ()) if r < 0)

        reverb = bool(cfg.reverb_mode)
        cap_extra = (int(cfg.max_tail_seconds * cfg.target_rate)
                     if reverb and T > 0 else 0)   # an empty file has no tail
        out_limit = out_total + cap_extra
        if cfg.output_format == "aiff":
            # AIFF has no 64-bit container: a projected overflow fails now,
            # not after hours of writing
            from ..io.aiff import check_aiff_capacity

            check_aiff_capacity(out_limit, out_ch, cfg.bits)

        # loudness-normalization pre-pass: the source (before routing, as
        # the batch scheduler meters the decoded input) through the shared
        # streamed meter on its own default grid; the audio path's
        # chunk_seconds must not leak in, or the gain and every byte after
        # it would depend on it
        norm_gain_db = 0.0
        if cfg.normalize_lufs is not None and T > 0:
            from ..ops.loudness import (meter_source_streamed,
                                        normalization_gain_db, surround_weights)

            m = meter_source_streamed(
                reader.read, C_in, T, rate_in,
                want_tp=cfg.normalize_tp_db is not None,
                weights=surround_weights(C_in) if cfg.surround_weights else None,
                device=dev)
            if m["lufs"] > -199.0:
                norm_gain_db, note = normalization_gain_db(
                    cfg.normalize_lufs, m["lufs"], cfg.gain_db,
                    cfg.normalize_tp_db, m["true_peak_db"])
                if norm_info is not None:
                    norm_info.update(source_lufs=m["lufs"],
                                     applied_gain_db=norm_gain_db, gain_note=note)

        # the gain as one float32 factor, composed as the batch graph
        # composes g_static * gain_lin, so the product is the same float32
        g_static = 10.0 ** (cfg.gain_db / 20.0) if cfg.gain_db else 1.0
        if cfg.normalize_lufs is not None:
            gain = float(np.float32(g_static) * gain_lin_f32(norm_gain_db)[0])
        else:
            gain = float(np.float32(g_static))

        # DC pre-pass: the whole-file mean per routed channel, accumulated
        # on the fixed DC_GRID (a chunk-sized grid would make the mean, and
        # every byte, depend on the chunk size)
        mean = np.zeros((out_ch, 1), np.float32)
        if cfg.remove_dc and T > 0:
            acc = np.zeros(out_ch, np.float64)
            pos = 0
            while pos < T:
                blk = routed(reader.read(pos, DC_GRID))
                acc += blk.sum(axis=1)
                pos += blk.shape[1]
            mean = (acc / T).astype(np.float32).reshape(-1, 1)

        base_seed = (cfg.seed if cfg.seed is not None
                     else int(time.time()) & 0x7FFFFFFF)
        seeds_c = dither.channel_seeds(
            torch.tensor(dither.file_seed(base_seed, in_path), dtype=torch.int64,
                         device=dev), out_ch)
        carry = (cfg.chain.stream_init(cfg.target_rate, out_ch, dev)
                 if cfg.chain is not None else None)
        detector = None
        if reverb and T > 0:
            nf = (noise_floor_db if noise_floor_db is not None
                  else cfg.noise_floor_db)
            detector = _TailDetector(cfg.target_rate, out_total, cfg,
                                     20.0 * float(np.log10(max(gain, 1e-30))), nf)
        want_env = detector is not None
        env_rms = want_env and cfg.tail_mode == "rms"
        wire = {24: "pack24", 16: "i16"}.get(cfg.bits)

        # raw upload wire: integer-PCM sources ship their container bytes
        # (3 B/sample at 24 bits) and decode, fan out, route and take the DC
        # mean off on the device, bit for bit as the host path does
        in_wire = getattr(reader, "raw_wire", lambda: None)()
        bpf_in = C_in * (in_wire[0] // 8) if in_wire is not None else 0
        mean_dev = (torch.from_numpy(mean).to(dev)
                    if (cfg.remove_dc and in_wire is not None) else None)

        def read_span(lo: int, length: int) -> np.ndarray:
            """Frames ``[lo, lo + length)`` routed and DC-corrected,
            zero-padded past both ends of the file (the mean comes off the
            real samples only: a -mean step in the halos would smear an edge
            through the filter)."""
            hi = lo + length
            span = routed(reader.read(max(0, lo), hi - max(0, lo)))
            if cfg.remove_dc:
                span = span - mean
            pad_l = max(0, -lo)
            pad_r = length - pad_l - span.shape[1]
            return np.pad(span, ((0, 0), (pad_l, max(0, pad_r))))

        def read_span_raw(lo: int, length: int):
            """The container bytes of frames ``[lo, lo + length)``,
            zero-padded past both ends, and the real frames' span in it."""
            hi = lo + length
            span_b = reader.read_raw(max(0, lo), hi - max(0, lo))
            pad_l = max(0, -lo)
            buf = np.zeros(length * bpf_in, np.uint8)
            buf[pad_l * bpf_in:pad_l * bpf_in + span_b.size] = span_b
            return buf, pad_l, pad_l + span_b.size // bpf_in

        def finish(y, pos0: int, chain_pos: int) -> tuple:
            """Everything after the SRC for the chunk ``y`` whose first
            output sits at pre-trim position ``chain_pos``, on ``y``'s
            device; ``carry`` (the chain's state) threads through."""
            nonlocal carry
            codes, env, carry = _finish_chunk(
                y, carry, seeds_c.to(y.device), pos0, gain,
                rate_out=cfg.target_rate, bits=cfg.bits, do_dither=cfg.dither,
                chain=cfg.chain, chain_pos=chain_pos, silent=silent,
                want_env=want_env, env_rms=env_rms, wire=wire)
            return codes, env

        def dispatch(k: int) -> Download:
            # chunk k reads input at k*chunk_in and emits pre-trim output
            # positions k*chunk_out: the geometry is fixed, so dispatch runs
            # ahead of emission; `carry` threads through dispatch order
            span = chunk_in + halo_left + halo_right
            if in_wire is not None:
                buf, a, b = read_span_raw(k * chunk_in - halo_left, span)
                xp = _raw_front(upload(buf, dev), in_wire=in_wire,
                                in_channels=C_in, fanout=fanout, routing=routing,
                                mean=mean_dev, valid=(a, b))
            else:
                xp = upload(read_span(k * chunk_in - halo_left, span), dev)
            y = resample_presliced(xp, bank, cycles)
            return Download(*finish(y, k * chunk_out - lat, k * chunk_out))

        step_out = chunk_out
        if mesh is not None:
            step_out, dispatch = _sharded_dispatch(
                mesh, bank, cycles, lat, read_span, read_span_raw, finish,
                in_wire=in_wire, raw_args=(C_in, fanout, routing, mean_dev),
                shard_finish=cfg.chain is None)

        # atomic publish: stream into .part, os.replace at the end
        part = out_path + ".part"
        writer_cls = _WRITERS.get(cfg.output_format, WavWriter)
        with writer_cls(part, out_ch, cfg.target_rate, bits=cfg.bits) as writer:
            em = _Emitter(writer, detector, lat=lat, out_limit=out_limit,
                          out_total=out_total, progress_cb=progress_cb,
                          wire=wire, channels=out_ch)
            # one chunk ahead: dispatch chunk k, then write chunk k-1.  The
            # chunk count is exact without a detector; in reverb mode the
            # stream's length depends on the data, and at most one queued
            # chunk is discarded when the detector fires
            n_chunks = (None if detector is not None
                        else -(-(out_limit + lat) // step_out))
            k = 0
            pending = None
            done = out_limit == 0
            if lat < 0 and not done:
                done = _emit_acausal_head(em, lat, out_ch, seeds_c, gain, cfg,
                                          want_env, env_rms, wire, silent, dev)
            while not done:
                nxt = dispatch(k) if (n_chunks is None or k < n_chunks) else None
                k += 1
                if pending is not None:
                    done = em.emit(*pending.get())
                elif nxt is None:
                    break       # nothing in flight, nothing left
                if not done:
                    pending = nxt
        _carry_metadata(in_path, part, cfg, rate_in)
        os.replace(part, out_path)
        return em.written


def _sharded_dispatch(mesh, bank, cycles: int, lat: int, read_span, read_span_raw, finish,
                      *, in_wire, raw_args, shard_finish: bool):
    """The step of the sharded stream: ``(super_out, dispatch)``, where
    ``dispatch(k)`` queues super-chunk k, ``n`` chunks of ``cycles`` cycles
    split over the mesh's frames axis, and returns its `Download`.

    Each shard takes its chunk (container bytes decoded on the shard when
    ``in_wire``, else host floats), trades halos with its neighbours
    (`frames_local`), and the outermost shards take the halos read from the
    file; dense and varispeed banks alike.  ``shard_finish``: each shard also
    runs ``finish`` (gain, dither at its absolute positions, packing) and
    the codes are gathered; otherwise (a chain, whose state is sequential)
    the SRC output is gathered and finished on the first device."""
    from ..parallel import P, run_sharded, shard_halos
    from ..parallel.sharding import frames_local

    sub = mesh.sub(("frames",))
    n = sub.shape["frames"]
    M, L = bank.M, bank.L
    chunk_in, chunk_out = cycles * M, cycles * L
    super_in, super_out = n * chunk_in, n * chunk_out
    halo_left, halo_right = shard_halos(bank)
    if max(halo_left, halo_right) > chunk_in:
        raise ValueError(
            f"chunk of {chunk_in} frames is smaller than the filter halo "
            f"({max(halo_left, halo_right)}); raise chunk_seconds")
    C_in, fanout, routing, mean_dev = raw_args
    frames = P(None, "frames")

    def local(ctx, xc, ol, orr, k, raw_valid):
        idx = ctx.axis_index("frames")
        if raw_valid is not None:
            xc = _raw_front(xc, in_wire=in_wire, in_channels=C_in, fanout=fanout,
                            routing=routing,
                            mean=None if mean_dev is None else mean_dev.to(ctx.device),
                            valid=raw_valid, idx_offset=idx * chunk_in)
        y = frames_local(ctx, xc, ol, orr, bank)
        if not shard_finish:
            return (y,)
        # positions of this shard's outputs in the whole stream
        return finish(y, k * super_out + idx * chunk_out - lat, k * super_out)

    def dispatch(k: int) -> Download:
        start = k * super_in
        raw_valid = None
        if in_wire is not None:
            x, a, b = read_span_raw(start, super_in)
            raw_valid, spec = (a, b), P("frames")
        else:
            x, spec = read_span(start, super_in), frames
        ol = read_span(start - halo_left, halo_left)
        orr = read_span(start + super_in, halo_right)
        out = run_sharded(sub, local, (x, ol, orr, k, raw_valid),
                          (spec, P(), P(), None, None),
                          (frames,) if not shard_finish else None)
        if not shard_finish:
            return Download(*finish(out[0], k * super_out - lat, k * super_out))
        codes = [o[0] for o in out]
        env = [o[1] for o in out]
        dev0 = sub.devices.flat[0]
        return Download(torch.cat([c.to(dev0) for c in codes], dim=-1),
                        None if env[0] is None else torch.cat([e.to(dev0) for e in env]))

    return super_out, dispatch


def _carry_metadata(in_path: str, out_path: str, cfg, rate_in: int) -> None:
    """Best-effort ``keep_metadata`` (`io.codec.carry_metadata`, the batch
    path's rule); failures are swallowed: the audio is complete."""
    if not cfg.keep_metadata:
        return
    from ..io.codec import carry_metadata

    try:
        carry_metadata(in_path, out_path, cfg.output_format, rate_in,
                       cfg.target_rate)
    except (ValueError, OSError, MemoryError):
        pass
