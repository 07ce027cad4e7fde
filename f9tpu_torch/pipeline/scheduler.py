"""Batch scheduler (port of `f9tpu/pipeline/scheduler.py`).

decode threads -> length-bucketed fixed-shape batches -> the device graph
-> collector (device-to-host copy) -> encode threads, overlapped through
queues.  Files are grouped by (rate, channels, raw wire) and length-bucketed;
per-file status flows through the persistent `JobManifest` (resume at file
granularity) and the `StatusLog`.  Calibration runs the impulse through the
SRC and the insert chain; reverb mode takes its tail threshold from the
measured noise floor (or -80 dB) and caps each capture at
``max_tail_seconds``; channel routing is checked per file before any
output is written.

Without reverb mode, files longer than the largest bucket take the
constant-memory streaming path (`pipeline/stream.py`) on the processor's
device, after the batches, with the group's calibrated latency.

Loudness normalization (``cfg.normalize_lufs``): each decode worker meters
its file with the chunk-exact streamed meter on the processor's device
(`ops.loudness.meter_source_streamed`, the function the streaming path
calls, so a file gets the same gain either way) and the per-file gains ride
to the graph as one vector.  The meter needs decoded floats, so
normalization turns the raw-bytes upload off.  The workers are threads:
their device work is queued on the default CUDA stream beside the batches',
the kernel's launch count is raised under a lock, and the kernel library,
the packed banks and the K-weighting spectrum are built once behind locks
or idempotent caches.  One worker meters at a time (the others go on
decoding): a meter is thousands of small launches, and four threads making
them through one interpreter lock took twice as long as one.

On a mesh (`f9tpu_torch.parallel.make_mesh`) each batch is split over the
files axis, one shard per device, each shard's results downloaded on its
device's side stream and put back in file order by the collector.  A group
whose channel count, routing and chain allow it (`channels_shardable`) is
split over the channels axis too; the raw-bytes upload and loudness
normalization take the files axis only, and every fallback is logged.
Files past the largest bucket stream on the processor's device alone.

Not ported yet, each refused when the processor is built: the rows layout
and the native loader.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import struct
import threading
import time

import numpy as np
import torch

from ..config import ProcessingConfig
from ..io import aiff, codec, flac, wav

from ..device import resolve_device
from ..ops.chain import Chain
from ..ops.dither import file_seed as _file_seed
from ..ops.resample import resample_rates
from .calibration import CAPTURE_FRAMES, CalibrationCache
from . import link
from .graph import not_ported, process_batch, process_batch_raw
from .logbook import StatusLog, Throughput
from .manifest import FileStatus, JobManifest, file_crc32
from .stream import stream_resample_file, streaming_exclusions

__all__ = ["BatchResult", "BatchProcessor", "build_output_path"]

#: files at/above this many source frames get sub-file decode/encode progress
SUBFILE_PROGRESS_FRAMES = 1 << 21
#: host-stage chunk size (frames) for the sub-file progress paths
SUBFILE_PROGRESS_CHUNK = 1 << 20
#: bound of the decode -> dispatch and collector -> encode queues
QUEUE_DEPTH = 16


def build_output_path(src_path: str, output_dir: str, postfix: str,
                      fmt: str = "wav") -> str:
    """out_dir/<stem><postfix>.<fmt>"""
    stem = os.path.splitext(os.path.basename(src_path))[0]
    ext = fmt if fmt in ("aiff", "flac") else "wav"
    return os.path.join(output_dir, f"{stem}{postfix}.{ext}")


@dataclasses.dataclass
class BatchResult:
    completed: int
    failed: int
    invalid: int
    audio_seconds_in: float
    audio_seconds_out: float
    wall_seconds: float
    throughput: dict
    per_file: dict = dataclasses.field(default_factory=dict)
    """Per-file device metrics keyed by input path: out_frames, peak_db,
    rms_db, noise_floor_db, tail_terminated."""
    skipped: int = 0
    """How many of `completed` were resume skips."""
    aborted: bool = False
    """True when a device step failed and the remaining files were failed
    with 'batch aborted'."""

    @property
    def x_realtime(self) -> float:
        return self.audio_seconds_out / self.wall_seconds if self.wall_seconds else 0.0


@dataclasses.dataclass
class _Decoded:
    entry_path: str
    data: np.ndarray      # (channels, frames) float32, or the raw uint8 payload
    rate: int
    gain_db: float = 0.0  # per-file loudness-normalization gain


class BatchProcessor:
    """Orchestrates a whole batch: probe -> validate -> calibrate ->
    pipeline, on ``device`` or over ``mesh``.

    ``mesh``: batches are split over its files axis (``cfg.batch_size``
    must be a multiple of it) and, where a group allows it, its channels
    axis.  ``device`` (default: the mesh's first device, else CUDA) runs
    calibration, the meter and the streamed oversized files."""

    def __init__(
        self,
        cfg: ProcessingConfig,
        log: StatusLog | None = None,
        calibration: CalibrationCache | None = None,
        decode_workers: int = 4,
        encode_workers: int = 4,
        mesh=None,
        device: torch.device | str | None = None,
    ):
        cfg.validate()
        for what, on in (("rows_layout", cfg.device_layout == "rows"),
                         ("native_loader", cfg.native_loader)):
            if on:
                raise not_ported(what)
        if cfg.chain is not None and not isinstance(cfg.chain, Chain):
            raise TypeError(
                "cfg.chain must be an f9tpu_torch.ops.chain.Chain (convert a "
                "JAX chain with f9tpu_torch.ops.chain.chain_from_jax)")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            n = mesh.shape["files"]
            if cfg.batch_size % n:
                raise ValueError(
                    f"batch_size {cfg.batch_size} not divisible by the mesh's "
                    f"files axis ({n})")
            if device is None:
                device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.log = log or StatusLog()
        self.calibration = calibration or CalibrationCache()
        self.decode_workers = decode_workers
        self.encode_workers = encode_workers
        self.throughput = Throughput()
        self._meter_lock = threading.Lock()

    # ------------------------------------------------------------------- run

    def run(self, files: list[str], manifest_path: str | None = None) -> BatchResult:
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        manifest = (
            JobManifest.load_or_create(files, manifest_path)
            if manifest_path else JobManifest.from_files(files)
        )
        try:
            return self._run(files, manifest)
        finally:
            manifest.close()

    def _probe(self, run_files, manifest):
        """Probe + validate; returns (groups, skipped) with groups keyed by
        (rate, channels, raw_bits, raw_big_endian)."""
        cfg = self.cfg
        groups: dict[tuple, list] = {}
        skipped = 0
        for path in run_files:
            e = manifest.get(path)
            if e.status == FileStatus.COMPLETED:
                self.log.append(f"Skip (already completed): {e.path}")
                skipped += 1
                continue
            if not codec.is_supported(e.path):
                manifest.update(e.path, FileStatus.FAILED, error="unsupported file type")
                continue
            try:
                info = codec.probe(e.path)
                in_st = os.stat(e.path)
            except (ValueError, OSError, struct.error, EOFError) as err:
                manifest.update(e.path, FileStatus.FAILED, error=str(err))
                self.log.append(f"Probe failed: {e.path}: {err}")
                continue
            bound_err = cfg.routing_channel_bound_error(info.num_channels)
            if bound_err:
                manifest.update(e.path, FileStatus.FAILED, error=bound_err)
                self.log.append(f"Routing invalid: {e.path}: {bound_err}")
                continue
            if (cfg.require_input_rate is not None
                    and not info.is_valid_for_rate(cfg.require_input_rate)):
                manifest.update(e.path, FileStatus.INVALID_SAMPLE_RATE,
                                sample_rate=info.sample_rate)
                self.log.append(
                    f"Invalid sample rate {info.sample_rate} (require "
                    f"{cfg.require_input_rate}): {e.path}")
                continue
            manifest.update(e.path, FileStatus.PENDING,
                            sample_rate=info.sample_rate,
                            num_channels=info.num_channels,
                            num_frames=info.num_frames,
                            input_size=in_st.st_size,
                            input_mtime_ns=in_st.st_mtime_ns)
            # raw wire: integer-PCM WAV/AIFF/FLAC/AU ship 2-3 B/sample and
            # decode on the device (either byte order)
            raw_bits = (info.bit_depth
                        if (not info.is_float
                            and info.container in ("wav", "aiff", "flac", "au")
                            and info.bit_depth in (16, 24)
                            and cfg.bits in (16, 24)
                            # the loudness meter needs decoded floats
                            and cfg.normalize_lufs is None)
                        else 0)
            raw_be = bool(raw_bits) and info.byte_order == "big"
            groups.setdefault(
                (info.sample_rate, info.num_channels, raw_bits, raw_be),
                []).append(info)
        return groups, skipped

    def _output_paths(self, run_files, manifest) -> dict[str, str]:
        """Collision-safe output naming: two inputs with one stem never share
        an output, and no output lands on an input of this run."""
        cfg = self.cfg
        out_paths: dict[str, str] = {}
        taken: dict[str, int] = {}
        in_real = {os.path.realpath(p) for p in run_files}
        will_process = {p for p in run_files
                        if manifest.get(p).status == FileStatus.PENDING}
        for e in manifest.entries():
            # deliverables of files not (re)processed this run are reserved
            if e.path not in will_process and e.output_path:
                taken.setdefault(e.output_path, 1)
        for path in run_files:
            if path not in will_process:
                continue
            base = build_output_path(path, cfg.output_dir, cfg.postfix,
                                     fmt=cfg.output_format)
            if base in taken or os.path.realpath(base) in in_real:
                stem, ext = os.path.splitext(base)
                n = taken.get(base, 1)
                while True:
                    n += 1
                    out = f"{stem}_{n}{ext}"
                    if out not in taken and os.path.realpath(out) not in in_real:
                        break
                taken[base] = n
                taken[out] = 1
                self.log.append(
                    f"Output name collision: {os.path.basename(path)} -> "
                    f"{os.path.basename(out)}")
            else:
                taken[base] = 1
                out = base
            out_paths[path] = out
        return out_paths

    def _calibrate(self, groups) -> tuple[dict[int, int], dict[int, float]]:
        """Latency and measured noise floor per input rate:
        ``cfg.latency_frames`` (no floor), or a cached/measured impulse
        calibration on the processor's device through SRC + chain."""
        cfg = self.cfg
        latencies: dict[int, int] = {}
        noise_floors: dict[int, float] = {}
        for rate_in, _, _, _ in groups:
            if rate_in in latencies:
                continue
            if cfg.latency_frames is not None:
                latencies[rate_in] = cfg.latency_frames
                continue
            chain_fn, chain_sig, capture, ringout = None, "", CAPTURE_FRAMES, 0
            if cfg.chain is not None:
                # the impulse passes through what a batch passes through; the
                # capture fits the peak and a noise window after the ring-out
                chain, rate_out = cfg.chain, cfg.target_rate
                chain_sig = chain.sig_str()
                ringout = int(chain.tail_frames(rate_out))
                capture = max(CAPTURE_FRAMES,
                              -(-(3 * ringout + (1 << 15)) * rate_in // rate_out))

                def chain_fn(x, _rate_in=rate_in):
                    y = resample_rates(x, _rate_in, rate_out,
                                       quality=cfg.quality, kind=cfg.kind)
                    return chain.apply(y, rate_out)

            cal = self.calibration.get_or_measure(
                rate_in, cfg.target_rate, quality=cfg.quality, kind=cfg.kind,
                chain_fn=chain_fn, chain_sig=chain_sig, capture_frames=capture,
                ringout_frames=ringout, device=self.device)
            if not cal.detected:
                hint = ("" if cfg.chain is None else
                        " (a dynamics stage, such as a slow-attack gate or a "
                        "heavy limiter, can hold the impulse under the "
                        "detection threshold; pass --latency / "
                        "cfg.latency_frames to skip calibration)")
                raise RuntimeError(
                    f"calibration impulse not detected for "
                    f"{rate_in}->{cfg.target_rate}{hint}")
            latencies[rate_in] = cal.latency_frames
            noise_floors[rate_in] = cal.noise_floor_db
            self.log.append(
                f"Calibrated {rate_in}->{cfg.target_rate}: latency "
                f"{cal.latency_frames} frames, noise floor {cal.noise_floor_db:.1f} dB")
        return latencies, noise_floors

    def _normalization_gain(self, path: str, data: np.ndarray, rate: int,
                            norm_info: dict) -> float:
        """A decode worker's meter: the chunk-exact streamed meter on the
        processor's device and the shared gain rule (the functions the
        streaming path uses, so a file gets the bit-identical gain either
        way).  Logs and records ``source_lufs`` / ``applied_gain_db``; a
        file too short or silent to meter keeps 0 dB."""
        from ..ops.loudness import (array_reader, meter_source_streamed,
                                    normalization_gain_db, surround_weights)

        cfg = self.cfg
        with self._meter_lock:
            m = meter_source_streamed(
                array_reader(data), data.shape[0], data.shape[-1], rate,
                want_tp=cfg.normalize_tp_db is not None,
                weights=(surround_weights(data.shape[0])
                         if cfg.surround_weights else None),
                device=self.device)
        lufs = m["lufs"]
        if lufs <= -199.0:
            return 0.0
        gain_db, note = normalization_gain_db(
            cfg.normalize_lufs, lufs, cfg.gain_db, cfg.normalize_tp_db,
            m["true_peak_db"])
        norm_info[path] = {"source_lufs": round(lufs, 2),
                           "applied_gain_db": round(gain_db, 2)}
        self.log.append(
            f"Normalize: {os.path.basename(path)} {lufs:.1f} LUFS -> "
            f"{cfg.normalize_lufs:.1f} ({gain_db:+.1f} dB{note})")
        return gain_db

    def _channel_sharding(self, cfg: ProcessingConfig, channels: int, raw_bits: int) -> bool:
        """Does this group run channel-sharded?  Decided per group, since it
        depends on the input's channel count; a group that cannot keeps the
        files axis, and the log says why."""
        if self.mesh is None or self.mesh.shape["channels"] <= 1:
            return False
        from ..parallel import channels_shardable

        if raw_bits:
            self.log.append("Channel sharding: raw-bytes path has no channel "
                            "axis; files-axis sharding for this group")
            return False
        if cfg.normalize_lufs is not None:
            self.log.append("Channel sharding: loudness normalization uses "
                            "per-file gains (files-axis sharding only)")
            return False
        ok, reason = channels_shardable(cfg, channels, self.mesh)
        if not ok:
            self.log.append(f"Channel sharding unavailable: {reason}")
        return ok

    def _group_noise_floor(self, rate_in: int, noise_floors) -> float | None:
        """Reverb mode's tail threshold base for one rate: the configured
        floor, else the measured one if usable, else None (-80 dB)."""
        cfg = self.cfg
        if cfg.noise_floor_db is not None or not cfg.reverb_mode:
            return cfg.noise_floor_db
        measured = noise_floors.get(rate_in)
        if measured is not None and measured > -150.0:
            self.log.append(f"Using measured noise floor {measured:.1f} dB "
                            f"for {rate_in} Hz group")
            return measured
        self.log.append("No usable noise floor (numerically silent chain); "
                        "using -80 dB fallback for tail detection")
        return None

    def _run(self, files: list[str], manifest: JobManifest) -> BatchResult:
        t_start = time.time()
        cfg = self.cfg
        dev = self.device
        self.log.append(f"Batch start: {len(files)} file(s) -> {cfg.output_dir}")
        run_files = list(dict.fromkeys(files))
        listed = set(run_files)
        groups, skipped = self._probe(run_files, manifest)
        out_paths = self._output_paths(run_files, manifest)
        latencies, noise_floors = self._calibrate(groups)

        audio_in = audio_out = 0.0
        stop_event = threading.Event()
        errors: list[str] = []
        per_file_metrics: dict[str, dict] = {}
        norm_info: dict[str, dict] = {}
        # per-file dither seeds from (cfg.seed, path): reruns are
        # byte-identical whatever the decode order; None = wall clock
        base_seed = (cfg.seed if cfg.seed is not None
                     else int(time.time()) & 0x7FFFFFFF)

        # ---- plan: group -> length buckets; files beyond the largest
        # bucket stream instead (an exact-fit bucket at batch width would
        # stage batch_size x the file on the host and the card) ----
        max_bucket = max(cfg.bucket_frames)
        mesh_files = self.mesh.shape["files"] if self.mesh is not None else 1
        stream_jobs: list[tuple] = []          # (info, rate_in, latency)
        buckets: list[dict] = []
        for (rate_in, channels, raw_bits, raw_be), infos in groups.items():
            infos = [i for i in infos
                     if manifest.get(i.path).status == FileStatus.PENDING]
            if not infos:
                continue
            group_nf = self._group_noise_floor(rate_in, noise_floors)
            # reverb mode caps each capture at max_tail_seconds (longer
            # sources are truncated, never streamed); without it a file
            # beyond the largest bucket streams, unless the config cannot
            # (`streaming_exclusions`, per rate pair), and then it takes an
            # exact-fit bucket at reduced width
            cap = int(cfg.max_tail_seconds * rate_in) if cfg.reverb_mode else None
            group_stream_ok = not streaming_exclusions(cfg, infos[0].path)
            by_bucket: dict[int, list] = {}
            for info in infos:
                n = info.num_frames
                if cap is not None and n > cap:
                    self.log.append(
                        f"Reverb capture cap: truncating {info.path} to "
                        f"{cfg.max_tail_seconds:.0f} s ({cap} frames)")
                    n = cap
                if cap is None and n > max_bucket and group_stream_ok:
                    stream_jobs.append((info, rate_in, latencies[rate_in]))
                    continue
                blen = next((b for b in sorted(cfg.bucket_frames) if n <= b), n)
                by_bucket.setdefault(blen if cap is None else min(max(blen, n), cap),
                                     []).append(info)
            use_cp = self._channel_sharding(cfg, channels, raw_bits)
            # output channel count after in-graph routing / mono fan-out
            out_ch = (len(cfg.channel_routing)
                      if cfg.channel_routing is not None
                      else (cfg.output_channels
                            if (cfg.output_channels and channels == 1)
                            else channels))
            for blen, binfos in sorted(by_bucket.items()):
                bs = cfg.batch_size
                if blen > max_bucket:
                    # a capped reverb capture past the largest bucket: a
                    # narrower batch keeps host staging within the budget,
                    # still a whole number of file shards wide
                    bs = min(max(1, cfg.batch_size * max_bucket // blen),
                             cfg.batch_size)
                    bs = min(-(-bs // mesh_files) * mesh_files, cfg.batch_size)
                    self.log.append(
                        f"Oversized bucket {blen} frames: batch width "
                        f"reduced to {bs} (memory budget)")
                buckets.append(dict(
                    rate_in=rate_in, channels=channels, raw_bits=raw_bits,
                    raw_be=raw_be, lat=latencies[rate_in], group_nf=group_nf,
                    use_cp=use_cp, out_ch=out_ch, blen=blen, infos=binfos, bs=bs))

        work = [(bi, info) for bi, b in enumerate(buckets) for info in b["infos"]]
        dec_q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        enc_q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        res_q: queue.Queue = queue.Queue(maxsize=2)
        # one download stream per card the batches run on, by card index
        sides: dict[int, torch.cuda.Stream] = {}
        for d in (self.mesh.devices.flat if self.mesh is not None else (dev,)):
            if d.type == "cuda":
                i = d.index if d.index is not None else torch.cuda.current_device()
                sides.setdefault(i, link.side_stream(torch.device("cuda", i)))

        def decode_worker(work_q):
            # the finally-sentinel is load-bearing: the main loop counts one
            # None per worker.  A per-file failure marks the file FAILED and
            # posts a failure token so the bucket's arrival count completes.
            try:
                while True:
                    try:
                        bi, info = work_q.get_nowait()
                    except queue.Empty:
                        return
                    if stop_event.is_set():
                        return
                    try:
                        t0 = time.time()
                        if buckets[bi]["raw_bits"]:
                            data, rinfo = codec.read_raw_pcm(info.path)
                            rate = rinfo.sample_rate
                            audio_s = rinfo.num_frames / rate
                        elif info.num_frames >= SUBFILE_PROGRESS_FRAMES:
                            manifest.update(info.path, FileStatus.PROCESSING,
                                            progress=0.0)
                            data, rate = codec.read_audio_progress(
                                info.path,
                                lambda fr, _p=info.path:
                                    manifest.set_progress(_p, 0.3 * fr),
                                chunk_frames=SUBFILE_PROGRESS_CHUNK)
                            audio_s = data.shape[-1] / rate
                        else:
                            data, rate = codec.read_audio(info.path)
                            audio_s = data.shape[-1] / rate
                        self.throughput.add("decode", audio_s, time.time() - t0)
                        gain_db = 0.0
                        if cfg.normalize_lufs is not None and not buckets[bi]["raw_bits"]:
                            gain_db = self._normalization_gain(info.path, data, rate,
                                                               norm_info)
                        manifest.update(info.path, FileStatus.PROCESSING,
                                        progress=0.3)
                        dec_q.put((bi, _Decoded(info.path, data, rate,
                                                gain_db=gain_db)))
                    except Exception as err:
                        manifest.update(info.path, FileStatus.FAILED,
                                        error=str(err))
                        self.log.append(f"Decode failed: {info.path}: {err}")
                        dec_q.put((bi, None))
            finally:
                dec_q.put(None)

        def put_enc(item) -> bool:
            # abort-aware bounded put: never wedge on a dead encode pool
            while not stop_event.is_set():
                try:
                    enc_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def encode_worker():
            while True:
                item = enc_q.get()
                if item is None:
                    return
                path, codes, out_frames, rate_out, metrics = item
                part = None
                try:
                    t0 = time.time()
                    out_path = out_paths[path]
                    # atomic publish: encode to .part, os.replace when done
                    part = out_path + ".part"
                    fmt = cfg.output_format
                    prog = None
                    if out_frames >= SUBFILE_PROGRESS_FRAMES:
                        prog = (lambda fr, _p=path:
                                manifest.set_progress(_p, 0.7 + 0.3 * fr))
                    if metrics["payload"]:
                        out_ch = metrics["out_channels"]
                        writer = {"aiff": aiff.write_aiff_payload,
                                  "flac": flac.write_flac_payload,
                                  }.get(fmt, wav.write_wav_payload)
                        writer(part, codes[: out_frames * out_ch * (cfg.bits // 8)],
                               out_ch, rate_out, bits=cfg.bits,
                               progress_cb=prog,
                               chunk_frames=SUBFILE_PROGRESS_CHUNK)
                    else:
                        writer = {"aiff": aiff.write_aiff_codes,
                                  "flac": flac.write_flac_codes,
                                  }.get(fmt, wav.write_wav_codes)
                        writer(part, codes[:, :out_frames], rate_out,
                               bits=cfg.bits, progress_cb=prog,
                               chunk_frames=SUBFILE_PROGRESS_CHUNK)
                    if cfg.keep_metadata:
                        try:
                            codec.carry_metadata(path, part, cfg.output_format,
                                                 metrics["rate_in"], rate_out)
                        except (ValueError, OSError, MemoryError) as err:
                            self.log.append(
                                f"Metadata passthrough skipped for "
                                f"{os.path.basename(path)}: {err}")
                    os.replace(part, out_path)
                    self.throughput.add("encode", out_frames / rate_out,
                                        time.time() - t0)
                    out_st = os.stat(out_path)
                    manifest.update(
                        path, FileStatus.COMPLETED,
                        output_path=out_path,
                        output_size=out_st.st_size,
                        output_crc32=file_crc32(out_path),
                        output_mtime_ns=out_st.st_mtime_ns,
                        metrics=per_file_metrics.get(path),
                        progress=1.0)
                    self.log.append(
                        f"Completed: {os.path.basename(out_path)} "
                        f"({out_frames} frames @ {rate_out} Hz, "
                        f"peak {metrics['peak_db']:.1f} dB)")
                except Exception as err:
                    # any write-path failure fails the file and keeps the
                    # worker alive so enc_q keeps draining
                    manifest.update(path, FileStatus.FAILED, error=str(err))
                    self.log.append(f"Encode failed: {path}: {err}")
                    errors.append(str(err))
                    if part is not None:
                        try:
                            os.unlink(part)
                        except OSError:
                            pass

        def collector():
            nonlocal audio_in, audio_out
            while True:
                item = res_q.get()
                if item is None:
                    return
                bi, c_paths, dl, c_valid, c_rate_in = item
                b = buckets[bi]
                # stage wall = the collector's blocking time materialising
                # this batch (device work still outstanding + the copies,
                # which the dispatch thread started)
                t_blk = time.time()
                try:
                    # a files-sharded batch comes as one download per shard,
                    # in file order; file i is row i % rows of part i // rows
                    # (no host copy joins the parts)
                    parts = [d.get() for d in (dl if isinstance(dl, list) else [dl])]
                except Exception as err:
                    stop_event.set()
                    manifest.fail_remaining(f"device step failed: {err}", paths=listed)
                    self.log.append(f"BATCH ABORT: device step failed: {err}")
                    errors.append(str(err))
                    continue
                self.throughput.add(
                    "device", float(c_valid.sum()) / c_rate_in,
                    max(time.time() - t_blk, 1e-3))
                rows = len(parts[0][1])
                for i, p in enumerate(c_paths):
                    codes, out_frames, pk, rms, nf, term = (
                        a[i % rows] for a in parts[i // rows])
                    manifest.set_progress(p, 0.7)
                    audio_in += c_valid[i] / c_rate_in
                    audio_out += int(out_frames) / cfg.target_rate
                    per_file_metrics[p] = {
                        "out_frames": int(out_frames),
                        "peak_db": round(float(pk), 2),
                        "rms_db": round(float(rms), 2),
                        "noise_floor_db": round(float(nf), 2),
                        "tail_terminated": bool(term),
                        **norm_info.get(p, {}),
                    }
                    delivered = put_enc(
                        (p, codes, int(out_frames), cfg.target_rate,
                         {"peak_db": float(pk), "rate_in": c_rate_in,
                          "payload": bool(b["raw_bits"]),
                          "out_channels": b["out_ch"]}))
                    if not delivered:
                        manifest.update(p, FileStatus.FAILED,
                                        error="aborted before encode")

        def _download(res) -> link.Download:
            # every result copy starts now, behind the graph on the side
            # stream: this batch's copy overlaps the next batch's graph
            return link.Download(res.codes, res.out_frames, res.peak_db, res.rms_db,
                                 res.noise_floor_db, res.tail_terminated,
                                 side=sides.get(res.codes.device.index))

        pending: dict[int, list] = {bi: [] for bi in range(len(buckets))}
        total = {bi: len(b["infos"]) for bi, b in enumerate(buckets)}
        got = {bi: 0 for bi in range(len(buckets))}

        def flush(bi: int):
            batch_x = pending[bi]
            if not batch_x:
                return
            b = buckets[bi]
            blen, channels, raw_bits = b["blen"], b["channels"], b["raw_bits"]
            paths = [d.entry_path for d in batch_x]
            # always the bucket's full batch width (zero-padded)
            bs = b["bs"]
            valid = np.zeros(bs, np.int32)
            seeds = np.zeros(bs, np.int32)
            gains = np.zeros(bs, np.float32)
            for i, d in enumerate(batch_x):
                seeds[i] = _file_seed(base_seed, d.entry_path)
                gains[i] = d.gain_db
            norm_gains = gains if cfg.normalize_lufs is not None else None
            # stage wall = the dispatch thread's time on this batch: build,
            # upload, graph enqueue and the start of its downloads
            t_disp = time.time()
            # the batch is built in place in a (pinned) host buffer, each
            # byte written once: data, then zeros to the bucket's end
            if raw_bits:
                bpf = channels * (raw_bits // 8)
                xt = link.host_empty((bs, blen * bpf), torch.uint8, dev)
                x = xt.numpy()
                for i, d in enumerate(batch_x):
                    nb = min(len(d.data), blen * bpf)
                    x[i, :nb] = d.data[:nb]
                    x[i, nb:] = 0
                    valid[i] = nb // bpf
            else:
                xt = link.host_empty((bs, channels, blen), torch.float32, dev)
                x = xt.numpy()
                for i, d in enumerate(batch_x):
                    n = min(d.data.shape[-1], blen)
                    x[i, :, :n] = d.data[:, :n]
                    x[i, :, n:] = 0
                    valid[i] = n
            x[len(batch_x):] = 0
            for d in batch_x:
                manifest.set_progress(d.entry_path, 0.4)
            def step(x, v, sd, g, device=dev):
                # enqueue only: the collector thread waits for the device
                # and copies the results while the next batch is staged
                if raw_bits:
                    res = process_batch_raw(
                        x, v, cfg, b["rate_in"], sd,
                        in_channels=channels, in_bits=raw_bits,
                        in_big_endian=b["raw_be"], latency_frames=b["lat"],
                        noise_floor_db=b["group_nf"], device=device)
                else:
                    res = process_batch(
                        x, v, cfg, b["rate_in"], sd,
                        latency_frames=b["lat"], noise_floor_db=b["group_nf"],
                        per_file_gain_db=g, device=device)
                return _download(res)

            try:
                if b["use_cp"]:
                    from ..parallel import process_batch_channels_sharded

                    dl = _download(process_batch_channels_sharded(
                        xt, valid, cfg, b["rate_in"], seeds, self.mesh,
                        latency_frames=b["lat"], noise_floor_db=b["group_nf"]))
                elif self.mesh is not None:
                    from ..parallel import process_files_sharded

                    # each shard on its device; the per-file vectors split
                    # with the batch
                    dl = process_files_sharded(
                        self.mesh, lambda x, v, sd, g: step(x, v, sd, g, device=x.device),
                        xt, valid, seeds, norm_gains)
                else:
                    dl = step(xt, valid, seeds, norm_gains)
            except Exception as err:
                stop_event.set()
                manifest.fail_remaining(f"device step failed: {err}", paths=listed)
                self.log.append(f"BATCH ABORT: device step failed: {err}")
                errors.append(str(err))
                pending[bi] = []
                return
            self.throughput.add("dispatch", float(valid.sum()) / b["rate_in"],
                                max(time.time() - t_disp, 1e-3))
            res_q.put((bi, paths, dl, valid.copy(), b["rate_in"]))
            pending[bi] = []

        dec_threads = []
        if work:
            work_q: queue.Queue = queue.Queue()
            for item in work:
                work_q.put(item)
            for _ in range(min(self.decode_workers, len(work))):
                t = threading.Thread(target=decode_worker, args=(work_q,),
                                     daemon=True)
                t.start()
                dec_threads.append(t)
        enc_threads = [threading.Thread(target=encode_worker, daemon=True)
                       for _ in range(self.encode_workers)]
        for t in enc_threads:
            t.start()
        collector_thread = threading.Thread(target=collector, daemon=True)
        collector_thread.start()

        done_workers = 0
        while done_workers < len(dec_threads):
            item = dec_q.get()
            if item is None:
                done_workers += 1
                continue
            bi, dec = item
            got[bi] += 1
            if stop_event.is_set():
                continue  # aborted: drain the queue, no more batches
            if dec is not None:
                pending[bi].append(dec)
                if len(pending[bi]) >= buckets[bi]["bs"]:
                    flush(bi)
            if got[bi] == total[bi]:
                flush(bi)   # every file of the bucket has arrived or failed
        if not stop_event.is_set():
            for bi in range(len(buckets)):
                flush(bi)   # safety sweep
        res_q.put(None)
        collector_thread.join()
        for _ in enc_threads:
            enc_q.put(None)
        for t in enc_threads:
            t.join()
        for t in dec_threads:
            t.join()

        # ---- oversized files: the streaming path, with the same manifest
        # flow and per-file progress ----
        for info, s_rate_in, s_lat in stream_jobs:
            if stop_event.is_set():
                break
            out_path = out_paths[info.path]
            self.log.append(
                f"Oversized ({info.num_frames} frames > largest bucket "
                f"{max_bucket}): streaming {os.path.basename(info.path)}")
            manifest.update(info.path, FileStatus.PROCESSING, progress=0.0)
            try:
                t0 = time.time()
                n = stream_resample_file(
                    info.path, out_path, cfg,
                    progress_cb=lambda p, _p=info.path: manifest.set_progress(_p, p),
                    latency_frames=s_lat, device=dev)
                # a whole-stream wall (decode, link, device, encode) has its
                # own counter, apart from the batch stages
                self.throughput.add("stream", info.num_frames / s_rate_in,
                                    time.time() - t0)
                audio_in += info.num_frames / s_rate_in
                audio_out += n / cfg.target_rate
                per_file_metrics[info.path] = {"out_frames": int(n), "streamed": True}
                out_st = os.stat(out_path)
                manifest.update(
                    info.path, FileStatus.COMPLETED,
                    output_path=out_path,
                    output_size=out_st.st_size,
                    output_crc32=file_crc32(out_path),
                    output_mtime_ns=out_st.st_mtime_ns,
                    metrics=per_file_metrics[info.path],
                    progress=1.0)
                self.log.append(
                    f"Completed (streamed): {os.path.basename(out_path)} "
                    f"({n} frames @ {cfg.target_rate} Hz)")
            except Exception as err:
                # stream_resample_file has removed its .part file
                manifest.update(info.path, FileStatus.FAILED, error=str(err))
                self.log.append(f"Stream failed: {info.path}: {err}")
                errors.append(str(err))

        if stop_event.is_set():
            manifest.fail_remaining("batch aborted", paths=listed)
        manifest.save()
        counts = manifest.counts(listed)
        wall = time.time() - t_start
        result = BatchResult(
            completed=counts.get("completed", 0),
            failed=counts.get("failed", 0),
            invalid=counts.get("invalid_sample_rate", 0),
            audio_seconds_in=audio_in,
            audio_seconds_out=audio_out,
            wall_seconds=wall,
            throughput=self.throughput.summary(),
            per_file=per_file_metrics,
            skipped=skipped,
            aborted=stop_event.is_set(),
        )
        xrt = result.x_realtime
        xrt_s = f"{xrt:.0f}x" if xrt >= 10 else f"{xrt:.2f}x"
        self.log.append(
            f"Batch done in {wall:.2f}s: {result.completed} completed, "
            f"{result.failed} failed, {result.invalid} invalid rate "
            f"({xrt_s} real time)")
        return result
