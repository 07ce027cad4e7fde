"""Command-line interface of the port (counterpart of `f9tpu/cli.py`): every
subcommand of the JAX CLI, on ``--device`` (default ``cuda``; ``cpu`` runs
the plain PyTorch path and is never taken unless asked for).

    process   batch resample files (insert loop, varispeed, normalization)
    stream    constant-memory resample of one long file
    preview   render a gapless playlist onto a bus, with a monitor mix
    measure   latency through SRC and the --chain-* chain (impulse test)
    selftest  the 1 kHz loop test through the device's SRC [--parity]
    probe     file metadata [--loudness]
    watch     process files as they land in a folder (polling daemon)
    verify    audit a manifest's outputs by size and CRC-32
    devices   list the CUDA devices

    python -m f9tpu_torch.cli process ./stems --out ./out --rate 48000 [--device cuda]
    python -m f9tpu_torch.cli process ./stems --out ./out --reverb --routing 1,0 \
        --chain-delay-ms 5 --chain-eq peaking:1000:1:3 --chain-comp=-18:3 \
        --chain-ir hall.wav --chain-limit=-0.3
    python -m f9tpu_torch.cli stream long.wav --out long_48k.wav --rate 48000
    python -m f9tpu_torch.cli preview a.wav b.wav --out bus.wav --channels 8 \
        --target-channels 2,3 --monitor --monitor-out mon.wav [--stream]
    python -m f9tpu_torch.cli watch ./drop --out ./out --rate 48000 --interval 2
    python -m f9tpu_torch.cli selftest --parity

``--config FILE`` loads `process` defaults from JSON (the JAX CLI's format
and keys) and ``--save-config FILE`` writes the resolved settings back.
``--files-shards`` / ``--channel-shards`` (`process`, `watch`) and
``--frames-shards`` (`stream`) run the job on a mesh
(`f9tpu_torch.parallel`) over every card of the machine, or over n CPU
shards with ``--device cpu``; a mesh larger than the machine's cards fails
with its size (``mesh 2x1x1 != 1 devices``), it never runs on fewer shards.
``--device-layout rows`` (`process`, `watch`) runs the JAX package's rows
layout, whose bytes are the packed layout's.  Without a GPU a command on
``cuda`` exits 1 with a one-line error.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

from .config import ProcessingConfig
from .io import codec

from .device import NoDeviceError, resolve_device
from .pipeline.calibration import CalibrationCache, measure_latency
from .pipeline.logbook import StatusLog
from .pipeline.scheduler import BatchProcessor

__all__ = ["main"]

#: `process` options persisted by --save-config and applied by --config,
#: under their CLI names (the JAX CLI's keys, so either reads the other's
#: file).
_CONFIG_KEYS = (
    "rate", "quality", "kind", "bits", "postfix", "output_format",
    "no_dither", "keep_dc", "normalize_lufs", "normalize_tp_db",
    "surround_weights", "keep_metadata",
    "gain", "reverb", "noise_floor", "margin", "require_rate", "batch_size",
    "routing", "channels", "device_layout", "seed", "latency",
    "chain_ir", "chain_wet", "chain_dry", "chain_fir", "chain_delay_ms",
    "chain_eq", "chain_comp", "chain_sat", "chain_width",
    "chain_gate", "chain_limit",
)


def _expand_inputs(inputs: list[str]) -> list[str]:
    files: list[str] = []
    for item in inputs:
        if os.path.isdir(item):
            files.extend(sorted(
                os.path.join(item, name) for name in os.listdir(item)
                if codec.is_supported(name)))
        elif os.path.exists(item):
            files.append(item)   # literal path first: '[' is legal in names
        elif any(ch in item for ch in "*?["):
            files.extend(sorted(glob.glob(item)))
        else:
            files.append(item)   # let probe report the error
    return list(dict.fromkeys(files))


def _parse_routing(spec):
    """'0,1,-1,2' -> [0, 1, -1, 2] with a clean usage error on junk."""
    if not spec:
        return None
    try:
        return [int(c) for c in spec.split(",")]
    except ValueError:
        raise SystemExit(
            f"error: --routing must be comma-separated integers "
            f"(-1 = silent), got {spec!r}")


def _build_chain(args):
    """The insert chain from the CLI flags, in studio signal order: delay
    -> gate -> EQ -> FIR -> compressor -> saturator -> width -> reverb ->
    limiter, each optional (the JAX CLI's `_build_chain`)."""
    from .ops.chain import (Biquad, Chain, Compressor, ConvolutionReverb,
                            Delay, Expander, FIRInsert, Limiter, Saturator,
                            StereoWidth)

    stages = []
    if args.chain_delay_ms:
        try:
            stages.append(Delay(args.chain_delay_ms / 1000.0))
        except ValueError as e:
            raise SystemExit(f"--chain-delay-ms: {e}")
    if args.chain_gate:
        parts = str(args.chain_gate).split(":")
        if not 2 <= len(parts) <= 5:
            raise SystemExit("--chain-gate expects "
                             "thresh_db:ratio[:release_db_s[:range_db"
                             f"[:attack_ms]]], got {args.chain_gate!r}")
        try:
            stages.append(Expander(
                threshold_db=float(parts[0]), ratio=float(parts[1]),
                release_db_per_s=(float(parts[2]) if len(parts) > 2
                                  else 200.0),
                range_db=float(parts[3]) if len(parts) > 3 else 60.0,
                attack_ms=float(parts[4]) if len(parts) > 4 else 0.0))
        except ValueError as e:
            raise SystemExit(f"--chain-gate: {e}")
    for spec in args.chain_eq or []:
        parts = spec.split(":")
        if not 2 <= len(parts) <= 4:
            raise SystemExit(
                f"--chain-eq expects kind:freq[:q[:gain_db]], got {spec!r}")
        try:
            kind, freq = parts[0], float(parts[1])
            q = float(parts[2]) if len(parts) > 2 else 0.70710678
            gain = float(parts[3]) if len(parts) > 3 else 0.0
            stages.append(Biquad(kind, freq, q=q, gain_db=gain))
        except ValueError as e:
            raise SystemExit(f"--chain-eq {spec!r}: {e}")

    def _read_at_session_rate(path):
        # a filter or IR captured at another rate keeps its response by the
        # float64 oracle resampler (host, exact) to the session rate
        try:
            arr, arr_rate = codec.read_audio(path)
        except (OSError, ValueError) as e:
            raise SystemExit(f"error: cannot read chain file {path}: {e}")
        if arr_rate != args.rate:
            from .models.oracle import resample_oracle

            arr = resample_oracle(arr.astype(np.float64), arr_rate,
                                  args.rate).astype(np.float32)
        return arr

    if args.chain_fir:
        taps = _read_at_session_rate(args.chain_fir)
        stages.append(FIRInsert(taps[0]))
    if args.chain_comp:
        parts = str(args.chain_comp).split(":")
        if not 2 <= len(parts) <= 5:
            raise SystemExit("--chain-comp expects "
                             "thresh_db:ratio[:attack_ms[:release_db_s"
                             f"[:makeup_db]]], got {args.chain_comp!r}")
        try:
            stages.append(Compressor(
                threshold_db=float(parts[0]), ratio=float(parts[1]),
                attack_ms=float(parts[2]) if len(parts) > 2 else 5.0,
                release_db_per_s=(float(parts[3]) if len(parts) > 3 else 80.0),
                makeup_db=float(parts[4]) if len(parts) > 4 else 0.0))
        except ValueError as e:
            raise SystemExit(f"--chain-comp: {e}")
    if args.chain_sat:
        parts = str(args.chain_sat).split(":")
        if not 2 <= len(parts) <= 3:
            raise SystemExit("--chain-sat expects kind:drive_db[:mix], "
                             f"got {args.chain_sat!r}")
        try:
            stages.append(Saturator(parts[0], drive_db=float(parts[1]),
                                    mix=(float(parts[2]) if len(parts) > 2
                                         else 1.0)))
        except ValueError as e:
            raise SystemExit(f"--chain-sat: {e}")
    if args.chain_width is not None:
        try:
            stages.append(StereoWidth(float(args.chain_width)))
        except ValueError as e:
            raise SystemExit(f"--chain-width: {e}")
    if args.chain_ir:
        ir = _read_at_session_rate(args.chain_ir)
        if ir.shape[0] == 1:
            ir = ir[0]
        stages.append(ConvolutionReverb(ir, wet=args.chain_wet,
                                        dry=args.chain_dry))
    if args.chain_limit:
        parts = str(args.chain_limit).split(":")
        if not 1 <= len(parts) <= 3:
            raise SystemExit("--chain-limit expects "
                             "ceiling_db[:lookahead_ms[:release_db_s]], "
                             f"got {args.chain_limit!r}")
        try:
            stages.append(Limiter(
                ceiling_db=float(parts[0]),
                lookahead_ms=float(parts[1]) if len(parts) > 1 else 1.5,
                release_db_per_s=(float(parts[2]) if len(parts) > 2
                                  else 300.0)))
        except ValueError as e:
            raise SystemExit(f"--chain-limit: {e}")
    return Chain(*stages) if stages else None


def _apply_config_file(parser, argv) -> None:
    """Install the JSON file of ``--config`` as the parser's defaults, so a
    flag given on the command line still wins."""
    path = None
    for i, a in enumerate(argv):
        if a == "--config" and i + 1 < len(argv):
            path = argv[i + 1]
        elif a.startswith("--config="):
            path = a.split("=", 1)[1]
    if not path:
        return
    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise ValueError("top level must be a JSON object")
        vals = {k: v for k, v in data.items() if k in _CONFIG_KEYS}
    except (OSError, ValueError) as err:
        print(f"error: cannot load --config {path}: {err}", file=sys.stderr)
        raise SystemExit(2)
    # an append option given on the command line replaces the file's list
    if any(a == "--chain-eq" or a.startswith("--chain-eq=") for a in argv):
        vals.pop("chain_eq", None)
    parser.set_defaults(**vals)


def _save_config(args) -> None:
    if not args.save_config:
        return
    with open(args.save_config, "w") as f:
        json.dump({k: getattr(args, k) for k in _CONFIG_KEYS}, f, indent=1)
    print(f"settings saved -> {args.save_config}")


def _mesh(device: str, files: int = 1, frames: int = 1, channels: int = 1):
    """The mesh of the shard options (None when every count is 1): over
    every card of the machine, each once, or over ``files * frames *
    channels`` CPU shards with ``--device cpu``.  A count the machine cannot
    hold raises `make_mesh`'s error."""
    if files * frames * channels <= 1:
        return None
    from .parallel import make_mesh

    dev = resolve_device(device)
    return make_mesh(files, frames, channels,
                     devices=None if dev.type == "cuda" else [dev] * (files * frames * channels))


def _batch_cfg_from_args(args) -> ProcessingConfig:
    """The one ProcessingConfig of `process` and `watch`."""
    return ProcessingConfig(
        target_rate=args.rate,
        quality=args.quality,
        kind=args.kind,
        bits=args.bits,
        dither=not args.no_dither,
        remove_dc=not args.keep_dc,
        output_dir=args.out,
        postfix=args.postfix,
        output_format=args.output_format,
        keep_metadata=args.keep_metadata,
        require_input_rate=args.require_rate,
        device_layout=args.device_layout,
        batch_size=args.batch_size,
        gain_db=args.gain,
        normalize_lufs=args.normalize_lufs,
        normalize_tp_db=args.normalize_tp_db,
        surround_weights=args.surround_weights,
        reverb_mode=args.reverb,
        noise_floor_db=args.noise_floor,
        noise_floor_margin_pct=args.margin,
        channel_routing=_parse_routing(args.routing),
        output_channels=args.channels,
        seed=None if args.seed == -1 else args.seed,
        latency_frames=args.latency,
        chain=_build_chain(args),
    )


def cmd_process(args) -> int:
    files = _expand_inputs(args.inputs)
    if not files:
        print("error: no input files", file=sys.stderr)
        return 2
    mesh = _mesh(args.device, args.files_shards, channels=args.channel_shards)
    cfg = _batch_cfg_from_args(args)
    _save_config(args)
    # --json: the summary is the only stdout; the log goes to stderr
    log_out = sys.stderr if args.json else sys.stdout
    log = StatusLog(sink=lambda line: print(line, file=log_out, flush=True),
                    jsonl_path=args.log_jsonl)
    cal = CalibrationCache(os.path.join(args.out, ".calibration.json"))
    os.makedirs(args.out, exist_ok=True)
    bp = BatchProcessor(cfg, log=log, calibration=cal, mesh=mesh, device=args.device)
    manifest_path = os.path.join(args.out, ".manifest.json") if args.resume else None
    if args.profile:
        res = _profiled(args.profile, bp.device,
                        lambda: bp.run(files, manifest_path=manifest_path))
        print(f"profiler trace -> {args.profile}", file=log_out)
    else:
        res = bp.run(files, manifest_path=manifest_path)
    if args.json:
        print(json.dumps({
            "completed": res.completed,
            "skipped": res.skipped,
            "aborted": res.aborted,
            "failed": res.failed,
            "invalid_sample_rate": res.invalid,
            "audio_seconds_out": res.audio_seconds_out,
            "wall_seconds": res.wall_seconds,
            "x_realtime": res.x_realtime,
            "throughput": res.throughput,
            "per_file": res.per_file,
            "device": str(bp.device),
        }, indent=1))
    return 0 if (res.failed == 0 and res.invalid == 0) else 1


def _profiled(path: str, device, fn):
    """``fn()`` under `torch.profiler`, its trace written as Chrome JSON
    to ``path/trace.json``: the card's kernels and copies when ``device`` is
    CUDA, the host's operators otherwise."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(path, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    return out


def cmd_stream(args) -> int:
    """One file of any length through the streaming path (the JAX CLI's
    `cmd_stream`, on ``--device``)."""
    from .pipeline.stream import stream_resample_file

    out_ext = os.path.splitext(args.out)[1].lower()
    if out_ext in (".ogg", ".oga", ".mp3", ".m4a"):
        print(f"error: lossy output format '{out_ext}' is not supported; "
              "deliverables are WAV/AIFF/FLAC", file=sys.stderr)
        return 2
    mesh = _mesh(args.device, frames=args.frames_shards)
    cfg = ProcessingConfig(
        target_rate=args.rate,
        quality=args.quality,
        kind=args.kind,
        bits=args.bits,
        dither=not args.no_dither,
        remove_dc=not args.keep_dc,
        output_dir=os.path.dirname(os.path.abspath(args.out)) or ".",
        # an explicit --format wins, else the --out extension decides
        output_format=(args.output_format
                       or {".aif": "aiff", ".aiff": "aiff", ".flac": "flac"}.get(
                           out_ext, "wav")),
        keep_metadata=args.keep_metadata,
        seed=None if args.seed == -1 else args.seed,
        gain_db=args.gain,
        normalize_lufs=args.normalize_lufs,
        normalize_tp_db=args.normalize_tp_db,
        surround_weights=args.surround_weights,
        channel_routing=_parse_routing(args.routing),
        output_channels=args.channels,
        reverb_mode=args.reverb,
        noise_floor_db=args.noise_floor,
        noise_floor_margin_pct=args.margin,
        chain=_build_chain(args),
    )
    cfg.validate()      # no processor object validates on this path
    last = [0]
    # --json: progress goes to stderr, stdout carries only the summary
    prog_out = sys.stderr if args.json else sys.stdout
    jlog = StatusLog(jsonl_path=args.log_jsonl) if args.log_jsonl else None

    def progress(p):
        pct = int(p * 100)
        if pct >= last[0] + 10:
            last[0] = pct
            print(f"  {pct}%", file=prog_out, flush=True)
            if jlog:
                jlog.append(f"progress {pct}%", event="progress",
                            input=args.input, pct=pct)

    os.makedirs(cfg.output_dir, exist_ok=True)
    if jlog:
        jlog.append(f"Streaming {args.input} -> {args.out}",
                    event="stream_start", input=args.input, output=args.out,
                    rate=args.rate, bits=cfg.bits, format=cfg.output_format)
    t0 = time.time()
    norm: dict = {}
    try:
        n = stream_resample_file(args.input, args.out, cfg,
                                 chunk_seconds=args.chunk_seconds,
                                 progress_cb=progress,
                                 latency_frames=args.latency,
                                 mesh=mesh, device=args.device, norm_info=norm)
    except Exception as err:
        # every stream_start gets a terminal event; the error still surfaces
        if jlog:
            jlog.append(f"FAILED: {args.input}: {err}", event="failed",
                        input=args.input, output=args.out, error=str(err))
        raise
    wall = time.time() - t0
    if jlog:
        jlog.append(f"Completed: {args.out} ({n} frames @ {args.rate} Hz)",
                    event="completed", input=args.input, output=args.out,
                    out_frames=n, rate=args.rate,
                    seconds=round(n / args.rate, 3), wall_seconds=round(wall, 3),
                    x_realtime=round(n / args.rate / wall, 2) if wall > 0 else None)
    if args.json:
        print(json.dumps({"input": args.input, "output": args.out,
                          "out_frames": n, "rate": args.rate,
                          "seconds": round(n / args.rate, 3),
                          "bits": cfg.bits, "format": cfg.output_format,
                          "wall_seconds": wall, "device": args.device,
                          # the batch summary's per-file fields
                          **({"source_lufs": round(norm["source_lufs"], 2),
                              "applied_gain_db": round(norm["applied_gain_db"], 2)}
                             if norm else {})}))
    else:
        if norm:
            print(f"Normalize: {os.path.basename(args.input)} "
                  f"{norm['source_lufs']:.1f} LUFS -> {cfg.normalize_lufs:.1f} "
                  f"({norm['applied_gain_db']:+.1f} dB{norm['gain_note']})")
        print(f"wrote {n} frames @ {args.rate} Hz -> {args.out}")
    return 0


def cmd_probe(args) -> int:
    """File metadata, one line or JSON row per file; ``--loudness`` adds
    integrated LUFS, true peak and LRA measured on ``--device`` (the JAX
    CLI's `cmd_probe`, same text and JSON fields)."""
    code = 0
    rows = []
    for f in _expand_inputs(args.inputs):
        try:
            info = codec.probe(f)
            loud = ""
            if args.loudness:
                # r128_stats shares one SRC-to-48k + K-weighting pass between
                # the integrated and LRA statistics; the file is uploaded
                # once for it and the true peak
                import torch

                from . import resolve_device
                from .ops.loudness import r128_stats, surround_weights, true_peak_db

                x, r = codec.read_audio(f)
                w = surround_weights(x.shape[0]) if args.surround_weights else None
                x = torch.from_numpy(x).to(resolve_device(args.device))
                lufs, lra = r128_stats(x, r, weights=w, device=args.device)
                tp = None
                if lufs <= -199.0:
                    loud = "  --.- LUFS (too short/silent)"
                else:
                    tp = float(true_peak_db(x, r, device=args.device))
                    loud = (f"  {lufs:.1f} LUFS, {tp:+.1f} dBTP, "
                            f"LRA {lra:.1f} LU")
        except Exception as e:
            # broad on purpose: with --loudness the metering can fail on the
            # device, and a failed file becomes an error row while stdout
            # stays parseable; one bad file must not abort the whole run
            if args.json:
                rows.append({"path": f, "error": str(e)})
            else:
                print(f"{f}: ERROR {e}")
            code = 1
            continue
        valid = ("" if args.require_rate is None else
                 ("  [ok]" if info.is_valid_for_rate(args.require_rate)
                  else f"  [INVALID: need {args.require_rate} Hz]"))
        kind = "float" if info.is_float else "pcm"
        if args.json:
            row = {"path": f, "container": info.container,
                   **({} if args.require_rate is None else
                      {"valid_for_rate":
                       info.is_valid_for_rate(args.require_rate)}),
                   "sample_rate": info.sample_rate,
                   "channels": info.num_channels,
                   "frames": info.num_frames,
                   "seconds": round(info.duration_seconds, 3),
                   "bit_depth": info.bit_depth, "is_float": info.is_float}
            if args.loudness:
                row["lufs"] = None if lufs <= -199.0 else round(lufs, 2)
                if lufs > -199.0:
                    row["true_peak_db"] = round(tp, 2)
                    row["lra_lu"] = round(lra, 2)
            if args.pairs:
                from .ops.routing import stereo_pairs

                row["stereo_pairs"] = [list(p) for p in
                                       stereo_pairs(info.num_channels)]
            rows.append(row)
        else:
            print(f"{f}: {info.container} {info.sample_rate} Hz, "
                  f"{info.num_channels} ch, {info.num_frames} frames "
                  f"({info.duration_seconds:.3f} s), {info.bit_depth}-bit {kind}"
                  f"{valid}{loud}")
            if args.pairs:
                # 0-indexed, so entries paste directly into --routing
                from .ops.routing import stereo_pairs

                pairs = stereo_pairs(info.num_channels)
                txt = (", ".join(f"{a}-{b}" for a, b in pairs)
                       if pairs else "(none: fewer than 2 channels)")
                print(f"  stereo pairs (0-indexed): {txt}")
    if args.json:
        print(json.dumps(rows, indent=1))
    return code


def cmd_preview(args) -> int:
    """A gapless playlist onto a bus (the JAX CLI's `cmd_preview`, on
    ``--device``): in memory, or through the constant-memory renderer with
    ``--stream`` or when the programme would pass 512 MB of float32."""
    from .pipeline.preview import projected_frames, render_playlist, stream_playlist

    files = _expand_inputs(args.inputs)
    if not files:
        print("error: no input files", file=sys.stderr)
        return 2
    # --monitor-out implies the dual render; in bus mode the main file is
    # a sink of the mixdown too
    want_monitor = args.monitor or bool(args.monitor_out)
    if args.monitor and not args.monitor_out and not args.target_channels:
        print("note: --monitor without --monitor-out has no sink in plain "
              "mode (no --target-channels); pass --monitor-out PATH",
              file=sys.stderr)
    try:
        mon_ch = tuple(int(c) for c in args.monitor_channels.split(","))
    except ValueError:
        print(f"error: --monitor-channels must be two integers, got "
              f"{args.monitor_channels!r}", file=sys.stderr)
        return 2
    if len(mon_ch) != 2:
        print(f"error: --monitor-channels needs exactly two channels, got "
              f"{args.monitor_channels!r}", file=sys.stderr)
        return 2
    try:
        target_ch = ([int(c) for c in args.target_channels.split(",")]
                     if args.target_channels else None)
    except ValueError:
        print(f"error: --target-channels must be integers, got "
              f"{args.target_channels!r}", file=sys.stderr)
        return 2
    dev = resolve_device(args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    stream_mode = args.stream
    if not stream_mode:
        try:
            proj = projected_frames(files, args.rate, silence_ms=args.silence_ms,
                                    loops=args.loops)
        except (OSError, ValueError):
            proj = 0        # an unreadable item: the renderer reports it
        if proj * max(args.channels, 2) * 4 > (1 << 29):
            stream_mode = True
            print(f"note: projected programme of {proj} frames exceeds "
                  "the in-memory budget; using the streaming renderer",
                  file=sys.stderr)
    kw = dict(silence_ms=args.silence_ms, output_channels=args.channels,
              monitor=want_monitor, loops=args.loops, target_channels=target_ch,
              monitor_channels=mon_ch, quality=args.quality, kind=args.kind,
              device=dev)
    try:
        if stream_mode:
            items, frames = stream_playlist(files, args.rate, args.out,
                                            monitor_out=args.monitor_out, **kw)
            print(f"rendered {len(items)} item(s), {frames} frames -> "
                  f"{args.out} (streamed)")
            if want_monitor and args.monitor_out:
                print(f"monitor mix -> {args.monitor_out}")
        else:
            main_mix, monitor, items = render_playlist(files, args.rate, **kw)
            _write_render(args.out, main_mix, args.rate)
            print(f"rendered {len(items)} item(s), {main_mix.shape[-1]} frames "
                  f"-> {args.out}")
            if monitor is not None and args.monitor_out:
                _write_render(args.monitor_out, monitor, args.rate)
                print(f"monitor mix -> {args.monitor_out}")
    except ValueError as err:
        # channel placement (duplicate or out-of-bus channels, monitor
        # placement outside bus mode): a usage error
        print(f"error: {err}", file=sys.stderr)
        return 2
    for it in items:
        print(f"  @{it.start_frame:>10} {os.path.basename(it.path)} "
              f"({it.num_frames} frames)")
    return 0


def _write_render(path: str, x: np.ndarray, rate: int) -> None:
    """A rendered programme as a 24-bit WAV in the container the streaming
    renderer writes (`io.wav.WavWriter`, RF64-ready), with `write_wav`'s
    quantization: the two forms of `preview` give the same file."""
    from .io.wav import WavWriter

    with WavWriter(path, x.shape[0], rate, bits=24) as w:
        w.append_codes(np.clip(np.round(x * float(1 << 23)), -(1 << 23),
                               (1 << 23) - 1).astype(np.int32))


def cmd_measure(args) -> int:
    """The latency of SRC and the ``--chain-*`` chain by an impulse on
    ``--device``, with the capture and ring-out the scheduler's calibration
    uses (the JAX CLI's `cmd_measure`)."""
    from .ops.resample import resample_rates
    from .pipeline.calibration import CAPTURE_FRAMES

    chain = _build_chain(args)
    chain_fn, capture, ringout = None, CAPTURE_FRAMES, 0
    if chain is not None:
        ringout = int(chain.tail_frames(args.rate))
        capture = max(CAPTURE_FRAMES,
                      -(-(3 * ringout + (1 << 15)) * args.rate_in // args.rate))

        def chain_fn(x):
            y = resample_rates(x, args.rate_in, args.rate,
                               quality=args.quality, kind=args.kind)
            return chain.apply(y, args.rate)

    res = measure_latency(args.rate_in, args.rate, quality=args.quality,
                          kind=args.kind, chain_fn=chain_fn,
                          capture_frames=capture, ringout_frames=ringout,
                          device=args.device)
    status = "detected" if res.detected else "NOT DETECTED"
    what = f"SRC+chain({chain!r})" if chain is not None else "SRC"
    print(f"impulse {status} through {what}: latency {res.latency_frames} "
          f"frames @ {args.rate} Hz, "
          f"noise floor {res.noise_floor_db:.1f} dB, peak {res.peak_amplitude:.3f}")
    return 0 if res.detected else 1


def cmd_selftest(args) -> int:
    """The loop test on ``--device``; ``--parity`` also holds the device's
    SRC of 0.5 s of noise against the float64 oracle (<= -120 dB).  The
    exit code follows the verdict."""
    from .pipeline.selftest import run_loop_test

    rep = run_loop_test(args.rate_in, args.rate, quality=args.quality,
                        kind=args.kind, device=args.device)
    print(f"{rep.verdict.value}: {rep.detail}")
    ok = rep.verdict.value == "loop_detected"
    if args.parity:
        import torch

        from .models.oracle import resample_oracle
        from .ops.resample import resample_rates

        rng = np.random.default_rng(0)
        x = (0.25 * rng.standard_normal(args.rate_in // 2)).astype(np.float32)
        y = resample_rates(torch.from_numpy(x).to(resolve_device(args.device)),
                           args.rate_in, args.rate, quality=args.quality,
                           kind=args.kind).cpu().numpy()
        ref = resample_oracle(x, args.rate_in, args.rate,
                              quality=args.quality, kind=args.kind)
        err = y.astype(np.float64) - ref
        db = 20 * np.log10(np.sqrt((err**2).mean())
                           / np.sqrt((ref**2).mean()) + 1e-30)
        good = db <= -120.0
        print(f"parity: {db:.1f} dB RMS vs float64 oracle "
              f"[{'OK' if good else 'FAIL (target -120)'}]")
        ok = ok and good
    return 0 if ok else 1


def cmd_watch(args) -> int:
    """Process files as they land in a folder (the JAX CLI's `cmd_watch`):
    polling; a file is taken once its size and mtime held across two sweeps;
    the manifest and the calibration cache in ``--out`` are shared by every
    sweep and by restarts, so a file is processed once, and again when it is
    dropped anew with other content.  A sweep whose batch raises is logged
    with the error and its files retry on a later sweep; on the card a
    fault the context keeps shows on every later sweep, never moved to the
    CPU."""
    cfg = _batch_cfg_from_args(args)
    if args.interval <= 0:
        print("watch: --interval must be positive", file=sys.stderr)
        return 2
    if os.path.realpath(args.out) == os.path.realpath(args.dir):
        # outputs landing in the watched folder would be processed forever
        print("watch: --out must differ from the watched folder",
              file=sys.stderr)
        return 2
    try:
        cfg.validate()
    except ValueError as err:
        print(f"watch: invalid config: {err}", file=sys.stderr)
        return 2
    # what a sweep's processor would refuse fails now, not at the first drop;
    # the mesh is built once and serves every sweep
    mesh = _mesh(args.device, args.files_shards, channels=args.channel_shards)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    # every line goes to the sink (and the JSONL file); memory keeps 1000
    log = StatusLog(sink=lambda line: print(line, flush=True),
                    jsonl_path=args.log_jsonl, max_lines=1000)
    cal = CalibrationCache(os.path.join(args.out, ".calibration.json"))
    manifest_path = os.path.join(args.out, ".manifest.json")
    seen_sig: dict[str, tuple] = {}      # path -> (size, mtime) last sweep
    done_sig: dict[str, tuple] = {}      # path -> signature when processed
    sweeps = 0
    idle = 0.0

    log.append(f"watch: {args.dir} -> {args.out} (interval {args.interval}s)")
    while True:
        sweeps += 1
        try:
            names = sorted(os.listdir(args.dir))
        except OSError as err:
            if sweeps == 1:
                print(f"watch: cannot list {args.dir}: {err}", file=sys.stderr)
                return 2
            log.append(f"watch sweep {sweeps}: cannot list {args.dir}: {err}")
            time.sleep(args.interval)
            continue
        # forget files that left the folder
        current = {os.path.join(args.dir, n) for n in names}
        for d in (seen_sig, done_sig):
            for stale in [p for p in d if p not in current]:
                del d[stale]
        ready = []
        changing = False          # a candidate is still being copied in
        for name in names:
            path = os.path.join(args.dir, name)
            if not codec.is_supported(name) or not os.path.isfile(path):
                continue
            try:
                st = os.stat(path)
                sig = (st.st_size, st.st_mtime_ns)
            except OSError:
                continue
            if done_sig.get(path) == sig:
                continue
            if seen_sig.get(path) == sig:
                ready.append(path)
            else:
                changing = True
            seen_sig[path] = sig
        if ready:
            # the manifest processes new files, skips finished unchanged
            # ones and reprocesses a file dropped again with new content
            idle = 0.0
            try:
                bp = BatchProcessor(cfg, log=log, calibration=cal, mesh=mesh, device=dev)
                res = bp.run(ready, manifest_path=manifest_path)
            except Exception as err:
                # the daemon keeps serving; the files stay unmarked and retry
                log.append(f"watch sweep {sweeps} FAILED: {err}")
            else:
                if res.aborted:
                    # only verified completions are done; the rest retry
                    for p in ready:
                        if p in res.per_file:
                            done_sig[p] = seen_sig[p]
                    log.append(f"watch sweep {sweeps}: ABORTED "
                               f"({res.completed} completed, unprocessed "
                               f"files will retry)")
                else:
                    # failed files are per-file errors and are not retried
                    for p in ready:
                        done_sig[p] = seen_sig[p]
                    log.append(
                        f"watch sweep {sweeps}: {res.completed} completed"
                        + (f" ({res.skipped} resumed)" if res.skipped else "")
                        + f", {res.failed} failed in {res.wall_seconds:.3f} s")
        elif changing:
            idle = 0.0
        else:
            idle += args.interval
        if args.sweeps and sweeps >= args.sweeps:
            break
        if args.exit_after_idle and idle >= args.exit_after_idle:
            log.append(f"watch: idle {idle:.0f}s, exiting")
            break
        time.sleep(args.interval)
    return 0


def cmd_verify(args) -> int:
    """Audit a job manifest's completed outputs against their recorded size
    and CRC-32, on the host (the JAX CLI's `cmd_verify`; the manifest
    format is shared, so each package verifies the other's jobs)."""
    from .pipeline.manifest import FileStatus, JobManifest, file_crc32

    try:
        m = JobManifest.load(args.manifest)
    except (OSError, ValueError, KeyError) as err:
        print(f"verify: cannot load manifest {args.manifest}: {err}",
              file=sys.stderr)
        return 2
    rows = []
    counts = {"ok": 0, "corrupt": 0, "missing": 0, "unverified": 0,
              "not_completed": 0}
    for e in m.entries():
        if e.status != FileStatus.COMPLETED:
            counts["not_completed"] += 1
            continue
        row = {"output": e.output_path, "source": e.path}
        if not e.output_path or not os.path.exists(e.output_path):
            counts["missing"] += 1
            status = "missing"
        elif e.output_size is not None and os.path.getsize(e.output_path) != e.output_size:
            counts["corrupt"] += 1
            status = "size_mismatch"
        elif e.output_crc32 is None:
            counts["unverified"] += 1
            status = "no_hash"
        elif file_crc32(e.output_path) == e.output_crc32:
            counts["ok"] += 1
            status = "ok"
        else:
            counts["corrupt"] += 1
            status = "crc_mismatch"
        rows.append({**row, "status": status})
    if args.json:
        print(json.dumps({"counts": counts, "files": rows}, indent=1))
    else:
        for r in rows:
            if r["status"] != "ok" or args.verbose:
                print(f"{r['status'].upper():14s} {r['output']}")
        print(f"verified: {counts['ok']} ok, {counts['corrupt']} corrupt, "
              f"{counts['missing']} missing, {counts['unverified']} "
              f"without hash, {counts['not_completed']} not completed")
    return 1 if (counts["corrupt"] or counts["missing"]) else 0


def cmd_devices(args) -> int:
    """The devices of ``--device``'s kind: each CUDA device's index, name,
    memory and compute capability, then the count.  Unlike the JAX CLI,
    which lists the CPU when it finds no accelerator, this exits 1 when
    there is no GPU: the CPU is listed only with ``--device cpu``."""
    import torch

    if torch.device(args.device).type == "cpu":
        print(f"[0] cpu (platform cpu, {os.cpu_count()} cores)")
        print("1 device(s)")
        return 0
    if not torch.cuda.is_available():
        print("devices: no CUDA GPU available (--device cpu lists the CPU)",
              file=sys.stderr)
        return 1
    n = torch.cuda.device_count()
    for i in range(n):
        p = torch.cuda.get_device_properties(i)
        print(f"[{i}] {p.name} (platform cuda, {p.total_memory / 2**30:.1f} GiB, "
              f"compute capability {p.major}.{p.minor})")
    print(f"{n} device(s)")
    return 0


def main(argv: list[str] | None = None) -> int:
    from .version import __version__

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(
        prog="f9tpu-torch", allow_abbrev=False,
        description="Batch audio resampler on an NVIDIA GPU (PyTorch port of f9tpu)")
    ap.add_argument("--version", action="version", version=f"f9tpu-torch {__version__}")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("process", help="batch resample files")
    process_parser = p
    p.add_argument("inputs", nargs="+", help="files, globs or directories")
    _add_batch_args(p)
    p.add_argument("--resume", action="store_true",
                   help="persist a manifest in --out and skip completed files")
    p.add_argument("--json", action="store_true", help="print summary JSON")
    p.add_argument("--config", default=None, help="load settings JSON")
    p.add_argument("--save-config", default=None, help="save resolved settings JSON")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the job to DIR/trace.json "
                        "(the card's kernels on cuda, host operators on cpu)")
    p.set_defaults(fn=cmd_process)

    p = sub.add_parser("stream", help="constant-memory resample of one long file")
    p.add_argument("input")
    p.add_argument("--out", required=True, help="output WAV/AIFF/FLAC path")
    p.add_argument("--log-jsonl", default=None, metavar="PATH",
                   help="append stream_start/progress/completed events to "
                        "PATH as one JSON object per line")
    _add_src_args(p)
    p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32])
    p.add_argument("--format", dest="output_format", default=None,
                   choices=["wav", "aiff", "flac"],
                   help="output container (default: inferred from the "
                        "--out extension, else wav)")
    p.add_argument("--keep-metadata", action="store_true",
                   help="carry bext/LIST/cue metadata (same container)")
    p.add_argument("--seed", type=int, default=0,
                   help="dither seed (-1 = wall clock, non-reproducible)")
    p.add_argument("--no-dither", action="store_true")
    p.add_argument("--keep-dc", action="store_true")
    p.add_argument("--gain", type=float, default=0.0, help="gain dB")
    _add_normalize_args(p)
    _add_routing_args(p)
    p.add_argument("--latency", type=int, default=None,
                   help="trim this many output frames of known chain/system "
                        "delay from the head (negative = dithered zero head)")
    p.add_argument("--reverb", action="store_true",
                   help="keep the (chain) tail past the source until it "
                        "falls below the noise floor; the input length is "
                        "unbounded, only the tail is capped")
    _add_tail_args(p)
    _add_chain_args(p)
    p.add_argument("--chunk-seconds", type=float, default=20.0,
                   help="chunk length (the bytes do not depend on it)")
    p.add_argument("--frames-shards", type=int, default=1,
                   help="split each step's frames over N devices (the cards, "
                        "or N CPU shards with --device cpu)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable result on stdout")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("watch", help="watch a folder, process files as they land")
    p.add_argument("dir", help="input folder to watch")
    _add_batch_args(p)
    p.add_argument("--interval", type=float, default=2.0, help="sweep interval seconds")
    p.add_argument("--sweeps", type=int, default=0,
                   help="stop after N sweeps (0 = run until killed)")
    p.add_argument("--exit-after-idle", type=float, default=0.0,
                   help="stop after this many idle seconds (0 = never)")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("verify", help="audit a manifest's outputs (size + CRC-32)")
    p.add_argument("manifest", help="job manifest JSON (process --resume, watch)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--verbose", action="store_true",
                   help="also list files that verified ok")
    p.set_defaults(fn=cmd_verify)

    p = sub.add_parser("devices", help="list the CUDA devices")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) lists the GPUs, 'cpu' the CPU")
    p.set_defaults(fn=cmd_devices)

    p = sub.add_parser("preview", help="render a gapless playlist")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--out", required=True, help="output WAV path")
    _add_src_args(p)
    p.add_argument("--silence-ms", type=int, default=150)
    p.add_argument("--channels", type=int, default=2)
    p.add_argument("--monitor", action="store_true")
    p.add_argument("--monitor-out", default=None)
    p.add_argument("--loops", type=int, default=1,
                   help="render the playlist N times (wrap-around looping)")
    p.add_argument("--target-channels", default=None,
                   help="render into these bus channels, e.g. '4,5' "
                        "(others stay silent)")
    p.add_argument("--monitor-channels", default="0,1",
                   help="bus channels carrying the monitor mix (dual render)")
    p.add_argument("--stream", action="store_true",
                   help="constant-memory renderer (one block at a time; "
                        "chosen by itself past 512 MB of programme)")
    p.set_defaults(fn=cmd_preview)

    p = sub.add_parser("measure", help="measure chain latency (impulse test)")
    p.add_argument("--rate-in", type=int, default=44100)
    _add_src_args(p)
    _add_chain_args(p)
    p.set_defaults(fn=cmd_measure)

    p = sub.add_parser("selftest", help="device loop test (1 kHz tone)")
    p.add_argument("--rate-in", type=int, default=48000)
    p.add_argument("--parity", action="store_true",
                   help="also hold the device's SRC against the float64 "
                        "oracle (<= -120 dB)")
    _add_src_args(p)
    p.set_defaults(fn=cmd_selftest)

    p = sub.add_parser("probe", help="print file metadata")
    p.add_argument("inputs", nargs="+")
    p.add_argument("--require-rate", type=int, default=None)
    p.add_argument("--loudness", action="store_true",
                   help="also measure BS.1770-4 integrated loudness (LUFS), "
                        "true peak and LRA on --device")
    p.add_argument("--surround-weights", action="store_true",
                   help="with --loudness: apply BS.1770-4 5.1/7.1 channel "
                        "weights to 6/8-channel files")
    p.add_argument("--pairs", action="store_true",
                   help="list each file's odd/even stereo pairs (0-indexed, "
                        "pasteable into --routing)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable output (one list of objects)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the --loudness meter (default cuda)")
    p.set_defaults(fn=cmd_probe)
    _apply_config_file(process_parser, argv)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except NoDeviceError as err:
        # asked for the card on a machine without one: no fallback to the CPU
        print(f"error: {err}", file=sys.stderr)
        return 1
    except (ValueError, NotImplementedError) as err:
        # the CLI boundary: usage and validation errors raised before any
        # work, and the option the port leaves out (the native loader)
        print(f"error: {err}", file=sys.stderr)
        return 2


def _add_batch_args(p: argparse.ArgumentParser) -> None:
    """The options `process` and `watch` share (watch is the serving form
    of a batch run and takes the whole surface)."""
    p.add_argument("--out", required=True, help="output directory (mandatory)")
    p.add_argument("--log-jsonl", default=None, metavar="PATH",
                   help="append every status-log event to PATH as one JSON "
                        "object per line")
    _add_src_args(p)
    p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32])
    p.add_argument("--no-dither", action="store_true")
    p.add_argument("--keep-dc", action="store_true", help="skip DC offset removal")
    p.add_argument("--gain", type=float, default=0.0, help="gain dB")
    _add_normalize_args(p)
    p.add_argument("--latency", type=int, default=None,
                   help="known delay in output frames: skip calibration and "
                        "trim exactly this (negative = zero head)")
    p.add_argument("--postfix", default="_processed")
    p.add_argument("--keep-metadata", action="store_true",
                   help="carry metadata chunks into same-container outputs, "
                        "sample positions rescaled to the output rate")
    p.add_argument("--format", dest="output_format", default="wav",
                   choices=["wav", "aiff", "flac"])
    p.add_argument("--require-rate", type=int, default=None,
                   help="strict mode: reject inputs not at this rate")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--device-layout", default="packed", choices=["packed", "rows"],
                   help="packed, or rows: the SRC's (n_rows, L) tiling with host-"
                        "marshalled rows (no reverb/chain/latency; the same bytes)")
    p.add_argument("--seed", type=int, default=0,
                   help="dither seed (per-file keys derive from seed+path; "
                        "-1 = wall clock)")
    p.add_argument("--reverb", action="store_true",
                   help="reverb mode: keep tails until below noise floor")
    p.add_argument("--files-shards", type=int, default=1,
                   help="split each batch's files over N devices (the cards, "
                        "or N CPU shards with --device cpu)")
    p.add_argument("--channel-shards", type=int, default=1,
                   help="split channel buses over N devices (files x "
                        "channels shards in all)")
    _add_tail_args(p)
    _add_routing_args(p)
    _add_chain_args(p)


def _add_src_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--rate", type=int, default=48000, help="target sample rate")
    p.add_argument("--quality", default="high",
                   choices=["low", "medium", "high", "ultra"])
    p.add_argument("--kind", default="sinc",
                   choices=["sinc", "minphase", "lagrange"])
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")


def _add_normalize_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--normalize-lufs", type=float, default=None, metavar="TARGET",
                   help="loudness-normalize each file to TARGET integrated "
                        "LUFS (BS.1770-4, measured on the source; negative "
                        "value needs the = form: --normalize-lufs=-14)")
    p.add_argument("--normalize-tp", dest="normalize_tp_db", type=float,
                   default=None, metavar="CEILING",
                   help="with --normalize-lufs: cap gains so the true peak "
                        "stays <= CEILING dBTP (= form for negatives)")
    p.add_argument("--surround-weights", action="store_true",
                   help="meter 6/8-channel files with BS.1770-4 5.1/7.1 "
                        "channel weights (surrounds 1.41, LFE excluded) "
                        "instead of treating them as discrete buses")


def _add_tail_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--noise-floor", type=float, default=None,
                   help="measured noise floor dB (default: -80 fallback)")
    p.add_argument("--margin", type=float, default=10.0,
                   help="noise floor margin %% (0-50)")


def _add_routing_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--routing", default=None,
                   help="channel routing map, e.g. '0,1,-1,2' "
                        "(out[i] <- in[map[i]], -1 = silence)")
    p.add_argument("--channels", type=int, default=None,
                   help="fan mono inputs out to N channels")


def _add_chain_args(p: argparse.ArgumentParser) -> None:
    """The insert chain's flags (`_build_chain` reads them)."""
    p.add_argument("--chain-ir", default=None,
                   help="insert chain: convolution reverb impulse-response "
                        "WAV (mono or matching channel count)")
    p.add_argument("--chain-wet", type=float, default=1.0,
                   help="reverb wet level (with --chain-ir)")
    p.add_argument("--chain-dry", type=float, default=0.0,
                   help="reverb dry level (with --chain-ir)")
    p.add_argument("--chain-fir", default=None,
                   help="insert chain: FIR taps WAV (first channel)")
    p.add_argument("--chain-delay-ms", type=float, default=0.0,
                   help="insert chain: pure delay in ms (calibration "
                        "measures and trims it)")
    p.add_argument("--chain-comp", default=None,
                   metavar="THRESH:RATIO[:ATTACK_MS[:RELEASE_DBS[:MAKEUP]]]",
                   help="insert chain: bus compressor (instant attack, "
                        "linear-dB release; channel-linked). Negative "
                        "threshold needs the = form: --chain-comp=-18:4")
    p.add_argument("--chain-sat", default=None, metavar="KIND:DRIVE_DB[:MIX]",
                   help="insert chain: saturator (tanh/soft/hard waveshaper)")
    p.add_argument("--chain-width", type=float, default=None,
                   help="insert chain: stereo M/S width (0=mono, 1=as-is, 2=wide)")
    p.add_argument("--chain-eq", action="append", default=None,
                   metavar="KIND:FREQ[:Q[:GAIN_DB]]",
                   help="insert chain: biquad EQ section (lowpass/highpass/"
                        "peaking/lowshelf/highshelf); repeatable, in order")
    p.add_argument("--chain-gate", default=None,
                   metavar="THRESH:RATIO[:RELEASE_DBS[:RANGE_DB[:ATTACK_MS]]]",
                   help="insert chain: downward expander / gate (channel-"
                        "linked). Negative threshold needs the = form: "
                        "--chain-gate=-50:3")
    p.add_argument("--chain-limit", default=None,
                   metavar="CEILING_DB[:LOOKAHEAD_MS[:RELEASE_DBS]]",
                   help="insert chain: lookahead brickwall limiter (applied "
                        "last; calibration measures and trims its "
                        "lookahead). Negative ceiling needs the = form: "
                        "--chain-limit=-0.3")


if __name__ == "__main__":
    sys.exit(main())
