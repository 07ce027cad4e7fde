"""Command-line interface of the port (counterpart of `f9tpu/cli.py`).

The batch job, with reverb mode, channel routing and the insert chain, and
the constant-memory stream of one file of any length:

    python -m f9tpu_torch.cli process ./stems --out ./out --rate 48000 [--device cuda]
    python -m f9tpu_torch.cli process ./stems --out ./out --reverb --routing 1,0 \
        --chain-delay-ms 5 --chain-eq peaking:1000:1:3 --chain-comp=-18:3 \
        --chain-ir hall.wav --chain-limit=-0.3
    python -m f9tpu_torch.cli stream long.wav --out long_48k.wav --rate 48000 \
        [--chunk-seconds 20] [--latency N] [--reverb] [--chain-* ...]
    python -m f9tpu_torch.cli process ./stems --out ./out --rate 44056
    python -m f9tpu_torch.cli process ./stems --out ./out --normalize-lufs=-16 \
        --normalize-tp=-1 [--surround-weights]
    python -m f9tpu_torch.cli probe ./stems --loudness [--json]

Varispeed rates (``--rate 44056``, the NTSC pull-down) and loudness
normalization run on `process` and `stream` alike.  `stream` takes the JAX
CLI's flags plus ``--device`` and every ``--chain-*`` flag of `process`;
``--frames-shards`` above 1 exits 2 with the ROADMAP item it waits for.
`probe` prints file metadata and, with ``--loudness``, LUFS, dBTP and LRA
measured on ``--device``.  Every other `f9tpu` subcommand prints "not yet
ported" and exits 2.
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

from .pipeline.calibration import CalibrationCache
from .pipeline.graph import not_ported
from .pipeline.logbook import StatusLog
from .pipeline.scheduler import BatchProcessor

__all__ = ["main"]

#: `f9tpu` subcommands the port does not have yet (ROADMAP Queue 1).
UNPORTED = ("preview", "measure", "selftest", "watch", "verify", "devices")


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


def _batch_cfg_from_args(args) -> ProcessingConfig:
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
    cfg = _batch_cfg_from_args(args)
    # --json: the summary is the only stdout; the log goes to stderr
    log_out = sys.stderr if args.json else sys.stdout
    log = StatusLog(sink=lambda line: print(line, file=log_out, flush=True))
    cal = CalibrationCache(os.path.join(args.out, ".calibration.json"))
    os.makedirs(args.out, exist_ok=True)
    bp = BatchProcessor(cfg, log=log, calibration=cal, device=args.device)
    manifest_path = os.path.join(args.out, ".manifest.json") if args.resume else None
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


def cmd_stream(args) -> int:
    """One file of any length through the streaming path (the JAX CLI's
    `cmd_stream`, on ``--device``)."""
    from .pipeline.stream import stream_resample_file

    out_ext = os.path.splitext(args.out)[1].lower()
    if out_ext in (".ogg", ".oga", ".mp3", ".m4a"):
        print(f"error: lossy output format '{out_ext}' is not supported; "
              "deliverables are WAV/AIFF/FLAC", file=sys.stderr)
        return 2
    if args.frames_shards > 1:
        raise not_ported("mesh")
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
                                 device=args.device, norm_info=norm)
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


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in UNPORTED:
        print(f"f9tpu-torch: '{argv[0]}' is not yet ported "
              f"(use the JAX package: python -m f9tpu.cli {argv[0]})",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(
        prog="f9tpu-torch", allow_abbrev=False,
        description="Batch audio resampler on an NVIDIA GPU (PyTorch port of f9tpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("process", help="batch resample files")
    p.add_argument("inputs", nargs="+", help="files, globs or directories")
    p.add_argument("--out", required=True, help="output directory (mandatory)")
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
    p.add_argument("--format", dest="output_format", default="wav",
                   choices=["wav", "aiff", "flac"])
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seed", type=int, default=0,
                   help="dither seed (per-file keys derive from seed+path; "
                        "-1 = wall clock)")
    p.add_argument("--resume", action="store_true",
                   help="persist a manifest in --out and skip completed files")
    p.add_argument("--json", action="store_true", help="print summary JSON")
    p.add_argument("--reverb", action="store_true",
                   help="reverb mode: keep tails until below noise floor")
    _add_tail_args(p)
    _add_routing_args(p)
    _add_chain_args(p)
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
                   help="shard each step over N devices (not ported yet)")
    p.add_argument("--json", action="store_true",
                   help="machine-readable result on stdout")
    p.set_defaults(fn=cmd_stream)

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
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (ValueError, NotImplementedError) as err:
        # the CLI boundary: usage and validation errors raised before any
        # work, and options not ported yet (naming their ROADMAP item)
        print(f"error: {err}", file=sys.stderr)
        return 2


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
