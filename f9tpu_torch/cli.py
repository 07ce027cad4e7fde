"""Command-line interface of the port (counterpart of `f9tpu/cli.py`).

Only the batch job is ported:

    python -m f9tpu_torch.cli process ./stems --out ./out --rate 48000 [--device cuda]

Every other `f9tpu` subcommand prints "not yet ported" and exits 2.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from f9tpu.config import ProcessingConfig
from f9tpu.io import codec

from .pipeline.calibration import CalibrationCache
from .pipeline.logbook import StatusLog
from .pipeline.scheduler import BatchProcessor

__all__ = ["main"]

#: `f9tpu` subcommands the port does not have yet (ROADMAP Queue 1).
UNPORTED = ("stream", "preview", "measure", "selftest", "probe", "watch",
            "verify", "devices")


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
        seed=None if args.seed == -1 else args.seed,
        latency_frames=args.latency,
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
    p.add_argument("--rate", type=int, default=48000, help="target sample rate")
    p.add_argument("--quality", default="high",
                   choices=["low", "medium", "high", "ultra"])
    p.add_argument("--kind", default="sinc",
                   choices=["sinc", "minphase", "lagrange"])
    p.add_argument("--bits", type=int, default=24, choices=[16, 24, 32])
    p.add_argument("--no-dither", action="store_true")
    p.add_argument("--keep-dc", action="store_true", help="skip DC offset removal")
    p.add_argument("--gain", type=float, default=0.0, help="gain dB")
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
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "PyTorch path)")
    args = ap.parse_args(argv)
    return cmd_process(args)


if __name__ == "__main__":
    sys.exit(main())
