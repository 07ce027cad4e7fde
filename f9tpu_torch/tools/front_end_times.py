#!/usr/bin/env python3
"""The front end's times on the card, for this checkout or another.

    python3 f9tpu_torch/tools/front_end_times.py [--root DIR] [--tag NAME] [--runs N]

Times the front end of the checkout at ``--root`` (default: the one holding
this file) at the default job's shape, 8 files x 2 channels x 2^22 frames
of 24-bit PCM in one resident wire, the files 50-60 s long (the takes of
`chip_smoke.py` phase 4: the same seed and recipe, quantized to 24 bits):

- ``raw``: `graph._front_end` on the wire with the files' true lengths;
- ``raw routed``: the same with ``routing=(1, 0)``;
- ``raw full bucket``: every file the whole bucket long;
- ``float``: the float wire, the same takes as a float32 bucket;
- ``graph raw`` / ``graph float``: `graph.process_batch_raw` and
  `graph.process_batch` (the default job's graph on each wire);
- ``stream chunk``: `stream._raw_front` on one 20 s chunk of phase 6's
  stream (44.1 kHz stereo 24-bit, its halos, the DC mean over the chunk);
- ``twin ...``: where the checkout has `ops.frontend`, its plain twin on
  the card for the three front-end cases.

For each it prints one JSON line: the median CUDA-event ms over ``--runs``
calls (after 3 warm-ups), the device ms and device operations (kernels,
copies, memsets) a call from `torch.profiler`'s events, the peak device
memory above the inputs, the bytes that bound it and the sha256 of the
output, with the card's name and power limit.  Run it as a script, not with
``-m``, so that ``--root`` decides which ``f9tpu_torch`` is imported:
comparing two trees takes one process each, in turns (parent, change,
change, parent) on one card.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

#: `chip_smoke.py`'s seed (phase 4's takes use SEED + 1, phase 6's long file SEED + 8)
SEED = 20260116
BUCKET = 1 << 22
#: the takes' length range, seconds (phase 4's)
TAKE_SECONDS = (50, 60)
HBM_BYTES_PER_S = 3.35e12


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        import torch

        return torch.cuda.get_device_name(0)


def _signal(rng, channels: int, frames: int, rate: int, start: int = 0):
    """`chip_smoke.py`'s two tones plus noise at about -12 dBFS, float64."""
    import numpy as np

    t = (start + np.arange(frames)) / rate
    f = rng.uniform(80.0, 6000.0, size=(channels, 2))
    return (0.3 * np.sin(2 * np.pi * f[:, :1] * t)
            + 0.15 * np.sin(2 * np.pi * f[:, 1:] * t + 0.7)
            + 0.02 * rng.standard_normal((channels, frames)))


def _codes24(x):
    import numpy as np

    return np.clip(np.round(x * (1 << 23)), -(1 << 23), (1 << 23) - 1).astype(np.int32)


def _wire24(codes):
    """int32 codes ``(C, frames)`` -> interleaved little-endian 24-bit bytes."""
    import numpy as np

    v = codes.T.astype(np.uint32)
    return np.stack([(v >> s) & 0xFF for s in (0, 8, 16)], axis=-1).astype(np.uint8).reshape(-1)


def _measure(fn, dev, runs: int) -> dict:
    """Median CUDA-event ms, device ms and operations a call, peak MB above
    what is allocated at the start, and the output's sha256."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        out = fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 1e6
    ts = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    names: dict = {}
    for e in dev_events:
        key = e.name[:60]
        names[key] = names.get(key, 0) + 1
    first = out[0] if isinstance(out, tuple) else out
    sha = hashlib.sha256(first.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]
    return {"events_ms": float(np.median(ts)),
            "device_ms": sum((e.time_range.end - e.time_range.start) for e in dev_events)
            / 1e3 / runs if dev_events else None,
            "device_ops": len(dev_events) / runs,
            "ops": {k: v / runs for k, v in sorted(names.items(), key=lambda kv: -kv[1])},
            "peak_mb": round(peak, 1), "sha256": sha}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the checkout whose f9tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the checkout in the output")
    ap.add_argument("--runs", type=int, default=10, help="calls timed a case")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("front_end_times: no CUDA GPU available", file=sys.stderr)
        return 1
    from f9tpu_torch import resolve_device
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.pipeline import calibration, graph, stream

    try:
        from f9tpu_torch.ops import frontend
    except ImportError:         # a tree from before the kernel: no twin to time
        frontend = None
    dev = resolve_device("cuda")
    card = _card()

    rng = np.random.default_rng(SEED + 1)
    wire = np.zeros((8, BUCKET * 6), np.uint8)
    bucket = np.zeros((8, 2, BUCKET), np.float32)
    valid = np.zeros(8, np.int32)
    for i in range(8):
        frames = int(rng.integers(TAKE_SECONDS[0] * 44100, TAKE_SECONDS[1] * 44100))
        codes = _codes24(_signal(rng, 2, frames, 44100))
        wire[i, :frames * 6] = _wire24(codes)
        bucket[i, :, :frames] = codes.astype(np.float32) / np.float32(1 << 23)
        valid[i] = frames
    wd, bd = torch.from_numpy(wire).to(dev), torch.from_numpy(bucket).to(dev)
    vd = torch.from_numpy(valid).to(dev)
    full = torch.full((8,), BUCKET, dtype=torch.int32, device=dev)
    raw_in = (2, 24, False)
    out_bytes = 8 * 2 * BUCKET * 4

    # one 20 s chunk of phase 6's 600 s stream (the 10th), with its halos
    bank = design_cycle_bank(44100, 48000)
    chunk_in = stream.stream_chunk_plan(bank, 20.0, 44100)
    halo_left = bank.pad_front
    halo_right = max(0, bank.W - bank.M - halo_left)
    span = chunk_in + halo_left + halo_right
    srng = np.random.default_rng(SEED + 8)
    chunk = _wire24(_codes24(_signal(srng, 2, span, 44100, start=10 * chunk_in - halo_left)))
    cd = torch.from_numpy(chunk).to(dev)
    mean = torch.tensor([[1.25e-4], [-2.5e-4]], dtype=torch.float32, device=dev)

    cfg = ProcessingConfig(output_dir="unused", target_rate=48000)
    lat = calibration.measure_latency(44100, 48000, device=dev).latency_frames
    seeds = np.arange(1, 9, dtype=np.int32)
    cases = [
        ("raw", lambda: graph._front_end(wd, vd, None, None, raw_in),
         int(valid.sum()) * 6 + out_bytes),
        ("raw routed", lambda: graph._front_end(wd, vd, (1, 0), None, raw_in),
         int(valid.sum()) * 6 + out_bytes),
        ("raw full bucket", lambda: graph._front_end(wd, full, None, None, raw_in),
         8 * BUCKET * 6 + out_bytes),
        ("float", lambda: graph._front_end(bd, vd, None, None, None),
         int(valid.sum()) * 2 * 4 + out_bytes),
        ("stream chunk", lambda: stream._raw_front(cd, in_wire=(24, False), in_channels=2,
                                                   mean=mean, valid=(0, span)),
         span * 6 + 2 * span * 4),
        ("graph raw", lambda: graph.process_batch_raw(
            wd, vd, cfg, 44100, seeds, in_channels=2, in_bits=24, latency_frames=lat,
            device=dev).codes, None),
        ("graph float", lambda: graph.process_batch(
            bd, vd, cfg, 44100, seeds, latency_frames=lat, device=dev).codes, None),
    ]
    if frontend is not None:
        cases += [
            ("twin raw", lambda: frontend.front_end_reference(wd, vd, raw=raw_in), None),
            ("twin raw routed", lambda: frontend.front_end_reference(
                wd, vd, raw=raw_in, routing=(1, 0)), None),
            ("twin stream chunk", lambda: frontend.front_end_reference(
                cd, raw=raw_in, mean=mean, span=(0, span)), None)]
    for name, fn, nbytes in cases:
        got = _measure(fn, dev, args.runs)
        if nbytes is not None:
            got.update(bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bound_bytes=nbytes)
        print(json.dumps({"tree": args.tag or args.root, "case": name, **got, "card": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
