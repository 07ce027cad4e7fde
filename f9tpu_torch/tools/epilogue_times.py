#!/usr/bin/env python3
"""The epilogue kernel pair's device times, for this checkout or another.

    python3 f9tpu_torch/tools/epilogue_times.py [--root DIR] [--tag NAME]

Times `ops.epilogue.epilogue` of the checkout at ``--root`` (default: the
one holding this file) on the card: ``bench.py``'s job (16 x 2 x 1,141,440
outputs) and the slice's batch (8 x 2 x 4,565,280), whole files, dither and
DC on, int32 codes and the 24-bit payload; and the stream's chunk finish
(one stereo 20 s chunk at 48 kHz, 24-bit payload, no mask, no statistics).
For each it prints one JSON line: the median over 10 calls of each pass's
time and of the pair's span (pass 1's start to pass 2's end) from
`torch.profiler`'s kernel events, with the card's name and power limit.
Run it as a script, not with ``-m``, so that ``--root`` decides which
``f9tpu_torch`` is imported: comparing two trees takes one process each, in
turns (parent, change, change, parent) on one card.  Without a card it
exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        import torch

        return torch.cuda.get_device_name(0)


def _profile(fn, runs: int = 10) -> dict:
    """Median ms of each pass and of the pair's span over ``runs`` calls."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    spans = {"dc_pass": [], "finish_pass": []}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name, got in spans.items():
                if name in e.name:
                    got.append((e.time_range.start, e.time_range.end))
    p1, p2 = sorted(spans["dc_pass"]), sorted(spans["finish_pass"])

    def med(xs):
        return float(np.median(xs)) if xs else None
    return {"pass1_ms": med([(b - a) / 1e3 for a, b in p1]),
            "pass2_ms": med([(b - a) / 1e3 for a, b in p2]),
            "pair_ms": med([(b[1] - a[0]) / 1e3 for a, b in zip(p1, p2)] if p1
                           else [(b - a) / 1e3 for a, b in p2])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the checkout whose f9tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the checkout in the output")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("epilogue_times: no CUDA GPU available", file=sys.stderr)
        return 1
    from f9tpu_torch import resolve_device
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import dither
    from f9tpu_torch.ops import epilogue as ep

    dev = resolve_device("cuda")
    card = _card()
    bank = design_cycle_bank(44100, 48000)

    def emit(shape: str, form: str, t: dict) -> None:
        print(json.dumps({"tree": args.tag or args.root, "shape": shape, "form": form, **t,
                          "card": card}), flush=True)

    for shape, files, frames in (("bench.py's job", 16, 1 << 20),
                                 ("the slice's batch", 8, 1 << 22)):
        total = -(-bank.out_len(frames) // bank.L) * bank.L
        gen = torch.Generator(device=dev).manual_seed(7)
        y = 0.25 * torch.randn((files, 2, total), generator=gen, device=dev) + 0.01
        out_frames = torch.full((files,), total, dtype=torch.int32, device=dev)
        seeds = dither.channel_seeds(torch.arange(1, files + 1, device=dev), 2)
        for form, kw in (("int32", {}), ("payload24", {"packed": 24})):
            emit(shape, form, _profile(lambda: ep.epilogue(
                y, out_frames, seeds, bits=24, remove_dc=True, gain=1.0, **kw)))
        del y
        torch.cuda.empty_cache()
    y = 0.25 * torch.randn((1, 2, 20 * 48000), device=dev)
    seeds = dither.channel_seeds(torch.tensor([5], device=dev), 2)
    emit("a stream chunk of 20 s", "payload24", _profile(lambda: ep.epilogue(
        y, None, seeds, bits=24, remove_dc=False, gain=0.9, packed=24, pos0=123456789,
        stats=False), runs=20))
    return 0


if __name__ == "__main__":
    sys.exit(main())
