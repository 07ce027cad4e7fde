#!/usr/bin/env python3
"""What the fixed-order delay-line sum costs the UPOLS block loop, and what
the library sum it replaced did to a file's bytes.

    python3 -m f9tpu_torch.tools.upols_sum_ablation [--rows 16] [--seconds 20] [--device cuda]

Runs `ops.chain._fft_convolve_multi` (a stereo 2.5 s IR at 48 kHz: B =
4096, K = 30, the insert loop's reverb) on ``--rows`` stereo signals of
``--seconds`` twice over, in turns tree, sum, sum, tree: with
`chain._delay_line_sum` (the halving tree of the port) and with a
``torch.sum`` over the delay-line axis in its place (the form before it),
and prints the median CUDA-event time of each with the card's name and
power limit.  Then, for each form, how many output samples of the first
signal differ between the ``--rows``-signal run and a 1-signal run (the
tree's must be 0).  On the CPU it prints the counts and no times.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import chain


def _card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def _library_sum(p: torch.Tensor) -> torch.Tensor:
    return torch.sum(p, dim=0)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=16, help="stereo signals per run")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = _card(dev)
    rng = np.random.default_rng(6)
    n_ir = int(2.5 * 48000)
    ir = (rng.standard_normal((2, n_ir)) * np.exp(-np.arange(n_ir) / (0.4 * 48000)))
    ir = (ir / np.sqrt(np.sum(ir * ir, axis=-1, keepdims=True))).astype(np.float32)
    x = torch.from_numpy((0.1 * rng.standard_normal((args.rows, 2, int(args.seconds * 48000))))
                         .astype(np.float32)).to(dev)
    blocks = -(-x.shape[-1] // 4096)
    forms = {"tree": chain._delay_line_sum, "sum": _library_sum}

    def run(form: str, v: torch.Tensor) -> torch.Tensor:
        chain._delay_line_sum = forms[form]
        try:
            return chain._fft_convolve_multi(v, ir)
        finally:
            chain._delay_line_sum = forms["tree"]

    if dev.type == "cuda":
        times = {"tree": [], "sum": []}
        for form in ("tree", "sum"):
            run(form, x)
        for form in ("tree", "sum", "sum", "tree"):
            for _ in range(args.runs):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run(form, x)
                b.record()
                torch.cuda.synchronize()
                times[form].append(a.elapsed_time(b))
        for form, ts in times.items():
            ms = float(np.median(ts))
            print(f"upols {args.rows} x 2 x {x.shape[-1]} frames, K=30 B=4096, {blocks} blocks, "
                  f"{form}: {ms:.2f} ms ({1e3 * ms / blocks:.1f} us per block; "
                  f"median of {len(ts)}) [{card}]", flush=True)
    for form in forms:
        t0 = time.time()
        whole = run(form, x)[0]
        alone = run(form, x[:1])[0]
        n = int((whole != alone).sum())
        print(f"upols {form}: signal 0 in a {args.rows}-signal run vs alone: {n} of "
              f"{whole.numel()} samples differ ({time.time() - t0:.1f} s) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
