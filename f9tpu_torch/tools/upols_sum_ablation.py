#!/usr/bin/env python3
"""What UPOLS's group form and its multiply-sum kernel buy, and what they
do to a file's bytes.

    python3 -m f9tpu_torch.tools.upols_sum_ablation [--rows 16] [--seconds 20] [--device cuda]

Runs `ops.chain._fft_convolve_multi` (a stereo 2.5 s IR at 48 kHz: B =
4096, K = 30, the insert loop's reverb) on ``--rows`` stereo signals of
``--seconds`` in three forms, in turns (group, block, twin, twin, block,
group): ``group``, the port's form (`chain.UPOLS_GROUP` blocks a batched
FFT pair and one `chain_kernels.upols_mac` launch); ``block``, the same
with groups of one block (a launch a block, as the scan steps); ``twin``,
the group form with the kernel replaced by its plain twin
`chain_kernels.upols_mac_reference` on the same device.  It prints the
median CUDA-event time of each with the card's name and power limit, and
whether each form's output equals the group form's bit for bit (all must).
Then, on the group form, how many output samples of the first signal
differ between the ``--rows``-signal run and a 1-signal run (must be 0).
On the CPU every form runs the twin: it prints the equalities and the
count, and no times.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import chain, chain_kernels


def _card(dev: torch.device) -> str:
    if dev.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


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
    group, kernel = chain.UPOLS_GROUP, chain_kernels.upols_mac
    forms = {"group": (group, kernel), "block": (1, kernel),
             "twin": (group, chain_kernels.upols_mac_reference)}

    def run(form: str, v: torch.Tensor) -> torch.Tensor:
        chain.UPOLS_GROUP, chain_kernels.upols_mac = forms[form]
        try:
            return chain._fft_convolve_multi(v, ir)
        finally:
            chain.UPOLS_GROUP, chain_kernels.upols_mac = group, kernel

    outs = {form: run(form, x) for form in forms}
    if dev.type == "cuda":
        times = {form: [] for form in forms}
        for form in ("group", "block", "twin", "twin", "block", "group"):
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
                  f"{form} (groups of {forms[form][0]}): {ms:.2f} ms ({1e3 * ms / blocks:.1f} us "
                  f"per block; median of {len(ts)}) [{card}]", flush=True)
    for form in ("block", "twin"):
        same = torch.equal(outs[form].view(torch.int32), outs["group"].view(torch.int32))
        print(f"upols {form} vs group: bitwise equal {same} [{card}]", flush=True)
    t0 = time.time()
    alone = run("group", x[:1])[0]
    n = int((outs["group"][0] != alone).sum())
    print(f"upols group: signal 0 in a {args.rows}-signal run vs alone: {n} of {alone.numel()} "
          f"samples differ ({time.time() - t0:.1f} s) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
