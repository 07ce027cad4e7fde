#!/usr/bin/env python3
"""How far `resample` of the studio banks that `cycle_src` does not take
rounds from the exact sum, on the card and on the CPU.

    python3 -m f9tpu_torch.tools.plain_src_error [--quality high] [--seconds 60]

Which implementation `f9tpu_torch.ops.resample.resample` runs on each
device is `src_kernel.src_route`'s answer (for these banks the float32
`torch.matmul` of the unfolded cycle windows on the CPU, with no
compensation).  For every studio pair whose answer is not ``cycle_src``
this runs a stereo signal of ``--seconds`` at about -12 dBFS (two tones
and noise) through `resample` on the card and on the CPU, and through the
fixed-order float64 fold `_presliced_fold` (the exact sum rounded once),
and prints in LSB at 24 bits the largest difference of card and CPU, the
24-bit codes they round to, and each against the fold, with the card's name
and power limit.  Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..models.filters import STANDARD_RATES, design_cycle_bank
from ..ops import resample as tr
from ..ops.src_kernel import src_route


def _signal(rng, frames: int, rate: int) -> torch.Tensor:
    t = np.arange(frames) / rate
    f = rng.uniform(80.0, 6000.0, size=(2, 2))
    x = (0.3 * np.sin(2 * np.pi * f[:, :1] * t) + 0.15 * np.sin(2 * np.pi * f[:, 1:] * t + 0.7)
         + 0.02 * rng.standard_normal((2, frames)))
    return torch.from_numpy(x.astype(np.float32))


def _lsb(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) * 2.0 ** 23


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quality", default="high")
    ap.add_argument("--seconds", type=float, default=60.0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(1)
    for ri in STANDARD_RATES:
        for ro in STANDARD_RATES:
            bank = design_cycle_bank(ri, ro, quality=args.quality)
            if ri == ro or src_route(bank, dev).impl == "cycle_src":
                continue
            x = _signal(rng, int(args.seconds * ri), ri)
            y_cpu = tr.resample(x, bank)
            y_card = tr.resample(x.to(dev), bank).cpu()
            Q = -(-y_cpu.shape[-1] // bank.L)
            xp = torch.zeros((2, (Q - 1) * bank.M + bank.W), dtype=torch.float32)
            keep = min(x.shape[-1], xp.shape[-1] - bank.pad_front)
            xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
            fold = tr._presliced_fold(xp.to(dev), bank, Q)[:, :y_cpu.shape[-1]].cpu()
            codes = int((torch.round(y_card.double() * 2 ** 23)
                         - torch.round(y_cpu.double() * 2 ** 23)).abs().max())
            print(f"{ri}->{ro} {args.quality} (L={bank.L} M={bank.M} W={bank.W}), 2 x "
                  f"{x.shape[-1]} frames: card vs CPU {_lsb(y_card, y_cpu):.3f} LSB (codes "
                  f"{codes} apart); vs the float64 fold: card {_lsb(y_card, fold):.3f}, CPU "
                  f"{_lsb(y_cpu, fold):.3f} LSB [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
