"""Faults planted in the timed path, underneath the harness: each breaks
what `process_batch_raw` answers in one way a batch job can go wrong, and a
run with it planted has to come out not correct.

    python3 bench_h100/tests/faults.py <fault> <workload> <seconds> <seed> [<seed> ...]

runs the cell once a seed with the fault planted, in one process, and
prints each run's result line.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

FAULTS = ("stale", "stale_lib", "seed", "undithered", "half", "altered", "frames")


def plant(fault: str, setattr_) -> None:
    """Replace the program's `process_batch_raw` by one that answers with
    ``fault``: ``stale`` the previous dispatch's results; ``stale_lib`` the
    results of the last dispatch of the same library batch (the same wire,
    other dither seeds); ``seed`` another dither seed a file; ``undithered``
    no dither; ``half`` the second half of the batch zero; ``altered`` one
    byte flipped; ``frames`` one file a frame short.  ``setattr_`` sets the
    attribute (pytest's ``monkeypatch.setattr`` or `setattr`)."""
    from f9tpu_torch.pipeline import graph

    if fault not in FAULTS:
        raise ValueError(f"no fault {fault!r}")
    real = graph.process_batch_raw
    last: list = []
    by_wire: dict = {}

    def step(raw, valid, cfg, rate_in, seeds, *args, **kwargs):
        if fault == "seed":
            seeds = (np.asarray(seeds, np.int64) + 1).astype(np.int32)
        elif fault == "undithered":
            cfg = dataclasses.replace(cfg, dither=False)
        res = real(raw, valid, cfg, rate_in, seeds, *args, **kwargs)
        if fault == "stale":
            out = last[0] if last else res
            last[:] = [res]
            return out
        if fault == "stale_lib":
            out = by_wire.get(id(raw), res)
            by_wire[id(raw)] = res
            return out
        if fault == "half":
            res.codes = res.codes.clone()
            res.codes[res.codes.shape[0] // 2:] = 0
        elif fault == "altered":
            res.codes = res.codes.clone()
            res.codes[0, 3 * 2 * 1000 + 2] ^= 0x40          # frame 1000, left, top byte
        elif fault == "frames":
            res.out_frames = res.out_frames.clone()
            res.out_frames[1] -= 1
        return res

    setattr_(graph, "process_batch_raw", step)


def main(argv: list[str]) -> int:
    fault, workload, seconds, *seeds = argv
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    from bench_h100 import harness

    plant(fault, setattr)
    rcs = []
    for seed in seeds:
        print(f"fault {fault} {workload} seed {seed}", flush=True)
        rcs.append(harness.main(["--workload", workload, "--seed", seed, "--seconds", seconds]))
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
