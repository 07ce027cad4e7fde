"""Small versions of the benchmark's cells for its CPU tests: every size cut
so that a run takes seconds on the port's plain CPU path, the cell's own
limits kept."""

from __future__ import annotations

import contextlib
import io
import json

from bench_h100 import harness

CELLS = ("studio48.cd_masters", "reverb48.stems_reverb", "studio48.hires_sfx")


def overrides(workload: str) -> dict:
    small = {"traffic": {"seconds": [0.2, 0.35], "files": 16, "warmup_batches": 1,
                         "trace_batches": 2, "check_batches": 2},
             "config": {"bucket_frames": [16384, 65536]}}
    if workload.startswith("reverb48"):
        # a capture of 1 s: the tail rings out past the source inside it
        small["config"]["max_tail_seconds"] = 1.0
    if workload.endswith("hires_sfx"):
        small["traffic"]["seconds"] = [0.1, 0.15]
    return small


def run(workload: str, seed: int = 4294967311, trace: int = 0, extra=(),
        traffic: dict | None = None) -> tuple[int, dict]:
    """``(exit code, result)`` of one small run of the cell on the CPU,
    its small traffic updated by ``traffic``."""
    ov = overrides(workload)
    ov["traffic"].update(traffic or {})
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "1",
                           "--trace", str(trace), *extra], device="cpu", overrides=ov)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else {})
