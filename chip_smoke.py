#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`f9tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, `nvcc` and
PyTorch built for CUDA.  It imports nothing of JAX.  Phases, each printing
its results, any failure exiting non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the CUDA kernels from `f9tpu_torch/csrc/` (seconds, ptxas report);
3. the cycle-matrix SRC kernel against its plain PyTorch twin on 32 signals
   x 2^20 frames for four banks (R = 1, 1, 2, 4): max abs difference, dB
   against the float64 oracle (<= -120 dB), launch count, median
   CUDA-event times of kernel and twin;
4. the default batch job, `f9tpu_torch.cli process --rate 48000` on 8
   stereo 24-bit 44.1 kHz WAVs of 50-60 s: 8 completed, kernel launches
   counted from zero, outputs <= -120 dB against the oracle and within
   2 LSB of the port's CPU path, wall time and x real time.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA GPU it exits 1 and
prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: kernel vs twin: the twin sums in float64 and rounds once, the kernel in
#: compensated float32 (~0.1 LSB RMS at 24 bits); on signals peaking near
#: 0.5 they agree to a few float32 ulps (6e-8 each), while an indexing
#: fault is of the order of the signal.
TWIN_TOL = 5e-7
ORACLE_DB_MAX = -120.0
#: the JAX package's own tolerance between two SRC forms after quantizing
LSB_TOL = 2
SEED = 20260116


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _db(err, ref) -> float:
    import numpy as np

    e = np.sqrt(np.mean(np.square(np.asarray(err, np.float64))))
    r = np.sqrt(np.mean(np.square(np.asarray(ref, np.float64))))
    return float(20.0 * np.log10(max(e, 1e-300) / r))


def _signal(rng, channels: int, frames: int, rate: int):
    """Two tones plus white noise at about -12 dBFS RMS, float32."""
    import numpy as np

    t = np.arange(frames) / rate
    f = rng.uniform(80.0, 6000.0, size=(channels, 2))
    x = (0.3 * np.sin(2 * np.pi * f[:, :1] * t)
         + 0.15 * np.sin(2 * np.pi * f[:, 1:] * t + 0.7)
         + 0.02 * rng.standard_normal((channels, frames)))
    return x.astype(np.float32)


def _median_ms(fn, runs: int = 10) -> float:
    import numpy as np
    import torch

    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def phase_kernel(card: str, dev) -> dict:
    """Kernel vs twin vs oracle on four banks; returns the default bank's
    numbers for the JSON summary."""
    import numpy as np
    import torch

    from f9tpu.models import design_cycle_bank, resample_oracle
    from f9tpu_torch.ops import src_kernel as sk

    rng = np.random.default_rng(SEED)
    x_np = _signal(rng, 32, 1 << 20, 44100)
    x = torch.from_numpy(x_np).to(dev)
    summary = None
    for ri, ro, q in [(44100, 48000, "high"), (48000, 44100, "high"),
                      (44100, 48000, "ultra"), (176400, 48000, "high")]:
        bank = design_cycle_bank(ri, ro, quality=q)
        R = sk._overlap_rows(bank)
        if not sk.kernel_applicable(bank):
            raise AssertionError(f"{ri}->{ro} {q}: kernel not applicable")
        n0 = sk.launches
        y = sk.resample_kernel(x, bank)
        torch.cuda.synchronize()
        if sk.launches != n0 + 1:
            raise AssertionError(f"{ri}->{ro} {q}: launch counter did not move")
        out_len = y.shape[-1]

        def twin():
            yt, _ = sk.resample_rows_reference(x, bank)
            return yt.reshape(32, -1)[:, :out_len]

        err = float((y - twin()).abs().max())
        small = x_np[:2, :1 << 16]
        yk = sk.resample_kernel(torch.from_numpy(small).to(dev), bank).cpu().numpy()
        ref = resample_oracle(small, ri, ro, quality=q)
        db = _db(yk - ref, ref)
        for _ in range(3):
            sk.resample_kernel(x, bank)
            twin()
        torch.cuda.synchronize()
        ms = _median_ms(lambda: sk.resample_kernel(x, bank))
        plain_ms = _median_ms(twin)
        ms2 = _median_ms(lambda: sk.resample_kernel(x, bank))
        plain_ms2 = _median_ms(twin)
        print(f"kernel {ri}->{ro} {q} (L={bank.L} M={bank.M} W={bank.W} R={R}) "
              f"32x2^20: max_abs_vs_twin={err:.3e} (tol {TWIN_TOL:g}) "
              f"oracle={db:.1f} dB (max {ORACLE_DB_MAX:g}) "
              f"kernel_ms={ms:.4f}/{ms2:.4f} twin_ms={plain_ms:.4f}/{plain_ms2:.4f} "
              f"(median of 10, two turns) [{card}]", flush=True)
        if not err <= TWIN_TOL:
            raise AssertionError(f"{ri}->{ro} {q}: kernel vs twin {err:.3e}")
        if not db <= ORACLE_DB_MAX:
            raise AssertionError(f"{ri}->{ro} {q}: {db:.1f} dB vs oracle")
        if summary is None:
            summary = {"max_abs_err": err, "ms": min(ms, ms2),
                       "plain_ms": min(plain_ms, plain_ms2)}
    del x
    torch.cuda.empty_cache()
    return summary


def _read_codes(path: str):
    import numpy as np

    from f9tpu.io import wav

    x, rate = wav.read_wav(path)
    return np.round(np.asarray(x, np.float64) * (1 << 23)).astype(np.int64), rate


def phase_slice(card: str, work: str) -> int:
    """The default batch job through the port's CLI; returns the kernel
    launches it made."""
    import numpy as np

    from f9tpu.io import wav
    from f9tpu.models import resample_oracle
    from f9tpu_torch import cli
    from f9tpu_torch.ops import src_kernel as sk

    rng = np.random.default_rng(SEED + 1)
    in_dir = os.path.join(work, "in")
    os.makedirs(in_dir)
    t0 = time.time()
    for i in range(8):
        frames = int(rng.integers(50 * 44100, 60 * 44100))
        wav.write_wav(os.path.join(in_dir, f"take{i}.wav"),
                      _signal(rng, 2, frames, 44100), 44100, bits=24)
    print(f"slice: wrote 8 stereo 24-bit 44.1 kHz WAVs of 50-60 s "
          f"in {time.time() - t0:.1f} s", flush=True)

    out_gpu = os.path.join(work, "out_gpu")
    buf = io.StringIO()
    sk.launches = 0
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["process", in_dir, "--out", out_gpu, "--rate", "48000",
                       "--json"])
    wall = time.time() - t0
    launches = sk.launches
    summary = json.loads(buf.getvalue())
    print(f"slice: cli process rc={rc} completed={summary['completed']} "
          f"failed={summary['failed']} kernel_launches={launches} "
          f"wall={wall:.3f} s audio_out={summary['audio_seconds_out']:.1f} s "
          f"x_realtime={summary['audio_seconds_out'] / wall:.1f} "
          f"(scheduler's own wall {summary['wall_seconds']:.3f} s, "
          f"{summary['x_realtime']:.1f}x) [{card}]", flush=True)
    print("slice: stages " + json.dumps(summary["throughput"]), flush=True)
    if rc != 0 or summary["completed"] != 8 or summary["failed"] != 0:
        raise AssertionError(f"slice: expected 8 completed, got {summary}")
    if launches < 2:     # calibration + at least one batch
        raise AssertionError(f"slice: {launches} kernel launches")

    names = ["take0.wav", "take1.wav"]
    srcs = [os.path.join(in_dir, n) for n in names]
    out_cpu = os.path.join(work, "out_cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["process", *srcs, "--out", out_cpu, "--rate", "48000",
                       "--batch-size", "2", "--device", "cpu", "--json"])
    if rc != 0:
        raise AssertionError(f"slice: CPU run rc={rc}")
    for src, name in zip(srcs, names):
        stem = os.path.splitext(name)[0]
        g_codes, g_rate = _read_codes(os.path.join(out_gpu, f"{stem}_processed.wav"))
        c_codes, c_rate = _read_codes(os.path.join(out_cpu, f"{stem}_processed.wav"))
        x_in, _ = wav.read_wav(src)
        ref = resample_oracle(x_in, 44100, 48000, quality="high")
        ref = ref - ref.mean(axis=-1, keepdims=True)
        got = g_codes / float(1 << 23)
        got = got - got.mean(axis=-1, keepdims=True)
        db = _db(got - ref, ref)
        diff = np.abs(g_codes - c_codes) if g_codes.shape == c_codes.shape else None
        n_diff = int((diff != 0).sum()) if diff is not None else -1
        max_diff = int(diff.max()) if diff is not None else -1
        print(f"slice: {name} frames={g_codes.shape[-1]} rate={g_rate} "
              f"oracle={db:.1f} dB (max {ORACLE_DB_MAX:g}) "
              f"vs_cpu: {n_diff} of {g_codes.size} samples differ, "
              f"max {max_diff} LSB (tol {LSB_TOL})", flush=True)
        if g_rate != 48000 or c_rate != 48000 or ref.shape != g_codes.shape:
            raise AssertionError(f"slice: {name}: shape/rate mismatch")
        if diff is None or max_diff > LSB_TOL:
            raise AssertionError(f"slice: {name}: card vs CPU path differ")
        if not db <= ORACLE_DB_MAX:
            raise AssertionError(f"slice: {name}: {db:.1f} dB vs oracle")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from f9tpu_torch import resolve_device
    from f9tpu_torch.ops import _build

    card = _card()
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    dev = resolve_device("cuda")

    t0 = time.time()
    _build.load_library()
    print(f"build: {time.time() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)",
          flush=True)
    print(_build.build_log.strip(), flush=True)

    k = phase_kernel(card, dev)
    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    try:
        launches = phase_slice(card, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "cycle_src",
        "route": "cuda",
        "source": "f9tpu_torch/csrc/cycle_src.cu",
        "replaces": "f9tpu/ops/pallas_src.py:189",
        "also_replaces": "f9tpu/ops/pallas_src.py:141",
        "launches": launches,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
