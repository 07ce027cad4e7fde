#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`f9tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, `nvcc` and
PyTorch built for CUDA.  It imports nothing of JAX.  Phases, each printing
its results, any failure exiting non-zero:

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build of the CUDA kernels from `f9tpu_torch/csrc/` (seconds, ptxas report);
3. the cycle-matrix SRC kernel against its plain PyTorch twin on 32 signals
   x 2^20 frames for four banks (R = 1, 1, 2, 4): max abs difference and
   24-bit LSB error against the twin, dB against the float64 oracle
   (<= -120 dB), launch count, launch plan and blocks per SM, median
   CUDA-event times of kernel, twin and the one-call library form (an fp32
   `torch.matmul` of the rows view plus R shifted adds, which the port never
   calls), and the card's bound for the same work;
4. the default batch job, `f9tpu_torch.cli process --rate 48000` on 8
   stereo 24-bit 44.1 kHz WAVs of 50-60 s: 8 completed, kernel launches
   counted from zero, outputs <= -120 dB against the oracle and within
   2 LSB of the port's CPU path, wall time and x real time; one batch's
   graph split; the link in turns: a pageable upload and `.cpu()` of the
   batch's six results against the pinned upload and the side-stream
   `link.Download` (same bytes); the collector's blocking ms and the
   dispatch thread's ms per batch (with its pinned allocations, uploads and
   the downloads' start) for this job and for 32 takes in four batches
   (wall, x real time);
5. the insert loop, `cli process --rate 48000 --reverb --routing 1,0
   --chain-delay-ms 5 --chain-eq peaking:1000:1:3 --chain-comp=-18:3
   --chain-ir IR.wav --chain-limit=-0.3` on 8 stereo 24-bit 44.1 kHz WAVs
   of 20-40 s with a stereo 2.5 s 48 kHz IR: 8 completed, every tail
   terminated and longer than its source, kernel launches counted from
   zero (calibration and batches), the 2 shortest outputs within 16 LSB of
   the port's CPU path, wall time and x real time, one batch's device graph
   split by CUDA events into SRC, each chain stage and the rest, and the 2
   shortest files run again as a 2-file batch on the card: 0 samples may
   differ from the 8-file batch (the UPOLS sum's order is fixed);
6. the streaming path: (a) `cycle_src` on a 2^22-frame stereo signal whole
   and as haloed chunks of 6000 and 1777 cycles, equal bit for bit, each
   chunk within `TWIN_TOL` of its plain twin, four banks; (b) `cli process`
   on a 10-minute stereo 24-bit 44.1 kHz WAV (past the largest bucket) and
   two 30 s files: 3 completed, the long one streamed, launches counted
   from zero; (c) `cli stream` with phase 5's chain flags and the
   calibrated latency on the 10-minute file at 20 s and 7.3 s chunks:
   identical sha256, wall time, x real time and peak device memory (also
   for a 2-minute file), the device's busy share of the 2-minute stream
   (`torch.profiler`), and one 20 s chunk split by CUDA events into SRC,
   each chain stage and finish / pack / download; (d) the same in reverb
   mode on a 5-minute file: tail detected past the source, identical bytes
   at two chunk sizes; (e) a 30 s file streamed at 4 s chunks on the card
   and on the CPU: <= 2 LSB and <= -120 dB against the oracle without the
   chain, <= 16 LSB with it; (f) `f9tpu_torch.tools.hw_soak` at a fixed
   seed, a few trials per part;
7. varispeed and loudness normalization: (a) the kernel's windowed form
   (varispeed banks, no dense matrix) against its plain twin, the float64
   gather, on 32 signals x 2^20 frames for 44.1k->44056 high, 44056->44.1k
   high and 44.1k->44056 ultra: max abs and 24-bit LSB error against the
   twin, dB against the float64 oracle, launch plan, the MB it stages
   from L2 (windows, band; counted from the plan), median CUDA-event times of kernel, twin and the
   library form (one fp32 `torch.matmul` per 128-output segment of the
   cycle rows, which the port never calls), and the bound; the output's
   sha256 equal to the first design's (`WINDOWED_DIGESTS`); (b) a 2^22-frame
   stereo signal whole and as haloed chunks of 100, 37 and 29 cycles (29: a
   smaller tile group): 0 outputs differ; one launch's device time
   at the stream's chunk shapes (2 x 80 and 2 x 29 cycles); (c) `cli process --rate 44056` on 8 stereo 24-bit 44.1 kHz WAVs
   of 50-60 s (8 completed, launches from zero, <= 2 LSB against the CPU
   path, <= -120 dB against the oracle) and `cli stream --rate 44056` on a
   10-minute file at 20 s and 7.3 s chunks (identical sha256, peak device
   memory); (d) `cli process --rate 48000 --normalize-lufs=-16
   --normalize-tp=-1` on 8 stereo files of 50-60 s whose levels span
   20 dB, one of them peaky: 8 completed, each output within 0.1 LU of
   -16 LUFS unless its log line says capped or clamped, source LUFS and
   gain on the card within 0.01 of the port's CPU path and bytes <= 2 LSB,
   the same gain from `cli stream` and from the meter on a file reader,
   `cli probe --loudness`, and one file's meter split by CUDA events;
8. the tool path: the kernel against its twin at the new callers' shapes
   (the 0.5 s parity noise and the 1 s loop tone, three banks; haloed
   chunks of 1, 2, 3 and 97 cycles, dense and windowed); (a) `cli selftest
   --parity` on four banks: loop detected, <= -120 dB; (c) `cli devices`:
   the card, count 1; (d) `cli watch` while the slice's 8 files land in two
   waves and one is dropped again with new content: each processed once,
   the new one again, every output's sha256 equal to `cli process` of the
   same files, then `cli verify`: all ok, and exit 1 with `crc_mismatch`
   after one byte flips; (b) `cli measure` without and with a 10 ms delay:
   480 frames apart, the chainless latency the one (d) cached; (e) `cli
   preview` of 6 items at 44.1k, 96k, 48k and 44,056 Hz onto an 8-channel
   bus with a monitor mix, in memory and `--stream`: identical sha256 of
   the main and monitor files, two items within 2 LSB of the CPU path, and
   a `--loops 3` programme routed to the stream by itself; (f) `cli process
   --profile` names the kernel, `--save-config` then `--config` gives the
   same bytes.  Kernel launches are counted from zero for (a), (b), (d), (e);
9. the multi-device path (`f9tpu_torch.parallel`) on the one card: each mesh
   names cuda:0 four times, so its shards share the card and the times
   record the shard threads' overhead, not a scaling.  (a) Phase 4's 8
   files through `BatchProcessor(mesh=4 files shards)` in turns with the
   one-device job: each output's sha256 equal to phase 4's, wall, x real
   time and the collector's blocking; (b) 4 files x 60 s on a 16-channel
   bus over 2 files x 2 channels shards (dither, DC removal, reverb mode, a
   bus-local routing map, delay and EQ): codes, out_frames, tail_terminated,
   peak and floor equal to the unsharded graph, rms_db within 1e-5, and the
   scheduler's logged fallback for a cross-shard map with the one-device
   job's bytes; (c) `resample_frames_sharded` on 32 x 2^20 frames over 4
   frames shards, default bank and 176.4k -> 48k high: bitwise the
   unsharded kernel's output, device ms of both; (d) the 10-minute file
   through `stream_resample_file(mesh=4 frames shards)` without a chain,
   with phase 5's chain and at 44,056 Hz (the varispeed bank's haloed
   chunks, as for dense banks): sha256 equal to the one-device stream, wall
   and x real time; the host's cost of one `run_sharded` call on 4 shards
   (a no-op, one `psum`, two `ppermute`s); and `cli process --files-shards
   2` on the one card exits non-zero with the mesh's size.  Kernel launches
   are counted from zero for (a)-(d).

Each phase prints its wall time.  The line before the last is the kernels'
JSON summary; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA GPU it exits 1 and prints no result.  ``python3 chip_smoke.py
--windowed-digests`` only prints 7a's digests, and ``--chunk-times`` only
7b's times of one launch at the stream's chunk shapes, for the checkout it
sits in (a parent tree unpacked by `git archive` beside this script's copy).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
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
#: split TF32 with compensated partials (~0.18 LSB RMS at 24 bits); on
#: signals peaking near 0.5 they agree to a few float32 ulps (6e-8 each),
#: while an indexing fault is of the order of the signal.
TWIN_TOL = 5e-7
ORACLE_DB_MAX = -120.0
#: the JAX package's own tolerance between two SRC forms after quantizing
LSB_TOL = 2
#: the insert loop's card-vs-CPU bound: the JAX package's full-scale bound
#: between two forms (tests/test_pipeline.py), since cuFFT and pocketfft
#: round differently and the dynamics stages amplify that through log/pow
LOOP_LSB_TOL = 16
SEED = 20260116
INSERT_LOOP_FLAGS = ["--rate", "48000", "--reverb", "--routing", "1,0",
                     "--chain-delay-ms", "5", "--chain-eq", "peaking:1000:1:3",
                     "--chain-comp=-18:3", "--chain-limit=-0.3"]


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


#: the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
#: HBM bytes per second and TF32 tensor-core operations per second
HBM_BYTES_PER_S = 3.35e12
TF32_OPS_PER_S = 495e12
#: TF32 products the kernel makes per multiply-add of the function
#: (split TF32: xh*gl, xl*gh, xh*gh)
TF32_PASSES = 3


def _src_bound(bank, signals: int, frames: int, out_len: int) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card needs for the
    SRC of ``signals`` x ``frames``: the signal read once, the output and
    the bank written and read once, against the kernel's TF32 passes of 2
    operations per non-zero tap of each output's phase at the tensor
    cores' TF32 rate."""
    import numpy as np

    if bank.G is not None:
        nnz = np.count_nonzero(bank.G, axis=0).astype(np.int64)       # per phase
        bank_bytes = 4 * bank.G.size
    else:
        # a varispeed bank: the non-zero taps of each phase's row of the
        # (L, K) phase bank, which is the operand the function needs (the
        # padded hi/lo band the kernel stages is its own cost, not the
        # function's, and is printed beside the plan)
        from f9tpu_torch.ops import resample as tr

        _off, ph = tr._phase_tables(bank)
        nnz = np.count_nonzero(bank.H, axis=1).astype(np.int64)[ph]
        bank_bytes = 4 * bank.H.size
    full, rest = divmod(out_len, bank.L)
    ops = TF32_PASSES * 2 * signals * (full * int(nnz.sum()) + int(nnz[:rest].sum()))
    nbytes = 4 * (signals * frames + signals * out_len) + bank_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / TF32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def _zero_counts() -> None:
    """Set both launch counts to 0, just before a main path is driven."""
    from f9tpu_torch.ops import src_kernel as sk

    sk.launches = sk.launches_windowed = 0


def _read_counts() -> tuple[int, int]:
    """(every launch, those of the windowed form) since `_zero_counts`, read
    just after a main path was driven."""
    from f9tpu_torch.ops import src_kernel as sk

    return sk.launches, sk.launches_windowed


def phase_kernel(card: str, dev) -> dict:
    """Kernel vs twin vs oracle on four banks, timed beside its plain twin
    and the one-call library form; returns the default bank's numbers for
    the JSON summary (and every bank's under ``per_bank``)."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank, resample_oracle
    from f9tpu_torch.ops import _build
    from f9tpu_torch.ops import src_kernel as sk

    rng = np.random.default_rng(SEED)
    n_sig, frames = 32, 1 << 20
    x_np = _signal(rng, n_sig, frames, 44100)
    x = torch.from_numpy(x_np).to(dev)
    summary = None
    per_bank = []
    lib = _build.load_library()
    for ri, ro, q in [(44100, 48000, "high"), (48000, 44100, "high"),
                      (44100, 48000, "ultra"), (176400, 48000, "high")]:
        bank = design_cycle_bank(ri, ro, quality=q)
        R = sk._overlap_rows(bank)
        plan = sk.kernel_plan(bank)
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
            return yt.reshape(n_sig, -1)[:, :out_len]

        # the library form: one fp32 torch.matmul of the zero-padded
        # (Q + R, M) rows view by the stacked bank, then R shifted adds
        # (TF32 off); the marshalling stays outside the timed window
        Q = -(-out_len // bank.L)
        n_rows = Q + R
        keep = min(frames, n_rows * bank.M - bank.pad_front)
        xp = torch.zeros((n_sig, n_rows * bank.M), device=dev)
        xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
        gs = torch.from_numpy(sk.stacked_bank_f32(bank)).to(dev)
        L = bank.L

        def library():
            P = torch.matmul(xp.view(n_sig, n_rows, bank.M), gs.T)
            yl = P[:, :Q, :L].clone()
            for r in range(1, R + 1):
                yl += P[:, r:r + Q, r * L:(r + 1) * L]
            return yl

        yt = twin()
        err = float((y - yt).abs().max())
        lsb = (y.double() - yt.double()) * float(1 << 23)
        lsb_rms, lsb_max = float(lsb.square().mean().sqrt()), float(lsb.abs().max())
        lib_err = float((library().reshape(n_sig, -1)[:, :out_len] - yt).abs().max())
        del yt, lsb
        small = x_np[:2, :1 << 16]
        yk = sk.resample_kernel(torch.from_numpy(small).to(dev), bank).cpu().numpy()
        ref = resample_oracle(small, ri, ro, quality=q)
        db = _db(yk - ref, ref)
        for _ in range(3):
            sk.resample_kernel(x, bank)
            twin()
            library()
        torch.cuda.synchronize()
        # kernel, plain, library, library, plain, kernel
        t = {"ms": [], "plain_ms": [], "library_ms": []}
        for key, fn in (("ms", lambda: sk.resample_kernel(x, bank)), ("plain_ms", twin),
                        ("library_ms", library), ("library_ms", library),
                        ("plain_ms", twin), ("ms", lambda: sk.resample_kernel(x, bank))):
            t[key].append(_median_ms(fn))
        bound_ms, bound_by = _src_bound(bank, n_sig, frames, out_len)
        blocks = lib.f9_cycle_src_blocks_per_sm(plan.nt, plan.warps, plan.smem_bytes)
        print(f"kernel {ri}->{ro} {q} (L={L} M={bank.M} W={bank.W} R={R}; "
              f"plan nt={plan.nt} warps={plan.warps} skew={plan.skew} rowmap={plan.rowmap} "
              f"smem={plan.smem_bytes} B, {blocks} blocks/SM) {n_sig}x2^20: "
              f"max_abs_vs_twin={err:.3e} (tol {TWIN_TOL:g}) "
              f"vs_twin_24bit_lsb rms={lsb_rms:.4f} max={lsb_max:.3f} "
              f"oracle={db:.1f} dB (max {ORACLE_DB_MAX:g}) library_vs_twin={lib_err:.3e} "
              f"kernel_ms={t['ms'][0]:.4f}/{t['ms'][1]:.4f} "
              f"plain_ms={t['plain_ms'][0]:.4f}/{t['plain_ms'][1]:.4f} "
              f"library_ms={t['library_ms'][0]:.4f}/{t['library_ms'][1]:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"(median of 10, two turns) [{card}]", flush=True)
        if not err <= TWIN_TOL:
            raise AssertionError(f"{ri}->{ro} {q}: kernel vs twin {err:.3e}")
        if not db <= ORACLE_DB_MAX:
            raise AssertionError(f"{ri}->{ro} {q}: {db:.1f} dB vs oracle")
        row = {"bank": f"{ri}->{ro} {q}", "max_abs_err": err, "lsb_rms": lsb_rms,
               "lsb_max": lsb_max, "oracle_db": db, "ms": min(t["ms"]),
               "plain_ms": min(t["plain_ms"]), "library_ms": min(t["library_ms"]),
               "bound_ms": bound_ms, "bound_by": bound_by}
        per_bank.append(row)
        if summary is None:
            summary = dict(row)
        del xp, gs
    del x
    torch.cuda.empty_cache()
    summary["per_bank"] = per_bank
    return summary


def _read_codes(path: str):
    import numpy as np

    from f9tpu_torch.io import wav

    x, rate = wav.read_wav(path)
    return np.round(np.asarray(x, np.float64) * (1 << 23)).astype(np.int64), rate


@contextlib.contextmanager
def _dispatch_clock():
    """Host seconds the batch job's dispatch thread spends in its calls
    while the block runs: ``host_empty`` (the pinned batch buffer),
    ``graph`` (`process_batch` / `process_batch_raw`, the uploads inside
    included), ``upload`` and ``download`` (`Download.__init__`: the pinned
    result buffers and the copies' enqueue)."""
    from f9tpu_torch.pipeline import link
    from f9tpu_torch.pipeline import scheduler

    spent = {"host_empty": 0.0, "graph": 0.0, "upload": 0.0, "download": 0.0}
    saved = link.host_empty, link.upload, link.Download.__init__
    graphs = scheduler.process_batch, scheduler.process_batch_raw

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    link.host_empty, link.upload = timed("host_empty", saved[0]), timed("upload", saved[1])
    link.Download.__init__ = timed("download", saved[2])
    scheduler.process_batch = timed("graph", graphs[0])
    scheduler.process_batch_raw = timed("graph", graphs[1])
    try:
        yield spent
    finally:
        link.host_empty, link.upload, link.Download.__init__ = saved
        scheduler.process_batch, scheduler.process_batch_raw = graphs


def phase_slice(card: str, work: str, rate: int = 48000, tag: str = "slice",
                oracle_files: int = 2, dev=None) -> tuple[int, int]:
    """The default batch job through the port's CLI at ``--rate`` (phase 4;
    phase 7c runs it at 44056); returns the kernel launches it made and how
    many of them were the windowed form.  With ``dev`` it also splits one
    batch's device graph.  The
    first two files also go through the port's CPU path, ``oracle_files`` of
    them through the float64 oracle."""
    import numpy as np

    from f9tpu_torch.io import wav
    from f9tpu_torch.models import resample_oracle
    from f9tpu_torch import cli

    rng = np.random.default_rng(SEED + 1)
    in_dir = os.path.join(work, "in")
    os.makedirs(in_dir)
    t0 = time.time()
    for i in range(8):
        frames = int(rng.integers(50 * 44100, 60 * 44100))
        wav.write_wav(os.path.join(in_dir, f"take{i}.wav"),
                      _signal(rng, 2, frames, 44100), 44100, bits=24)
    print(f"{tag}: wrote 8 stereo 24-bit 44.1 kHz WAVs of 50-60 s "
          f"in {time.time() - t0:.1f} s", flush=True)

    out_gpu = os.path.join(work, "out_gpu")
    buf = io.StringIO()
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), _dispatch_clock() as link_s:
        rc = cli.main(["process", in_dir, "--out", out_gpu, "--rate", str(rate),
                       "--json"])
    wall = time.time() - t0
    launches, windowed = _read_counts()
    summary = json.loads(buf.getvalue())
    print(f"{tag}: cli process rc={rc} completed={summary['completed']} "
          f"failed={summary['failed']} kernel_launches={launches} "
          f"wall={wall:.3f} s audio_out={summary['audio_seconds_out']:.1f} s "
          f"x_realtime={summary['audio_seconds_out'] / wall:.1f} "
          f"(scheduler's own wall {summary['wall_seconds']:.3f} s, "
          f"{summary['x_realtime']:.1f}x) [{card}]", flush=True)
    print(f"{tag}: stages " + json.dumps(summary["throughput"]), flush=True)
    if rc != 0 or summary["completed"] != 8 or summary["failed"] != 0:
        raise AssertionError(f"{tag}: expected 8 completed, got {summary}")
    if launches < 2:     # calibration + at least one batch
        raise AssertionError(f"{tag}: {launches} kernel launches")

    names = ["take0.wav", "take1.wav"]
    srcs = [os.path.join(in_dir, n) for n in names]
    out_cpu = os.path.join(work, "out_cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["process", *srcs, "--out", out_cpu, "--rate", str(rate),
                       "--batch-size", "2", "--device", "cpu", "--json"])
    if rc != 0:
        raise AssertionError(f"{tag}: CPU run rc={rc}")
    for src, name in zip(srcs, names):
        stem = os.path.splitext(name)[0]
        g_codes, g_rate = _read_codes(os.path.join(out_gpu, f"{stem}_processed.wav"))
        c_codes, c_rate = _read_codes(os.path.join(out_cpu, f"{stem}_processed.wav"))
        x_in, _ = wav.read_wav(src)
        db = None
        if names.index(name) < oracle_files:
            ref = resample_oracle(x_in, 44100, rate, quality="high")
            ref = ref - ref.mean(axis=-1, keepdims=True)
            got = g_codes / float(1 << 23)
            got = got - got.mean(axis=-1, keepdims=True)
            db = _db(got - ref, ref) if ref.shape == got.shape else 0.0
        n_expect = -(-x_in.shape[-1] * rate // 44100)
        diff = np.abs(g_codes - c_codes) if g_codes.shape == c_codes.shape else None
        n_diff = int((diff != 0).sum()) if diff is not None else -1
        max_diff = int(diff.max()) if diff is not None else -1
        print(f"{tag}: {name} frames={g_codes.shape[-1]} rate={g_rate} "
              f"oracle={'not run' if db is None else f'{db:.1f} dB'} (max {ORACLE_DB_MAX:g}) "
              f"vs_cpu: {n_diff} of {g_codes.size} samples differ, "
              f"max {max_diff} LSB (tol {LSB_TOL})", flush=True)
        if g_rate != rate or c_rate != rate or g_codes.shape[-1] != n_expect:
            raise AssertionError(f"{tag}: {name}: shape/rate mismatch")
        if diff is None or max_diff > LSB_TOL:
            raise AssertionError(f"{tag}: {name}: card vs CPU path differ")
        if db is not None and not db <= ORACLE_DB_MAX:
            raise AssertionError(f"{tag}: {name}: {db:.1f} dB vs oracle")
    if dev is not None:
        _slice_graph_split(card, in_dir, dev)
        _slice_link(card, in_dir, dev)
        _slice_steady(card, in_dir, work, summary, link_s)
    return launches, windowed


def _slice_link(card: str, in_dir: str, dev) -> None:
    """One 8-file batch of the default job (raw 24-bit PCM in, packed
    payload out) through the graph on the card, then its link in turns
    (pageable, pinned, pinned, pageable; host clock, median of 5, the card
    idle at each start): the upload as a pageable `torch.as_tensor` of the
    numpy batch against `link.upload` of the pinned buffer the scheduler
    builds it in, and the six result tensors as the collector's former
    pageable `.cpu()` each against `link.Download` on a side stream.  Both
    downloads must give the same bytes."""
    import numpy as np
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import codec
    from f9tpu_torch.pipeline import calibration, graph, link

    cfg = ProcessingConfig(output_dir="unused", target_rate=48000)
    blen, bpf = 1 << 22, 6
    xt = link.host_empty((8, blen * bpf), torch.uint8, dev)
    x = xt.numpy()
    x[:] = 0
    valid = np.zeros(8, np.int32)
    for i in range(8):
        data, _ = codec.read_raw_pcm(os.path.join(in_dir, f"take{i}.wav"))
        x[i, :data.size] = data
        valid[i] = data.size // bpf
    seeds = np.arange(1, 9, dtype=np.int32)
    lat = calibration.measure_latency(44100, 48000, device=dev).latency_frames
    res = graph.process_batch_raw(xt, valid, cfg, 44100, seeds, in_channels=2, in_bits=24,
                                  latency_frames=lat, device=dev)
    torch.cuda.synchronize()
    outs = (res.codes, res.out_frames, res.peak_db, res.rms_db, res.noise_floor_db,
            res.tail_terminated)
    side = link.side_stream(dev)

    def host_ms(fn, runs=5):
        ts, out = [], None
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return out, float(np.median(ts))

    x_pageable = np.array(x)        # the numpy batch the scheduler used to build
    legs = {"upload": (lambda: torch.as_tensor(x_pageable, device=dev),
                       lambda: link.upload(xt, dev)),
            "download": (lambda: [t.cpu().numpy() for t in outs],
                         lambda: link.Download(*outs, side=side).get())}
    nbytes = {"upload": x.nbytes, "download": sum(t.numel() * t.element_size() for t in outs)}
    for leg, (pageable, pinned) in legs.items():
        t = {"pageable": [], "pinned": []}
        got = {}
        for key in ("pageable", "pinned", "pinned", "pageable"):
            got[key], ms = host_ms(pageable if key == "pageable" else pinned)
            t[key].append(ms)
        if leg == "download":
            if not all(np.array_equal(a, b) for a, b in zip(got["pageable"], got["pinned"])):
                raise AssertionError("slice link: the pinned download differs from .cpu()")
        elif not torch.equal(got["pageable"], got["pinned"]):
            raise AssertionError("slice link: the pinned upload differs")
        mb = nbytes[leg] / 1e6
        print(f"slice link: {leg} of one 8-file batch ({mb:.1f} MB): pageable "
              f"{t['pageable'][0]:.2f}/{t['pageable'][1]:.2f} ms, pinned"
              f"{' side-stream' if leg == 'download' else ''} {t['pinned'][0]:.2f}/"
              f"{t['pinned'][1]:.2f} ms ({mb / min(t['pinned']):.1f} GB/s against "
              f"{mb / min(t['pageable']):.1f}) [{card}]", flush=True)


def _slice_steady(card: str, in_dir: str, work: str, one: dict, one_link: dict) -> None:
    """The default job on 32 of the slice's takes (each of the 8 files
    under four names: four 8-file batches), beside phase 4's one batch:
    wall, x real time, the collector's blocking time per batch (the
    "device" stage's thread-seconds over its batches) and the dispatch
    thread's (the "dispatch" stage: build, upload, graph enqueue and the
    downloads' start), split by `_dispatch_clock`."""
    from f9tpu_torch import cli

    many = os.path.join(work, "in32")
    os.makedirs(many)
    for k in range(4):
        for i in range(8):
            os.link(os.path.join(in_dir, f"take{i}.wav"), os.path.join(many, f"take{i}_{k}.wav"))
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), _dispatch_clock() as many_link:
        rc = cli.main(["process", many, "--out", os.path.join(work, "out32"), "--rate",
                       "48000", "--json"])
    wall = time.time() - t0
    summary = json.loads(buf.getvalue())
    if rc != 0 or summary["completed"] != 32 or summary["failed"] != 0:
        raise AssertionError(f"slice 4 batches: expected 32 completed, got {summary}")
    for n_batches, s, w, ln in ((1, one, None, one_link), (4, summary, wall, many_link)):
        dev_s = s["throughput"]["device"]["wall_seconds"]
        disp_s = s["throughput"]["dispatch"]["wall_seconds"]
        per = {k: 1e3 * v / n_batches for k, v in ln.items()}
        disp = 1e3 * disp_s / n_batches
        build = disp - per["host_empty"] - per["graph"] - per["download"]
        print(f"slice link: {n_batches} batch(es) of 8 files: collector blocking "
              f"{1e3 * dev_s / n_batches:.1f} ms per batch (device stage {dev_s:.3f} thread-s); "
              f"dispatch thread {disp:.1f} ms per batch: host_empty {per['host_empty']:.1f}, "
              f"batch build {build:.1f}, graph enqueue {per['graph'] - per['upload']:.1f} + "
              f"upload {per['upload']:.1f}, Download {per['download']:.1f} ms"
              + (f"; wall {w:.3f} s, {s['audio_seconds_out'] / w:.1f}x real time"
                 if w else "") + f" [{card}]", flush=True)


def _stereo_ir(rng, rate: int = 48000, seconds: float = 2.5):
    """Exponentially decaying noise, 90 dB down at its end, unit energy per
    channel, behind a 0.5 direct-sound spike (the calibration peak)."""
    import numpy as np

    n = int(seconds * rate)
    tau = seconds / (90.0 / (20.0 * np.log10(np.e)))
    ir = rng.standard_normal((2, n)) * np.exp(-np.arange(n) / (tau * rate))
    ir /= np.sqrt(np.sum(np.square(ir), axis=-1, keepdims=True))
    ir[:, 0] = 0.5
    return ir.astype(np.float32)


def _timed(fn, runs: int = 3):
    """(result of the last run, median CUDA-event ms over ``runs``)."""
    import numpy as np
    import torch

    out, ts = None, []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return out, float(np.median(ts))


def _slice_graph_split(card: str, in_dir: str, dev) -> None:
    """One 8-file batch of the default job on the card, every file in the
    2^22-frame bucket, on device-resident input by CUDA events (median of 3
    after one warm-up): the whole graph, the SRC alone, and the epilogue's
    DC-mean reduction over the graph's output accumulated in float64 (what
    the graph does) beside the float32 reduction it replaced."""
    import numpy as np
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import codec
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops.src_kernel import resample_auto
    from f9tpu_torch.pipeline import calibration, graph

    cfg = ProcessingConfig(output_dir="unused", target_rate=48000)
    blen = 1 << 22
    x = np.zeros((8, 2, blen), np.float32)
    valid = np.zeros(8, np.int32)
    for i in range(8):
        d = codec.read_audio(os.path.join(in_dir, f"take{i}.wav"))[0]
        valid[i] = d.shape[-1]
        x[i, :, :valid[i]] = d
    xd = torch.from_numpy(x).to(dev)
    vd = torch.from_numpy(valid).to(dev)
    seeds = np.arange(1, 9, dtype=np.int32)
    lat = calibration.measure_latency(44100, 48000, device=dev).latency_frames

    def whole():
        return graph.process_batch(xd, vd, cfg, 44100, seeds, latency_frames=lat,
                                   device=dev)
    whole()
    _, t_all = _timed(whole)
    y, t_src = _timed(lambda: resample_auto(xd, design_cycle_bank(44100, 48000)))
    _, t_f64 = _timed(lambda: torch.sum(y, dim=-1, keepdim=True, dtype=torch.float64))
    _, t_f32 = _timed(lambda: torch.sum(y, dim=-1, keepdim=True))
    audio_s = float(valid.sum()) / 44100
    print(f"slice graph: 8 files x 2 ch x 2^22 input frames ({audio_s:.1f} s of source), "
          f"latency {lat}: whole graph {t_all:.2f} ms ({audio_s / (t_all / 1000):.0f}x real "
          f"time), SRC alone {t_src:.3f} ms, the DC sum over {tuple(y.shape)} in float64 "
          f"{t_f64:.3f} ms, in float32 {t_f32:.3f} ms [{card}]", flush=True)


def _loop_graph_split(card: str, in_dir: str, names: list[str], ir_path: str,
                      lat: int, dev) -> None:
    """One 8-file batch of the insert loop on the card, every file in the
    60 s capture bucket, by CUDA events (median of 3 after one warm-up):
    the whole graph, the same graph without the chain on the same capture
    (chain = the difference, rest = no-chain graph - SRC), then SRC, each
    chain stage and the fold / moving-average / UPOLS helpers alone.
    ``lat`` is the calibrated latency."""
    import numpy as np
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import codec
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch import cli
    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops.routing import route_channels
    from f9tpu_torch.ops.src_kernel import resample_auto
    from f9tpu_torch.pipeline import graph

    chain = cli._build_chain(argparse.Namespace(**_chain_args(ir_path)))
    cfg = ProcessingConfig(output_dir="unused", target_rate=48000, reverb_mode=True,
                           channel_routing=[1, 0], chain=chain)
    datas = [codec.read_audio(os.path.join(in_dir, n))[0] for n in names]
    blen = int(60 * 44100)
    x = np.zeros((8, 2, blen), np.float32)
    valid = np.zeros(8, np.int32)
    for i, d in enumerate(datas):
        valid[i] = min(d.shape[-1], blen)
        x[i, :, :valid[i]] = d[:, :valid[i]]
    seeds = np.arange(1, 9, dtype=np.int32)
    xd = torch.from_numpy(x).to(dev)
    vd = torch.from_numpy(valid).to(dev)
    pad = graph._default_pad_frames(cfg, 44100, lat)

    def whole():
        return graph.process_batch(xd, vd, cfg, 44100, seeds, latency_frames=lat,
                                   device=dev)
    whole()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res, t_all = _timed(whole)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg_bare = ProcessingConfig(output_dir="unused", target_rate=48000,
                                reverb_mode=True, channel_routing=[1, 0])
    _, t_bare = _timed(lambda: graph.process_batch(
        xd, vd, cfg_bare, 44100, seeds, latency_frames=lat, pad_frames=pad,
        device=dev))
    xin = torch.nn.functional.pad(route_channels(xd, [1, 0]), (0, pad))
    bank = design_cycle_bank(44100, 48000)
    y, t_src = _timed(lambda: resample_auto(xin, bank))
    audio_s = float(valid.sum()) / 44100
    print(f"loop graph: 8 files x 2 ch, capture {blen} + pad {pad} input frames "
          f"({audio_s:.1f} s of source): whole graph {t_all:.1f} ms "
          f"({audio_s / (t_all / 1000):.0f}x real time), peak device memory "
          f"{peak_gb:.2f} GB, tail_terminated={res.tail_terminated.tolist()} [{card}]",
          flush=True)
    for name, t in (("chain (whole - no-chain graph)", t_all - t_bare),
                    ("SRC cycle_src alone", t_src),
                    ("rest (no-chain graph - SRC: routing, pad, trim, tail "
                     "detection, epilogue, dither)", t_bare - t_src)):
        print(f"loop graph: {name}: {t:.2f} ms ({100.0 * t / t_all:.1f} %) [{card}]",
              flush=True)
    for st in chain.stages:
        y, t = _timed(lambda st=st, y=y: st.apply(y, 48000))
        print(f"loop graph: chain stage {type(st).__name__} alone: {t:.2f} ms "
              f"[{card}]", flush=True)
    y = resample_auto(xin, bank)
    sq = torch.square(y)
    for label, fn in (
            ("_fir_fold 351 taps (8, 2, T)",
             lambda: ch._fir_fold(y, chain.stages[1].impulse_response(48000))),
            ("_uniform_ma_past win 48 (8, 2, T)", lambda: ch._uniform_ma_past(sq, 48)),
            ("_uniform_ma_past win 240 (8, 1, T)",
             lambda: ch._uniform_ma_past(sq[:, :1], 240)),
            ("_fft_convolve_multi 2.5 s stereo IR (upols)",
             lambda: ch._fft_convolve_multi(y, chain.stages[3].ir))):
        _, t = _timed(fn)
        print(f"loop helper: {label}, T={y.shape[-1]}: {t:.2f} ms [{card}]", flush=True)


#: calibration through SRC + chain in a fresh process: CUDA, the SRC kernel
#: and its first launch are warmed first, so the cold call isolates the
#: chain's own first use (cuFFT and the other library kernels it loads)
_COLD_CALIBRATION = """
import argparse, json, sys, time
sys.path.insert(0, {root!r})
import torch
from f9tpu_torch import cli
from f9tpu_torch.ops.resample import resample_rates
from f9tpu_torch.pipeline import calibration
resample_rates(torch.zeros(4096, device="cuda"), 44100, 48000)
torch.cuda.synchronize()
chain = cli._build_chain(argparse.Namespace(**{args!r}))
ring = chain.tail_frames(48000)
cap = max(calibration.CAPTURE_FRAMES, -(-(3 * ring + (1 << 15)) * 44100 // 48000))
out = []
for _ in range(2):
    t0 = time.time()
    cal = calibration.measure_latency(
        44100, 48000, capture_frames=cap, ringout_frames=ring, device="cuda",
        chain_fn=lambda v: chain.apply(resample_rates(v, 44100, 48000), 48000))
    out.append(time.time() - t0)
print(json.dumps({{"cold_s": out[0], "warm_s": out[1], "latency": cal.latency_frames}}))
"""


def _chain_args(ir_path: str) -> dict:
    """The phase-5 chain flags as `cli._build_chain` reads them."""
    return dict(rate=48000, chain_delay_ms=5.0, chain_gate=None,
                chain_eq=["peaking:1000:1:3"], chain_fir=None, chain_comp="-18:3",
                chain_sat=None, chain_width=None, chain_ir=ir_path,
                chain_wet=1.0, chain_dry=0.0, chain_limit="-0.3")


def phase_insert_loop(card: str, work: str, dev) -> tuple[int, int]:
    """The insert-loop job through the port's CLI; returns the kernel
    launches it made and how many of them were the windowed form."""
    import numpy as np

    from f9tpu_torch.io import wav
    from f9tpu_torch import cli

    rng = np.random.default_rng(SEED + 2)
    in_dir = os.path.join(work, "in")
    os.makedirs(in_dir)
    t0 = time.time()
    frames = {}
    for i in range(8):
        n = int(rng.integers(20 * 44100, 40 * 44100))
        frames[f"take{i}.wav"] = n
        wav.write_wav(os.path.join(in_dir, f"take{i}.wav"),
                      _signal(rng, 2, n, 44100), 44100, bits=24)
    ir_path = os.path.join(work, "IR.wav")
    wav.write_wav(ir_path, _stereo_ir(rng), 48000, bits=32)
    print(f"loop: wrote 8 stereo 24-bit 44.1 kHz WAVs of 20-40 s and a stereo "
          f"2.5 s 48 kHz float IR in {time.time() - t0:.1f} s", flush=True)

    out_gpu = os.path.join(work, "out_gpu")
    flags = INSERT_LOOP_FLAGS + ["--chain-ir", ir_path, "--json"]
    buf = io.StringIO()
    _zero_counts()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["process", in_dir, "--out", out_gpu, *flags])
    wall = time.time() - t0
    launches, windowed = _read_counts()
    summary = json.loads(buf.getvalue())
    print(f"loop: cli process rc={rc} completed={summary['completed']} "
          f"failed={summary['failed']} kernel_launches={launches} "
          f"wall={wall:.3f} s audio_out={summary['audio_seconds_out']:.1f} s "
          f"x_realtime={summary['audio_seconds_out'] / wall:.1f} "
          f"(scheduler's own wall {summary['wall_seconds']:.3f} s, "
          f"{summary['x_realtime']:.1f}x) [{card}]", flush=True)
    print("loop: stages " + json.dumps(summary["throughput"]), flush=True)
    if rc != 0 or summary["completed"] != 8 or summary["failed"] != 0:
        raise AssertionError(f"loop: expected 8 completed, got {summary}")
    if launches < 2:     # calibration + at least one batch
        raise AssertionError(f"loop: {launches} kernel launches")
    for name, n in sorted(frames.items()):
        m = summary["per_file"][os.path.join(in_dir, name)]
        n_out = -(-n * 160 // 147)
        print(f"loop: {name} source {n} frames ({n_out} at 48 kHz) -> out "
              f"{m['out_frames']} (+{(m['out_frames'] - n_out) / 48000:.3f} s tail) "
              f"tail_terminated={m['tail_terminated']} peak {m['peak_db']} dB",
              flush=True)
        if not m["tail_terminated"] or m["out_frames"] <= n_out:
            raise AssertionError(f"loop: {name}: tail not terminated past the source")

    names = sorted(frames, key=frames.get)[:2]
    srcs = [os.path.join(in_dir, n) for n in names]
    out_cpu = os.path.join(work, "out_cpu")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["process", *srcs, "--out", out_cpu, *flags,
                       "--batch-size", "2", "--device", "cpu"])
    print(f"loop: CPU path on the 2 shortest files rc={rc} in "
          f"{time.time() - t0:.1f} s", flush=True)
    if rc != 0:
        raise AssertionError(f"loop: CPU run rc={rc}")
    for name in names:
        stem = os.path.splitext(name)[0]
        g_codes, g_rate = _read_codes(os.path.join(out_gpu, f"{stem}_processed.wav"))
        c_codes, c_rate = _read_codes(os.path.join(out_cpu, f"{stem}_processed.wav"))
        same = g_codes.shape == c_codes.shape and g_rate == c_rate == 48000
        diff = np.abs(g_codes - c_codes) if same else None
        print(f"loop: {name} card frames={g_codes.shape[-1]} cpu frames="
              f"{c_codes.shape[-1]} vs_cpu: "
              f"{int((diff != 0).sum()) if same else -1} of {g_codes.size} "
              f"samples differ, max {int(diff.max()) if same else -1} LSB "
              f"(tol {LOOP_LSB_TOL})", flush=True)
        if not same or int(diff.max()) > LOOP_LSB_TOL:
            raise AssertionError(f"loop: {name}: card vs CPU path differ")

    # a file's bytes must not depend on the batch's width: the same 2 files
    # as a 2-file batch on the card, 0 samples apart
    out_gpu2 = os.path.join(work, "out_gpu2")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["process", *srcs, "--out", out_gpu2, *flags, "--batch-size", "2"])
    if rc != 0:
        raise AssertionError(f"loop: 2-file batch on the card rc={rc}")
    for name in names:
        stem = os.path.splitext(name)[0]
        g8, _ = _read_codes(os.path.join(out_gpu, f"{stem}_processed.wav"))
        g2, _ = _read_codes(os.path.join(out_gpu2, f"{stem}_processed.wav"))
        if g8.shape != g2.shape:
            raise AssertionError(f"loop: {name}: batch width changed the frame count")
        d = np.abs(g8 - g2)
        print(f"loop: {name} 2-file batch vs 8-file batch on the card: "
              f"{int((d != 0).sum())} of {d.size} samples differ, max {int(d.max())} LSB "
              f"(must be 0) [{card}]", flush=True)
        if int((d != 0).sum()):
            raise AssertionError(f"loop: {name}: the bytes follow the batch width")

    with open(os.path.join(out_gpu, ".calibration.json")) as f:
        (cal,) = json.load(f).values()
    print(f"loop: calibrated latency {cal['latency_frames']} frames "
          f"(5 ms delay = 240 + limiter lookahead 72), noise floor "
          f"{cal['noise_floor_db']:.1f} dB", flush=True)
    _loop_graph_split(card, in_dir, sorted(frames), ir_path,
                      cal["latency_frames"], dev)
    proc = subprocess.run(
        [sys.executable, "-c", _COLD_CALIBRATION.format(root=ROOT, args=_chain_args(ir_path))],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"loop: cold calibration failed:\n{proc.stderr[-3000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"loop calibration in a fresh process (CUDA and the SRC kernel warm): "
          f"cold {cold['cold_s']:.3f} s, warm {cold['warm_s']:.3f} s, latency "
          f"{cold['latency']} [{card}]", flush=True)
    return launches, windowed


def _write_long_wav(path: str, seconds: float, seed: int, rate: int = 44100) -> int:
    """A stereo 24-bit WAV of two tones plus noise (as `_signal`), written in
    blocks of 2^20 frames so the host never holds the whole file; returns
    its frames."""
    import numpy as np

    from f9tpu_torch.io.wav import WavWriter

    rng = np.random.default_rng(seed)
    f = rng.uniform(80.0, 6000.0, size=(2, 2))
    n = int(seconds * rate)
    with WavWriter(path, 2, rate, bits=24) as w:
        for a in range(0, n, 1 << 20):
            t = (a + np.arange(min(1 << 20, n - a))) / rate
            x = (0.3 * np.sin(2 * np.pi * f[:, :1] * t)
                 + 0.15 * np.sin(2 * np.pi * f[:, 1:] * t + 0.7)
                 + 0.02 * rng.standard_normal((2, t.size)))
            w.append_codes(np.clip(np.round(x * (1 << 23)), -(1 << 23),
                                   (1 << 23) - 1).astype(np.int32))
    return n


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


DENSE_BANKS = [(44100, 48000, "high"), (48000, 44100, "high"),
               (44100, 48000, "ultra"), (176400, 48000, "high")]
VARISPEED_BANKS = [(44100, 44056, "high"), (44056, 44100, "high"),
                   (44100, 44056, "ultra")]


def _stream_kernel_check(card: str, dev, frames: int = 1 << 22, banks=DENSE_BANKS,
                         cycle_counts=(6000, 1777)) -> None:
    """6a / 7b: the kernel on a 2^22-frame stereo signal whole (implicit
    pad) against the same signal cut into haloed chunks
    (`resample_presliced`, pad 0) of two cycle counts: equal bit for bit,
    and every chunk within `TWIN_TOL` of its plain twin (the float64 fold;
    for a varispeed bank the float64 gather)."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import resample as tr
    from f9tpu_torch.ops import src_kernel as sk
    from f9tpu_torch.ops.resample import resample_presliced

    rng = np.random.default_rng(SEED + 6)
    x = torch.from_numpy(_signal(rng, 2, frames, 44100)).to(dev)
    for ri, ro, q in banks:
        bank = design_cycle_bank(ri, ro, quality=q)
        twin = ((lambda sp, n, b=bank: tr._gather_core(sp, b, n * b.L)) if bank.G is None
                else (lambda sp, n, b=bank: tr._presliced_fold(sp, b, n)))
        whole = sk.resample_kernel(x, bank)
        out_len = whole.shape[-1]
        Q = -(-out_len // bank.L)
        # the signal behind its front pad, zero past the end: the file's
        # halos as the stream reads them
        xp = torch.zeros((2, (Q + max(cycle_counts)) * bank.M + bank.W), device=dev)
        xp[:, bank.pad_front:bank.pad_front + frames] = x
        for cycles in cycle_counts:
            outs, twin_err, n0 = [], 0.0, sk.launches
            for q0 in range(0, Q, cycles):
                span = xp[:, q0 * bank.M:q0 * bank.M + (cycles - 1) * bank.M + bank.W]
                y = resample_presliced(span, bank, cycles)
                twin_err = max(twin_err, float((y - twin(span, cycles)).abs().max()))
                outs.append(y)
            got = torch.cat(outs, dim=-1)[:, :out_len]
            torch.cuda.synchronize()
            n_diff = int((got != whole).sum())
            print(f"stream kernel {ri}->{ro} {q}: 2 x {frames} frames whole vs "
                  f"{len(outs)} haloed chunks of {cycles} cycles "
                  f"({sk.launches - n0} launches): {n_diff} of {got.numel()} outputs "
                  f"differ; chunks vs twin max abs {twin_err:.3e} (tol {TWIN_TOL:g}) "
                  f"[{card}]", flush=True)
            if n_diff or not torch.equal(got, whole):
                raise AssertionError(f"stream kernel {ri}->{ro} {q}: presliced "
                                     f"chunks of {cycles} cycles differ from whole")
            if not twin_err <= TWIN_TOL:
                raise AssertionError(f"stream kernel {ri}->{ro} {q}: vs twin {twin_err:.3e}")
        del xp, whole, outs
    del x
    torch.cuda.empty_cache()


def _stream_chunk_split(card: str, ir_path: str, lat: int, dev) -> None:
    """6c: one 20 s chunk of the stream with phase 5's chain, by CUDA events
    (median of 3 after a warm-up): the SRC, each chain stage from its
    initial state, the finish (gain, dither, pack), the pinned copy to the
    host, and the whole step."""
    import numpy as np
    import torch

    from f9tpu_torch import cli
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import dither
    from f9tpu_torch.ops.chain import _ring_stream
    from f9tpu_torch.ops.resample import resample_presliced
    from f9tpu_torch.pipeline import link
    from f9tpu_torch.pipeline import stream as st

    chain = cli._build_chain(argparse.Namespace(**_chain_args(ir_path)))
    cfg = ProcessingConfig(output_dir="unused", target_rate=48000, chain=chain,
                           latency_frames=lat)
    bank = design_cycle_bank(44100, 48000)
    cycles = st._chunk_cycles(bank, cfg, 20.0, 44100)
    span = (cycles - 1) * bank.M + bank.W
    rng = np.random.default_rng(SEED + 7)
    xp = torch.from_numpy(_signal(rng, 2, span, 44100)).to(dev)
    seeds_c = dither.channel_seeds(torch.tensor(12345, device=dev), 2)
    states = chain.stream_init(48000, 2, dev)

    def stage(s, y, state):
        if hasattr(s, "apply_stream"):
            return s.apply_stream(y, state, 48000, 0)[0]
        return _ring_stream(s, y, state, 48000)[0]

    def finish(y):
        return st._finish_chunk(y, None, seeds_c, 0, 1.0, rate_out=48000, bits=24,
                                do_dither=True, wire="pack24")[0]

    def step():
        y = resample_presliced(xp, bank, cycles)
        return st._finish_chunk(y, states, seeds_c, 0, 1.0, rate_out=48000, bits=24,
                                do_dither=True, chain=chain, wire="pack24")[0]

    for fn in (step, step):
        fn()
    torch.cuda.synchronize()
    y, t_src = _timed(lambda: resample_presliced(xp, bank, cycles))
    rows = [("SRC cycle_src (presliced)", t_src)]
    z = y
    for s, state in zip(chain.stages, states):
        z_next, t = _timed(lambda s=s, z=z, state=state: stage(s, z, state))
        rows.append((f"chain stage {type(s).__name__}", t))
        z = z_next
    codes, t_fin = _timed(lambda: finish(z))
    rows.append(("finish (gain, dither, pack24)", t_fin))
    _, t_dl = _timed(lambda: link.Download(codes).get())
    rows.append(("pinned copy to the host", t_dl))
    _, t_all = _timed(step)
    print(f"stream chunk: 20 s chunk = {cycles} cycles, {cycles * bank.L} output frames "
          f"x 2 ch; whole step (SRC + chain + finish) {t_all:.2f} ms "
          f"({cycles * bank.L / 48000 / (t_all / 1000):.0f}x real time) [{card}]", flush=True)
    for label, t in rows:
        print(f"stream chunk: {label}: {t:.2f} ms ({100.0 * t / t_all:.1f} % of the "
              f"step) [{card}]", flush=True)


def _stream_busy_share(card: str, run, wall: float) -> None:
    """The device's busy share of one stream: the summed duration of every
    kernel and copy `torch.profiler` saw on the card during ``run``, over
    ``wall``, the same run's wall time without the profiler (which slows
    the host several times over, not the device)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rc = run()[0]
        torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"stream: profiled run rc={rc}")
    by_name = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    if busy <= 0:
        print(f"stream profile: device busy share not measured (the profiler saw no "
              f"device time) [{card}]", flush=True)
        return
    print(f"stream profile: 120 s with chain at 20 s chunks: device busy {busy:.3f} s "
          f"(kernels and copies, torch.profiler) of {wall:.3f} s wall unprofiled: "
          f"{100.0 * busy / wall:.1f} % busy, {100.0 - 100.0 * busy / wall:.1f} % idle "
          f"[{card}]", flush=True)
    for name, us in by_name.most_common(6):
        print(f"stream profile: {name[:80]}: {us / 1e3:.2f} ms", flush=True)


def _cli_json(argv: list[str]) -> tuple[int, dict, float]:
    """(rc, the --json summary, wall seconds) of one in-process CLI run."""
    from f9tpu_torch import cli

    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    wall = time.time() - t0
    return rc, (json.loads(buf.getvalue()) if rc == 0 else {}), wall


def phase_stream(card: str, work: str, dev) -> tuple[int, int]:
    """The streaming path (phase 6); returns the kernel launches of the
    stream path's run, `cli stream` with the chain at 20 s chunks, counted
    from zero, and how many of them were the windowed form."""
    import numpy as np
    import torch

    from f9tpu_torch import cli
    from f9tpu_torch.io import wav
    from f9tpu_torch.models import resample_oracle
    from f9tpu_torch.ops import src_kernel as sk
    from f9tpu_torch.ops.resample import resample_rates
    from f9tpu_torch.pipeline import calibration
    from f9tpu_torch.tools import hw_soak

    t0 = time.time()
    _stream_kernel_check(card, dev)
    print(f"stream 6a: {time.time() - t0:.1f} s", flush=True)

    # ---- 6b: the scheduler's oversized-file route
    t0 = time.time()
    in_dir = os.path.join(work, "in")
    os.makedirs(in_dir)
    long_path = os.path.join(in_dir, "long.wav")
    n_long = _write_long_wav(long_path, 600.0, SEED + 8)
    for i in range(2):
        _write_long_wav(os.path.join(in_dir, f"short{i}.wav"), 30.0, SEED + 9 + i)
    print(f"stream: wrote a 600 s and two 30 s stereo 24-bit 44.1 kHz WAVs "
          f"({os.path.getsize(long_path) / 1e6:.0f} MB long) in {time.time() - t0:.1f} s",
          flush=True)
    t0 = time.time()
    sk.launches = 0
    rc, summary, wall = _cli_json(["process", in_dir, "--out", os.path.join(work, "out_b"),
                                   "--rate", "48000", "--json"])
    launches_b = sk.launches
    m_long = summary.get("per_file", {}).get(long_path, {})
    print(f"stream 6b: cli process rc={rc} completed={summary.get('completed')} "
          f"failed={summary.get('failed')} long.wav {n_long} frames streamed="
          f"{m_long.get('streamed')} out_frames={m_long.get('out_frames')} "
          f"kernel_launches={launches_b} wall={wall:.3f} s audio_out="
          f"{summary.get('audio_seconds_out', 0):.1f} s x_realtime="
          f"{summary.get('audio_seconds_out', 0) / wall:.1f} [{card}]", flush=True)
    print("stream 6b: stages " + json.dumps(summary.get("throughput")), flush=True)
    if rc != 0 or summary["completed"] != 3 or summary["failed"] != 0:
        raise AssertionError(f"stream 6b: expected 3 completed, got {summary}")
    if m_long.get("streamed") is not True or m_long["out_frames"] != -(-n_long * 160 // 147):
        raise AssertionError(f"stream 6b: long file not streamed whole: {m_long}")
    if launches_b < n_long // 882000 + 2:
        raise AssertionError(f"stream 6b: {launches_b} kernel launches")
    print(f"stream 6b: {time.time() - t0:.1f} s", flush=True)

    # ---- 6c: cli stream with the insert chain at two chunk sizes
    t0 = time.time()
    rng = np.random.default_rng(SEED + 2)
    ir_path = os.path.join(work, "IR.wav")
    wav.write_wav(ir_path, _stereo_ir(rng), 48000, bits=32)
    chain = cli._build_chain(argparse.Namespace(**_chain_args(ir_path)))
    ring = chain.tail_frames(48000)
    cal = calibration.measure_latency(
        44100, 48000, chain_fn=lambda v: chain.apply(resample_rates(v, 44100, 48000), 48000),
        capture_frames=max(calibration.CAPTURE_FRAMES,
                           -(-(3 * ring + (1 << 15)) * 44100 // 48000)),
        ringout_frames=ring, device=dev)
    lat = cal.latency_frames
    chain_flags = ["--rate", "48000", "--chain-delay-ms", "5", "--chain-eq",
                   "peaking:1000:1:3", "--chain-comp=-18:3", "--chain-ir", ir_path,
                   "--chain-limit=-0.3", "--latency", str(lat), "--json"]
    shas, launches_c, windowed_c = {}, 0, 0
    for cs in ("20", "7.3"):
        out = os.path.join(work, f"long_{cs}.wav")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        rc, res, wall = _cli_json(["stream", long_path, "--out", out, *chain_flags,
                                   "--chunk-seconds", cs])
        if cs == "20":
            launches_c, windowed_c = _read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        shas[cs] = _sha256(out)
        print(f"stream 6c: cli stream 600 s with chain, latency {lat}, chunk {cs} s: "
              f"rc={rc} out_frames={res.get('out_frames')} wall={wall:.3f} s "
              f"x_realtime={res.get('seconds', 0) / wall:.1f} peak device memory "
              f"{peak:.3f} GB kernel_launches={sk.launches} sha256={shas[cs][:16]} "
              f"[{card}]", flush=True)
        if rc != 0 or res["out_frames"] != -(-n_long * 160 // 147):
            raise AssertionError(f"stream 6c: chunk {cs}: rc={rc} {res}")
    if shas["20"] != shas["7.3"]:
        raise AssertionError("stream 6c: bytes depend on the chunk size")
    if launches_c < 1:
        raise AssertionError("stream 6c: the stream launched no kernel")
    two_min = os.path.join(work, "two_min.wav")
    _write_long_wav(two_min, 120.0, SEED + 11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc, res, wall = _cli_json(["stream", two_min, "--out", os.path.join(work, "two_out.wav"),
                               *chain_flags, "--chunk-seconds", "20"])
    print(f"stream 6c: cli stream 120 s with chain, chunk 20 s: rc={rc} wall={wall:.3f} s "
          f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
          f"[{card}]", flush=True)
    if rc != 0:
        raise AssertionError(f"stream 6c: 2-minute file rc={rc}")
    _stream_busy_share(card, lambda: _cli_json(
        ["stream", two_min, "--out", os.path.join(work, "two_prof.wav"), *chain_flags,
         "--chunk-seconds", "20"]), wall)
    _stream_chunk_split(card, ir_path, lat, dev)
    print(f"stream 6c: {time.time() - t0:.1f} s", flush=True)

    # ---- 6d: reverb mode streamed on a 5-minute file
    t0 = time.time()
    five = os.path.join(work, "five.wav")
    n_five = _write_long_wav(five, 300.0, SEED + 12)
    src_out = -(-n_five * 160 // 147)
    rev = {}
    for cs in ("20", "7.3"):
        out = os.path.join(work, f"five_{cs}.wav")
        rc, res, wall = _cli_json(["stream", five, "--out", out, *chain_flags, "--reverb",
                                   "--chunk-seconds", cs])
        rev[cs] = (_sha256(out), res.get("out_frames"))
        print(f"stream 6d: cli stream --reverb 300 s, chunk {cs} s: rc={rc} out_frames="
              f"{res.get('out_frames')} (source {src_out}, tail "
              f"{(res.get('out_frames', 0) - src_out) / 48000:.3f} s) wall={wall:.3f} s "
              f"sha256={rev[cs][0][:16]} [{card}]", flush=True)
        if rc != 0 or not src_out < res["out_frames"] < src_out + 60 * 48000:
            raise AssertionError(f"stream 6d: tail not detected past the source: {res}")
    if rev["20"] != rev["7.3"]:
        raise AssertionError("stream 6d: reverb bytes depend on the chunk size")
    print(f"stream 6d: {time.time() - t0:.1f} s", flush=True)

    # ---- 6e: the card against the port's CPU path, 30 s at 4 s chunks
    t0 = time.time()
    short = os.path.join(in_dir, "short0.wav")
    x_in, _ = wav.read_wav(short)
    for label, flags, tol in (("no chain", ["--rate", "48000", "--json"], LSB_TOL),
                              ("chain", chain_flags, LOOP_LSB_TOL)):
        got = {}
        for d in ("cuda", "cpu"):
            out = os.path.join(work, f"e_{d}_{label.replace(' ', '_')}.wav")
            rc, _res, wall = _cli_json(["stream", short, "--out", out, *flags,
                                        "--chunk-seconds", "4", "--device", d])
            if rc != 0:
                raise AssertionError(f"stream 6e: {label} on {d}: rc={rc}")
            got[d] = _read_codes(out)[0]
        same = got["cuda"].shape == got["cpu"].shape
        diff = np.abs(got["cuda"] - got["cpu"]) if same else None
        msg = (f"stream 6e: 30 s {label}, card vs CPU: "
               f"{int((diff != 0).sum()) if same else -1} of {got['cuda'].size} samples "
               f"differ, max {int(diff.max()) if same else -1} LSB (tol {tol})")
        if label == "no chain":
            ref = resample_oracle(x_in, 44100, 48000, quality="high")
            ref = ref - ref.mean(axis=-1, keepdims=True)
            y = got["cuda"] / float(1 << 23)
            db = _db(y - y.mean(axis=-1, keepdims=True) - ref, ref) if same else 0.0
            msg += f"; oracle {db:.1f} dB (max {ORACLE_DB_MAX:g})"
            if not db <= ORACLE_DB_MAX:
                raise AssertionError(f"stream 6e: {db:.1f} dB vs oracle")
        print(msg + f" [{card}]", flush=True)
        if not same or int(diff.max()) > tol:
            raise AssertionError(f"stream 6e: {label}: card vs CPU path differ")
    print(f"stream 6e: {time.time() - t0:.1f} s", flush=True)

    # ---- 6f: the soak on the card
    t0 = time.time()
    if hw_soak.main(["--seed", str(SEED % 100000), "--chain-trials", "3",
                     "--stream-trials", "3", "--device", "cuda"]) != 0:
        raise AssertionError("stream 6f: hw_soak failed")
    print(f"stream 6f: {time.time() - t0:.1f} s", flush=True)
    return launches_c, windowed_c


#: sha256[:16] of the windowed form's output on 7a's seeded signal, per bank,
#: as its first design (one window per row and tile, 4-byte copies) wrote
#: it: tile groups and bulk copies keep every output's summation order, so
#: its bytes too.
#: `python3 chip_smoke.py --windowed-digests` prints them for a checkout.
WINDOWED_DIGESTS = {
    (44100, 44056, "high"): "655bbac27c013816",
    (44056, 44100, "high"): "69e89177a6f01f0d",
    (44100, 44056, "ultra"): "619c9645cad39057",
}


def _digest(y) -> str:
    return hashlib.sha256(y.contiguous().cpu().numpy().tobytes()).hexdigest()[:16]


def _windowed_signal(ri: int, dev):
    """7a's seeded input: 32 signals x 2^20 frames at ``ri``."""
    import numpy as np
    import torch

    x_np = _signal(np.random.default_rng(SEED + 70), 32, 1 << 20, ri)
    return x_np, torch.from_numpy(x_np).to(dev)


def windowed_digests(dev) -> dict:
    """`_digest` of the windowed form's output on 7a's signal, per bank."""
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import src_kernel as sk

    out = {}
    for ri, ro, q in VARISPEED_BANKS:
        _, x = _windowed_signal(ri, dev)
        out[f"{ri}:{ro}:{q}"] = _digest(sk.resample_kernel(x, design_cycle_bank(ri, ro, quality=q)))
    return out


#: cycles of one varispeed stream launch at 20 s and 7.3 s chunks
STREAM_CHUNK_CYCLES = (80, 29)


def windowed_chunk_ms(dev) -> dict:
    """Device ms of one presliced windowed launch at the stream's chunk
    shapes (2 haloed signals of 80 and 29 cycles), per bank: 20 launches
    queued behind a device sleep between two CUDA events, so the host's
    launch cost does not count; median of 5.  Uses only what every
    checkout since the windowed form has, so `--chunk-times` reads a
    parent tree too."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import src_kernel as sk

    out = {}
    for ri, ro, q in VARISPEED_BANKS:
        bank = design_cycle_bank(ri, ro, quality=q)
        for cycles in STREAM_CHUNK_CYCLES:
            x = torch.from_numpy(_signal(np.random.default_rng(SEED + 72), 2,
                                         (cycles - 1) * bank.M + bank.W, ri)).to(dev)
            sk.resample_presliced_kernel(x, bank, cycles)
            torch.cuda.synchronize()
            ts = []
            for _ in range(5):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(20_000_000)
                a.record()
                for _ in range(20):
                    sk.resample_presliced_kernel(x, bank, cycles)
                b.record()
                torch.cuda.synchronize()
                ts.append(a.elapsed_time(b) / 20)
            out[f"{ri}:{ro}:{q}:{cycles}"] = float(np.median(ts))
    return out


def _windowed_chunk_check(card: str, dev) -> None:
    """7b: `windowed_chunk_ms` with the group and grid `_win_launch` gives
    each shape (a launch of few rows takes a smaller group), and the blocks
    per SM the card reports for it beside `_win_launch`'s count."""
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import _build
    from f9tpu_torch.ops import src_kernel as sk

    lib = _build.load_library()
    for key, ms in windowed_chunk_ms(dev).items():
        ri, ro, q, cycles = key.split(":")
        bank = design_cycle_bank(int(ri), int(ro), quality=q)
        plan = sk.kernel_plan(bank)
        n_rows = 2 * int(cycles)
        warps, _, group, pitch, smem = sk._win_launch(plan, n_rows, sk._sm_count(dev))
        blocks = -(-n_rows // (16 * warps)) * -(-len(plan.bands) // group)
        per_sm = lib.f9_cycle_src_win_blocks_per_sm(plan.nt, warps, smem)
        print(f"stream kernel {ri}->{ro} {q}: one presliced launch of 2 x {cycles} cycles: "
              f"{ms:.4f} ms (device, mean of 20 queued, median of 5); group={group} "
              f"(plan {plan.group}) warps={warps} pitch={pitch} smem={smem} B, {blocks} "
              f"blocks on {sk._sm_count(dev)} SMs at {per_sm} blocks/SM (counted "
              f"{sk._win_blocks_per_sm(smem)}) [{card}]", flush=True)


def phase_windowed_kernel(card: str, dev) -> dict:
    """7a: the kernel's windowed form on three varispeed banks against its
    plain twin (the float64 gather) and the float64 oracle, timed beside the
    twin and the library form: the JAX package's banded evaluation, one fp32
    `torch.matmul` per 128-output segment of the marshalled cycle rows
    (TF32 off; the port never calls it).  Returns the first bank's numbers
    (and every bank's under ``per_bank``)."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank, resample_oracle
    from f9tpu_torch.ops import _build
    from f9tpu_torch.ops import resample as tr
    from f9tpu_torch.ops import src_kernel as sk

    n_sig, frames = 32, 1 << 20
    lib = _build.load_library()
    per_bank = []
    for ri, ro, q in VARISPEED_BANKS:
        x_np, x = _windowed_signal(ri, dev)
        bank = design_cycle_bank(ri, ro, quality=q)
        if bank.G is not None or not sk.kernel_applicable(bank):
            raise AssertionError(f"{ri}->{ro} {q}: not a varispeed bank the kernel takes")
        plan = sk.kernel_plan(bank)
        n0, w0 = sk.launches, sk.launches_windowed
        y = sk.resample_kernel(x, bank)
        torch.cuda.synchronize()
        if (sk.launches, sk.launches_windowed) != (n0 + 1, w0 + 1):
            raise AssertionError(f"{ri}->{ro} {q}: launch counters did not move")
        out_len = y.shape[-1]
        Q = -(-out_len // bank.L)

        def twin():
            return tr.resample_gather(x, bank)

        # the library form's operands, marshalled outside the timed window
        in0, w, seg, w_rows, G = tr._banded_plan(bank)
        xp = torch.zeros((n_sig, (Q - 1) * bank.M + w_rows), device=dev)
        keep = min(frames, xp.shape[-1] - bank.pad_front)
        xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
        rows = xp.unfold(-1, w_rows, bank.M).contiguous()        # (n_sig, Q, w_rows)
        gs = torch.from_numpy(G).to(dev)
        S, L = len(in0), bank.L
        del xp

        def library():
            ys = [torch.matmul(rows[..., a:a + w], gs[i]) for i, a in enumerate(in0)]
            ys[-1] = ys[-1][..., S * seg - L:]
            return torch.cat(ys, dim=-1)

        yt = twin()
        err = float((y - yt).abs().max())
        lsb = (y.double() - yt.double()) * float(1 << 23)
        lsb_rms, lsb_max = float(lsb.square().mean().sqrt()), float(lsb.abs().max())
        lib_err = float((library().reshape(n_sig, -1)[:, :out_len] - yt).abs().max())
        del yt, lsb
        small = x_np[:2, :1 << 16]
        yk = sk.resample_kernel(torch.from_numpy(small).to(dev), bank).cpu().numpy()
        ref = resample_oracle(small, ri, ro, quality=q)
        db = _db(yk - ref, ref)
        for _ in range(3):
            sk.resample_kernel(x, bank)
            library()
        twin()
        torch.cuda.synchronize()
        # kernel, plain, library, library, plain, kernel (the twin's 130-200
        # float64 passes take ~0.1 s a call: median of 3)
        t = {"ms": [], "plain_ms": [], "library_ms": []}
        for key, fn, runs in (("ms", lambda: sk.resample_kernel(x, bank), 10),
                              ("plain_ms", twin, 3), ("library_ms", library, 10),
                              ("library_ms", library, 10), ("plain_ms", twin, 3),
                              ("ms", lambda: sk.resample_kernel(x, bank), 10)):
            t[key].append(_median_ms(fn, runs))
        bound_ms, bound_by = _src_bound(bank, n_sig, frames, out_len)
        blocks = lib.f9_cycle_src_win_blocks_per_sm(plan.nt, plan.warps, plan.smem_bytes)
        packed_mb = sk.packed_bank_f32(bank)[0].nbytes / 1e6
        moved = sk.window_traffic(bank, n_sig, frames, sk._sm_count(dev))
        digest = _digest(y)
        print(f"windowed kernel {ri}->{ro} {q} (L={L} M={bank.M} W={bank.W} "
              f"K={bank.taps_per_phase}; plan nt={plan.nt} group={moved['group']} "
              f"warps={moved['warps']} pitch={plan.pitch} tiles={len(plan.bands)} "
              f"smem={plan.smem_bytes} B, {blocks} blocks/SM, packed bank {packed_mb:.1f} MB; "
              f"{n_sig * Q} rows; L2 -> shared counted from the plan, not measured: windows "
              f"{moved['windows']:.1f} MB, band {moved['band']:.1f} MB) "
              f"{n_sig}x2^20: sha256 {digest} (first design {WINDOWED_DIGESTS[(ri, ro, q)]}) "
              f"max_abs_vs_twin={err:.3e} (tol {TWIN_TOL:g}) "
              f"vs_twin_24bit_lsb rms={lsb_rms:.4f} max={lsb_max:.3f} "
              f"oracle={db:.1f} dB (max {ORACLE_DB_MAX:g}) library_vs_twin={lib_err:.3e} "
              f"kernel_ms={t['ms'][0]:.4f}/{t['ms'][1]:.4f} "
              f"plain_ms={t['plain_ms'][0]:.3f}/{t['plain_ms'][1]:.3f} "
              f"library_ms ({S} matmuls)={t['library_ms'][0]:.4f}/{t['library_ms'][1]:.4f} "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"(median of 10, the twin of 3, two turns) [{card}]", flush=True)
        if not err <= TWIN_TOL:
            raise AssertionError(f"{ri}->{ro} {q}: windowed kernel vs twin {err:.3e}")
        if not db <= ORACLE_DB_MAX:
            raise AssertionError(f"{ri}->{ro} {q}: {db:.1f} dB vs oracle")
        if digest != WINDOWED_DIGESTS[(ri, ro, q)]:
            raise AssertionError(f"{ri}->{ro} {q}: output bytes differ from the first design's")
        per_bank.append({"bank": f"{ri}->{ro} {q}", "max_abs_err": err, "lsb_rms": lsb_rms,
                         "lsb_max": lsb_max, "oracle_db": db, "ms": min(t["ms"]),
                         "plain_ms": min(t["plain_ms"]),
                         "library_ms": min(t["library_ms"]), "bound_ms": bound_ms,
                         "bound_by": bound_by})
        del x, y, rows, gs
        torch.cuda.empty_cache()
    summary = dict(per_bank[0])
    summary["per_bank"] = per_bank
    return summary


def _stream_two_chunk_sizes(card: str, tag: str, src: str, work: str, flags: list[str],
                            n_expect: int) -> None:
    """`cli stream` on ``src`` at 20 s and 7.3 s chunks: identical sha256,
    the expected frame count, wall, x real time and peak device memory."""
    import torch

    from f9tpu_torch.ops import src_kernel as sk

    shas = {}
    for cs in ("20", "7.3"):
        out = os.path.join(work, f"{tag.replace(' ', '_')}_{cs}.wav")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sk.launches = 0
        rc, res, wall = _cli_json(["stream", src, "--out", out, *flags, "--json",
                                   "--chunk-seconds", cs])
        peak = torch.cuda.max_memory_allocated() / 1e9
        shas[cs] = _sha256(out) if rc == 0 else ""
        print(f"{tag}: cli stream {' '.join(flags)}, chunk {cs} s: rc={rc} out_frames="
              f"{res.get('out_frames')} wall={wall:.3f} s x_realtime="
              f"{res.get('seconds', 0) / wall:.1f} peak device memory {peak:.3f} GB "
              f"kernel_launches={sk.launches} sha256={shas[cs][:16]} [{card}]", flush=True)
        if rc != 0 or res["out_frames"] != n_expect or sk.launches < 1:
            raise AssertionError(f"{tag}: chunk {cs}: rc={rc} {res}")
    if shas["20"] != shas["7.3"]:
        raise AssertionError(f"{tag}: bytes depend on the chunk size")


def phase_varispeed(card: str, work: str, dev) -> tuple[int, int]:
    """7b and 7c: the windowed form's invariance, then the varispeed job
    (`cli process --rate 44056`) and stream; returns the job's launches and
    how many of them were the windowed form."""
    import torch

    from f9tpu_torch.ops import src_kernel as sk

    t0 = time.time()
    _stream_kernel_check(card, dev, banks=VARISPEED_BANKS, cycle_counts=(100, 37, 29))
    _windowed_chunk_check(card, dev)
    print(f"varispeed 7b: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    launches, windowed = phase_slice(card, os.path.join(work, "job"), rate=44056,
                                     tag="varispeed 7c", oracle_files=1)
    print(f"varispeed 7c: cli process: {launches} kernel launches, "
          f"{windowed} of them the windowed form [{card}]", flush=True)
    if windowed != launches:
        raise AssertionError("varispeed 7c: a launch of the job was not the windowed form")
    print(f"varispeed 7c (process): {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    # only the streamed bank's device copies count towards the stream's peak
    # memory: drop those the phases before left cached on the card
    from f9tpu_torch.ops import resample as tr

    for cache in (sk._device_bank, sk._stacked_bank_f64, tr.bank_to_torch,
                  tr._phase_bank_f64, tr._bank_f64):
        cache.cache_clear()
    torch.cuda.empty_cache()
    long_path = os.path.join(work, "long.wav")
    n_long = _write_long_wav(long_path, 600.0, SEED + 71)
    _stream_two_chunk_sizes(card, "varispeed 7c", long_path, work, ["--rate", "44056"],
                            -(-n_long * 44056 // 44100))
    print(f"varispeed 7c (stream): {time.time() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()
    return launches, windowed


NORMALIZE_FLAGS = ["--rate", "48000", "--normalize-lufs=-16", "--normalize-tp=-1"]


def _meter_split(card: str, path: str, dev) -> None:
    """One file's normalization meter by CUDA events (median of 3 after a
    warm-up), summed over its 20 s chunks: the SRC to 48 kHz, the
    K-weighting, the hop energies and the 4x true-peak fold, beside the
    whole `meter_source_streamed` call (host reads and uploads included)."""
    import torch

    from f9tpu_torch.io import codec
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import loudness as ld
    from f9tpu_torch.ops.resample import resample_presliced

    x, rate = codec.read_audio(path)
    C, T = x.shape
    ctx = int(ld.k_weighting_ir().shape[0]) - 1
    chunk_in, cycles, bank = ld._meter_chunk_plan(rate, 20.0, ctx)
    tp_bank = design_cycle_bank(rate, rate * 4, quality="high")
    h_l, h_r = ld._halos(bank)
    th_l, th_r = ld._halos(tp_bank)
    read = ld.array_reader(x)
    t = {"SRC to 48 kHz (cycle_src, presliced)": 0.0, "K-weighting (UPOLS)": 0.0,
         "hop energies": 0.0, "4x true-peak fold (float64, L=4)": 0.0}
    n_chunks = 0
    for start in range(0, T, chunk_in):
        xp = torch.from_numpy(ld._read_span(read, C, T, start - h_l,
                                            h_l + chunk_in + h_r)).to(dev)
        xtp = torch.from_numpy(ld._read_span(read, C, T, start - th_l,
                                             th_l + chunk_in + th_r)).to(dev)
        carry = torch.zeros((C, ctx), device=dev)
        for fn in (lambda: resample_presliced(xp, bank, cycles),
                   lambda: ld._tp_step(xtp, cycles=chunk_in, rate_in=rate, oversample=4)):
            fn()
        y, ms = _timed(lambda: resample_presliced(xp, bank, cycles))
        t["SRC to 48 kHz (cycle_src, presliced)"] += ms
        z = torch.cat([carry, y], dim=-1)
        kw, ms = _timed(lambda: ld.k_weight(z))
        t["K-weighting (UPOLS)"] += ms
        _, ms = _timed(lambda: torch.sum(torch.square(kw[:, ctx:]).reshape(C, -1, ld._HOP),
                                         dim=-1))
        t["hop energies"] += ms
        _, ms = _timed(lambda: ld._tp_step(xtp, cycles=chunk_in, rate_in=rate, oversample=4))
        t["4x true-peak fold (float64, L=4)"] += ms
        n_chunks += 1
    t0 = time.time()
    m = ld.meter_source_streamed(read, C, T, rate, want_tp=True, device=dev)
    wall = time.time() - t0
    print(f"normalize meter: {os.path.basename(path)} {T / rate:.1f} s x {C} ch in "
          f"{n_chunks} chunks of {chunk_in} frames: meter_source_streamed {1e3 * wall:.1f} ms "
          f"wall ({m['lufs']:.2f} LUFS, {m['true_peak_db']:.2f} dBTP) [{card}]", flush=True)
    for label, ms in t.items():
        print(f"normalize meter: {label}: {ms:.2f} ms over {n_chunks} chunks "
              f"({ms / n_chunks:.2f} ms per 20 s chunk) [{card}]", flush=True)


def phase_normalize(card: str, work: str, dev) -> tuple[int, int]:
    """7d: loudness normalization through `cli process`, `cli stream` and
    `cli probe`; returns the batch job's kernel launches and how many of
    them were the windowed form."""
    import numpy as np
    import torch

    from f9tpu_torch.io import codec, wav
    from f9tpu_torch.ops import loudness as ld

    rng = np.random.default_rng(SEED + 72)
    in_dir = os.path.join(work, "in")
    os.makedirs(in_dir)
    t0 = time.time()
    levels_db = np.linspace(0.0, -20.0, 8)
    for i in range(8):
        frames = int(rng.integers(50 * 44100, 60 * 44100))
        x = _signal(rng, 2, frames, 44100) * np.float32(10.0 ** (levels_db[i] / 20.0))
        if i == 6:
            # a quiet file with a click every half second: its gain would
            # lift the clicks past the -1 dBTP ceiling, so the cap engages
            x[:, ::22050] = 0.6
        wav.write_wav(os.path.join(in_dir, f"take{i}.wav"), x, 44100, bits=24)
    print(f"normalize: wrote 8 stereo 24-bit 44.1 kHz WAVs of 50-60 s, levels 0 to "
          f"-20 dB of the -12 dBFS signal, take6 with 0.6 clicks, in "
          f"{time.time() - t0:.1f} s", flush=True)

    out_gpu = os.path.join(work, "out_gpu")
    _zero_counts()
    rc, out, log, wall = _run_cli(["process", in_dir, "--out", out_gpu, *NORMALIZE_FLAGS,
                                   "--json"])
    launches, windowed = _read_counts()
    summary = json.loads(out) if rc == 0 else {}
    print(f"normalize: cli process {' '.join(NORMALIZE_FLAGS)} rc={rc} completed="
          f"{summary.get('completed')} failed={summary.get('failed')} kernel_launches="
          f"{launches} wall={wall:.3f} s audio_out={summary.get('audio_seconds_out', 0):.1f} s "
          f"x_realtime={summary.get('audio_seconds_out', 0) / wall:.1f} [{card}]", flush=True)
    print("normalize: stages " + json.dumps(summary.get("throughput")), flush=True)
    if rc != 0 or summary["completed"] != 8 or summary["failed"] != 0:
        raise AssertionError(f"normalize: expected 8 completed, got {summary}\n{log[-2000:]}")
    if launches < 2 + 8 * 3:     # calibration, a batch, three meter chunks per file
        raise AssertionError(f"normalize: {launches} kernel launches")
    # "[timestamp] Normalize: take3.wav -21.5 LUFS -> -16.0 (+5.5 dB...)"
    notes = {line.split("Normalize: ")[1].split()[0]: line for line in log.splitlines()
             if "Normalize: " in line}
    n_capped = 0
    for i in range(8):
        name = f"take{i}.wav"
        m = summary["per_file"][os.path.join(in_dir, name)]
        y, r = wav.read_wav(os.path.join(out_gpu, f"take{i}_processed.wav"))
        got = float(ld.integrated_lufs(y, r, device=dev))
        limited = "capped" in notes[name] or "clamped" in notes[name]
        n_capped += limited
        print(f"normalize: {name} source {m['source_lufs']} LUFS, gain "
              f"{m['applied_gain_db']:+} dB -> output {got:.2f} LUFS"
              f"{' (' + notes[name].split('(')[-1] if limited else ''}", flush=True)
        if not limited and not abs(got + 16.0) <= 0.1:
            raise AssertionError(f"normalize: {name}: output {got:.2f} LUFS, target -16")
        if limited and not got < -16.0:
            raise AssertionError(f"normalize: {name}: limited but at {got:.2f} LUFS")
    if n_capped < 1:
        raise AssertionError("normalize: the dBTP cap engaged on no file")

    # the meter's share of the job: the same files without normalization
    # (raw upload, no meter), and the normalized job again with one decode
    # worker, so that a single thread makes the meter's launches
    rc, out, _log, wall_plain = _run_cli(["process", in_dir, "--out",
                                          os.path.join(work, "out_plain"),
                                          "--rate", "48000", "--json"])
    if rc != 0:
        raise AssertionError(f"normalize: the job without normalization rc={rc}")
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.pipeline.scheduler import BatchProcessor

    cfg1 = ProcessingConfig(output_dir=os.path.join(work, "out_one"), target_rate=48000,
                            normalize_lufs=-16.0, normalize_tp_db=-1.0, seed=0)
    t1 = time.time()
    res1 = BatchProcessor(cfg1, decode_workers=1, device=dev).run(
        sorted(os.path.join(in_dir, n) for n in os.listdir(in_dir)))
    wall_one = time.time() - t1
    print(f"normalize: the same 8 files without normalization {wall_plain:.3f} s, "
          f"normalized {wall:.3f} s with 4 decode workers (the meter and the float upload: "
          f"{100.0 * (1.0 - wall_plain / wall):.1f} % of the wall) and {wall_one:.3f} s with "
          f"1 decode worker ({res1.completed} completed) [{card}]", flush=True)
    if res1.completed != 8:
        raise AssertionError(f"normalize: one decode worker: {res1}")
    same = all(
        _sha256(os.path.join(out_gpu, f"take{i}_processed.wav"))
        == _sha256(os.path.join(work, "out_one", f"take{i}_processed.wav")) for i in range(8))
    print(f"normalize: outputs of the 4-worker and the 1-worker job identical: {same}",
          flush=True)
    if not same:
        raise AssertionError("normalize: the bytes depend on the decode workers")

    # the card against the port's CPU path: the loudest file and the capped one
    names = ["take0.wav", "take6.wav"]
    srcs = [os.path.join(in_dir, n) for n in names]
    out_cpu = os.path.join(work, "out_cpu")
    rc, out, log_c, wall_c = _run_cli(["process", *srcs, "--out", out_cpu, *NORMALIZE_FLAGS,
                                       "--batch-size", "2", "--device", "cpu", "--json"])
    if rc != 0:
        raise AssertionError(f"normalize: CPU run rc={rc}\n{log_c[-2000:]}")
    cpu = json.loads(out)["per_file"]
    print(f"normalize: CPU path on 2 files in {wall_c:.1f} s", flush=True)
    for src, name in zip(srcs, names):
        stem = os.path.splitext(name)[0]
        mg, mc = summary["per_file"][src], cpu[src]
        g_codes, _ = _read_codes(os.path.join(out_gpu, f"{stem}_processed.wav"))
        c_codes, _ = _read_codes(os.path.join(out_cpu, f"{stem}_processed.wav"))
        same = g_codes.shape == c_codes.shape
        diff = np.abs(g_codes - c_codes) if same else None
        print(f"normalize: {name} card {mg['source_lufs']} LUFS {mg['applied_gain_db']:+} dB, "
              f"CPU {mc['source_lufs']} LUFS {mc['applied_gain_db']:+} dB; vs_cpu: "
              f"{int((diff != 0).sum()) if same else -1} of {g_codes.size} samples differ, "
              f"max {int(diff.max()) if same else -1} LSB (tol {LSB_TOL}) [{card}]", flush=True)
        if (abs(mg["source_lufs"] - mc["source_lufs"]) > 0.011
                or abs(mg["applied_gain_db"] - mc["applied_gain_db"]) > 0.011):
            raise AssertionError(f"normalize: {name}: card and CPU meters differ")
        if not same or int(diff.max()) > LSB_TOL:
            raise AssertionError(f"normalize: {name}: card vs CPU path differ")

    # the same file through the stream: the same gain, from the same meter
    src = srcs[1]
    rc, out, _log, wall_s = _run_cli(["stream", src, "--out", os.path.join(work, "s6.wav"),
                                      *NORMALIZE_FLAGS, "--json"])
    res = json.loads(out) if rc == 0 else {}
    mb = summary["per_file"][src]
    x, rate = codec.read_audio(src)
    with codec.open_reader(src) as reader:
        m_file = ld.meter_source_streamed(reader.read, x.shape[0], x.shape[1], rate,
                                          want_tp=True, device=dev)
    m_arr = ld.meter_source_streamed(ld.array_reader(x), x.shape[0], x.shape[1], rate,
                                     want_tp=True, device=dev)
    print(f"normalize: take6 through cli stream rc={rc} in {wall_s:.3f} s: "
          f"{res.get('source_lufs')} LUFS {res.get('applied_gain_db')} dB, batch "
          f"{mb['source_lufs']} LUFS {mb['applied_gain_db']} dB; the meter on the file "
          f"reader {m_file!r}, on the decoded array {m_arr!r} [{card}]", flush=True)
    if (rc != 0 or res["source_lufs"] != mb["source_lufs"]
            or res["applied_gain_db"] != mb["applied_gain_db"] or m_file != m_arr):
        raise AssertionError("normalize: batch and stream gains differ")

    rc, out, _log, wall_p = _run_cli(["probe", srcs[0], "--loudness", "--json"])
    row = json.loads(out)[0] if rc == 0 else {}
    print(f"normalize: cli probe --loudness take0.wav rc={rc} in {wall_p:.3f} s: "
          f"{row.get('lufs')} LUFS, {row.get('true_peak_db')} dBTP, LRA {row.get('lra_lu')} LU "
          f"[{card}]", flush=True)
    if rc != 0 or not all(isinstance(row.get(k), float)
                          for k in ("lufs", "true_peak_db", "lra_lu")):
        raise AssertionError(f"normalize: probe row {row}")
    if abs(row["lufs"] - summary["per_file"][srcs[0]]["source_lufs"]) > 0.05:
        raise AssertionError("normalize: probe and the streamed meter disagree")
    _meter_split(card, srcs[0], dev)
    torch.cuda.empty_cache()
    return launches, windowed


def _slice_takes(rng):
    """The slice's 8 stereo 44.1 kHz takes of 50-60 s (phase 4's files,
    made from the same seed): a list of float32 arrays."""
    return [_signal(rng, 2, int(rng.integers(50 * 44100, 60 * 44100)), 44100)
            for _ in range(8)]


#: the length range of phase 8e's preview items, seconds
PREVIEW_SECONDS = (20.0, 40.0)
#: the banks `cli selftest --parity` runs in phase 8a: the JAX CLI's
#: default pair first
SELFTEST_BANKS = [(48000, 44100, "high"), (44100, 48000, "high"),
                  (44100, 48000, "ultra"), (96000, 48000, "high")]


def _tool_kernel_check(card: str, dev) -> float:
    """The kernel against its plain twin at the tool path's new shapes: the
    0.5 s parity noise and the 1 s mono loop tone of `selftest` (whole
    form, the three banks of `SELFTEST_BANKS` the kernel takes), and haloed
    chunks of 1, 2, 3 and 97 cycles of `preview` (presliced form; the dense
    44.1 -> 48 k bank and the varispeed 44.1 k -> 44,056 bank, the windowed
    form).  Tolerance: `TWIN_TOL` for signals peaking near 0.5,
    scaled by the peak above that (an ulp grows with the value; the parity
    noise peaks near 1.2).  Returns the largest difference."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import resample as tr
    from f9tpu_torch.ops import src_kernel as sk
    from f9tpu_torch.ops.signal import sine

    worst = 0.0
    for ri, ro, q in SELFTEST_BANKS:
        bank = design_cycle_bank(ri, ro, quality=q)
        if not sk.kernel_applicable(bank):
            # 96 -> 48 k is L/M = 1/2: `resample_auto` takes the plain form
            print(f"tool kernel {ri}->{ro} {q}: L={bank.L}, below the kernel's L >= 8; "
                  f"selftest runs the plain unfold + matmul form", flush=True)
            continue
        noise = (0.25 * np.random.default_rng(0).standard_normal(ri // 2)).astype(np.float32)
        for label, x in (("parity noise 0.5 s", torch.from_numpy(noise).to(dev)),
                         ("loop tone 1 s", sine(ri, ri, device=dev)[0])):
            n0 = sk.launches
            y = sk.resample_kernel(x, bank)
            torch.cuda.synchronize()
            yt = sk.resample_rows_reference(x, bank)[0].reshape(-1)[:y.shape[-1]]
            err = float((y - yt).abs().max())
            tol = TWIN_TOL * max(1.0, 2.0 * float(x.abs().max()))
            worst = max(worst, err)
            print(f"tool kernel {ri}->{ro} {q}: {label} mono, {x.numel()} frames: "
                  f"{sk.launches - n0} launch, max_abs_vs_twin={err:.3e} (tol {tol:.2e}) "
                  f"[{card}]", flush=True)
            if sk.launches != n0 + 1 or not err <= tol:
                raise AssertionError(f"tool kernel {ri}->{ro} {q} {label}: {err:.3e}")
    rng = np.random.default_rng(SEED + 80)
    for ri, ro, q in [(44100, 48000, "high"), (44100, 44056, "high")]:
        bank = design_cycle_bank(ri, ro, quality=q)
        twin = ((lambda sp, n, b=bank: tr._gather_core(sp, b, n * b.L)) if bank.G is None
                else (lambda sp, n, b=bank: tr._presliced_fold(sp, b, n)))
        for cycles in (1, 2, 3, 97):
            span = torch.from_numpy(_signal(rng, 2, (cycles - 1) * bank.M + bank.W, ri)).to(dev)
            n0, w0 = sk.launches, sk.launches_windowed
            y = tr.resample_presliced(span, bank, cycles)
            torch.cuda.synchronize()
            err = float((y - twin(span, cycles)).abs().max())
            worst = max(worst, err)
            print(f"tool kernel {ri}->{ro} {q}: presliced chunk of {cycles} cycles "
                  f"({sk.launches - n0} launch, {sk.launches_windowed - w0} windowed): "
                  f"max_abs_vs_twin={err:.3e} (tol {TWIN_TOL:g}) [{card}]", flush=True)
            if sk.launches != n0 + 1 or not err <= TWIN_TOL:
                raise AssertionError(f"tool kernel {ri}->{ro} {q}: {cycles} cycles {err:.3e}")
    return worst


def _run_cli(argv: list[str]) -> tuple[int, str, str, float]:
    """(rc, stdout, stderr, wall seconds) of one in-process CLI run."""
    from f9tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue(), time.time() - t0


def _selftest_path(card: str) -> None:
    """8a: `cli selftest --parity` on four banks."""
    for ri, ro, q in SELFTEST_BANKS:
        rc, out, err, wall = _run_cli(["selftest", "--rate-in", str(ri), "--rate", str(ro),
                                       "--quality", q, "--parity"])
        verdict = out.split(":")[0]
        db = float(out.split("parity: ")[1].split(" dB")[0]) if "parity: " in out else 0.0
        print(f"tool 8a: cli selftest --parity {ri}->{ro} {q}: rc={rc} verdict={verdict} "
              f"parity {db:.1f} dB (max {ORACLE_DB_MAX:g}) in {wall:.2f} s [{card}]",
              flush=True)
        if rc != 0 or verdict != "loop_detected" or not db <= ORACLE_DB_MAX:
            raise AssertionError(f"tool 8a: selftest {ri}->{ro} {q}: {out}{err[-2000:]}")


def _watch_path(card: str, work: str) -> dict:
    """8d: `cli watch` while the slice's 8 files land in two waves of 4,
    then one file is dropped again with new content.  Returns the watch's
    output folder and its inputs."""
    import threading

    import numpy as np

    from f9tpu_torch.io import wav

    drop, stage = os.path.join(work, "drop"), os.path.join(work, "stage")
    out = os.path.join(work, "watch_out")
    os.makedirs(drop)
    os.makedirs(stage)
    takes = _slice_takes(np.random.default_rng(SEED + 1))
    t0 = time.time()
    for i, x in enumerate(takes):
        wav.write_wav(os.path.join(stage, f"take{i}.wav"), x, 44100, bits=24)
    redrop = os.path.join(stage, "take0.wav.new")
    wav.write_wav(redrop, _signal(np.random.default_rng(SEED + 81), 2, 52 * 44100, 44100),
                  44100, bits=24)
    print(f"tool 8d: wrote the slice's 8 stereo 24-bit 44.1 kHz WAVs of 50-60 s and a "
          f"replacement for take0 in {time.time() - t0:.1f} s", flush=True)

    def land(names):
        for n in names:      # a rename: the watcher never sees half a file
            os.replace(os.path.join(stage, n), os.path.join(drop, n))

    def processed(n) -> bool:
        return os.path.exists(os.path.join(out, n.replace(".wav", "_processed.wav")))

    events, failure = [], []

    def dropper():
        try:
            for wave in (["take0.wav", "take1.wav", "take2.wav", "take3.wav"],
                         ["take4.wav", "take5.wav", "take6.wav", "take7.wav"]):
                land(wave)
                events.append((time.time(), f"landed {len(wave)}"))
                deadline = time.time() + 60
                while not all(processed(n) for n in wave):
                    if time.time() > deadline:
                        raise TimeoutError(f"wave {wave} not processed")
                    time.sleep(0.1)
            first = os.stat(os.path.join(out, "take0_processed.wav")).st_mtime_ns
            os.replace(redrop, os.path.join(drop, "take0.wav"))
            events.append((time.time(), "re-dropped take0"))
            deadline = time.time() + 60
            while os.stat(os.path.join(out, "take0_processed.wav")).st_mtime_ns == first:
                if time.time() > deadline:
                    raise TimeoutError("re-dropped take0 not processed")
                time.sleep(0.1)
        except Exception as e:           # reported by the main thread
            failure.append(e)

    th = threading.Thread(target=dropper, daemon=True)
    _zero_counts()
    th.start()
    rc, log, err, wall = _run_cli(["watch", drop, "--out", out, "--rate", "48000",
                                   "--interval", "0.5", "--sweeps", "24"])
    th.join(timeout=5)
    launches = _read_counts()
    sweeps = [ln for ln in log.splitlines() if "watch sweep" in ln]
    completed = [ln.split("Completed: ")[1].split()[0] for ln in log.splitlines()
                 if "Completed: " in ln]
    print(f"tool 8d: cli watch --interval 0.5 --sweeps 24: rc={rc} in {wall:.3f} s, "
          f"kernel launches {launches[0]} ({launches[1]} windowed); sweeps that ran a "
          f"batch: {sweeps}; completions {completed} [{card}]", flush=True)
    if rc != 0 or failure or th.is_alive():
        raise AssertionError(f"tool 8d: watch rc={rc} {failure}\n{log[-3000:]}{err[-2000:]}")
    want = sorted([f"take{i}_processed.wav" for i in range(8)] + ["take0_processed.wav"])
    if sorted(completed) != want:
        raise AssertionError(f"tool 8d: completions {completed}, want each once and take0 twice")
    return {"out": out, "drop": drop, "launches": launches, "wall": wall}


def _verify_and_process_match(card: str, work: str, w: dict) -> None:
    """8d, continued: the watch's outputs against `cli process` of the same
    files and seed (sha256), then `cli verify` on the watch's manifest."""
    out_p = os.path.join(work, "process_out")
    rc, _out, err, wall = _run_cli(["process", w["drop"], "--out", out_p, "--rate", "48000"])
    if rc != 0:
        raise AssertionError(f"tool 8d: cli process rc={rc}\n{err[-2000:]}")
    same = {n: _sha256(os.path.join(w["out"], n)) == _sha256(os.path.join(out_p, n))
            for n in sorted(os.listdir(out_p)) if n.endswith(".wav")}
    print(f"tool 8d: watch outputs vs cli process of the same 8 files ({wall:.3f} s): "
          f"sha256 equal {sum(same.values())} of {len(same)} [{card}]", flush=True)
    if len(same) != 8 or not all(same.values()):
        raise AssertionError(f"tool 8d: watch and process outputs differ: {same}")
    man = os.path.join(w["out"], ".manifest.json")
    rc, out, _err, _ = _run_cli(["verify", man, "--json"])
    counts = json.loads(out)["counts"] if out.strip() else {}
    print(f"tool 8d: cli verify on the watch's manifest: rc={rc} {counts}", flush=True)
    if rc != 0 or counts.get("ok") != 8:
        raise AssertionError(f"tool 8d: verify {rc} {counts}")
    victim = os.path.join(w["out"], "take5_processed.wav")
    with open(victim, "r+b") as f:
        f.seek(-1000, os.SEEK_END)
        b = f.read(1)
        f.seek(-1000, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x10]))
    rc, out, _err, _ = _run_cli(["verify", man, "--json"])
    rows = {os.path.basename(r["output"]): r["status"] for r in json.loads(out)["files"]}
    print(f"tool 8d: one byte of take5_processed.wav flipped: rc={rc} "
          f"take5={rows.get('take5_processed.wav')}", flush=True)
    if rc != 1 or rows.get("take5_processed.wav") != "crc_mismatch":
        raise AssertionError(f"tool 8d: verify after the flip: rc={rc} {rows}")


def _measure_path(card: str, cal_path: str) -> None:
    """8b: `cli measure` without a chain and with a 10 ms delay."""
    lat = {}
    for label, extra in (("SRC", []), ("SRC + 10 ms delay", ["--chain-delay-ms", "10"])):
        rc, out, err, wall = _run_cli(["measure", "--rate-in", "44100", "--rate", "48000",
                                       *extra])
        lat[label] = int(out.split("latency ")[1].split(" frames")[0]) if rc == 0 else None
        print(f"tool 8b: cli measure {label}: rc={rc} latency {lat[label]} frames in "
              f"{wall:.2f} s: {out.strip()} [{card}]", flush=True)
        if rc != 0:
            raise AssertionError(f"tool 8b: measure {label}: {out}{err[-2000:]}")
    with open(cal_path) as f:
        cached = {k: v["latency_frames"] for k, v in json.load(f).items()}
    print(f"tool 8b: the watch's calibration cache: {cached}", flush=True)
    if lat["SRC + 10 ms delay"] - lat["SRC"] != 480:
        raise AssertionError(f"tool 8b: a 10 ms delay measured {lat}")
    if cached.get("44100->48000:sinc:high:") != lat["SRC"]:
        raise AssertionError(f"tool 8b: measure {lat['SRC']} vs the cache {cached}")


def _preview_path(card: str, work: str) -> tuple[int, int]:
    """8e: `cli preview` of 6 mixed-rate items onto an 8-channel bus with a
    monitor mix, in memory and streamed (the same bytes), the CPU path on
    two items, and a looped programme that routes itself to the stream.
    Returns the kernel launches of the in-memory and streamed runs."""
    import numpy as np
    import torch

    from f9tpu_torch.io import wav
    from f9tpu_torch.pipeline.preview import playlist_item_frames

    rng = np.random.default_rng(SEED + 82)
    items = []
    t0 = time.time()
    for i, rate in enumerate([44100, 44100, 96000, 96000, 48000, 44056]):
        n = int(rng.uniform(*PREVIEW_SECONDS) * rate)
        t = np.arange(n) / rate
        f = rng.uniform(150.0, 4000.0, size=(2, 2))
        x = (0.1 * np.sin(2 * np.pi * f[:, :1] * t) + 0.05 * np.sin(2 * np.pi * f[:, 1:] * t)
             + 0.01 * rng.standard_normal((2, n)))      # about -20 dBFS RMS
        items.append(os.path.join(work, f"item{i}_{rate}.wav"))
        wav.write_wav(items[-1], x.astype(np.float32), rate, bits=24)
    audio_s = sum(playlist_item_frames(p, 48000) for p in items) / 48000
    print(f"tool 8e: wrote 6 stereo 24-bit items of 20-40 s at 44.1k, 44.1k, 96k, 96k, "
          f"48k and 44,056 Hz in {time.time() - t0:.1f} s", flush=True)
    flags = ["--rate", "48000", "--channels", "8", "--target-channels", "2,3", "--monitor"]
    shas, launches = {}, [0, 0]
    for form, extra in (("in memory", []), ("streamed", ["--stream"])):
        tag = form.split()[-1]
        main_p, mon_p = os.path.join(work, f"bus_{tag}.wav"), os.path.join(work, f"mon_{tag}.wav")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        rc, out, err, wall = _run_cli(["preview", *items, "--out", main_p,
                                       "--monitor-out", mon_p, *flags, *extra])
        n, nw = _read_counts()
        launches = [launches[0] + n, launches[1] + nw]
        peak = torch.cuda.max_memory_allocated() / 1e9
        shas[form] = (_sha256(main_p), _sha256(mon_p)) if rc == 0 else ("", "")
        print(f"tool 8e: cli preview {form}: rc={rc} wall={wall:.3f} s for {audio_s:.1f} s "
              f"of programme ({audio_s / wall:.1f}x real time), kernel launches {n} ({nw} "
              f"windowed), peak device memory {peak:.3f} GB, sha256 main "
              f"{shas[form][0][:16]} monitor {shas[form][1][:16]} [{card}]", flush=True)
        if rc != 0:
            raise AssertionError(f"tool 8e: preview {form} rc={rc}\n{err[-2000:]}")
    if shas["in memory"] != shas["streamed"]:
        raise AssertionError("tool 8e: the streamed preview's bytes differ from the render's")
    # the card against the port's CPU path on two items (a dense and a
    # varispeed bank), both in memory
    pair = [items[0], items[5]]
    got = {}
    for d in ("cuda", "cpu"):
        p = os.path.join(work, f"pair_{d}.wav")
        rc, _out, err, wall = _run_cli(["preview", *pair, "--out", p, *flags, "--device", d])
        if rc != 0:
            raise AssertionError(f"tool 8e: preview pair on {d} rc={rc}\n{err[-2000:]}")
        got[d] = _read_codes(p)[0]
    same = got["cuda"].shape == got["cpu"].shape
    diff = np.abs(got["cuda"] - got["cpu"]) if same else None
    print(f"tool 8e: two items (44.1k, 44,056 Hz), card vs CPU: "
          f"{int((diff != 0).sum()) if same else -1} of {got['cuda'].size} samples differ, "
          f"max {int(diff.max()) if same else -1} LSB (tol {LSB_TOL}) [{card}]", flush=True)
    if not same or int(diff.max()) > LSB_TOL:
        raise AssertionError("tool 8e: preview card vs CPU path differ")
    # three loops project past 512 MB of float32: the CLI streams by itself
    loop_p = os.path.join(work, "loops.wav")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rc, out, err, wall = _run_cli(["preview", *items, "--out", loop_p, "--rate", "48000",
                                   "--channels", "8", "--loops", "3"])
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"tool 8e: cli preview --loops 3 --channels 8: rc={rc} wall={wall:.3f} s "
          f"({3 * audio_s / wall:.1f}x real time), peak device memory {peak:.3f} GB, "
          f"{os.path.getsize(loop_p) / 1e6:.0f} MB written; note: "
          f"{err.strip().splitlines()[0] if err.strip() else 'none'} [{card}]", flush=True)
    if rc != 0 or "(streamed)" not in out or "in-memory budget" not in err:
        raise AssertionError(f"tool 8e: --loops 3 did not stream: {out}{err[-2000:]}")
    return launches[0], launches[1]


def _profile_and_config(card: str, work: str, in_dir: str) -> None:
    """8f: `cli process --profile` names the kernel; `--save-config` then
    `--config` gives the same bytes."""
    names = sorted(os.listdir(in_dir))[:2]
    srcs = [os.path.join(in_dir, n) for n in names]
    prof = os.path.join(work, "prof")
    cfg = os.path.join(work, "settings.json")
    rc, _out, err, wall = _run_cli(["process", *srcs, "--out", os.path.join(work, "pa"),
                                    "--rate", "48000", "--gain", "-3", "--seed", "11",
                                    "--profile", prof, "--save-config", cfg])
    if rc != 0:
        raise AssertionError(f"tool 8f: process --profile rc={rc}\n{err[-2000:]}")
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    kernels = sorted({e.get("name", "") for e in trace.get("traceEvents", [])
                      if e.get("cat") == "kernel" and "cycle_src" in e.get("name", "")})
    print(f"tool 8f: cli process --profile ({wall:.3f} s): trace.json "
          f"{os.path.getsize(os.path.join(prof, 'trace.json')) / 1e6:.1f} MB, kernels named "
          f"cycle_src: {kernels} [{card}]", flush=True)
    if not kernels:
        raise AssertionError("tool 8f: the profile names no cycle_src kernel")
    rc, _out, err, _ = _run_cli(["process", *srcs, "--out", os.path.join(work, "pb"),
                                 "--config", cfg])
    same = all(_sha256(os.path.join(work, "pa", n.replace(".wav", "_processed.wav")))
               == _sha256(os.path.join(work, "pb", n.replace(".wav", "_processed.wav")))
               for n in names)
    print(f"tool 8f: --save-config then --config: rc={rc} same bytes {same}", flush=True)
    if rc != 0 or not same:
        raise AssertionError("tool 8f: --config did not reproduce the saved job")


def phase_tools(card: str, work: str, dev) -> dict:
    """Phase 8, the tool path: the kernel at the new callers' shapes, then
    `selftest`, `devices`, `watch` with `verify`, `measure`, `preview`,
    `process --profile` and the config file.  Returns the kernel launches
    of each path as (every launch, the windowed form's)."""
    t0 = time.time()
    _tool_kernel_check(card, dev)
    print(f"tool kernel check: {time.time() - t0:.1f} s", flush=True)
    counts = {}

    t0 = time.time()
    _zero_counts()
    _selftest_path(card)
    counts["selftest"] = _read_counts()
    print(f"tool 8a: {time.time() - t0:.1f} s", flush=True)

    rc, out, err, _ = _run_cli(["devices"])
    print(f"tool 8c: cli devices rc={rc}: {out.strip()} [{card}]", flush=True)
    import torch

    name = torch.cuda.get_device_name(0)
    if rc != 0 or name not in out or "GiB" not in out or "1 device(s)" not in out:
        raise AssertionError(f"tool 8c: devices rc={rc}: {out}{err}")

    t0 = time.time()
    w = _watch_path(card, work)
    counts["watch"] = w["launches"]
    _verify_and_process_match(card, work, w)
    print(f"tool 8d: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    _zero_counts()
    _measure_path(card, os.path.join(w["out"], ".calibration.json"))
    counts["measure"] = _read_counts()
    print(f"tool 8b: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    counts["preview"] = _preview_path(card, work)
    print(f"tool 8e: {time.time() - t0:.1f} s", flush=True)

    t0 = time.time()
    _profile_and_config(card, work, w["drop"])
    print(f"tool 8f: {time.time() - t0:.1f} s", flush=True)
    print(f"tool: kernel launches by path (all, windowed) {counts} [{card}]", flush=True)
    for path, (n, nw) in counts.items():
        if n - nw < 1:
            raise AssertionError(f"tool: {path} launched no dense kernel")
    if counts["preview"][1] < 1:
        raise AssertionError("tool: preview launched no windowed kernel")
    return counts


#: phase 9's meshes name the one card several times: its shards share that
#: card (each on a stream of its own), so their times record the shard
#: threads' overhead and are no scaling figure
ONE_CARD_NOTE = ("the mesh names cuda:0 {n} times: {n} shards share one card, "
                 "so times show the shard threads' overhead, not scaling")


def _files_axis(card: str, slice_work: str, dev) -> tuple[int, int]:
    """9a: phase 4's 8 files through `BatchProcessor(mesh=4 files shards)`,
    in turns with the one-device job: each output's sha256 equal to phase
    4's `cli process` output; wall, x real time, the collector's blocking."""
    from f9tpu_torch import cli
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.parallel import make_mesh
    from f9tpu_torch.pipeline import BatchProcessor, build_output_path

    in_dir = os.path.join(slice_work, "in")
    paths = cli._expand_inputs([in_dir])      # phase 4's paths: they key the dither
    want = {p: _sha256(build_output_path(p, os.path.join(slice_work, "out_gpu"),
                                         "_processed")) for p in paths}
    mesh = make_mesh(4, devices=[dev] * 4)
    print(f"files 9a: {ONE_CARD_NOTE.format(n=4)}", flush=True)
    counts = None
    for turn, m in enumerate((None, mesh, mesh, None)):
        out = os.path.join(slice_work, f"out_9a_{turn}")
        # phase 4's `cli process` settings (its defaults)
        cfg = ProcessingConfig(output_dir=out, target_rate=48000, quality="high",
                               batch_size=8, seed=0, postfix="_processed")
        bp = BatchProcessor(cfg, mesh=m, device=dev)
        if turn == 1:
            _zero_counts()
        t0 = time.time()
        res = bp.run(paths)
        wall = time.time() - t0
        if turn == 1:
            counts = _read_counts()
        same = sum(_sha256(build_output_path(p, out, "_processed")) == want[p] for p in paths)
        dev_stage = res.throughput.get("device", {})
        print(f"files 9a: {'mesh 4x1x1' if m is not None else 'one device'} "
              f"completed={res.completed} sha256 equal to phase 4: {same} of {len(paths)} "
              f"wall={wall:.3f} s x_realtime={res.audio_seconds_out / wall:.1f} collector "
              f"blocking {1e3 * dev_stage.get('wall_seconds', 0.0):.1f} ms "
              f"[{card}]", flush=True)
        if res.completed != len(paths) or same != len(paths):
            raise AssertionError(f"files 9a: {same} of {len(paths)} outputs equal")
        shutil.rmtree(out, ignore_errors=True)
    print(f"files 9a: kernel launches of the sharded job (all, windowed) {counts}", flush=True)
    if counts[0] - counts[1] < 4:
        raise AssertionError(f"files 9a: {counts} launches, expected one per shard")
    return counts


def _channels_axis(card: str, work: str, dev) -> tuple[int, int]:
    """9b: 4 files x 60 s on a 16-channel bus over 2 files x 2 channels
    shards with dither, DC removal, reverb mode, a bus-local routing map and
    the delay and EQ stages: codes, out_frames and tail_terminated equal
    to the unsharded graph, rms_db within 1e-5; then the scheduler's
    fallback for a cross-shard map, logged, with the same bytes."""
    import numpy as np
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import wav
    from f9tpu_torch.ops.chain import Biquad, Chain, Delay
    from f9tpu_torch.parallel import make_mesh, process_batch_channels_sharded
    from f9tpu_torch.pipeline import BatchProcessor, build_output_path, process_batch

    rng = np.random.default_rng(SEED + 20)
    files, C, T = 4, 16, 60 * 44100
    x = np.empty((files, C, T), np.float32)
    for f in range(files):
        x[f] = _signal(rng, C, T, 44100)
    x[:, 3] = 0.0                         # a silent input channel
    valid = np.array([T, T - 441000, T, T - 1234567], np.int32)
    seeds = np.arange(101, 101 + files, dtype=np.int32)
    # outputs 0-7 draw from 0-7, 8-15 from 8-15: bus-local on 2 shards
    routing = [1, 0, 2, 3, 4, 5, 7, 6, 9, 8, -1, 11, 12, 13, 15, 14]
    cfg = ProcessingConfig(output_dir="unused", target_rate=48000, seed=0,
                           reverb_mode=True, channel_routing=routing,
                           chain=Chain(Delay(0.005), Biquad("peaking", 1000, 1, 3)))
    mesh = make_mesh(2, 1, 2, devices=[dev] * 4)
    xd = torch.from_numpy(x).to(dev)
    print(f"channels 9b: {ONE_CARD_NOTE.format(n=4)}", flush=True)

    def unsharded():
        return process_batch(xd, valid, cfg, 44100, seeds, latency_frames=240, device=dev)

    def sharded():
        return process_batch_channels_sharded(xd, valid, cfg, 44100, seeds, mesh,
                                              latency_frames=240)

    unsharded()
    ref, t_ref = _timed(unsharded, runs=2)
    _zero_counts()
    got = sharded()
    torch.cuda.synchronize()
    counts = _read_counts()
    got, t_got = _timed(sharded, runs=2)
    for name in ("codes", "out_frames", "tail_terminated", "peak_db", "noise_floor_db"):
        if not torch.equal(getattr(got, name), getattr(ref, name)):
            raise AssertionError(f"channels 9b: {name} differs from the unsharded graph")
    rel = ((got.rms_db - ref.rms_db).abs() / ref.rms_db.abs()).max().item()
    silent_ok = not bool(got.codes[:, 10].any())
    print(f"channels 9b: 4 files x 16 ch x 60 s, reverb + DC + dither + routing + "
          f"delay/EQ: codes, out_frames {got.out_frames.tolist()}, tail_terminated "
          f"{got.tail_terminated.tolist()}, peak and floor equal to the unsharded graph; "
          f"rms_db max rel diff {rel:.2e} (tol 1e-5); routed-silent channel zero: {silent_ok}; "
          f"graph {t_ref:.1f} ms unsharded, {t_got:.1f} ms on 2x2 shards; kernel launches "
          f"(all, windowed) {counts} [{card}]", flush=True)
    if rel > 1e-5 or not silent_ok or counts[0] - counts[1] < 4:
        raise AssertionError(f"channels 9b: rms {rel}, silent {silent_ok}, launches {counts}")
    del xd, ref, got
    torch.cuda.empty_cache()

    # the scheduler: a cross-shard map falls back to the files axis, logged
    in_dir = os.path.join(work, "bus")
    os.makedirs(in_dir)
    paths = []
    for i in range(4):
        p = os.path.join(in_dir, f"bus{i}.wav")
        wav.write_wav(p, _signal(rng, 16, 2 * 44100 + 7 * i, 44100), 44100, bits=32)
        paths.append(p)
    for label, rmap, fallback in (("bus-local", routing, False),
                                  ("cross-shard", [8] + list(range(1, 16)), True)):
        outs = []
        for m in (None, mesh):
            out = os.path.join(work, f"bus_{label}_{m is not None}")
            bp = BatchProcessor(ProcessingConfig(output_dir=out, target_rate=48000, seed=0,
                                                 batch_size=4, channel_routing=rmap),
                                mesh=m, device=dev)
            res = bp.run(paths)
            if res.completed != 4:
                raise AssertionError(f"channels 9b: {label}: {res.completed} completed")
            outs.append((out, bp.log.lines))
        logged = any("Channel sharding unavailable: routing crosses channel shards" in ln
                     for ln in outs[1][1])
        same = sum(_sha256(build_output_path(p, outs[0][0], "_processed"))
                   == _sha256(build_output_path(p, outs[1][0], "_processed")) for p in paths)
        print(f"channels 9b: scheduler, {label} map on 2x2 shards: fallback logged "
              f"{logged}; sha256 equal to the one-device job {same} of 4 [{card}]",
              flush=True)
        if logged != fallback or same != 4:
            raise AssertionError(f"channels 9b: {label}: logged {logged}, same {same}")
    return counts


def _frames_axis(card: str, dev) -> tuple[int, int]:
    """9c: `resample_frames_sharded` on 32 x 2^20 frames over 4 frames
    shards, the default bank and 176.4k -> 48k high (R = 4): bitwise the
    unsharded kernel's output; device ms of both."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops.resample import resample_presliced
    from f9tpu_torch.parallel import make_mesh, required_frames_padding, resample_frames_sharded
    from f9tpu_torch.parallel import shard_halos

    mesh = make_mesh(1, 4, devices=[dev] * 4)
    print(f"frames 9c: {ONE_CARD_NOTE.format(n=4)}", flush=True)
    rng = np.random.default_rng(SEED + 21)
    total = [0, 0]
    for rate_in, rate_out, q in ((44100, 48000, "high"), (176400, 48000, "high")):
        bank = design_cycle_bank(rate_in, rate_out, quality=q)
        T = (1 << 20) + required_frames_padding(1 << 20, bank, 4)
        x = torch.from_numpy(_signal(rng, 32, T, rate_in)).to(dev)
        hl, hr = shard_halos(bank)
        xp = F.pad(x, (hl, hr))

        def whole():
            return resample_presliced(xp, bank, T // bank.M)

        def sharded():
            return resample_frames_sharded(x, rate_in, rate_out, mesh, quality=q)

        ref = whole()
        _zero_counts()
        got = sharded()
        torch.cuda.synchronize()
        a, w = _read_counts()
        total[0] += a
        total[1] += w
        equal = torch.equal(got, ref)
        t_whole = _median_ms(whole)
        t_shard = _median_ms(sharded)
        print(f"frames 9c: {rate_in}->{rate_out} {q} (L={bank.L} M={bank.M}) 32 x {T} frames "
              f"over 4 shards: bitwise equal to the unsharded kernel: {equal}; device ms "
              f"unsharded {t_whole:.3f}, sharded {t_shard:.3f} (launches {a}) [{card}]",
              flush=True)
        if not equal or a < 4:
            raise AssertionError(f"frames 9c: {rate_in}->{rate_out}: equal {equal}, {a} launches")
        del x, xp, ref, got
    return total[0], total[1]


def _sharded_stream(card: str, work: str, dev) -> tuple[int, int]:
    """9d: a 10-minute stereo file through `stream_resample_file(mesh=1 x 4
    frames shards)` without a chain, with phase 5's chain and at 44,056 Hz
    (a varispeed bank): sha256 equal to the one-device stream each time; wall
    and x real time of both."""
    import numpy as np

    from f9tpu_torch import cli
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import wav
    from f9tpu_torch.ops.resample import resample_rates
    from f9tpu_torch.parallel import make_mesh
    from f9tpu_torch.pipeline import calibration
    from f9tpu_torch.pipeline.stream import stream_resample_file

    long_path = os.path.join(work, "long.wav")
    n_long = _write_long_wav(long_path, 600.0, SEED + 8)
    rng = np.random.default_rng(SEED + 2)
    ir_path = os.path.join(work, "IR.wav")
    wav.write_wav(ir_path, _stereo_ir(rng), 48000, bits=32)
    chain = cli._build_chain(argparse.Namespace(**_chain_args(ir_path)))
    ring = chain.tail_frames(48000)
    lat = calibration.measure_latency(
        44100, 48000, chain_fn=lambda v: chain.apply(resample_rates(v, 44100, 48000), 48000),
        capture_frames=max(calibration.CAPTURE_FRAMES,
                           -(-(3 * ring + (1 << 15)) * 44100 // 48000)),
        ringout_frames=ring, device=dev).latency_frames
    mesh = make_mesh(1, 4, devices=[dev] * 4)
    print(f"stream 9d: {ONE_CARD_NOTE.format(n=4)}", flush=True)
    total = [0, 0]
    for label, kw in (("no chain", dict(target_rate=48000)),
                      ("phase 5 chain", dict(target_rate=48000, chain=chain,
                                             latency_frames=lat)),
                      ("44056 (varispeed)", dict(target_rate=44056))):
        shas = []
        for m in (None, mesh):
            out = os.path.join(work, f"long_{len(shas)}.wav")
            cfg = ProcessingConfig(output_dir=work, seed=0, **kw)
            if m is not None:
                _zero_counts()
            t0 = time.time()
            n = stream_resample_file(long_path, out, cfg, mesh=m, device=dev)
            wall = time.time() - t0
            if m is not None:
                a, w = _read_counts()
                total[0] += a
                total[1] += w
            shas.append(_sha256(out))
            print(f"stream 9d: {label}, {'mesh 1x4x1' if m is not None else 'one device'}: "
                  f"{n} frames wall={wall:.3f} s x_realtime={n / kw['target_rate'] / wall:.1f} "
                  f"sha256={shas[-1][:16]}"
                  + (f" launches (all, windowed) {(a, w)}" if m is not None else "")
                  + f" [{card}]", flush=True)
            os.unlink(out)
        if shas[0] != shas[1]:
            raise AssertionError(f"stream 9d: {label}: the sharded stream's bytes differ")
    print(f"stream 9d: {n_long} frames in; 3 of 3 forms sha256-equal [{card}]", flush=True)
    if total[1] < 4 or total[0] - total[1] < 8:
        raise AssertionError(f"stream 9d: launches {total}")
    return total[0], total[1]


def _run_sharded_cost(card: str, dev, calls: int = 200) -> None:
    """The host's cost of one `run_sharded` call on 4 frames shards of the
    card: median ms over ``calls`` calls of a no-op, of one ``psum`` and of
    two ``ppermute``s (a frames shard's halo trade) on (2, 4096) floats,
    synchronized after each call."""
    import torch

    from f9tpu_torch.parallel import P, make_mesh, run_sharded

    mesh = make_mesh(1, 4, devices=[dev] * 4)
    x = torch.ones((2, 4 * 4096), device=dev)
    right = [(i, i + 1) for i in range(3)]
    left = [(i + 1, i) for i in range(3)]
    bodies = {
        "no-op": lambda ctx, a: a,
        "psum": lambda ctx, a: ctx.psum(a, "frames"),
        "2 ppermutes": lambda ctx, a: (ctx.ppermute(a, "frames", right)
                                       + ctx.ppermute(a, "frames", left)),
    }
    parts = []
    for name, fn in bodies.items():
        times = []
        for _ in range(calls):
            t0 = time.perf_counter()
            run_sharded(mesh, fn, (x,), (P(None, "frames"),), P(None, "frames"))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        times.sort()
        parts.append(f"{name} {1e3 * times[len(times) // 2]:.3f} ms")
    print(f"run_sharded 9: 4 shards on one card, host ms per call (median of {calls}): "
          f"{', '.join(parts)} [{card}]", flush=True)


def _shards_cli_check(card: str, work: str) -> None:
    """The CLI on one card: ``process --files-shards 2`` fails with the
    mesh's size, non-zero, writing nothing; it never runs on one shard."""
    import torch

    in_dir = os.path.join(work, "cli_in")
    os.makedirs(in_dir)
    from f9tpu_torch.io import wav
    import numpy as np

    wav.write_wav(os.path.join(in_dir, "a.wav"),
                  _signal(np.random.default_rng(SEED + 22), 2, 44100, 44100), 44100, bits=24)
    out = os.path.join(work, "cli_out")
    rc, _, err, _ = _run_cli(["process", in_dir, "--out", out, "--files-shards", "2"])
    n = torch.cuda.device_count()
    msg = f"mesh 2x1x1 != {n} devices"
    wrote = os.path.isdir(out) and any(f.endswith(".wav") for f in os.listdir(out))
    print(f"cli 9: process --files-shards 2 on {n} card(s): rc={rc} "
          f"message {'found' if msg in err else 'missing'} ({err.strip()[:80]}); "
          f"outputs written: {wrote} [{card}]", flush=True)
    if n == 2:
        return
    if rc == 0 or msg not in err or wrote:
        raise AssertionError(f"cli 9: --files-shards 2 rc={rc}: {err}")


def phase_multi_device(card: str, work: str, slice_work: str, dev) -> dict:
    """Phase 9, the multi-device path on one card; returns the kernel
    launches of each sub-phase as (every launch, the windowed form's)."""
    counts = {}
    for path, fn in (("files_axis", lambda: _files_axis(card, slice_work, dev)),
                     ("channels_axis", lambda: _channels_axis(card, work, dev)),
                     ("frames_axis", lambda: _frames_axis(card, dev)),
                     ("sharded_stream", lambda: _sharded_stream(card, work, dev))):
        t0 = time.time()
        counts[path] = fn()
        print(f"multi-device {path}: {time.time() - t0:.1f} s", flush=True)
    _run_sharded_cost(card, dev)
    _shards_cli_check(card, work)
    print(f"multi-device: kernel launches by path (all, windowed) {counts} [{card}]",
          flush=True)
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from f9tpu_torch import resolve_device
    from f9tpu_torch.ops import _build

    if sys.argv[1:] == ["--windowed-digests"]:
        print(json.dumps(windowed_digests(resolve_device("cuda"))), flush=True)
        return 0
    if sys.argv[1:] == ["--chunk-times"]:
        print(json.dumps(windowed_chunk_ms(resolve_device("cuda"))), flush=True)
        return 0
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

    t0 = time.time()
    k = phase_kernel(card, dev)
    print(f"phase 3 (kernel): {time.time() - t0:.1f} s", flush=True)
    dense = {}
    windowed = {}
    kw = None
    slice_work = None
    for n, path, phase in ((4, "default_job", lambda c, w: phase_slice(c, w, dev=dev)),
                           (5, "insert_loop", lambda c, w: phase_insert_loop(c, w, dev)),
                           (6, "stream", lambda c, w: phase_stream(c, w, dev)),
                           ("7b-c", "varispeed", lambda c, w: phase_varispeed(c, w, dev)),
                           ("7d", "normalize", lambda c, w: phase_normalize(c, w, dev))):
        if path == "varispeed":
            # after phases 3-6, whose memory readings it would otherwise
            # raise by the varispeed banks it leaves cached on the card
            t0 = time.time()
            kw = phase_windowed_kernel(card, dev)
            print(f"phase 7a (windowed kernel): {time.time() - t0:.1f} s", flush=True)
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        t0 = time.time()
        try:
            # each phase sets both counts to 0 just before it drives its
            # path and reads both just after: a launch is the dense form's
            # unless it was counted as the windowed form's
            total, windowed[path] = phase(card, work)
            dense[path] = total - windowed[path]
            if path == "default_job":
                slice_work, work = work, None    # phase 9a holds its outputs to these
        finally:
            if work is not None:
                shutil.rmtree(work, ignore_errors=True)
        print(f"phase {n} ({path}): {time.time() - t0:.1f} s", flush=True)

    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    t0 = time.time()
    try:
        for path, (total, win) in phase_tools(card, work, dev).items():
            dense[path], windowed[path] = total - win, win
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 8 (tool path): {time.time() - t0:.1f} s", flush=True)

    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    t0 = time.time()
    try:
        for path, (total, win) in phase_multi_device(card, work, slice_work, dev).items():
            dense[path], windowed[path] = total - win, win
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(slice_work, ignore_errors=True)
    print(f"phase 9 (multi-device): {time.time() - t0:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "cycle_src",
        "route": "cuda",
        "source": "f9tpu_torch/csrc/cycle_src.cu",
        "replaces": "f9tpu/ops/pallas_src.py:189",
        "also_replaces": "f9tpu/ops/pallas_src.py:141",
        "launches": sum(dense.values()),
        "launches_by_path": dense,
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": k["library_ms"],
        "per_bank": k["per_bank"],
    }, {
        # a second launch form of the same kernel, for banks with no dense
        # matrix; the JAX package has no TPU kernel for it (XLA evaluates
        # `_banded_eval_rows`, one matmul per segment)
        "name": "cycle_src (windowed form)",
        "route": "cuda",
        "source": "f9tpu_torch/csrc/cycle_src.cu",
        "replaces": "f9tpu/ops/resample.py:202",
        "launches": sum(windowed.values()),
        "launches_by_path": windowed,
        "max_abs_err": kw["max_abs_err"],
        "ms": kw["ms"],
        "plain_ms": kw["plain_ms"],
        "bound_ms": kw["bound_ms"],
        "bound_by": kw["bound_by"],
        "library_ms": kw["library_ms"],
        "per_bank": kw["per_bank"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
