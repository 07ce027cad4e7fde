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
   graph split (whole graph, SRC, the epilogue pair, peak memory); the link in turns: a pageable upload and `.cpu()` of the
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
   --profile`, in a process of its own, names the kernel, `--save-config`
   then `--config` gives the same bytes.  Kernel launches are counted from zero for (a), (b), (d), (e);
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
   are counted from zero for (a)-(d);
10. the rows layout (`device_layout="rows"`): (a) `bench.py`'s job, 16
   files x 2 channels x 2^20 frames, through `process_batch(rows_layout=
   True)` on the resident bucket and on the host-marshalled rows (route 2 at
   48 kHz, the varispeed rows of route 3 at 44,056), beside the packed graph
   on the same input: `torch.equal` on codes and metrics, one kernel launch
   per graph, each graph's device ms (CUDA events, median of 10), the ms of
   route 3's un-marshal copy, peak device memory; (b) `bench.py`'s six
   accuracy gates and its varispeed gate through the rows dispatch, each <=
   -120 dB against the float64 oracle; (c) `cli process --device-layout
   rows` on phase 4's 8 files as 24-bit WAVs (the raw wire) and as float32
   WAVs at 48 kHz and 44,056 Hz: every output's sha256 equal to the packed
   run's, wall and x real time, kernel launches counted from zero for each
   rows run; (e) `examples/demo_torch.py`'s 13 configurations on the card,
   with their asserts, and its wall;
11. the epilogue kernel pair (`f9tpu_torch/csrc/epilogue.cu`): (a) at
   `bench.py`'s shape (16 x 2 x 2^20) and the slice's (8 x 2 x 2^22), the
   kernel against its twin run on the card over a flag grid (dither, DC,
   gains, 16 / 24 / 32 bits, int32 codes and payloads, a silent channel,
   keep < total, the stream's form): `torch.equal` on codes or payload, sum
   of squares, peak and mean, also on buses of 1 to 72 channels, 65,600
   mono files, and the persistent design's edges (row strides 1, 2, 3 and 0
   mod 4 floats, valid lengths a float before and after a 16-byte boundary,
   fewer units than blocks, a unit count no grid divides, the stream's
   chunk shapes); (b) on whole files each pass's device ms and bytes per
   second and the pair's (`torch.profiler`), one call's and the
   twin's (CUDA events, median of 10), the bound (y read once) and the
   two-read floor, the launches per graph (1, packed and rows, with the twin
   made to raise); (c) `bench.py`'s packed graph traced five times in a
   process of its own (``--graph-profile``), the trace checked (every kernel a multiple of 5 times, the SRC kernel and the
   pair as often as their counters say; traced again once, then the phase
   fails), the device's busy time as the union of its events' intervals and
   the idle share of the profiled wall; phase 4's and 10a's graph ms and
   peak memory beside the eager epilogue's figures; the pair's launches by
   path over phases 4-10, each at least one;
12. every rate pair, preset and filter kind (`phase_sweep`): (a) the 30
   studio pairs at the four sinc presets, at minphase high and at lagrange,
   and 44.1k <-> 44,056, 192k -> 44,056 and 44.1k -> 42,735 at the four
   presets, each on 2 x 16384 frames of noise and a tone through
   `resample_rates`: the exact length, <= -120 dB against the float64
   oracle, the route read from the launch counters as `kernel_applicable`
   and `fold_batch_applicable` say (dense, windowed, the flat fold for
   L = 1, no launch for the matmul of L = 2-6), each `cycle_src` bank
   within `TWIN_TOL` of its twin and each flat-fold bank bitwise its twin;
   (b) every kernel bank whole against three
   haloed chunks of unequal cycle counts (`resample_presliced`):
   `torch.equal`; (c) the 72 studio sinc kernel banks at the slice's batch,
   8 stereo signals x 60 s at the input rate: the kernel against the
   float64 twin, its device time (CUDA events, median of 5), the bound and
   the share of it, the slowest bank and the lowest share; (d)
   `f9tpu_torch.tools.gen_quality` over its whole matrix, every figure
   within its tolerance of `docs/QUALITY.md`; (e) the batch job
   (`BatchProcessor.run`) on every studio pair at high, two stereo 24-bit
   WAVs of 5 s and 7.3 s: exact lengths, <= 2 LSB from the port's CPU path.
   Launches are counted from zero around each call of (a) and each job of
   (e); the phase fails past `SWEEP_BUDGET_S`;
13. the config-interaction fuzz at card scale (`phase_fuzz`), the
   configurations of `tests/test_torch_fuzz_configs.py` and
   `tests/test_torch_fuzz_stream.py` drawn from the same seeds: (a) the 24
   batch configurations (routing, dither, 16 / 24 / 32 bits, WAV / AIFF,
   the chain, reverb with the peak or RMS rule, packed / rows, fan-out,
   normalization with and without a true-peak cap, the oversized file that
   streams) through `BatchProcessor.run` over 2-4 mono and stereo WAVs of
   5-20 s on the card and on the port's CPU path: the same completions,
   names and frame counts, card vs CPU <= 2 LSB (<= 16 with a chain or
   reverb); (b) the 8 stream configurations (WAV, AIFF, FLAC and MP3 or its
   FLAC fallback; latency, routing, fan-out, normalization, reverb, both
   filter kinds, every output format) on the card at two chunk sizes, equal
   sha256, and against the CPU path as in (a); (c) the 5 sharded-stream
   configurations on a mesh naming the card four times: sha256 equal to the
   one-device stream; (d) a transient device failure and a resume after a
   flipped output byte on the card: the retried and reprocessed bytes equal
   a clean run's.  Launches are counted from zero around every card run and
   each run must launch the kernels its bank takes; the phase fails past
   `FUZZ_BUDGET_S`;
14. the insert chain's kernels (`phase_chain_kernels`; `f9tpu_torch/csrc/
   upols.cu`, `fold.cu`, `dynamics.cu`): (a) cuFFT at n = 8192, 16384, 32768
   and 6000 gives a row the same bits wherever it sits in the one batch
   shape UPOLS calls on the card, (`UPOLS_GROUP`, `UPOLS_FFT_ROWS`), the
   premise of the group form; each row the same bits in a batch of rows as
   in one of rows x G (G = 1, 7, 32, 33; rows 1, 2, 16), a fault at n = 8192
   and counted elsewhere, as are G x rows against G x 16; (b) bitwise
   against the twins: the delay-line multiply-sum (K = 1, 2, 7, 30, 64, mono
   and two-channel H, 1, 2 and 16 rows, groups of 1, 5 and 32), the fold (W
   = 2-5632) and the moving average (2-60,000: staged, staged past 48 KB,
   and from device memory) on rows that start with +0.0 and -0.0, on a 1-D
   row and on rows shorter than a tile; the release envelope with
   `_ENV_BLOCK` patched to 256 and at 2^17 (chunks from mid-block, shorter
   than a tile, ending on the grid, carried states, an empty chunk, a NaN;
   a tile's length +- 1, 8 rows in one launch, rows off the 16-byte grid,
   at 2^20 a look-back over more than 32 tiles) and the windowed maximum (W
   = 2-30,000 across the register form's limit, signed input, ties of both
   zeros, NaNs of two payloads, rows off the 16-byte grid and at its step
   edges); the compressor, expander and limiter streamed at two chunk sizes
   equal to the whole by sha256; `_upols` at B = 4096, 8192 and 16384
   streamed at 1, G - 1, G and G + 1 blocks (and at 4096 with groups of 1)
   equal to the whole by sha256 and two rows alone equal to them in a batch
   of 16; (c) each kernel bitwise against its twin at the insert loop's and
   a 20 s stream chunk's shapes, its ms there (CUDA events, median of 10;
   device ms from `torch.profiler` in a process of its own, ``--chain-
   device-times``, a fault if it reads none) beside its bound, its twin's ms
   and a library call the port never makes (`torch.einsum`, `F.conv1d`,
   `F.avg_pool1d`, `torch.cummax`, `F.max_pool1d`), then the UPOLS reverb,
   the EQ's fold, the compressor and the limiter; the kernels' launches by
   path over phases 4-10 and 14c, each non-zero on the insert loop and the
   stream, the multiply-sum also on normalize; the phase fails past
   `CHAIN_KERNELS_BUDGET_S`;
15. the L < 8 fold (`phase_cycle_fold`; `f9tpu_torch/csrc/cycle_fold.cu`):
   (a) on the 48 dense L < 8 banks of the standard rates at the four sinc
   presets, the meter's 8-32 kHz banks, a Lagrange bank and two banks of
   the generic form only (M = 3, M = 48), the kernel in its form, and the
   slid banks in the generic form too, against its twin on the card at 4 x
   2^18 cycles (a NaN and an inf in a row) and at a tile's edges, rows off
   the 16-byte grid and a 3-D chunk: bitwise outside NaNs, NaN at the same
   places; (b) the fused peak bitwise
   `torch.max(torch.abs(twin))` there and on the true-peak bank with a NaN,
   +-inf, silence, -0.0 and subnormals; (c) the card's kernel bitwise the
   CPU's twin on eight banks; (d) chunked == whole by sha256 at two chunk
   sizes on a 2^22-frame signal, and the chunks' peak the whole one's; the
   fold banks and phase 3's four `cycle_src` banks against the float64
   oracle at a 0.89 peak (dB, 24-bit LSB error; the batch graph's
   `resample` beside each fold bank: the flat fold for L = 1, float32
   matmul otherwise); (e) `cli stream` of a 96 kHz 24-bit stereo file to 48
   kHz at two chunk sizes: identical bytes, the fold launched, codes
   against the CPU path; (f) at the meter's true-peak chunk and a 20 s
   stream chunk, device time (`torch.profiler` in a process of its own,
   ``--cycle-fold-device-times``) and CUDA-event time beside the bound, the
   twin and a float64 `F.conv1d` the port never calls; the phase fails past
   `CYCLE_FOLD_BUDGET_S`; (g) the flat form, the batch SRC of an L = 1
   bank, at the `studio48.hires_sfx` cell's batch (8 x 2 x 2^22 at 96 kHz,
   files of 30-43 s, zero past them) through `resample`: one flat launch,
   bitwise its twin on the padded signal and the presliced kernel on it,
   and its device time (``--cycle-fold-flat-device-times``) beside its
   bound, the twin and the unfold + matmul form it replaced, held to
   `CYCLE_FOLD_FLAT_BUDGET_S`; the kernel's launches, and its flat form's,
   by path over phases 4-10, 15e and 15g, non-zero on normalize, 15e's
   stream and 15g;
16. the front end as one kernel (`phase_front_end`; `f9tpu_torch/csrc/
   frontend.cu`): (a) against its twin on the card, bitwise, over 16- and
   24-bit wires in both byte orders and the float32 bucket, 1-8 input
   channels, fan-out and identity, swapped, silent and wider routing, valid
   lengths at a tile's edges, rows off the 16-byte grid, the stream form's
   means, spans and offsets, the slice's 8 x 2 x 2^22 wire and 65,600 mono
   files; (b) `f9tpu_torch/tools/front_end_times.py` in a process of its own:
   the raw front end at the slice's shape (plain and routed, beside its bound
   and the twin), the float wire, the raw- and float-wire graphs and a 20 s
   stream chunk, with device operations a call and peak memory; ptxas; (c)
   the kernel's launches by path over phases 4-10, non-zero on the default
   job, the insert loop, the stream, normalize and the rows layout; the
   phase fails past `FRONT_END_BUDGET_S`.  Phase 4's graph split also times
   the graph on the raw wire.

Each phase prints its wall time.  The line before the last is the kernels'
JSON summary; the last line is ``{"ok": true, "device": {...}}``.  Without a
CUDA GPU it exits 1 and prints no result.  ``python3 chip_smoke.py
--windowed-digests`` only prints 7a's digests, and ``--chunk-times`` only
7b's times of one launch at the stream's chunk shapes, for the checkout it
sits in (a parent tree unpacked by `git archive` beside this script's copy);
``--epilogue`` runs phase 11 alone, ``--graph-profile`` only 11c's trace,
``--sweep`` phase 12 alone, ``--fuzz`` phase 13 alone, ``--chain-kernels``
phase 14 alone, ``--chain-device-times`` only 14c's profiled device
times, ``--cycle-fold`` phase 15 alone and ``--cycle-fold-device-times``
only 15f's profiled device times, ``--front-end`` phase 16 alone, and
``--front-end-digests DIR`` only the sha256 of phase 4's job, phase 6's
streams and phase 7d's normalized job, their inputs made in DIR (the same
DIR for every tree compared: a file's dither is keyed by its path).
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import re
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


#: the epilogue pair's launches of each main-path drive, as `_read_counts`
#: read them (`main` sums them by phase)
EPILOGUE_READS: list[int] = []
#: the chain kernels' launch counters (`f9tpu_torch/ops/chain_kernels.py`):
#: the MAC, the fold, the moving average, the envelope, the windowed maximum
CHAIN_COUNTERS = ("launches_mac", "launches_fold", "launches_ma", "launches_env",
                  "launches_wmax")
#: the chain kernels' launches of each main-path drive, in `CHAIN_COUNTERS`'
#: order, as `_read_counts` read them (`main` sums them by path)
CHAIN_READS: list[tuple[int, ...]] = []


def _zero_counts() -> None:
    """Set every launch count to 0, just before a main path is driven."""
    from f9tpu_torch.ops import chain_kernels as ck
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import epilogue as ep
    from f9tpu_torch.ops import frontend as fe
    from f9tpu_torch.ops import src_kernel as sk

    sk.launches = sk.launches_windowed = 0
    ep.launches = 0
    cf.launches = cf.launches_flat = 0
    fe.launches = 0
    for name in CHAIN_COUNTERS:
        setattr(ck, name, 0)


def _read_counts() -> tuple[int, int]:
    """(every `cycle_src` launch, those of the windowed form) since
    `_zero_counts`, read just after a main path was driven; the epilogue
    pair's count is read at the same moment into `EPILOGUE_READS`, the
    chain kernels' into `CHAIN_READS`, the L < 8 fold's into
    `CYCLE_FOLD_READS` (its flat form's, the batch SRC of L = 1 banks, also
    into `CYCLE_FOLD_FLAT_READS`), the front end's into `FRONT_END_READS`."""
    from f9tpu_torch.ops import chain_kernels as ck
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import epilogue as ep
    from f9tpu_torch.ops import frontend as fe
    from f9tpu_torch.ops import src_kernel as sk

    EPILOGUE_READS.append(ep.launches)
    CYCLE_FOLD_READS.append(cf.launches)
    CYCLE_FOLD_FLAT_READS.append(cf.launches_flat)
    FRONT_END_READS.append(fe.launches)
    CHAIN_READS.append(tuple(getattr(ck, name) for name in CHAIN_COUNTERS))
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
    "collect" stage's thread-seconds over its batches) and the dispatch
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
        collect_s = s["throughput"]["collect"]["wall_seconds"]
        disp_s = s["throughput"]["dispatch"]["wall_seconds"]
        per = {k: 1e3 * v / n_batches for k, v in ln.items()}
        disp = 1e3 * disp_s / n_batches
        build = disp - per["host_empty"] - per["graph"] - per["download"]
        print(f"slice link: {n_batches} batch(es) of 8 files: collector blocking "
              f"{1e3 * collect_s / n_batches:.1f} ms per batch (collect stage {collect_s:.3f} "
              f"thread-s); "
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


#: this run's graph readings (phase 4's slice batch, phase 10a's graphs),
#: printed again by phase 11 beside `PERF.md` section 5's eager figures
GRAPH_READINGS: dict = {}


def _peak_gb(fn, dev) -> float:
    """Peak device memory in GB that ``fn()`` allocates above what is
    allocated when it starts."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize()
    return round((torch.cuda.max_memory_allocated(dev) - base) / 1e9, 3)


def _slice_graph_split(card: str, in_dir: str, dev) -> None:
    """One 8-file batch of the default job on the card, every file in the
    2^22-frame bucket, on device-resident input by CUDA events (median of 3
    after one warm-up): the whole graph, the SRC alone, the epilogue pair
    alone on the SRC output, and the graph's peak device memory above its
    inputs; then the same graph on the raw 24-bit wire the job uploads."""
    import numpy as np
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import codec
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import dither
    from f9tpu_torch.ops import epilogue as ep
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
    res = whole()
    peak = _peak_gb(whole, dev)
    _, t_all = _timed(whole)
    y, t_src = _timed(lambda: resample_auto(xd, design_cycle_bank(44100, 48000)))
    cs = dither.channel_seeds(torch.from_numpy(seeds).to(dev).to(torch.int64), 2)
    _, t_ep = _timed(lambda: ep.epilogue(y, res.out_frames, cs, bits=24, remove_dc=True,
                                         gain=1.0))
    audio_s = float(valid.sum()) / 44100
    # the default job's own wire: the same files as 24-bit PCM bytes, resident
    wire = np.zeros((8, blen * 6), np.uint8)
    for i in range(8):
        data, _ = codec.read_raw_pcm(os.path.join(in_dir, f"take{i}.wav"))
        wire[i, :data.size] = data
    wd = torch.from_numpy(wire).to(dev)

    def whole_raw():
        return graph.process_batch_raw(wd, vd, cfg, 44100, seeds, in_channels=2, in_bits=24,
                                       latency_frames=lat, device=dev)
    whole_raw()
    peak_raw = _peak_gb(whole_raw, dev)
    _, t_raw = _timed(whole_raw)
    GRAPH_READINGS["slice"] = {"graph_ms": t_all, "src_ms": t_src, "epilogue_ms": t_ep,
                               "peak_gb": peak, "raw_graph_ms": t_raw, "raw_peak_gb": peak_raw}
    print(f"slice graph: 8 files x 2 ch x 2^22 input frames ({audio_s:.1f} s of source), "
          f"latency {lat}: whole graph {t_all:.2f} ms ({audio_s / (t_all / 1000):.0f}x real "
          f"time), SRC alone {t_src:.3f} ms, the epilogue pair alone over {tuple(y.shape)} "
          f"{t_ep:.3f} ms; the graph's peak device memory above its inputs {peak} GB; "
          f"on the raw 24-bit wire (process_batch_raw, the default job's) {t_raw:.2f} ms, "
          f"peak {peak_raw} GB [{card}]", flush=True)


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

    from f9tpu_torch.ops import cycle_fold as cf

    for cache in (sk._device_bank, sk._stacked_bank_f64, tr.bank_to_torch,
                  tr._phase_bank_f64, tr._bank_f64, cf._device_operands):
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
#: `_meter_split`'s true-peak line (before the kernel, "4x true-peak fold (float64, L=4)")
TP_LABEL = "4x true-peak (cycle_fold kernel, fused peak, L=4)"


def _meter_split(card: str, path: str, dev) -> None:
    """One file's normalization meter by CUDA events (median of 3 after a
    warm-up), summed over its 20 s chunks: the SRC to 48 kHz, the
    K-weighting, the hop energies and the 4x true-peak oversampler fused
    with its peak (`_tp_step`: the `cycle_fold` kernel, one memset and one
    launch a chunk), beside the whole `meter_source_streamed` call (host
    reads and uploads included)."""
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
         "hop energies": 0.0, TP_LABEL: 0.0}
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
        t[TP_LABEL] += ms
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
    `--config` gives the same bytes.  The profiled job runs as a user runs
    it, in a process of its own: deep in this script the profiler has lost
    the port's own kernels while recording torch's (11c and 14c profile in
    a child process for the same reason)."""
    names = sorted(os.listdir(in_dir))[:2]
    srcs = [os.path.join(in_dir, n) for n in names]
    prof = os.path.join(work, "prof")
    cfg = os.path.join(work, "settings.json")
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "f9tpu_torch.cli", "process", *srcs, "--out",
                           os.path.join(work, "pa"), "--rate", "48000", "--gain", "-3",
                           "--seed", "11", "--profile", prof, "--save-config", cfg],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"tool 8f: process --profile rc={proc.returncode}\n"
                             f"{proc.stderr[-2000:]}")
    with open(os.path.join(prof, "trace.json")) as f:
        trace = json.load(f)
    kernels = sorted({e.get("name", "") for e in trace.get("traceEvents", [])
                      if e.get("cat") == "kernel" and "cycle_src" in e.get("name", "")})
    print(f"tool 8f: cli process --profile ({wall:.3f} s in a process of its own): trace.json "
          f"{os.path.getsize(os.path.join(prof, 'trace.json')) / 1e6:.1f} MB, kernels named "
          f"cycle_src: {kernels} [{card}]", flush=True)
    if not kernels:
        cats = {}
        for e in trace.get("traceEvents", []):
            cats[e.get("cat", "")] = cats.get(e.get("cat", ""), 0) + 1
        raise AssertionError(f"tool 8f: the profile names no cycle_src kernel (the trace's "
                             f"events by category: {cats})")
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
        collect_s = res.throughput["collect"]["wall_seconds"]
        print(f"files 9a: {'mesh 4x1x1' if m is not None else 'one device'} "
              f"completed={res.completed} sha256 equal to phase 4: {same} of {len(paths)} "
              f"wall={wall:.3f} s x_realtime={res.audio_seconds_out / wall:.1f} collector "
              f"blocking {1e3 * collect_s:.1f} ms "
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


#: phase 10a's batch, `bench.py`'s job: 16 files x 2 channels x 2^20 frames
ROWS_JOB = (16, 2, 1 << 20)


def _rows_equal(rows, packed) -> bool:
    """rows == packed bitwise: the tiling read flat up to the packed length,
    zeros past it, and every metric."""
    import torch

    flat = rows.codes.reshape(*rows.codes.shape[:2], -1)
    n = packed.codes.shape[-1]
    return (rows.layout == "rows" and torch.equal(flat[..., :n], packed.codes)
            and not bool(flat[..., n:].any())
            and all(torch.equal(getattr(rows, k), getattr(packed, k))
                    for k in ("out_frames", "peak_db", "rms_db", "noise_floor_db")))


def _staging(x, bank, frames: int):
    """The JAX package's host-marshalled rows of ``x (files, C, frames)``
    for ``bank``, built on x's device: dense rows a view of their staging,
    varispeed rows a contiguous copy of the overlapping window view (as the
    JAX marshal makes them)."""
    import torch

    from f9tpu_torch.pipeline import graph as tg

    total, pf = tg.rows_staging_plan(bank, frames)
    st = torch.zeros((*x.shape[:2], total), device=x.device)
    st[..., pf:pf + frames] = x
    rows = tg.marshalled_rows(st, bank)
    return rows if bank.G is not None else rows.contiguous()


def _rows_graphs(card: str, dev) -> None:
    """10a: `bench.py`'s job through `process_batch(rows_layout=True)` and
    packed on the same resident input (the bucket, and the host-marshalled
    rows of route 2), 44.1k -> 48k high, dither and DC removal on:
    `torch.equal` on codes and metrics; each graph's device ms (CUDA events,
    median of 10 after warm-up); the same at 44,056 with the varispeed rows
    of route 3 and the ms of their un-marshal copy; one kernel launch per
    rows graph (no CPU twin); each graph's peak device memory above its
    resident inputs."""
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import src_kernel as sk
    from f9tpu_torch.pipeline import graph as tg

    files, C, frames = ROWS_JOB
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 0.25 * torch.randn((files, C, frames), generator=gen, device=dev)
    valid = torch.full((files,), frames, dtype=torch.int32, device=dev)
    seeds = torch.arange(1, files + 1, dtype=torch.int32, device=dev)
    for rate, route in ((48000, "route 2, dense rows"), (44056, "route 3, varispeed rows")):
        cfg = ProcessingConfig(output_dir="/nonexistent", target_rate=rate, quality="high")
        bank = design_cycle_bank(44100, rate, quality="high")
        rows4 = _staging(x, bank, frames)
        graphs = {
            "packed": lambda: tg.process_batch(x, valid, cfg, 44100, seeds),
            "rows": lambda: tg.process_batch(x, valid, cfg, 44100, seeds, rows_layout=True),
            "staged": lambda: tg.process_batch(rows4, valid, cfg, 44100, seeds,
                                               rows_layout=True),
        }
        res, launched, peak = {}, {}, {}
        for name, fn in graphs.items():
            n0 = sk.launches
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            res[name] = fn()
            torch.cuda.synchronize()
            peak[name] = round((torch.cuda.max_memory_allocated(dev) - base) / 1e9, 3)
            launched[name] = sk.launches - n0
        eq = {k: _rows_equal(res[k], res["packed"]) for k in ("rows", "staged")}
        del res
        for fn in graphs.values():
            for _ in range(2):
                fn()
        # in turns: packed, rows, staged, staged, rows, packed
        ms = {name: [] for name in graphs}
        for name in ("packed", "rows", "staged", "staged", "rows", "packed"):
            ms[name].append(_median_ms(graphs[name]))
        ms_s = " ".join(f"{k} {a:.3f}/{b:.3f}" for k, (a, b) in ms.items())
        GRAPH_READINGS[f"rows 10a {rate}"] = {"graph_ms": ms, "peak_gb": peak}
        unmarshal = (f" un-marshal copy {_median_ms(lambda: tg._rows_staging(rows4, bank)):.3f} ms"
                     if bank.G is None else "")
        print(f"rows 10a: 44100->{rate} high {files}x{C}x2^20 ({route}): rows == packed "
              f"{eq['rows']}, staged == packed {eq['staged']}; device ms {ms_s}{unmarshal} "
              f"(median of 10, two turns); kernel launches per graph {launched}; each graph's "
              f"peak device memory above its inputs {peak} GB [{card}]", flush=True)
        if not all(eq.values()):
            raise AssertionError(f"rows 10a: rows layout differs from packed at {rate}: {eq}")
        if any(n != 1 for n in launched.values()):
            raise AssertionError(f"rows 10a: kernel launches {launched}, expected 1 each")
        del rows4
    del x
    torch.cuda.empty_cache()


def _rows_gates(card: str, dev) -> None:
    """10b: `bench.py`'s six accuracy gates and its varispeed gate through
    the port's rows dispatch (the scheduler's: host-marshalled rows where the
    bank takes them, the raw wire's rows route for the 24-bit gate), each
    <= -120 dB RMS against `f9tpu_torch.models.oracle`, dither and DC removal
    off, 2^15 frames of white noise at 0.125 RMS."""
    import numpy as np
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.models import design_cycle_bank, resample_oracle
    from f9tpu_torch.ops import resample as tr
    from f9tpu_torch.pipeline import graph as tg

    n_acc = 1 << 15
    xa = (0.125 * np.random.default_rng(0).standard_normal((1, 1, n_acc))).astype(np.float32)
    valid = np.array([n_acc], np.int32)

    def graph_case(r_in, r_out, quality="high", kind="sinc"):
        cfg = ProcessingConfig(output_dir="/nonexistent", target_rate=r_out, quality=quality,
                               kind=kind, dither=False, remove_dc=False)
        bank = design_cycle_bank(r_in, r_out, quality=quality, kind=kind)
        x = torch.from_numpy(xa).to(dev)
        if tr.rows_pre_applicable(bank) or tr.banded_rows_applicable(bank):
            x = _staging(x, bank, n_acc)
        res = tg.process_batch(x, valid, cfg, r_in, [1], rows_layout=True)
        n = int(res.out_frames[0])
        got = res.codes.reshape(-1)[:n].cpu().numpy().astype(np.float64) / (1 << 23)
        return got, resample_oracle(xa[0, 0], r_in, r_out, quality=quality, kind=kind)

    def raw_case(r_in, r_out):
        cfg = ProcessingConfig(output_dir="/nonexistent", target_rate=r_out, quality="high",
                               dither=False, remove_dc=False)
        q = np.clip(np.round(xa[0, 0] * (1 << 23)), -(1 << 23), (1 << 23) - 1).astype(np.int64)
        u = (q & 0xFFFFFF).astype(np.uint32)
        b = np.stack([u & 0xFF, (u >> 8) & 0xFF, (u >> 16) & 0xFF], -1).astype(np.uint8)
        res = tg.process_batch_raw(torch.from_numpy(b.reshape(1, -1)).to(dev), valid, cfg,
                                   r_in, [1], in_channels=1, in_bits=24, rows_layout=True)
        n = int(res.out_frames[0])
        pb = res.codes[0, :3 * n].cpu().numpy().astype(np.int64)
        v = pb[0::3] | (pb[1::3] << 8) | (pb[2::3] << 16)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        return (v.astype(np.float64) / (1 << 23),
                resample_oracle(q.astype(np.float64) / (1 << 23), r_in, r_out, quality="high"))

    gates = {
        "up_44k_to_48k_rows": lambda: graph_case(44100, 48000),
        "down_96k_to_44k_rows": lambda: graph_case(96000, 44100),
        "raw24_44k_to_48k_rows": lambda: raw_case(44100, 48000),
        "ultra_44k_to_48k": lambda: graph_case(44100, 48000, "ultra"),
        "down_176k_to_48k": lambda: graph_case(176400, 48000),
        "minphase_44k_to_48k": lambda: graph_case(44100, 48000, kind="minphase"),
        "varispeed_44k_to_44056_rows": lambda: graph_case(44100, 44056),
    }
    failed = []
    for name, case in gates.items():
        got, ref = case()
        db = _db(got - ref[:got.shape[-1]], ref[:got.shape[-1]])
        print(f"rows 10b: accuracy[{name}] {db:.1f} dB RMS vs the float64 oracle "
              f"(max {ORACLE_DB_MAX:g}) [{card}]", flush=True)
        if not db <= ORACLE_DB_MAX:
            failed.append(name)
    if failed:
        raise AssertionError(f"rows 10b: gates failed: {failed}")


def _rows_cli(card: str, work: str, slice_work: str) -> tuple[int, int]:
    """10c: `cli process --device-layout rows` on phase 4's 8 files: as
    24-bit WAVs (the raw wire, route 1) against phase 4's own outputs, and
    as float32 WAVs at 48 kHz (dense host-marshalled rows, route 2) and at
    44,056 Hz (varispeed rows, route 3) against the packed run of the same
    files: every output's sha256 equal; wall and x real time.  Returns the
    kernel launches of the rows runs at 48 kHz and at 44,056, counted from 0
    around each."""
    from f9tpu_torch import cli
    from f9tpu_torch.io import wav
    from f9tpu_torch.pipeline import build_output_path

    in24 = os.path.join(slice_work, "in")
    paths24 = cli._expand_inputs([in24])          # phase 4's paths: they key the dither
    in32 = os.path.join(work, "in32")
    os.makedirs(in32)
    for p in paths24:
        x, rate = wav.read_wav(p)
        wav.write_wav(os.path.join(in32, os.path.basename(p)), x, rate, bits=32)
    paths32 = cli._expand_inputs([in32])
    runs = (("24-bit, route 1", in24, paths24, "48000", os.path.join(slice_work, "out_gpu")),
            ("float32, route 2", in32, paths32, "48000", None),
            ("float32, route 3", in32, paths32, "44056", None))
    counts = {"rows_layout": [0, 0], "rows_varispeed": [0, 0]}
    for k, (tag, in_dir, paths, rate, want_dir) in enumerate(runs):
        if want_dir is None:
            want_dir = os.path.join(work, f"packed_{rate}")
            rc, _, wall = _cli_json(["process", in_dir, "--out", want_dir, "--rate", rate,
                                     "--json"])
            if rc != 0:
                raise AssertionError(f"rows 10c: packed run at {rate} rc={rc}")
        out = os.path.join(work, f"rows_{k}")
        _zero_counts()
        rc, summary, wall = _cli_json(["process", in_dir, "--out", out, "--rate", rate,
                                       "--device-layout", "rows", "--json"])
        launched = _read_counts()
        key = "rows_varispeed" if rate == "44056" else "rows_layout"
        counts[key] = [a + b for a, b in zip(counts[key], launched)]
        same = sum(_sha256(build_output_path(p, out, "_processed"))
                   == _sha256(build_output_path(p, want_dir, "_processed")) for p in paths)
        print(f"rows 10c: cli process --device-layout rows --rate {rate} ({tag}): rc={rc} "
              f"completed={summary.get('completed')} sha256 equal to packed: {same} of "
              f"{len(paths)} kernel launches (all, windowed) {launched} wall={wall:.3f} s "
              f"x_realtime={summary.get('audio_seconds_out', 0.0) / wall:.1f} [{card}]",
              flush=True)
        if rc != 0 or same != len(paths):
            raise AssertionError(f"rows 10c: {tag}: {same} of {len(paths)} outputs equal")
        if launched[0] < 2 or (rate == "44056") != (launched[1] > 0):
            raise AssertionError(f"rows 10c: {tag}: kernel launches {launched}")
    return {k: tuple(v) for k, v in counts.items()}


def _demo(card: str, work: str) -> None:
    """10e: `examples/demo_torch.py`, `examples/demo.py`'s 13
    configurations through the port's CLI on the card, with its asserts."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "demo_torch", os.path.join(ROOT, "examples", "demo_torch.py"))
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    buf = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            demo.run(os.path.join(work, "demo"), "cuda")
    except BaseException:
        print(buf.getvalue()[-4000:], flush=True)
        raise
    wall = time.time() - t0
    done = [ln for ln in buf.getvalue().splitlines() if re.match(r"\[\d+\] ", ln)]
    print(f"rows 10e: examples/demo_torch.py on the card: {len(done)} configurations, "
          f"wall {wall:.1f} s [{card}]", flush=True)
    for ln in done:
        print(f"rows 10e:   {ln}", flush=True)
    if len(done) != 13:
        raise AssertionError(f"rows 10e: {len(done)} of 13 configurations ran")


def phase_rows(card: str, work: str, slice_work: str, dev) -> dict:
    """Phase 10, the rows layout; returns the kernel launches of its CLI
    runs (all, windowed) by path."""
    t0 = time.time()
    _rows_graphs(card, dev)
    print(f"rows 10a: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    _rows_gates(card, dev)
    print(f"rows 10b: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    counts = _rows_cli(card, work, slice_work)
    print(f"rows 10c: {time.time() - t0:.1f} s", flush=True)
    _demo(card, work)
    print(f"rows: kernel launches by path (all, windowed) {counts} [{card}]", flush=True)
    return counts


#: phase 11's shapes: `bench.py`'s job and the slice's batch, as the
#: epilogue sees them (the SRC output of 44.1k -> 48k high, whole cycles)
EPILOGUE_SHAPES = (("bench.py's job", 16, 2, 1 << 20), ("the slice's batch", 8, 2, 1 << 22))
#: and mono, and buses whose payload a block stages beside its ring (C = 4,
#: and 16 at 16 bits) or writes in place (C = 16 at 24 bits, 24, 72: past
#: the ~184 KB it stages; channel 70 of 72 silent), in both payload widths,
#: and more files than a grid's second axis holds, held to the twin only
EPILOGUE_BUSES = (("mono", 3, 1, 1 << 16), ("a 4-channel bus", 3, 4, 1 << 16),
                  ("a 16-channel bus", 2, 16, 1 << 16), ("a 24-channel bus", 2, 24, 1 << 15),
                  ("a 72-channel bus", 2, 72, 1 << 13), ("65,600 mono files", 65600, 1, 64))
#: and the edges of the persistent, TMA-fed design, held to the twin only:
#: row strides (the output length) 1, 2, 3 and 0 mod 4 floats, so a bulk
#: copy's head and tail fall anywhere; fewer units than blocks; a unit count
#: no grid divides (337 tiles a row); the stream's chunk shapes (the grid's
#: "stream" cases: pos0, no mask, no statistics).  Valid lengths cycle
#: through `_edge_lengths`.
EPILOGUE_EDGES = (("row stride 1 mod 4", 4, 2, 3 * 4096 + 1),
                  ("row stride 2 mod 4", 4, 2, 3 * 4096 + 2),
                  ("row stride 3 mod 4", 4, 2, 3 * 4096 + 3),
                  ("row stride 0 mod 4", 4, 2, 3 * 4096 + 4),
                  ("one file of 5,000 frames: fewer units than blocks", 1, 2, 5000),
                  ("337 tiles a row: units no grid divides", 3, 2, 337 * 4096 - 1),
                  ("a stream chunk of 20 s at 48k", 1, 2, 960000),
                  ("a stream chunk of 7.3 s at 48k", 1, 2, 350400),
                  ("a stream chunk of 12,345 frames", 1, 2, 12345))
#: the graphs with the eager epilogue this kernel pair replaced, as `PERF.md`
#: section 5 records them (NVIDIA H100 80GB HBM3, 700 W), printed beside this
#: run's readings
EAGER_GRAPHS = ("slice batch 13.21-13.36 ms (SRC 0.94-1.07); bench.py's job packed "
                "6.747-6.789 ms, rows 6.596-6.602, staged 6.372-6.387; each graph's peak "
                "1.57-1.70 GB above its inputs")
#: phase 11a's flag grid: (label, `epilogue` keywords); "stream" drops the
#: mask and the statistics and keys the noise at pos0, as `_finish_chunk` does
EPILOGUE_GRID = (
    ("24-bit, dither, DC", dict(bits=24, dither=True, remove_dc=True)),
    ("24-bit payload, dither, DC", dict(bits=24, dither=True, remove_dc=True, packed=24)),
    ("16-bit payload, -3 dB, per-file gain, no DC, keep < total (rows not 16-byte aligned)",
     dict(bits=16, dither=True, remove_dc=False, packed=16, gain=10 ** (-3 / 20),
          per_file=True, cut=1001)),
    ("24-bit, no dither, DC, silent channels 1 and 70 (those the bus has), keep < total",
     dict(bits=24, dither=False, remove_dc=True, silent=(1, 70), cut=1000)),
    ("32-bit, dither, DC, per-file gain", dict(bits=32, dither=True, remove_dc=True,
                                               per_file=True)),
    ("stream: 24-bit payload, pos0, silent channels 0 and 70 (those the bus has)",
     dict(bits=24, dither=True, remove_dc=False, packed=24, silent=(0, 70), stream=True)),
    ("stream: int16 codes, pos0", dict(bits=16, dither=True, remove_dc=False,
                                       dtype="int16", stream=True)),
)


def _epilogue_case(y, out_frames, seeds, opts: dict) -> tuple[tuple, dict]:
    """(positional, keyword) arguments of `ops.epilogue` for a grid case."""
    import torch

    from f9tpu_torch.ops import dither

    files, C, total = y.shape
    stream = opts.get("stream", False)
    cs = dither.channel_seeds(seeds.to(torch.int64), C) if opts["dither"] else None
    gain_lin = None
    if opts.get("per_file"):
        gain_lin = torch.linspace(0.5, 1.5, files, device=y.device, dtype=torch.float32)
    kw = dict(bits=opts["bits"], remove_dc=opts["remove_dc"], gain=opts.get("gain", 1.0),
              gain_lin=gain_lin, keep=total - min(opts.get("cut", 0), total // 3),
              silent=tuple(c for c in opts.get("silent", ()) if c < C),
              packed=opts.get("packed"),
              pos0=123456789 if stream else 0, stats=not stream,
              codes_dtype=torch.int16 if opts.get("dtype") == "int16" else torch.int32)
    return (y, None if stream else out_frames, cs), kw


def _epilogue_inputs(files: int, C: int, frames: int, dev):
    """The SRC output of ``frames`` input frames (whole cycles of 44.1k ->
    48k high) as normal noise at 0.25 plus 0.01 of DC, and valid lengths
    from whole down to 0 (within a tile, shorter than a tile, shorter than
    the tail window; none past the output)."""
    import torch

    from f9tpu_torch.models import design_cycle_bank

    bank = design_cycle_bank(44100, 48000)
    total = -(-bank.out_len(frames) // bank.L) * bank.L
    gen = torch.Generator(device=dev).manual_seed(SEED + files)
    y = 0.25 * torch.randn((files, C, total), generator=gen, device=dev) + 0.01
    lengths = [total, total - 1, total - 4095, total // 3 + 7, 4097, 4095, 1000, 0]
    out_frames = torch.tensor([min(max(lengths[i % len(lengths)], 0), total)
                               for i in range(files)], dtype=torch.int32, device=dev)
    seeds = torch.arange(1, files + 1, dtype=torch.int32, device=dev)
    return y, out_frames, seeds


def _edge_lengths(total: int) -> list[int]:
    """Valid lengths for 11a's edges: whole, one element before and one
    after a 16-byte boundary of an aligned row, the boundary itself, 0."""
    b = 4 * (total // 8)
    return [total, b - 1, b + 1, b, 0]


def _edge_inputs(files: int, C: int, total: int, dev):
    """Normal noise at 0.25 plus 0.01 of DC, ``(files, C, total)``, with
    `_edge_lengths` as the valid lengths, cycled over the files."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + total)
    y = 0.25 * torch.randn((files, C, total), generator=gen, device=dev) + 0.01
    lengths = _edge_lengths(total)
    out_frames = torch.tensor([lengths[i % len(lengths)] for i in range(files)],
                              dtype=torch.int32, device=dev)
    seeds = torch.arange(1, files + 1, dtype=torch.int32, device=dev)
    return y, out_frames, seeds


def _epilogue_bound_ms(files: int, C: int, keep: int, out_bytes: int, reads: int = 1) -> float:
    """The least time of the epilogue's traffic: ``reads`` reads of the
    float32 input and one write of ``out_bytes`` per sample, at the card's
    memory rate (one read is the function's; two are a DC-removing design's
    floor, since the mean precedes the first code and y outgrows L2)."""
    return 1e3 * files * C * keep * (4 * reads + out_bytes) / HBM_BYTES_PER_S


def _pass_ms(fn, runs: int = 10,
             names=(("pass1_ms", "dc_pass"), ("pass2_ms", "finish_pass"))) -> dict:
    """Each kernel's device ms in ``runs`` calls of ``fn`` (one launch of
    each a call; by default the epilogue pair's passes): the median of
    `torch.profiler`'s kernel events whose name holds ``names``' second
    item, under its first; None where the profiler saw none."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = {key: [] for key, _ in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key, name in names:
                if name in e.name:
                    times[key].append(e.time_range.elapsed_us() / 1e3)
    return {k: float(np.median(v)) if v else None for k, v in times.items()}


def _busy_union_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals (us): copies on
    the side stream that overlap kernels count once."""
    busy, hi = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > hi:
            busy += b - max(a, hi)
            hi = b
    return busy


def _trace_faults(count, runs: int, expect: dict) -> list[str]:
    """What is wrong with a trace of ``runs`` graphs: a name seen a count
    that is not a multiple of ``runs``, or a kernel (by a part of its name)
    seen other than ``runs`` times its launches per graph in ``expect``."""
    bad = [f"{n[:60]} x{k}" for n, k in count.items() if k % runs]
    for part, per_graph in expect.items():
        seen = sum(k for n, k in count.items() if part in n)
        if seen != runs * per_graph:
            bad.append(f"{part} x{seen} != {runs} x {per_graph}")
    return bad


def _graph_profile(card: str, graph, remove_dc: bool, runs: int = 5) -> dict:
    """11c: where `bench.py`'s packed graph spends its time: the host wall
    per graph (host clock around ``runs`` calls ended by a synchronize,
    without and with the profiler), and from `torch.profiler`'s device
    events of the profiled calls the device's busy time per graph (the
    union of the kernels' and copies' intervals), its launches and the
    largest by name.  The idle share is 1 - busy / the profiled wall: both
    from the same calls.  The trace is checked first: every name a multiple
    of ``runs`` times, the SRC kernel and the pair ``runs`` times their
    launches per graph as the kernels' counters read them around one graph;
    a trace that fails is taken once more, then the phase raises."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from f9tpu_torch.ops import epilogue as ep
    from f9tpu_torch.ops import src_kernel as sk

    graph()
    torch.cuda.synchronize()
    src0, pair0 = sk.launches, ep.launches
    graph()
    torch.cuda.synchronize()
    pair = ep.launches - pair0
    expect = {"cycle_src": sk.launches - src0, "finish_pass": pair,
              "dc_pass": pair if remove_dc else 0}
    t0 = time.perf_counter()
    for _ in range(runs):
        graph()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / runs
    for attempt in (1, 2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                graph()
            torch.cuda.synchronize()
            prof_wall_ms = 1e3 * (time.perf_counter() - t0) / runs
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_name, count = collections.Counter(), collections.Counter()
        for e in events:
            by_name[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        bad = _trace_faults(count, runs, expect)
        if not bad:
            break
        print(f"epilogue 11c: trace {attempt} of {runs} graphs fails its count check: "
              f"{bad} [{card}]", flush=True)
    else:
        raise AssertionError(f"epilogue 11c: two traces failed the count check: {bad}")
    busy_ms = _busy_union_us([(e.time_range.start, e.time_range.end) for e in events]) / 1e3 / runs
    sum_ms = sum(by_name.values()) / 1e3 / runs
    idle = 100.0 - 100.0 * busy_ms / prof_wall_ms
    print(f"epilogue 11c: bench.py's packed graph: trace check passed on trace {attempt} "
          f"(every name a multiple of {runs}; per graph {expect}); host wall "
          f"{wall_ms:.3f} ms per graph without the profiler, {prof_wall_ms:.3f} with it; "
          f"device busy {busy_ms:.3f} ms per graph (union of intervals; {sum_ms:.3f} as a "
          f"sum of durations) in {len(events) / runs:.0f} kernels and copies: {idle:.1f} % "
          f"idle over the profiled wall (torch.profiler) [{card}]", flush=True)
    for name, us in by_name.most_common(8):
        print(f"epilogue 11c:   {us / 1e3 / runs:.4f} ms in {count[name] / runs:.1f} launches "
              f"per graph: {name[:90]}", flush=True)
    return {"wall_ms": wall_ms, "profiled_wall_ms": prof_wall_ms, "busy_ms": busy_ms,
            "busy_sum_ms": sum_ms, "idle_pct": idle, "per_graph": expect, "trace": attempt}


def graph_profile_main(dev) -> dict:
    """11c itself: `bench.py`'s packed graph (`ROWS_JOB`, resident) traced
    by `_graph_profile`."""
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.pipeline import graph as tg

    files, C, frames = ROWS_JOB
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 0.25 * torch.randn((files, C, frames), generator=gen, device=dev)
    valid = torch.full((files,), frames, dtype=torch.int32, device=dev)
    seeds = torch.arange(1, files + 1, dtype=torch.int32, device=dev)
    cfg = ProcessingConfig(output_dir="/nonexistent", target_rate=48000, quality="high")
    return _graph_profile(_card(), lambda: tg.process_batch(x, valid, cfg, 44100, seeds),
                          cfg.remove_dc)


def _graph_profile_fresh() -> dict:
    """11c in a process of its own (``--graph-profile``), its lines passed
    through: after the earlier phases, this process's traces came out a
    whole graph short every time (both attempts, run after run), while a
    fresh process's were whole.  Raises if it fails."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--graph-profile"],
                          capture_output=True, text=True, timeout=600)
    out = [line for line in proc.stdout.splitlines() if line.startswith("epilogue 11c")]
    for line in out:
        print(line, flush=True)
    result = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or not result:
        raise AssertionError(f"epilogue 11c: the traced process failed (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(result[-1])


def phase_epilogue(card: str, dev) -> dict:
    """Phase 11, the epilogue kernel pair: (a) kernel == twin on the card
    (`torch.equal` on codes or payload, sum of squares, peak and mean) over
    the flag grid at both shapes, on the buses and on the edges; (b) on
    whole files, each pass's device ms and bytes per second and the pair's
    (`torch.profiler`, median of 10 after warm-up), one call's and the
    twin's (CUDA events), the bounds, the launches per graph and that
    `_epilogue` on the card never runs the twin; (c) the packed graph's
    checked trace and idle share, and phase 4's and phase 10a's graph ms
    and peak memory beside the eager figures.  Returns the numbers for the
    JSON summary."""
    import torch

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.ops import epilogue as ep
    from f9tpu_torch.pipeline import graph as tg

    per_shape = []
    max_err = 0.0
    shapes = [(label, files, C, frames, False) for label, files, C, frames
              in EPILOGUE_SHAPES + EPILOGUE_BUSES]
    shapes += [(label, files, C, total, True) for label, files, C, total in EPILOGUE_EDGES]
    for label, files, C, frames, edge in shapes:
        y, out_frames, seeds = (_edge_inputs if edge else _epilogue_inputs)(files, C, frames, dev)
        total = y.shape[-1]
        for name, opts in EPILOGUE_GRID:
            args, kw = _epilogue_case(y, out_frames, seeds, opts)
            got = ep.epilogue(*args, **kw)
            want = ep.epilogue_reference(*args, **kw)
            torch.cuda.synchronize()
            same = {k: (g is None and w is None) or (g is not None and w is not None
                                                     and torch.equal(g, w))
                    for k, g, w in zip(("codes", "sumsq", "peak", "mean"), got, want)}
            err = max((float((g.double() - w.double()).abs().max()) for g, w in zip(got, want)
                       if g is not None and w is not None and g.numel()), default=0.0)
            max_err = max(max_err, err)
            print(f"epilogue 11a: {label} {files}x{C}x{total} [{name}]: kernel == twin "
                  f"{same}, max abs difference {err:g} [{card}]", flush=True)
            if not all(same.values()):
                raise AssertionError(f"epilogue 11a: {label} [{name}]: kernel != twin {same}")
            del got, want
        if edge or (label, files, C, frames) in EPILOGUE_BUSES:
            continue
        # (b) on whole files, as bench.py's job and the slice's batch give
        # them (every sample read, so the bound counts them all), int32
        # codes and the payload: each pass's device time (the profiler's
        # kernel events) and their sum, the pair's device time; one call
        # of the wrapper and one of the twin (CUDA events: the call's
        # allocations and launch gaps included)
        full = torch.full_like(out_frames, total)
        row = {"shape": f"{files}x{C}x2^{frames.bit_length() - 1}", "outputs": total}
        for form, opts, out_bytes in (("int32", EPILOGUE_GRID[0][1], 4),
                                      ("payload24", EPILOGUE_GRID[1][1], 3)):
            args, kw = _epilogue_case(y, full, seeds, opts)
            for _ in range(3):
                ep.epilogue(*args, **kw)
                ep.epilogue_reference(*args, **kw)
            torch.cuda.synchronize()
            t = {"call_ms": _median_ms(lambda: ep.epilogue(*args, **kw)),
                 "plain_ms": _median_ms(lambda: ep.epilogue_reference(*args, **kw))}
            t.update(_pass_ms(lambda: ep.epilogue(*args, **kw)))
            seen = [t[k] for k in ("pass1_ms", "pass2_ms") if t[k] is not None]
            t["ms"] = sum(seen) if len(seen) == 2 else t["call_ms"]
            t["bound_ms"] = _epilogue_bound_ms(files, C, total, out_bytes)
            t["two_read_floor_ms"] = _epilogue_bound_ms(files, C, total, out_bytes, reads=2)
            # each pass's bytes (y read once; pass 2 also writes the codes)
            # over its profiler time
            for k, nbytes in (("pass1", 4), ("pass2", 4 + out_bytes)):
                ms = t[f"{k}_ms"]
                t[f"{k}_tb_per_s"] = (None if not ms
                                      else files * C * total * nbytes / (ms * 1e-3) / 1e12)
            row[form] = t
            passes = ", ".join(
                f"{name} not measured" if t[f"{k}_ms"] is None else
                f"{name} {t[f'{k}_ms']:.4f} ms = {t[f'{k}_tb_per_s']:.3f} TB/s"
                for k, name in (("pass1", "pass 1 (DC sum)"), ("pass2", "pass 2 (finish)")))
            print(f"epilogue 11b: {label} {files}x{C}x{total} whole files {form}: {passes}, "
                  f"the pair {t['ms']:.4f} ms (torch.profiler; the call's CUDA events if it "
                  f"saw no kernel); one call {t['call_ms']:.4f} ms, twin {t['plain_ms']:.3f} "
                  f"ms (CUDA events); bound {t['bound_ms']:.4f} ms (y read once, bytes), "
                  f"two-read floor {t['two_read_floor_ms']:.4f} ms (median of 10) [{card}]",
                  flush=True)
        per_shape.append(row)
        del y
        torch.cuda.empty_cache()

    # launches per graph, and no twin on the card
    files, C, frames = ROWS_JOB
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = 0.25 * torch.randn((files, C, frames), generator=gen, device=dev)
    valid = torch.full((files,), frames, dtype=torch.int32, device=dev)
    seeds = torch.arange(1, files + 1, dtype=torch.int32, device=dev)
    cfg = ProcessingConfig(output_dir="/nonexistent", target_rate=48000, quality="high")
    twin = ep.epilogue_reference

    def no_twin(*a, **k):
        raise AssertionError("_epilogue ran the twin on a CUDA tensor")
    per_graph = {}
    ep.epilogue_reference = no_twin
    try:
        for name, kw in (("packed", {}), ("rows", {"rows_layout": True})):
            n0 = ep.launches
            tg.process_batch(x, valid, cfg, 44100, seeds, **kw)
            torch.cuda.synchronize()
            per_graph[name] = ep.launches - n0
    finally:
        ep.epilogue_reference = twin
    print(f"epilogue 11b: launches per graph {per_graph} (the twin never ran) [{card}]",
          flush=True)
    graph_prof = _graph_profile_fresh()
    if any(n != 1 for n in per_graph.values()):
        raise AssertionError(f"epilogue 11b: launches per graph {per_graph}, expected 1")
    del x
    torch.cuda.empty_cache()

    # (c) this run's graphs beside the eager epilogue's
    for key, r in GRAPH_READINGS.items():
        print(f"epilogue 11c: {key}: {json.dumps(r)} [{card}]", flush=True)
    print(f"epilogue 11c: the eager epilogue's graphs (PERF.md section 5): {EAGER_GRAPHS}",
          flush=True)
    head = per_shape[0]["int32"]
    return {"max_abs_err": max_err, "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "per_shape": per_shape, "per_graph": per_graph,
            "graph_profile": graph_prof}


#: phase 12's presets, and the pairs it adds to the studio rates' 30: the
#: NTSC pull-down both ways, 192k down to it, and `tests/test_sweep.py`'s
#: arbitrary varispeed ratio
SWEEP_PRESETS = ("low", "medium", "high", "ultra")
SWEEP_VARISPEED = ((44100, 44056), (44056, 44100), (192000, 44056), (44100, 42735))
#: 12a's input: signals x frames
SWEEP_SHAPE = (2, 16384)
#: 12c's batch: files x channels x seconds at the input rate (the slice's)
SWEEP_WIDTH = (8, 2, 60)
#: 12e's two files, seconds
SWEEP_JOB_SECONDS = (5.0, 7.3)
#: phase 12's wall time on the card, at most
SWEEP_BUDGET_S = 240.0


def _sweep_pairs() -> list[tuple[int, int]]:
    from f9tpu_torch.models.filters import STANDARD_RATES

    return [(a, b) for a in STANDARD_RATES for b in STANDARD_RATES if a != b]


def _sweep_banks() -> list[tuple[int, int, str, str]]:
    """12a's banks, (rate_in, rate_out, quality, kind): the 30 studio pairs
    at the four sinc presets, at minphase high and at lagrange, then the
    varispeed pairs at the four presets."""
    pairs = _sweep_pairs()
    banks = [(a, b, q, "sinc") for a, b in pairs for q in SWEEP_PRESETS]
    banks += [(a, b, "high", "minphase") for a, b in pairs]
    banks += [(a, b, "high", "lagrange") for a, b in pairs]
    banks += [(a, b, q, "sinc") for a, b in SWEEP_VARISPEED for q in SWEEP_PRESETS]
    return banks


def _bank_name(ri: int, ro: int, q: str, kind: str) -> str:
    return f"{ri}->{ro} {q}" + ("" if kind == "sinc" else f" {kind}")


def _plan_text(bank) -> str:
    from f9tpu_torch.ops import src_kernel as sk

    plan = sk.kernel_plan(bank)
    geo = f"L={bank.L} M={bank.M} W={bank.W} R={sk._overlap_rows(bank)}"
    if plan is None:
        return geo + ", no plan"
    form = (f"pitch={plan.pitch} group={plan.group}" if plan.pitch
            else f"skew={plan.skew} rowmap={plan.rowmap}")
    return (f"{geo}; nt={plan.nt} tiles={len(plan.bands)} warps={plan.warps} {form} "
            f"smem={plan.smem_bytes} B")


def _sweep_route(bank) -> tuple[str, tuple[int, int, int]]:
    """The route `kernel_applicable`, `fold_batch_applicable` and the plan
    give a bank, and the launch counts (every `cycle_src` launch, the
    windowed form's, the `cycle_fold` flat form's) one call must read."""
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import src_kernel as sk

    if not sk.kernel_applicable(bank):
        if bank.G is None:
            return "gather", (0, 0, 0)
        return ("fold (L = 1)", (0, 0, 1)) if cf.fold_batch_applicable(bank) else \
            ("matmul (L < 8)", (0, 0, 0))
    return ("windowed", (1, 1, 0)) if sk.kernel_plan(bank).pitch else ("dense", (1, 0, 0))


def _sweep_input(ri: int, frames: int):
    """12a's input at rate ``ri``: noise at 0.3 from `SEED` plus a 997 Hz
    tone at 0.25, (2, frames) float32."""
    import numpy as np

    noise = np.random.default_rng(SEED + 12).standard_normal((SWEEP_SHAPE[0], frames))
    t = np.arange(frames) / ri
    return (0.3 * noise + 0.25 * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)


def _twin_rows(x, bank):
    """The kernel's plain twin on ``x``'s device, flat ``(signals, out_len)``."""
    from f9tpu_torch.ops import src_kernel as sk

    yt, out_len = sk.resample_rows_reference(x, bank)
    return yt.reshape(x.shape[0], -1)[:, :out_len]


def _sweep_accuracy(card: str, dev, banks: dict) -> dict:
    """12a: every bank through `resample_rates` on the card: exact length,
    <= -120 dB against the float64 oracle, the route read from the launch
    counters (as `kernel_applicable` and `fold_batch_applicable` say), each
    `cycle_src` bank within `TWIN_TOL` of its plain twin on the card and
    each flat-fold bank bit for bit its twin."""
    import torch

    from f9tpu_torch.models import resample_oracle
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr
    from f9tpu_torch.ops import src_kernel as sk

    frames = SWEEP_SHAPE[1]
    routes: dict[str, int] = {}
    launches = [0, 0, 0]
    worst_db, max_err = -1e9, {"dense": 0.0, "windowed": 0.0}
    faults = []
    for (ri, ro, q, kind), bank in banks.items():
        name = _bank_name(ri, ro, q, kind)
        x_np = _sweep_input(ri, frames)
        x = torch.from_numpy(x_np).to(dev)
        route, want = _sweep_route(bank)
        _zero_counts()
        y = tr.resample_rates(x, ri, ro, quality=q, kind=kind)
        torch.cuda.synchronize()
        got = (sk.launches, sk.launches_windowed, cf.launches_flat)
        for i, n in enumerate(got):
            launches[i] += n
        ref = resample_oracle(x_np, ri, ro, quality=q, kind=kind)
        db = _db(y.cpu().numpy() - ref, ref) if tuple(y.shape) == ref.shape else 0.0
        err = float((y - _twin_rows(x, bank)).abs().max()) if want[0] else None
        if want[2]:         # the flat fold: bit for bit its twin on the padded signal
            n, Q, keep, pad_front, pad_back = tr._cycle_budget(frames, bank, None)
            twin = tr._presliced_fold(torch.nn.functional.pad(x[:, :keep], (pad_front, pad_back)),
                                      bank, Q)[:, :n]
            if not _nan_bitwise(y, twin):
                faults.append(f"{name}: the flat fold differs from its twin")
        print(f"sweep 12a: {name}: {_plan_text(bank)}; route {route}, launches {got} "
              f"(want {want}); out_len {y.shape[-1]} (exact {bank.out_len(frames)}); "
              f"oracle {db:.1f} dB; vs twin "
              f"{'-' if err is None else f'{err:.3e}'}", flush=True)
        if tuple(y.shape) != (SWEEP_SHAPE[0], bank.out_len(frames)):
            faults.append(f"{name}: shape {tuple(y.shape)}")
        if got != want:
            faults.append(f"{name}: launches {got}, route {route} wants {want}")
        if not db <= ORACLE_DB_MAX:
            faults.append(f"{name}: {db:.1f} dB vs oracle")
        if err is not None and not err <= TWIN_TOL:
            faults.append(f"{name}: kernel vs twin {err:.3e}")
        routes[f"{kind} {route}"] = routes.get(f"{kind} {route}", 0) + 1
        worst_db = max(worst_db, db)
        if err is not None:
            max_err[route] = max(max_err[route], err)
    print(f"sweep 12a: {len(banks)} banks of 2 x {frames} frames, routes {routes}, worst "
          f"{worst_db:.1f} dB vs oracle, kernel vs twin max abs {max_err} (tol "
          f"{TWIN_TOL:g}), launches (all, windowed, flat fold) {tuple(launches)} [{card}]",
          flush=True)
    _raise_faults("sweep 12a", faults)
    return {"launches": tuple(launches), "max_abs_err": max_err}


def _raise_faults(tag: str, faults: list[str]) -> None:
    """Print every fault a sub-phase found, then fail it."""
    for fault in faults:
        print(f"{tag}: FAULT {fault}", flush=True)
    if faults:
        raise AssertionError(f"{tag}: {len(faults)} faults, the first: {faults[0]}")


def _three_counts(Q: int) -> tuple[int, int, int]:
    """Three unequal cycle counts that add up to ``Q >= 7``."""
    a = max(1, Q // 6)
    b = max(a + 1, Q // 3)
    return a, b, Q - a - b


def _sweep_chunks(card: str, dev, banks: dict) -> None:
    """12b: for every kernel bank, `resample_presliced` of the whole padded
    signal against three haloed chunks of unequal cycle counts:
    `torch.equal` (the chunk-invariance contract on every plan variant).
    The signal is 12a's, made long enough for at least 8 cycles."""
    import torch

    from f9tpu_torch.ops import src_kernel as sk
    from f9tpu_torch.ops.resample import resample_presliced

    n, faults = 0, []
    for (ri, ro, q, kind), bank in banks.items():
        if not sk.kernel_applicable(bank):
            continue
        frames = max(SWEEP_SHAPE[1], 8 * bank.M)
        x = torch.from_numpy(_sweep_input(ri, frames)).to(dev)
        Q = -(-bank.out_len(frames) // bank.L)
        xp = torch.zeros((x.shape[0], (Q - 1) * bank.M + bank.W), device=dev)
        keep = min(frames, xp.shape[-1] - bank.pad_front)
        xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
        whole = resample_presliced(xp, bank, Q)
        outs, q0 = [], 0
        counts = _three_counts(Q)
        for c in counts:
            outs.append(resample_presliced(
                xp[:, q0 * bank.M:q0 * bank.M + (c - 1) * bank.M + bank.W], bank, c))
            q0 += c
        got = torch.cat(outs, dim=-1)
        torch.cuda.synchronize()
        same = torch.equal(got, whole)
        print(f"sweep 12b: {_bank_name(ri, ro, q, kind)}: {Q} cycles whole vs chunks of "
              f"{counts}: equal {same}", flush=True)
        if not same:
            faults.append(f"{_bank_name(ri, ro, q, kind)}: chunks of {counts} differ from "
                          f"whole ({int((got != whole).sum())} outputs)")
        n += 1
    print(f"sweep 12b: {n} kernel banks, chunked == whole on {n - len(faults)} [{card}]",
          flush=True)
    _raise_faults("sweep 12b", faults)


def _sweep_full_width(card: str, dev, banks: dict) -> float:
    """12c: every sinc kernel bank of the studio pairs at the slice's batch
    shape, 8 stereo signals x 60 s at its input rate: the kernel against the
    float64 twin on the card (over 4 signals at a time), its device time
    (CUDA events, median of 5), `_src_bound` and the share of it.  Returns
    the largest difference from the twin."""
    import numpy as np
    import torch

    from f9tpu_torch.models.filters import STANDARD_RATES
    from f9tpu_torch.ops import src_kernel as sk

    files, C, seconds = SWEEP_WIDTH
    signals = files * C
    rows, faults = [], []
    for ri in STANDARD_RATES:
        mine = [(key, b) for key, b in banks.items()
                if key[0] == ri and key[1] in STANDARD_RATES and key[3] == "sinc"
                and sk.kernel_applicable(b)]
        if not mine:
            continue
        frames = seconds * ri
        gen = torch.Generator(device=dev).manual_seed(SEED + ri)
        f = 80.0 + 5920.0 * torch.rand((signals, 1), generator=gen, device=dev,
                                       dtype=torch.float64)
        t = torch.arange(frames, device=dev, dtype=torch.float64) / ri
        x = (0.3 * torch.sin(2 * np.pi * f * t) + 0.02 * torch.randn(
            (signals, frames), generator=gen, device=dev, dtype=torch.float64)).float()
        del f, t
        for (_, ro, q, kind), bank in mine:
            y = sk.resample_kernel(x, bank)
            err = 0.0
            for s in range(0, signals, 4):
                err = max(err, float((y[s:s + 4] - _twin_rows(x[s:s + 4], bank)).abs().max()))
            out_len = y.shape[-1]
            del y
            ms = _median_ms(lambda: sk.resample_kernel(x, bank), runs=5)
            bound_ms, bound_by = _src_bound(bank, signals, frames, out_len)
            row = {"bank": _bank_name(ri, ro, q, kind), "ms": ms, "share": bound_ms / ms,
                   "max_abs_err": err}
            rows.append(row)
            print(f"sweep 12c: {row['bank']} {signals} x {frames} frames ({_plan_text(bank)}): "
                  f"kernel {ms:.4f} ms (median of 5), bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * row['share']:.1f} % of it; vs twin {err:.3e} (tol {TWIN_TOL:g}) "
                  f"[{card}]", flush=True)
            if not err <= TWIN_TOL:
                faults.append(f"{row['bank']}: kernel vs twin {err:.3e}")
        del x
        torch.cuda.empty_cache()
    slow = max(rows, key=lambda r: r["ms"])
    low = min(rows, key=lambda r: r["share"])
    print(f"sweep 12c: {len(rows)} banks; slowest {slow['bank']} {slow['ms']:.4f} ms; lowest "
          f"share {low['bank']} {100 * low['share']:.1f} % of its bound [{card}]", flush=True)
    _raise_faults("sweep 12c", faults)
    return max(r["max_abs_err"] for r in rows)


def _sweep_quality(card: str, dev) -> None:
    """12d: `f9tpu_torch.tools.gen_quality` on the card over its whole
    matrix, every figure held to `docs/QUALITY.md` (parsed) within the
    tool's tolerances (`gen_quality.compare`)."""
    from f9tpu_torch.tools import gen_quality as gq

    text = gq.render(dev)
    for line in text.splitlines():
        if line.startswith("## ") or (line.startswith("| ") and "·Nyq" in line):
            print(f"quality 12d: {line}", flush=True)
    got = gq.read_tables(text)
    with open(os.path.join(ROOT, "docs", "QUALITY.md")) as fh:
        want = gq.read_tables(fh.read())
    faults = gq.compare(got, want)
    n = sum(len(rows) for rows in got.values())
    print(f"quality 12d: {n} rows in {len(got)} tables against docs/QUALITY.md: "
          f"{len(faults)} outside the tolerances [{card}]", flush=True)
    if n != len(gq.PAIRS) * len(gq.SECTIONS):
        faults.append(f"{n} rows, not {len(gq.PAIRS) * len(gq.SECTIONS)}")
    _raise_faults("quality 12d", faults)


def _sweep_jobs(card: str, dev) -> dict:
    """12e: per studio pair at high, one in-process `BatchProcessor.run` on
    the card over two stereo 24-bit WAVs of 5 s and 7.3 s at the input rate
    (calibration, the bucket, the SRC route, the epilogue pair), then the
    same job on the port's CPU path: every output at the exact length and
    within `LSB_TOL` of the CPU's bytes.  Returns the launches (every SRC
    launch, the epilogue pair's)."""
    import numpy as np

    from f9tpu_torch import resolve_device
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import wav
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import epilogue as ep
    from f9tpu_torch.ops import src_kernel as sk
    from f9tpu_torch.pipeline import BatchProcessor, build_output_path

    rng = np.random.default_rng(SEED + 120)
    cpu = resolve_device("cpu")
    src_total, flat_total, ep_total, worst = 0, 0, 0, 0
    faults = []
    for ri, ro in _sweep_pairs():
        bank = design_cycle_bank(ri, ro, quality="high")
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        try:
            paths = []
            for i, sec in enumerate(SWEEP_JOB_SECONDS):
                p = os.path.join(work, f"take{i}.wav")
                wav.write_wav(p, _signal(rng, 2, int(sec * ri), ri), ri, bits=24)
                paths.append(p)
            outs = {}
            for tag, d in (("card", dev), ("cpu", cpu)):
                cfg = ProcessingConfig(output_dir=os.path.join(work, tag), target_rate=ro,
                                       quality="high", batch_size=2, seed=0)
                _zero_counts()
                res = BatchProcessor(cfg, device=d).run(paths)
                if tag == "card":
                    n_src, n_flat, n_ep = sk.launches, cf.launches_flat, ep.launches
                if res.completed != 2:
                    raise AssertionError(f"sweep 12e: {ri}->{ro} {tag}: {res.completed} of 2")
                outs[tag] = [_read_codes(build_output_path(p, cfg.output_dir, cfg.postfix))
                             for p in paths]
            lens, diffs = [], []
            for p, (g, g_rate), (c, c_rate) in zip(paths, outs["card"], outs["cpu"]):
                n_in = wav.read_wav(p)[0].shape[-1]
                lens.append((g.shape[-1], bank.out_len(n_in)))
                if g_rate != ro or c_rate != ro or g.shape != c.shape \
                        or g.shape[-1] != bank.out_len(n_in):
                    faults.append(f"{ri}->{ro}: frames {g.shape} / {c.shape}, exact "
                                  f"{bank.out_len(n_in)}")
                    continue
                diffs.append(int(np.abs(g - c).max()))
            worst = max([worst] + diffs)
            src_total += n_src
            flat_total += n_flat
            ep_total += n_ep
            want_src, want_flat = sk.kernel_applicable(bank), cf.fold_batch_applicable(bank)
            print(f"sweep 12e: {ri}->{ro} high (L={bank.L}): frames (got, exact) {lens}; card vs "
                  f"CPU max {diffs} LSB (tol {LSB_TOL}); SRC launches {n_src}, flat fold "
                  f"{n_flat}, epilogue {n_ep}", flush=True)
            if max(diffs, default=0) > LSB_TOL:
                faults.append(f"{ri}->{ro}: card vs CPU {diffs} LSB")
            if n_ep < 1 or (n_src >= 1) != want_src or (n_flat >= 1) != want_flat:
                faults.append(f"{ri}->{ro}: launches SRC {n_src}, flat fold {n_flat}, epilogue "
                              f"{n_ep} (cycle_src takes the bank: {want_src}, the flat fold: "
                              f"{want_flat})")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"sweep 12e: {len(_sweep_pairs())} pairs, card vs CPU max {worst} LSB; launches SRC "
          f"{src_total}, flat fold {flat_total}, epilogue {ep_total} [{card}]", flush=True)
    _raise_faults("sweep 12e", faults)
    return {"src": src_total, "flat_fold": flat_total, "epilogue": ep_total}


def phase_sweep(card: str, dev) -> dict:
    """Phase 12, every rate pair, preset and filter kind on the card: 12a
    accuracy and route, 12b chunked == whole, 12c full width, 12d the
    quality tool, 12e the batch job per pair; each sub-phase's wall and the
    total, held to `SWEEP_BUDGET_S`.  Returns the numbers for the JSON
    summary."""
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import src_kernel as sk

    t_all = time.time()
    banks = {key: design_cycle_bank(key[0], key[1], quality=key[2], kind=key[3])
             for key in _sweep_banks()}
    walls = {"design": time.time() - t_all}
    out, failed = {}, []
    for sub, fn in (("12a", lambda: _sweep_accuracy(card, dev, banks)),
                    ("12b", lambda: _sweep_chunks(card, dev, banks)),
                    ("12c", lambda: _sweep_full_width(card, dev, banks)),
                    ("12d", lambda: _sweep_quality(card, dev)),
                    ("12e", lambda: _sweep_jobs(card, dev))):
        t0 = time.time()
        try:
            out[sub] = fn()
        except AssertionError as e:     # the other sub-phases still run
            failed.append(f"{sub}: {e}")
        walls[sub] = time.time() - t0
        print(f"phase {sub}: {walls[sub]:.1f} s", flush=True)
    total = time.time() - t_all
    print(f"phase 12 (sweep): {total:.1f} s (budget {SWEEP_BUDGET_S:g}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" [{card}]", flush=True)
    if total > SWEEP_BUDGET_S:
        failed.append(f"{total:.1f} s > {SWEEP_BUDGET_S:g} s")
    if failed:
        raise AssertionError("phase 12: " + "; ".join(failed))
    kernel = [b for b in banks.values() if sk.kernel_applicable(b)]
    windowed = sum(bool(sk.kernel_plan(b).pitch) for b in kernel)
    return {
        "dense_banks": len(kernel) - windowed, "windowed_banks": windowed,
        "dense_err": max(out["12a"]["max_abs_err"]["dense"], out["12c"]),
        "windowed_err": out["12a"]["max_abs_err"]["windowed"],
        "launches": out["12a"]["launches"], "job": out["12e"], "seconds": total}


#: phase 13, the config-interaction fuzz at card scale: the seeds of
#: `tests/test_torch_fuzz_configs.py` (batch), `tests/test_torch_fuzz_stream.py`
#: (stream, sharded stream); each draws its configuration as the JAX test
#: does, then its sources at card scale from a second generator
FUZZ_BATCH_SEEDS = tuple(range(1000, 1024))
FUZZ_STREAM_SEEDS = tuple(range(7000, 7008))
FUZZ_SHARDED_SEEDS = tuple(range(9000, 9005))
#: 13a: files of 5-20 s, the buckets scaled as the JAX test's (2048, 8192)
#: are to its files of 500-6000 frames, and an oversized file of 30 s past
#: the largest bucket (the JAX test's 12,000 frames past 8192)
FUZZ_SECONDS = (5.0, 20.0)
FUZZ_BUCKETS = (1 << 19, 1 << 20)
FUZZ_OVERSIZED_S = 30.0
#: 13b / 13c: the JAX tests' source lengths times these, and their chunk
#: sizes (0.11 and 0.34 s; 0.4 and 0.1 s sharded) times 10
FUZZ_STREAM_SCALE = 30
FUZZ_SHARDED_SCALE = 20
FUZZ_STREAM_CHUNKS = (1.1, 3.4)
FUZZ_SHARDED_CHUNKS = (4.0, 1.0)
#: phase 13 alone took 95 s on an H100 (13a 87 s, 75 of them the CPU path); the whole
#: script ran phase 12 23 % slower than alone
FUZZ_BUDGET_S = 150.0


def _fuzz_cfg(rng) -> dict:
    """`tests/test_fuzz_configs.py::_random_cfg`, draw for draw (the chain as
    the flag ``"chain"``)."""
    kw = dict(quality="low", batch_size=4, bucket_frames=(2048, 8192))
    kw["target_rate"] = int(rng.choice([44100, 48000, 32000, 44056]))
    kw["bits"] = int(rng.choice([16, 24, 32]))
    kw["dither"] = bool(rng.integers(2))
    kw["remove_dc"] = bool(rng.integers(2))
    kw["gain_db"] = float(rng.choice([0.0, -6.0, 3.0]))
    kw["seed"] = int(rng.integers(100))
    kw["output_format"] = str(rng.choice(["wav", "aiff"]))
    if kw["output_format"] == "aiff" and kw["bits"] == 32:
        kw["bits"] = 24
    kw["device_layout"] = str(rng.choice(["packed", "rows"]))
    if rng.integers(2):
        kw.update(reverb_mode=True, noise_floor_db=-90.0,
                  tail_mode=str(rng.choice(["peak", "rms"])))
    kw["chain"] = bool(rng.integers(3) == 0)
    if rng.integers(3) == 0:
        kw["output_channels"] = 2
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = float(rng.choice([-14.0, -20.0, -24.0]))
        if rng.integers(2):
            kw["normalize_tp_db"] = -1.0
        kw["surround_weights"] = bool(rng.integers(2))
    return kw


def _fuzz_batch_draw(seed: int):
    """The JAX batch trial's draws: ``(files, kw)``, each file ``(name,
    channels, bits, dc)``; the config is the CPU test's for this seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    files = []
    for i in range(int(rng.integers(2, 5))):
        ch = int(rng.choice([1, 2]))
        rng.standard_normal((ch, int(rng.integers(500, 6000))))
        dc = bool(rng.integers(2))
        files.append((f"f{i}.wav", ch, int(rng.choice([16, 24, 32])), dc))
    kw = _fuzz_cfg(rng)
    kw["oversized"] = bool(rng.integers(3) == 0 and not kw.get("reverb_mode", False))
    if kw["oversized"]:
        files.append(("big.wav", 2, 24, False))
    return files, kw


def _fuzz_draw_stream(seed: int, sharded: bool):
    """The JAX stream (or sharded-stream) trial's draws: ``(channels, frames,
    container, kw, latency)``; the chain, for the sharded draws, as a flag."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ch = int(rng.choice([1, 2, 4]))
    frames = int(rng.integers(20_000, 50_000) if sharded else rng.integers(3000, 30_000))
    rng.standard_normal((ch, frames))
    container = str(rng.choice(["wav", "aiff"] if sharded else ["wav", "aiff", "flac", "mp3"]))
    kw = dict(quality="low", target_rate=int(rng.choice([48000, 32000, 44056])))
    if not sharded:
        kw["kind"] = str(rng.choice(["sinc", "minphase"]))
    kw.update(bits=int(rng.choice([16, 24])), dither=bool(rng.integers(2)),
              remove_dc=bool(rng.integers(2)), seed=int(rng.integers(100)),
              gain_db=float(rng.choice([0.0, -3.0])))
    if not sharded:
        kw["output_format"] = str(rng.choice(["wav", "aiff", "flac"]))
    lat = int(rng.integers(1, 300)) if rng.integers(2) else 0
    if ch == 1 and rng.integers(2):
        kw["output_channels"] = 2
    elif ch == 4 and rng.integers(2):
        kw["channel_routing"] = [3, 0, -1, 1]
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = -18.0
    if sharded:
        kw["chain"] = bool(rng.integers(2))
    if rng.integers(3) == 0:
        kw.update(reverb_mode=True, noise_floor_db=-85.0, max_tail_seconds=0.3)
    return ch, frames, container, kw, lat


def _fuzz_config(kw: dict, out_dir: str, chain_kind: str):
    """The port's config for drawn keywords; the chain is the JAX test's
    (``"saturator"``: Gain + Saturator; ``"delay"``: Gain + Delay)."""
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.ops import chain as tc

    kw = {k: v for k, v in kw.items() if k != "oversized"}
    if kw.pop("chain", False):
        kw["chain"] = tc.Chain(tc.Gain(-1.5), tc.Saturator("soft", 3.0, 0.7)
                               if chain_kind == "saturator" else tc.Delay(0.002))
    return ProcessingConfig(output_dir=out_dir, **kw)


def _fuzz_codes(path: str, bits: int):
    """(channels, frames) codes at ``bits`` and the rate of any output file;
    32-bit WAV data read as int32 (a float32 decode would round it)."""
    import numpy as np

    from f9tpu_torch.io import codec

    y, rate = codec.read_audio(path)
    if bits == 32:
        with open(path, "rb") as f:
            blob = f.read()
        start = blob.index(b"data") + 8
        c = np.frombuffer(blob[start:start + 4 * y.size], "<i4").reshape(-1, y.shape[0]).T
        return c.astype(np.int64), rate
    return np.round(np.asarray(y, np.float64) * (1 << (bits - 1))).astype(np.int64), rate


def _lsb24(card_codes, cpu_codes, bits: int) -> tuple[float, float, float]:
    """Card against CPU codes in LSB at 24-bit resolution (a 32-bit code is
    1/256 of one; a 16-bit code one, as the batch tests count it): the
    largest gap, the largest below -12 dBFS, and the level (|y|, 1 at full
    scale) where the largest sits."""
    import numpy as np

    if card_codes.size == 0:
        return 0.0, 0.0, 0.0
    unit = float(1 << max(0, bits - 24))
    gap = np.abs(card_codes - cpu_codes)
    quiet = np.abs(cpu_codes) < (1 << (bits - 3))
    at = np.unravel_index(int(np.argmax(gap)), gap.shape)
    return (float(gap.max()) / unit, float(gap[quiet].max(initial=0)) / unit,
            float(abs(cpu_codes[at])) / (1 << (bits - 1)))


def _fuzz_counts() -> tuple[int, int, int]:
    """(dense, windowed, epilogue) launches since `_zero_counts`."""
    from f9tpu_torch.ops import epilogue as ep
    from f9tpu_torch.ops import src_kernel as sk

    return sk.launches - sk.launches_windowed, sk.launches_windowed, ep.launches


def _route_faults(tag: str, bank, counts) -> list[str]:
    """A run must launch the epilogue pair, and the SRC form that
    ``bank`` takes (`kernel_applicable`, a windowed plan or a dense one)."""
    from f9tpu_torch.ops import src_kernel as sk

    dense, win, ep = counts
    faults = [] if ep >= 1 else [f"{tag}: no epilogue launch"]
    if sk.kernel_applicable(bank):
        windowed = bool(sk.kernel_plan(bank).pitch)
        if (win if windowed else dense) < 1:
            faults.append(f"{tag}: no {'windowed' if windowed else 'dense'} SRC launch "
                          f"(launches dense, windowed, epilogue {counts})")
    return faults


def _fuzz_noise(rng, ch: int, frames: int, level: float, dc: bool = False):
    import numpy as np

    x = (level * rng.standard_normal((ch, frames))).astype(np.float32)
    return x + np.float32(0.05) if dc else x


def _fuzz_batch(card: str, dev, cpu) -> dict:
    """13a: each of the 24 batch configurations through `BatchProcessor.run`
    on the card and on the port's CPU path over the same 5-20 s files: the
    same completions, names and frame counts, each card output at the target
    rate, card vs CPU <= `LSB_TOL` (<= `LOOP_LSB_TOL` with a chain or
    reverb), and the launches of the route the bank takes.  Returns the
    launches (dense, windowed, epilogue) and the worst gap."""
    import numpy as np

    from f9tpu_torch.io import wav
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.pipeline import BatchProcessor

    total, faults = [0, 0, 0], []
    worst = {"plain": 0.0, "chain or reverb": 0.0, "below -12 dBFS": 0.0}
    for seed in FUZZ_BATCH_SEEDS:
        files, kw = _fuzz_batch_draw(seed)
        rng = np.random.default_rng(SEED + seed)
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        try:
            paths = []
            for name, ch, bits, dc in files:
                frames = (int(FUZZ_OVERSIZED_S * 44100) if name == "big.wav" else
                          int(rng.integers(FUZZ_SECONDS[0] * 44100, FUZZ_SECONDS[1] * 44100)))
                p = os.path.join(work, name)
                wav.write_wav(p, _fuzz_noise(rng, ch, frames, 0.2 if name == "big.wav" else 0.3,
                                             dc), 44100, bits=bits)
                paths.append(p)
            runs = {}
            for side, d in (("card", dev), ("cpu", cpu)):
                cfg = _fuzz_config(dict(kw, bucket_frames=FUZZ_BUCKETS),
                                   os.path.join(work, side), "saturator")
                if side == "card":
                    _zero_counts()
                t0 = time.time()
                res = BatchProcessor(cfg, device=d).run(paths)
                wall = time.time() - t0
                if side == "card":
                    counts = _fuzz_counts()
                outs = sorted(f for f in os.listdir(cfg.output_dir)
                              if f.endswith((".wav", ".aiff")))
                runs[side] = (res, outs, wall)
            loose = kw["chain"] or kw.get("reverb_mode", False)
            tol = LOOP_LSB_TOL if loose else LSB_TOL
            gaps, tag = [], f"seed {seed}"
            for name in ("card", "cpu"):
                res, outs, _ = runs[name]
                if res.completed != len(paths) or res.failed:
                    faults.append(f"{tag} {name}: {res.completed} of {len(paths)} completed, "
                                  f"{res.failed} failed")
            if runs["card"][1] != runs["cpu"][1] or len(runs["card"][1]) != len(paths):
                faults.append(f"{tag}: outputs {runs['card'][1]} vs {runs['cpu'][1]}")
            streamed = [p for p in paths if runs["card"][0].per_file.get(p, {}).get("streamed")]
            if streamed != (paths[-1:] if kw["oversized"] else []):
                faults.append(f"{tag}: streamed {streamed}, oversized drawn {kw['oversized']}")
            for f in runs["card"][1]:
                g, g_rate = _fuzz_codes(os.path.join(work, "card", f), kw["bits"])
                try:
                    c, c_rate = _fuzz_codes(os.path.join(work, "cpu", f), kw["bits"])
                except (OSError, ValueError) as e:
                    faults.append(f"{tag} {f}: no CPU output ({e})")
                    continue
                if g_rate != kw["target_rate"] or c_rate != g_rate or g.shape != c.shape:
                    faults.append(f"{tag} {f}: card {g.shape} at {g_rate}, CPU {c.shape} "
                                  f"at {c_rate}")
                    continue
                gaps.append(_lsb24(g, c, kw["bits"]))
            gap, quiet, level = max(gaps, default=(0.0, 0.0, 0.0))
            quiet = max((q for _, q, _ in gaps), default=0.0)
            key = "chain or reverb" if loose else "plain"
            worst[key] = max(worst[key], gap)
            worst["below -12 dBFS"] = max(worst["below -12 dBFS"], quiet)
            bank = design_cycle_bank(44100, kw["target_rate"], quality="low")
            faults += _route_faults(tag, bank, counts)
            total = [a + b for a, b in zip(total, counts)]
            print(f"fuzz 13a: {tag}: {len(paths)} files -> {kw['target_rate']} Hz "
                  f"{kw['bits']}-bit {kw['output_format']} {kw['device_layout']}"
                  f"{' dither' if kw['dither'] else ''}{' dc' if kw['remove_dc'] else ''}"
                  f" gain {kw['gain_db']:+.0f}{' chain' if kw['chain'] else ''}"
                  f"{' reverb/' + kw['tail_mode'] if kw.get('reverb_mode') else ''}"
                  f"{' fan-out' if kw.get('output_channels') else ''}"
                  f"{' lufs ' + str(kw['normalize_lufs']) if kw.get('normalize_lufs') else ''}"
                  f"{' tp' if kw.get('normalize_tp_db') else ''}"
                  f"{' oversized' if kw['oversized'] else ''}: card {runs['card'][2]:.2f} s, "
                  f"CPU {runs['cpu'][2]:.2f} s; card vs CPU max {gap:g} LSB (tol {tol}) at |y| "
                  f"{level:.3f}, below -12 dBFS {quiet:g}; "
                  f"launches (dense, windowed, epilogue) {counts} [{card}]", flush=True)
            if gap > tol:
                faults.append(f"{tag}: card vs CPU {gap:g} LSB > {tol}")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"fuzz 13a: {len(FUZZ_BATCH_SEEDS)} configurations; card vs CPU worst {worst} LSB; "
          f"launches {tuple(total)} [{card}]", flush=True)
    _raise_faults("fuzz 13a", faults)
    return {"launches": total, "worst": worst}


def _fuzz_source(work: str, x, container: str) -> str:
    """The source in ``container``; MP3 through the test-only `avref`
    encoder where the machine has it, else FLAC (as the JAX test falls back)."""
    import numpy as np

    codes24 = np.clip(np.round(x.astype(np.float64) * (1 << 23)), -(1 << 23), (1 << 23) - 1)
    if container == "mp3":
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        try:
            import avref

            ok = avref.available()
        except ImportError:
            ok = False
        finally:
            sys.path.pop(0)
        if ok and x.shape[0] <= 2:
            src = os.path.join(work, "s.mp3")
            avref.encode_file_opts("libmp3lame", src, "mp3", codes24.astype(np.int32), 44100,
                                   24, bit_rate=192000)
            return src
        container = "flac"
    src = os.path.join(work, f"s.{container}")
    if container == "flac":
        from f9tpu_torch.io.flac import write_flac_codes

        write_flac_codes(src, codes24.astype(np.int64), 44100, bits=24)
    elif container == "aiff":
        from f9tpu_torch.io.aiff import write_aiff

        write_aiff(src, x, 44100, bits=24)
    else:
        from f9tpu_torch.io import wav

        wav.write_wav(src, x, 44100, bits=24)
    return src


def _fuzz_stream(card: str, dev, cpu) -> dict:
    """13b: each stream configuration on the card at two chunk sizes
    (`FUZZ_STREAM_CHUNKS`): the same frame count and sha256; then on the
    port's CPU path: the same frame count, card vs CPU <= `LSB_TOL`
    (<= `LOOP_LSB_TOL` in reverb mode).  Returns the launches and the worst
    gap."""
    import numpy as np

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.pipeline.stream import stream_resample_file

    total, worst, faults = [0, 0, 0], 0.0, []
    for seed in FUZZ_STREAM_SEEDS:
        ch, frames, container, kw, lat = _fuzz_draw_stream(seed, sharded=False)
        rng = np.random.default_rng(SEED + seed)
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        try:
            x = _fuzz_noise(rng, ch, frames * FUZZ_STREAM_SCALE, 0.3)
            src = _fuzz_source(work, x, container)
            cfg = _fuzz_config(kw, work, "saturator")
            ext = {"aiff": "aiff", "flac": "flac"}.get(cfg.output_format, "wav")
            ns, shas, walls, counts = [], [], [], [0, 0, 0]
            for cs in FUZZ_STREAM_CHUNKS:
                out = os.path.join(work, f"card_{cs}.{ext}")
                _zero_counts()
                t0 = time.time()
                ns.append(stream_resample_file(src, out, cfg, chunk_seconds=cs,
                                               latency_frames=lat, device=dev))
                walls.append(time.time() - t0)
                counts = [a + b for a, b in zip(counts, _fuzz_counts())]
                shas.append(_sha256(out))
            cpu_out = os.path.join(work, f"cpu.{ext}")
            n_cpu = stream_resample_file(src, cpu_out, cfg, chunk_seconds=FUZZ_STREAM_CHUNKS[-1],
                                         latency_frames=lat, device=cpu)
            tag = f"seed {seed}"
            g, g_rate = _fuzz_codes(out, cfg.bits)
            c, _ = _fuzz_codes(cpu_out, cfg.bits)
            gap, quiet, level = (_lsb24(g, c, cfg.bits) if g.shape == c.shape
                                 else (float("inf"),) * 3)
            tol = LOOP_LSB_TOL if cfg.reverb_mode else LSB_TOL
            worst = max(worst, gap)
            bank = design_cycle_bank(44100, cfg.target_rate, quality="low", kind=cfg.kind)
            faults += _route_faults(tag, bank, counts)
            total = [a + b for a, b in zip(total, counts)]
            print(f"fuzz 13b: {tag}: {container} ({src.rsplit('.', 1)[1]}) {ch} ch x "
                  f"{x.shape[1]} frames -> {cfg.target_rate} Hz {cfg.kind} {cfg.bits}-bit {ext}"
                  f" latency {lat}{' fan-out' if cfg.output_channels else ''}"
                  f"{' routing' if cfg.channel_routing else ''}"
                  f"{' lufs' if cfg.normalize_lufs is not None else ''}"
                  f"{' reverb' if cfg.reverb_mode else ''}: frames {ns} (CPU {n_cpu}), walls "
                  f"{[round(w, 2) for w in walls]} s, sha256 {[s[:12] for s in shas]}; card vs "
                  f"CPU max {gap:g} LSB (tol {tol}) at |y| {level:.3f}, below -12 dBFS "
                  f"{quiet:g}; launches {tuple(counts)} [{card}]",
                  flush=True)
            if ns[0] != ns[1] or shas[0] != shas[1]:
                faults.append(f"{tag}: chunk sizes {FUZZ_STREAM_CHUNKS} give {ns} frames, "
                              f"sha256 equal {shas[0] == shas[1]}")
            if n_cpu != ns[0] or g_rate != cfg.target_rate or gap > tol:
                faults.append(f"{tag}: card {ns[0]} frames at {g_rate}, CPU {n_cpu}; "
                              f"{gap:g} LSB")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"fuzz 13b: {len(FUZZ_STREAM_SEEDS)} configurations; card vs CPU worst {worst:g} "
          f"LSB; launches {tuple(total)} [{card}]", flush=True)
    _raise_faults("fuzz 13b", faults)
    return {"launches": total, "worst": worst}


def _fuzz_sharded(card: str, dev) -> dict:
    """13c: each sharded-stream configuration on a mesh that names the card
    four times (frames shards) and on the card alone: the same frame count
    and sha256.  Returns the mesh runs' launches."""
    import numpy as np

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.parallel import make_mesh
    from f9tpu_torch.pipeline.stream import stream_resample_file

    mesh = make_mesh(1, 4, devices=[dev] * 4)
    total, faults = [0, 0, 0], []
    for seed in FUZZ_SHARDED_SEEDS:
        ch, frames, container, kw, lat = _fuzz_draw_stream(seed, sharded=True)
        rng = np.random.default_rng(SEED + seed)
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        try:
            x = _fuzz_noise(rng, ch, frames * FUZZ_SHARDED_SCALE, 0.3)
            src = _fuzz_source(work, x, container)
            cfg = _fuzz_config(kw, work, "delay")
            ns, shas, walls = [], [], []
            for m, cs in zip((None, mesh), FUZZ_SHARDED_CHUNKS):
                out = os.path.join(work, f"{'one' if m is None else 'mesh'}.wav")
                _zero_counts()
                t0 = time.time()
                ns.append(stream_resample_file(src, out, cfg, chunk_seconds=cs, mesh=m,
                                               latency_frames=lat, device=dev))
                walls.append(time.time() - t0)
                if m is not None:
                    counts = _fuzz_counts()
                shas.append(_sha256(out))
            tag = f"seed {seed}"
            bank = design_cycle_bank(44100, cfg.target_rate, quality="low")
            faults += _route_faults(tag, bank, counts)
            total = [a + b for a, b in zip(total, counts)]
            print(f"fuzz 13c: {tag}: {container} {ch} ch x {x.shape[1]} frames -> "
                  f"{cfg.target_rate} Hz {cfg.bits}-bit latency {lat}"
                  f"{' chain' if cfg.chain is not None else ''}"
                  f"{' fan-out' if cfg.output_channels else ''}"
                  f"{' routing' if cfg.channel_routing else ''}"
                  f"{' lufs' if cfg.normalize_lufs is not None else ''}"
                  f"{' reverb' if cfg.reverb_mode else ''}: one device {ns[0]} frames "
                  f"{walls[0]:.2f} s, mesh 1x4x1 {ns[1]} frames {walls[1]:.2f} s; sha256 "
                  f"{[s[:12] for s in shas]}; mesh launches {counts} [{card}]", flush=True)
            if ns[0] != ns[1] or shas[0] != shas[1]:
                faults.append(f"{tag}: one device {ns[0]} frames, mesh {ns[1]}; sha256 equal "
                              f"{shas[0] == shas[1]}")
        finally:
            shutil.rmtree(work, ignore_errors=True)
    print(f"fuzz 13c: {len(FUZZ_SHARDED_SEEDS)} configurations, {ONE_CARD_NOTE.format(n=4)}; "
          f"launches {tuple(total)} [{card}]", flush=True)
    _raise_faults("fuzz 13c", faults)
    return {"launches": total}


def _fuzz_robust(card: str, dev) -> dict:
    """13d: the scheduler's robustness on the card over two stereo 24-bit
    WAVs of 10 s: a clean run; a run whose first device step raises (the
    retry, with the sleep patched out); a resume after an output's byte is
    flipped at the same size (the file is reprocessed).  The retried and the
    reprocessed bytes equal the clean run's.  Returns the launches."""
    import numpy as np

    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import wav
    from f9tpu_torch.pipeline import scheduler as sched

    rng = np.random.default_rng(SEED + 130)
    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    total, faults = [0, 0, 0], []
    try:
        paths = []
        for i in range(2):
            p = os.path.join(work, f"r{i}.wav")
            wav.write_wav(p, _signal(rng, 2, int((10.0 + i) * 44100), 44100), 44100, bits=24)
            paths.append(p)

        def run(tag, manifest=None):
            cfg = ProcessingConfig(output_dir=os.path.join(work, tag), target_rate=48000,
                                   seed=3, batch_size=2)
            _zero_counts()
            bp = sched.BatchProcessor(cfg, device=dev)
            res = bp.run(paths, manifest_path=manifest)
            counts = _fuzz_counts()
            nonlocal total
            total = [a + b for a, b in zip(total, counts)]
            if counts[0] < 1 or counts[2] < 1:
                faults.append(f"{tag}: launches {counts}")
            shas = {os.path.basename(p): _sha256(sched.build_output_path(
                p, cfg.output_dir, cfg.postfix)) for p in paths}
            return bp, res, shas

        _, res, clean = run("clean")
        calls = {"n": 0}
        real = sched.process_batch_raw

        def flaky(*a, **k):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected device step failure")
            return real(*a, **k)

        saved_sleep = sched.time.sleep
        sched.process_batch_raw, sched.time.sleep = flaky, lambda s: None
        try:
            bp, res_r, retried = run("retried")
        finally:
            sched.process_batch_raw, sched.time.sleep = real, saved_sleep
        log = bp.log.text()
        print(f"fuzz 13d: transient device failure: {res_r.completed} of 2 completed after "
              f"{calls['n']} graph calls, retry logged {'retrying once' in log}, bytes equal "
              f"to the clean run {retried == clean} [{card}]", flush=True)
        if not (res.completed == res_r.completed == 2 and calls["n"] == 2
                and "retrying once" in log and "BATCH ABORT" not in log and retried == clean):
            faults.append(f"retry: {res_r.completed} completed, {calls['n']} calls, equal "
                          f"{retried == clean}")
        mpath = os.path.join(work, "m.json")
        _, res1, first = run("resume", mpath)
        out = os.path.join(work, "resume", "r0_processed.wav")
        with open(out, "r+b") as f:
            f.seek(os.path.getsize(out) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        _, res2, again = run("resume", mpath)
        print(f"fuzz 13d: resume after a flipped byte: {res2.completed} completed, "
              f"{res2.skipped} skipped, bytes equal to the clean run {again == clean} "
              f"[{card}]", flush=True)
        if not (res1.completed == 2 and first == clean and res2.completed == 2
                and res2.skipped == 1 and again == clean):
            faults.append(f"resume: {res2.completed} completed, {res2.skipped} skipped, "
                          f"equal {again == clean}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    _raise_faults("fuzz 13d", faults)
    return {"launches": total}


def phase_fuzz(card: str, dev) -> dict:
    """Phase 13, the config-interaction fuzz on the card: 13a the batch
    configurations, 13b the stream's, 13c the sharded stream's, 13d the
    scheduler's retry and resume; each sub-phase's wall and the total, held
    to `FUZZ_BUDGET_S`.  Returns the launches by path and the worst gaps."""
    from f9tpu_torch import resolve_device

    cpu = resolve_device("cpu")
    t_all = time.time()
    walls, out, failed = {}, {}, []
    for sub, fn in (("13a", lambda: _fuzz_batch(card, dev, cpu)),
                    ("13b", lambda: _fuzz_stream(card, dev, cpu)),
                    ("13c", lambda: _fuzz_sharded(card, dev)),
                    ("13d", lambda: _fuzz_robust(card, dev))):
        t0 = time.time()
        try:
            out[sub] = fn()
        except AssertionError as e:     # the other sub-phases still run
            failed.append(f"{sub}: {e}")
        walls[sub] = time.time() - t0
        print(f"phase {sub}: {walls[sub]:.1f} s", flush=True)
    total = time.time() - t_all
    print(f"phase 13 (fuzz): {total:.1f} s (budget {FUZZ_BUDGET_S:g}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" [{card}]", flush=True)
    if total > FUZZ_BUDGET_S:
        failed.append(f"{total:.1f} s > {FUZZ_BUDGET_S:g} s")
    if failed:
        raise AssertionError("phase 13: " + "; ".join(failed))
    job = [a + b for a, b in zip(out["13a"]["launches"], out["13d"]["launches"])]
    return {"launches": {"fuzz_job": job, "fuzz_stream": out["13b"]["launches"],
                         "fuzz_sharded": out["13c"]["launches"]},
            "worst": {"job": out["13a"]["worst"], "stream": out["13b"]["worst"]},
            "trials": {"13a": len(FUZZ_BATCH_SEEDS), "13b": len(FUZZ_STREAM_SEEDS),
                       "13c": len(FUZZ_SHARDED_SEEDS), "13d": 2},
            "seconds": {**walls, "total": total}}


#: phase 14 (the chain's kernels) fails past this many seconds: 30 until the
#: dynamics kernels, then 25 more for what they added (on one H100 the
#: dynamics cases of 14b 0.9-1.0 s, 14c's envelope and windowed maximum 0.2,
#: and 14c's profiled child process 22.5-23.4, 24.6 at most)
CHAIN_KERNELS_BUDGET_S = 55.0
#: 14c's shape: the insert loop's batch at 48 kHz, 8 stereo files in the 60 s
#: capture bucket with its tail
CHAIN_SHAPE = (8, 2, 2_903_040)
#: 14a's FFT sizes: the insert loop's n, the next two `_fft_block_size`
#: picks and one n that is not a power of two
CHAIN_FFT_SIZES = (8192, 16384, 32768, 6000)
#: the card's float64 and float32 instruction rates outside the tensor cores
#: (NVIDIA H100 SXM data sheet, 700 W): 33.5 and 67 TFLOP/s count an FMA as
#: two operations, and the MAC's, the fold's and the moving average's
#: operations are separately rounded products and sums, one instruction each
FP64_INSTR_PER_S = 16.75e12
FP32_INSTR_PER_S = 33.5e12


def _chain_sum(reads: int) -> tuple[int, ...]:
    """The chain kernels' launches read since `CHAIN_READS` held ``reads``
    entries (the epilogue's `EPILOGUE_READS` keeps step with it)."""
    return tuple(sum(r[i] for r in CHAIN_READS[reads:]) for i in range(len(CHAIN_COUNTERS)))


def _bits(t):
    """The integer view of a float or complex tensor: `torch.equal` on it is
    bitwise (a -0.0 differs from +0.0, a NaN equals its own bits)."""
    import torch

    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _bitwise(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(_bits(a), _bits(b)))


def _chain_fft_premise(card: str, dev) -> list[str]:
    """14a, cuFFT's bits against the batch at each n of `CHAIN_FFT_SIZES`,
    rFFT and irFFT.  What the group form rests on, a fault at every n: in
    the one batch shape the card's UPOLS calls, ``(UPOLS_GROUP,
    UPOLS_FFT_ROWS)``, a row's bits do not depend on where it sits or on the
    rows beside it (the batch rolled by 7 rows, half of it redrawn).  Each
    row block's bits in a batch of ``rows`` against one of ``rows x G`` (G =
    1, 7, 32, 33; rows 1, 2, 16): a fault at n = 8192, where 14b's groups
    of one and `tools/upols_sum_ablation.py` compare group sizes; counted
    elsewhere, as are the first rows of a batch of ``G x rows`` (rows 1, 2,
    8) against one of ``G x 16``, which row tiles keep out of the path."""
    import torch

    from f9tpu_torch.ops import chain as ch

    faults = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 140)
    G, R = ch.UPOLS_GROUP, ch.UPOLS_FFT_ROWS
    for n in CHAIN_FFT_SIZES:
        x = torch.randn((G, R, n), device=dev, generator=gen)
        X = torch.fft.rfft(x, n=n, dim=-1)
        xi = torch.fft.irfft(X, n=n, dim=-1)
        x2 = x.reshape(G * R, n).roll(7, 0).reshape(G, R, n).clone()
        X2 = X.reshape(G * R, -1).roll(7, 0).reshape(G, R, -1).clone()
        keep = torch.zeros(G * R, dtype=torch.bool, device=dev)
        keep[::2] = True
        keep = keep.reshape(G, R)
        x2[~keep] = torch.randn((int((~keep).sum()), n), device=dev, generator=gen)
        X2[~keep] = torch.fft.rfft(x2[~keep], n=n, dim=-1)
        want_r = _bits(X.reshape(G * R, -1).roll(7, 0).reshape(G, R, -1))
        want_i = _bits(xi.reshape(G * R, n).roll(7, 0).reshape(G, R, n))
        tiled = []
        if not torch.equal(_bits(torch.fft.rfft(x2, n=n, dim=-1))[keep], want_r[keep]):
            tiled.append(f"n={n} rfft: a row moved in the ({G}, {R}) batch")
        if not torch.equal(_bits(torch.fft.irfft(X2, n=n, dim=-1))[keep], want_i[keep]):
            tiled.append(f"n={n} irfft: a row moved in the ({G}, {R}) batch")
        wide = []
        x = torch.randn((G, 16, n), device=dev, generator=gen)
        X = torch.fft.rfft(x, n=n, dim=-1)
        wide_r, wide_i = _bits(X), _bits(torch.fft.irfft(X, n=n, dim=-1))
        for rows in (1, 2, 8):
            if not torch.equal(_bits(torch.fft.rfft(x[:, :rows].contiguous(), n=n, dim=-1)),
                               wide_r[:, :rows]):
                wide.append(f"rfft {G} x {rows}")
            if not torch.equal(_bits(torch.fft.irfft(X[:, :rows].contiguous(), n=n, dim=-1)),
                               wide_i[:, :rows]):
                wide.append(f"irfft {G} x {rows}")
        differ, cases = [], 0
        for rows in (1, 2, 16):
            x = torch.randn((rows * 33, n), device=dev, generator=gen)
            X = torch.fft.rfft(x, n=n, dim=-1)
            for g in (1, 7, 32, 33):
                m = rows * g
                big_r = torch.fft.rfft(x[:m], n=n, dim=-1)
                big_i = torch.fft.irfft(X[:m], n=n, dim=-1)
                for gi in range(g):
                    sl = slice(gi * rows, (gi + 1) * rows)
                    cases += 1
                    if not _bitwise(big_r[sl], torch.fft.rfft(x[sl], n=n, dim=-1)):
                        differ.append(f"n={n} rfft rows={rows} G={g} block {gi}")
                    if not _bitwise(big_i[sl], torch.fft.irfft(X[sl], n=n, dim=-1)):
                        differ.append(f"n={n} irfft rows={rows} G={g} block {gi}")
        faults += tiled + (differ if n == 8192 else [])
        print(f"chain 14a: cuFFT n={n}: rows moved and redrawn in the ({G}, {R}) batch: "
              f"{len(tiled)} transforms differ; rows vs rows x G (G = 1, 7, 32, 33; rows 1, 2, "
              f"16): {cases} blocks, {len(differ)} transforms differ {differ[:2]}"
              f"{'' if n == 8192 else ' (counted)'}; {G} x rows vs {G} x 16 (rows 1, 2, 8): "
              f"{len(wide)} differ {wide} (counted) [{card}]", flush=True)
    return faults


def _chain_twin_cases(card: str, dev) -> list[str]:
    """14b: each kernel against its twin on the card, bitwise: the MAC at K
    = 1, 2, 7, 30, 64, mono and two-channel H, 1, 2 and 16 rows, groups of
    1, 5 and 32, 4097 bins; at K = 2, 16, 17, 30, 31, 32 (the register
    tree's edges) and 33 (the column form's first) on 33, 4097 and 8193
    bins, groups of 1, 5, 32 and 37 (two output blocks); the fold at W = 2,
    3, 7, 63-65 (8 outputs a thread x 8 taps +- 1), 351, 1024, 5631 and 5632
    (the widest, past 48 KB of shared memory) and the moving average at 2,
    48, 73, 240, 4801, 12,000 and 20,000 (staged past 48 KB) and 60,000
    (past a block's 227 KB, unstaged) on rows of 100,037 frames that start
    with +0.0 and -0.0, and on one 1-D row, and both on rows of 300 and 7
    frames (less than a tile); the
    whole `_upols` / `_upols_stream` at B = 4096, 8192 and 16384 chunked at
    1, G - 1, G and G + 1 blocks, and at 4096 with groups of 1, by sha256,
    and two rows alone against the same rows in a batch of 16."""
    import numpy as np
    import torch

    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck

    faults, n_mac = [], 0
    gen = torch.Generator(device=dev).manual_seed(SEED + 141)
    t0 = time.time()
    for K in (1, 2, 7, 30, 64):
        for hrows in (1, 2):
            for rows in (1, 2, 16):
                for G in (1, 5, 32):
                    lead = (rows,) if hrows == 1 else (2, rows)
                    buf = torch.randn((K - 1 + G, *lead, 4097), dtype=torch.complex64,
                                      device=dev, generator=gen)
                    H = torch.randn((K, *((1,) if hrows == 1 else (2, 1)), 4097),
                                    dtype=torch.complex64, device=dev, generator=gen)
                    n_mac += 1
                    if not _bitwise(ck.upols_mac(buf, H, G), ck.upols_mac_reference(buf, H, G)):
                        faults.append(f"upols_mac K={K} H rows={hrows} rows={rows} G={G}")
    # the register tree's edges (K = 16, 17, 31, 32) and the column form's
    # first (33), at odd bin counts, a short output block and two of them
    for K in (2, 16, 17, 30, 31, 32, 33):
        for Nf in (33, 4097, 8193):
            for hrows, rows, G in ((1, 1, 1), (1, 3, 5), (2, 8, 32), (1, 2, 37)):
                lead = (rows,) if hrows == 1 else (2, rows)
                buf = torch.randn((K - 1 + G, *lead, Nf), dtype=torch.complex64, device=dev,
                                  generator=gen)
                H = torch.randn((K, *((1,) if hrows == 1 else (2, 1)), Nf),
                                dtype=torch.complex64, device=dev, generator=gen)
                n_mac += 1
                if not _bitwise(ck.upols_mac(buf, H, G), ck.upols_mac_reference(buf, H, G)):
                    faults.append(f"upols_mac K={K} Nf={Nf} H rows={hrows} rows={rows} G={G}")
    print(f"chain 14b: upols_mac vs twin: {n_mac - len(faults)} of {n_mac} cases bitwise "
          f"({time.time() - t0:.1f} s) [{card}]", flush=True)

    t0 = time.time()
    rng = np.random.default_rng(SEED + 142)
    x = (0.3 * rng.standard_normal((3, 2, 100_037))).astype(np.float32)
    x[0, :, :50] = 0.0
    x[1, :, :50] = -0.0
    xd = torch.from_numpy(x).to(dev)
    n_fold = n_ma = 0
    short = xd[:, :, :300].contiguous()
    for sig, label in ((xd, "(3, 2, 100037)"), (xd[2, 1].contiguous(), "1-D"),
                       (short, "(3, 2, 300)"), (short[..., :7].contiguous(), "(3, 2, 7)")):
        for W in (2, 3, 7, 63, 64, 65, 351, 1024, 5631, 5632):
            taps = (rng.standard_normal(W) / np.sqrt(W)).astype(np.float32)
            n_fold += 1
            if not _bitwise(ch._fir_fold(sig, taps), ch._fir_fold_reference(sig, taps)):
                faults.append(f"fir_fold W={W} {label}")
        # windows past 48 KB of staged span (12,000, 20,000) and past a
        # block's 227 KB (60,000, read from device memory); the short rows
        # are less than a tile
        wins = (2, 48, 73, 240, 4801, 12000, 20000, 60000) if sig.shape[-1] > 1000 else (2, 9, 240)
        for win in wins:
            n_ma += 1
            if not _bitwise(ch._uniform_ma_past(sig, win),
                            ch._uniform_ma_past_reference(sig, win)):
                faults.append(f"ma_past win={win} {label}")
    print(f"chain 14b: fir_fold {n_fold} and ma_past {n_ma} cases vs twins: "
          f"{len([f for f in faults if not f.startswith('upols')])} faults "
          f"({time.time() - t0:.1f} s) [{card}]", flush=True)

    G = ch.UPOLS_GROUP
    ir = _stereo_ir(np.random.default_rng(SEED + 143))
    nb = 3 * G + 7
    xs = torch.from_numpy((0.2 * rng.standard_normal((2, 1, nb * 16384))).astype(np.float32)).to(dev)
    x16 = 0.2 * torch.randn((16, 8 * 16384), device=dev, generator=gen)
    for B in (4096, 8192, 16384):    # the reverb's block, and the next two (n = 32768)
        t0 = time.time()
        H = ch._spectrum([ch._partition_ir(r, B) for r in ir], dev)   # (K, 2, 1, Nf)
        h = H[:, 0]                                                   # (K, 1, Nf)
        if not _bitwise(ch._upols_rows(x16, h, B)[:2], ch._upols_rows(x16[:2], h, B)):
            faults.append(f"_upols_rows B={B}: 2 rows alone != in a batch of 16")
        x = xs[..., :nb * B]
        digest = _digest(ch._upols(x, H, B))
        shas = {}
        for blocks in (1, G - 1, G, G + 1):
            state = ch._upols_state((2, 1), H.shape[0], B, dev)
            out = []
            for a in range(0, nb * B, blocks * B):
                y, state = ch._upols_stream(x[..., a:a + blocks * B], state, H, B)
                out.append(y)
            shas[f"chunks of {blocks}"] = _digest(torch.cat(out, dim=-1))
        if B == 4096:
            ch.UPOLS_GROUP = 1
            try:
                shas["groups of 1"] = _digest(ch._upols(x, H, B))
            finally:
                ch.UPOLS_GROUP = G
        bad = [k for k, v in shas.items() if v != digest]
        faults += [f"_upols B={B} {k} != whole" for k in bad]
        print(f"chain 14b: _upols on 2 x {nb} blocks (B={B}, K={H.shape[0]}, G={G}) whole "
              f"sha256 {digest}; streamed and regrouped: {shas}; 2 rows alone vs in 16: "
              f"{'differ' if any(f.startswith(f'_upols_rows B={B}:') for f in faults) else 'bitwise'}"
              f" ({time.time() - t0:.1f} s) [{card}]", flush=True)
    return faults


def _env_chunks(B: int) -> list[tuple[int, int]]:
    """14b's envelope chunks ``(pos, T)`` on the grid of ``B``-frame blocks:
    from the grid's start and from mid-block (long: several blocks at B =
    256), shorter than a tile, across one boundary, ending on the grid after
    half a block and after two and a half, on the grid at both ends, and
    one frame."""
    return [(0, 100_037), (B // 2 + 13, 100_037), (5, 7), (B - 3, 5), (3 * B + B // 2, B // 2),
            (3 * B + B // 2, 2 * B + B // 2), (7 * B, 3 * B), (11 * B + 77, 1)]


def _dynamics_twin_cases(card: str, dev) -> list[str]:
    """14b for the dynamics kernels, bitwise against their twins on the
    card.  The envelope (`Compressor._slanted_cummax_stream` against
    `_slanted_cummax_stream_reference`: env, m' and env_carry') with
    `_ENV_BLOCK` patched to 256 and at 2^17 over `_env_chunks`, on 3 x 1 rows
    and a 1-D row, levels that start with +0.0 and -0.0 and hold a plateau
    of equal values, from the virgin state and from a carried one; an empty
    chunk hands its state back; a NaN spreads as the twin's does; the tiles'
    edges (a tile's length +- 1, from a tile's last frame, across two block
    boundaries, at 2^20 a look-back over more than 32 tiles of a block) on 8
    rows in one launch, 8 rows one float off the 16-byte grid and one row.
    The windowed maximum (`_window_max_past` against the reference) at W =
    2, 3, 8, 9, 72, 73, 74, 289, 512 (the widest in registers) and 513, 1025,
    27,009 (the widest staged) and 30,000 (level launches) on signed noise
    with zeros of both signs, ties of both in one window, NaNs of two
    payloads (bit for bit: the tree keeps the newest) and a plateau, rows of
    100,037 frames, the same one float off the 16-byte grid, rows at the
    register form's step edges (253, 256, 513 and 1023 frames), of 300 and 7
    frames and a 1-D row.  Then the compressor, the expander and the limiter
    streamed at two chunk sizes against the whole signal by sha256, at both
    block lengths, each launching both kernels."""
    import numpy as np
    import torch

    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck

    faults = []
    rng = np.random.default_rng(SEED + 146)
    comp = ch.Compressor
    B0 = comp._ENV_BLOCK
    t0 = time.time()
    n_env = 0
    try:
        for B in (256, B0):
            comp._ENV_BLOCK = B
            for pos, T in _env_chunks(B):
                for lead in ((3, 1), ()):
                    lv = rng.uniform(-90.0, 6.0, size=(*lead, T)).astype(np.float32)
                    lv[..., :40] = 0.0
                    lv[..., 1:40:3] = -0.0
                    lv[..., T // 2:T // 2 + 500] = -12.5
                    lvd = torch.from_numpy(lv).to(dev)
                    for c, carried in ((80.0 / 48000, False), (300.0 / 48000, True)):
                        if carried:
                            m, ec = (torch.from_numpy(np.asarray(
                                rng.uniform(-40.0, 0.0, size=lead), np.float32)).to(dev)
                                for _ in "me")
                        else:
                            m = ec = torch.full(lead, -1e9, device=dev)
                        got = comp._slanted_cummax_stream(lvd, c, pos, m, ec)
                        want = comp._slanted_cummax_stream_reference(lvd, c, pos, m, ec)
                        n_env += 1
                        bad = [k for k, g, w in zip(("env", "m'", "env_carry'"), got, want)
                               if not _bitwise(g, w)]
                        if bad:
                            faults.append(f"slanted_cummax B={B} pos={pos} T={T} rows={lead} "
                                          f"{'carried' if carried else 'virgin'}: {bad} differ")
        comp._ENV_BLOCK = B0
        m = torch.full((3, 1), -5.0, device=dev)
        got = comp._slanted_cummax_stream(torch.empty((3, 1, 0), device=dev), 0.01, 77, m, m)
        if got[1] is not m or got[2] is not m or got[0].shape != (3, 1, 0):
            faults.append("slanted_cummax: an empty chunk did not hand its state back")
        lv = rng.uniform(-60.0, 0.0, size=(2, 1, 300_000)).astype(np.float32)
        lv[0, 0, 1000] = np.nan
        lvd = torch.from_numpy(lv).to(dev)
        init = torch.full((2, 1), -1e9, device=dev)
        got = comp._slanted_cummax_stream(lvd, 0.01, 12_345, init, init)
        want = comp._slanted_cummax_stream_reference(lvd, 0.01, 12_345, init, init)
        for k, g, w in zip(("env", "m'", "env_carry'"), got, want):
            nan_g, nan_w = torch.isnan(g), torch.isnan(w)
            if not torch.equal(nan_g, nan_w) or not _bitwise(g[~nan_g], w[~nan_w]):
                faults.append(f"slanted_cummax with a NaN: {k} differs")
        # the one-pass design's edges at 2^17: a tile's length +- 1, a chunk
        # from a tile's last frame, chunks across two block boundaries (8
        # rows take the narrow tile there, `chain_kernels.env_tile_frames`,
        # and 600 rows the wide one); at 2^20 a look-back over more than 32
        # tiles of a block (64 wide tiles on 8 rows, 512 narrow on 1); 8 rows
        # in one launch, and rows that start off the 16-byte grid (a view
        # one float in)
        n_edge = 0
        tile = ck.ENV_TILE
        flat = torch.from_numpy(rng.uniform(
            -90.0, 6.0, max(8 * (70 * tile + 9), 600 * (2 * tile + 4))).astype(np.float32)).to(dev)
        eight = ((8, 0), (8, 1), (1, 3))
        wide = ((600, 0), (600, 1))
        for B, pos, T, shapes in ((B0, 0, tile, eight + wide), (B0, 0, tile + 1, eight + wide),
                                  (B0, tile - 1, 2, eight), (B0, tile - 1, tile + 2, eight + wide),
                                  (B0, B0 - tile, tile, eight),
                                  (B0, B0 - tile - 1, 2 * tile + 3, eight + wide),
                                  (B0, 5, 2 * B0 + 3, eight), (1 << 20, 1, 70 * tile + 5, eight)):
            comp._ENV_BLOCK = B
            for rows, shift in shapes:
                lvd = flat[shift:shift + rows * T].view(rows, 1, T)
                m = torch.from_numpy(rng.uniform(-40.0, 0.0, (rows, 1)).astype(np.float32)).to(dev)
                ec = torch.from_numpy(rng.uniform(-40.0, 0.0, (rows, 1)).astype(np.float32)).to(dev)
                got = comp._slanted_cummax_stream(lvd, 300.0 / 48000, pos, m, ec)
                want = comp._slanted_cummax_stream_reference(lvd, 300.0 / 48000, pos, m, ec)
                n_edge += 1
                bad = [k for k, g, w in zip(("env", "m'", "env_carry'"), got, want)
                       if not _bitwise(g, w)]
                if bad:
                    faults.append(f"slanted_cummax edge B={B} pos={pos} T={T} rows={rows} "
                                  f"view+{shift}: {bad} differ")
    finally:
        comp._ENV_BLOCK = B0
    print(f"chain 14b: slanted_cummax vs twin: {n_env} cases (B = 256 and {B0}), {n_edge} at "
          f"the tiles' edges (8 and 600 rows a launch, rows off the 16-byte grid, wide and "
          f"narrow tiles), {len(faults)} faults, an empty chunk and a NaN "
          f"({time.time() - t0:.1f} s) [{card}]", flush=True)

    t0 = time.time()
    n_wmax, nf = 0, len(faults)
    x = rng.standard_normal((3, 1, 100_037)).astype(np.float32)
    x[0, :, :60] = 0.0
    x[1, :, :60] = -0.0
    x[2, :, 1000:1100] = -0.0
    x[2, :, 1100:1200] = 0.0
    x[:, :, 5000:5100] = 0.25
    # ties of both zeros in one window, and NaNs of two payloads a few
    # positions apart (the tree's newest NaN wins) and at a row's start
    x[0, :, 7000:7400:2] = -0.0
    x[0, :, 7001:7400:2] = 0.0
    nan_a, nan_b = (np.array([w], np.uint32).view(np.float32)[0] for w in (0x7FC00001, 0xFFC00123))
    x[1, :, 9000] = nan_a
    x[1, :, 9011] = nan_b
    x[2, :, 3] = nan_b
    x[2, :, 60_000] = nan_a
    x[2, :, 60_300] = nan_b
    xd = torch.from_numpy(x).to(dev)
    short = xd[..., :300].contiguous()
    # the same rows one float off the 16-byte grid (the output, a fresh
    # tensor, then on another grid than the input), and rows whose lengths
    # sit at the register form's step and segment edges
    flat = torch.from_numpy(np.concatenate([[0.5], x.reshape(-1)]).astype(np.float32)).to(dev)
    shifted = flat[1:].view(3, 1, 100_037)
    step = ck.WMAX_STEP
    edges = [xd[..., :n].contiguous() for n in (step - 3, step, 2 * step + 1, 4 * step - 1)]
    reg_ws = (2, 3, 8, 9, 72, 73, 74, 289, ck.WMAX_REG_MAX_W, ck.WMAX_REG_MAX_W + 1)
    for sig, label, ws in (
            (xd, "(3, 1, 100037)", reg_ws + (1025, 27009, 30000)),
            (shifted, "(3, 1, 100037) one float off the grid", reg_ws),
            (xd[2, 0].contiguous(), "1-D", (2, 3, 8, 73, 1025, 27009, 30000)),
            (short, "(3, 1, 300)", (2, 3, 8, 73, 289, 1025)),
            (short[..., :7].contiguous(), "(3, 1, 7)", (2, 3, 8, 73, 1025)),
            *((e, f"(3, 1, {e.shape[-1]})", (9, 73, 289, ck.WMAX_REG_MAX_W)) for e in edges)):
        for W in ws:
            n_wmax += 1
            if not _bitwise(ch._window_max_past(sig, W), ch._window_max_past_reference(sig, W)):
                faults.append(f"window_max W={W} {label}")
    print(f"chain 14b: window_max vs twin: {n_wmax} cases (NaNs of two payloads and ties of "
          f"both zeros held bit for bit), {len(faults) - nf} faults ({time.time() - t0:.1f} s) "
          f"[{card}]", flush=True)
    # torch's own tie rule for zeros of both signs on the card, which the
    # twins inherit (reported, not held: the kernels replay it or never meet it)
    z = torch.tensor([0.0, -0.0], device=dev)

    def sign(t):
        return "".join("-0" if b else "+0" for b in torch.signbit(t).tolist())

    print(f"chain 14b: torch's ties on the card: maximum(+0, -0) {sign(torch.maximum(z[:1], z[1:]))}"
          f", maximum(-0, +0) {sign(torch.maximum(z[1:], z[:1]))}, cummax([+0, -0]) "
          f"{sign(torch.cummax(z, 0).values)}, cummax([-0, +0]) "
          f"{sign(torch.cummax(z.flip(0), 0).values)} [{card}]", flush=True)

    t0 = time.time()
    nf = len(faults)
    T = 384_000
    t = np.arange(T) / 48000.0
    y = (0.5 * np.sin(2 * np.pi * 220.0 * t) * np.where((t > 2.0) & (t < 4.5), 0.01, 1.0)
         + 0.05 * rng.standard_normal((2, T))).astype(np.float32)
    yd = torch.from_numpy(y).to(dev)
    stages = (("compressor", ch.Compressor(-20.0, 4.0, 2.0, 200.0)),
              ("expander", ch.Expander(-25.0, 2.0, 0.0, 300.0)),
              ("limiter", ch.Limiter(-4.0, 1.0, 250.0)))
    shas = {}
    try:
        for B in (256, B0):
            comp._ENV_BLOCK = B
            for name, stage in stages:
                env0, wmax0 = ck.launches_env, ck.launches_wmax
                whole = _digest(stage.apply(yd, 48000))
                for chunk in (31_415, 100_000):
                    state, out = stage.stream_state(48000, 2, dev), []
                    for a in range(0, T, chunk):
                        o, state = stage.apply_stream(yd[..., a:a + chunk], state, 48000, a)
                        out.append(o)
                    got = _digest(torch.cat(out, dim=-1))
                    shas[f"{name} B={B} chunks of {chunk}"] = got == whole
                    if got != whole:
                        faults.append(f"{name} B={B} chunks of {chunk}: sha256 {got} != whole "
                                      f"{whole}")
                if ck.launches_env == env0 or (name == "limiter" and ck.launches_wmax == wmax0):
                    faults.append(f"{name} B={B}: the dynamics kernels were not launched")
    finally:
        comp._ENV_BLOCK = B0
    print(f"chain 14b: compressor, expander, limiter on 2 x {T} streamed at 31,415 and 100,000 "
          f"frames vs whole, sha256 equal: {sum(shas.values())} of {len(shas)}, "
          f"{len(faults) - nf} faults ({time.time() - t0:.1f} s) [{card}]", flush=True)
    return faults


def _ptxas_stats(pattern: str):
    """What ptxas reported for the first kernel whose mangled name holds
    ``pattern`` (`_build.ptxas_report`); None when the library was not built
    by this process."""
    from f9tpu_torch.ops import _build

    return next((v for k, v in _build.ptxas_report(_build.build_log).items() if pattern in k),
                None)


def _env_quads(lv, pos: int) -> int:
    """The quads a thread of the envelope kernel's instance for the chunk
    ``lv`` from ``pos`` (`chain_kernels.env_tile_frames`: 16 for the wide
    tile, 2 for the narrow one)."""
    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck

    B = ch.Compressor._ENV_BLOCK
    tile = ck.env_tile_frames(lv.numel() // lv.shape[-1], lv.shape[-1], pos % B, B)
    return (ck.ENV_TILE if tile > ck.ENV_TILE_NARROW else ck.ENV_TILE_NARROW) // 1024


def _chain_cases(dev) -> tuple[list[dict], dict]:
    """14c's kernel calls at the path's shapes, built the same way in this
    process and in the profiled child (``--chain-device-times``): a list of
    {kernel, label, shape, run, twin, library, bound_ms, bound_by,
    patterns, per_call} (the first case of each kernel is its insert-loop
    shape), and the chain's stages with the batch ``y`` they run on.

    The MAC: one group of the insert loop's reverb, of a 20 s stream
    chunk's and of the meter's K-weighting; bound 6 separately rounded
    float64 instructions a complex multiply-add against the spectra and H
    read once and Y written once (beside it the first design's 8); library
    `torch.einsum`.  The fold: the EQ's taps on the insert loop's batch and
    on the chunk, `FIR_FOLD_MAX` taps on the chunk; bound 2W - 1 float32
    instructions an output; library `F.conv1d` (TF32 off).  The moving
    average: the compressor's detector (win 48, both channels), its attack
    (240) and the limiter's ramp (73) on the linked row; bound win float32
    instructions an output; library `F.avg_pool1d`.  The envelope: the
    compressor's level on the insert loop's linked row from position 0 and
    on the chunk's from a position mid-grid with a carried state; bound
    the level read once and env written once (8 float32 instructions a
    frame); library `torch.cummax` over the whole row.  The windowed
    maximum: the limiter's W = 73 over its ring and attenuation on both
    rows; bound the same bytes (its 7 levels of maxima are the ops);
    library `F.max_pool1d` over the padded row."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from f9tpu_torch import cli
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import wav
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck
    from f9tpu_torch.ops import loudness as ld
    from f9tpu_torch.pipeline import stream as st

    files, C, T = CHAIN_SHAPE
    rng = np.random.default_rng(SEED + 144)
    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    try:
        ir_path = os.path.join(work, "IR.wav")
        wav.write_wav(ir_path, _stereo_ir(rng), 48000, bits=32)
        chain = cli._build_chain(argparse.Namespace(**_chain_args(ir_path)))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    delay, eq, comp, rev, lim = chain.stages
    gen = torch.Generator(device=dev).manual_seed(SEED + 145)
    y = 0.1 * torch.randn((files, C, T), device=dev, generator=gen)
    cases = []

    def bound(ops: float, nbytes: float, rate: float = FP32_INSTR_PER_S) -> dict:
        t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
        return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                    bound_by="operations" if t_ops > t_bytes else "bytes")

    B = rev.stream_grid(48000)
    H = rev._spectrum(B, dev).to(torch.complex64)                      # (30, 2, 1, Nf)
    kw = ld.k_weighting_ir().astype(np.float32)
    Bk = ch._fft_block_size(int(kw.shape[0]))
    Hk = ch._spectrum([ch._partition_ir(kw, Bk)], dev)[:, 0].contiguous()   # (K, 1, Nf)
    G = ch.UPOLS_GROUP
    for label, Hs, lead in (("insert loop", H, (C, files)), ("20 s stream chunk", H, (C, 1)),
                            ("meter", Hk, (C,))):
        K, Nf = Hs.shape[0], Hs.shape[-1]
        buf = torch.randn((K - 1 + G, *lead, Nf), dtype=torch.complex64, device=dev,
                          generator=gen)
        rows, h_rows = int(np.prod(lead)), int(np.prod(Hs.shape[1:-1]))
        macs = K * G * rows * Nf
        nbytes = 8.0 * Nf * ((K - 1 + G) * rows + K * h_rows + G * rows)
        Xw = buf.unfold(0, K, 1)                                  # (G, *lead, Nf, K), oldest first
        Hx = Hs.flip(0).movedim(0, -1).expand(*lead, Nf, K)
        cases.append(dict(
            kernel="upols_mac", label=label,
            shape=f"K={K}, G={G}, {' x '.join(map(str, lead))} rows, {Nf} bins",
            run=lambda buf=buf, Hs=Hs: ck.upols_mac(buf, Hs, G),
            twin=lambda buf=buf, Hs=Hs: ck.upols_mac_reference(buf, Hs, G),
            library=lambda Xw=Xw, Hx=Hx: torch.einsum("g...k,...k->g...", Xw, Hx),
            patterns=("upols_mac",), per_call=1,
            ptxas=f"upols_mac_regILi{K}E" if K <= 32 else "upols_mac_col",
            bound_ms_8_instructions=1e3 * max(8.0 * macs / FP64_INSTR_PER_S,
                                              nbytes / HBM_BYTES_PER_S),
            **bound(6.0 * macs, nbytes, FP64_INSTR_PER_S)))

    bank = design_cycle_bank(44100, 48000)
    scfg = ProcessingConfig(output_dir="unused", target_rate=48000, chain=chain,
                            latency_frames=312)
    t_chunk = st._chunk_cycles(bank, scfg, 20.0, 44100) * bank.L
    yc = 0.1 * torch.randn((C, t_chunk), device=dev, generator=gen)
    taps = eq._taps(48000)
    wide = (rng.standard_normal(ch.FIR_FOLD_MAX) / np.sqrt(ch.FIR_FOLD_MAX)).astype(np.float32)
    for label, v, tp in (("insert loop", y, taps), ("20 s stream chunk", yc, taps),
                         (f"20 s stream chunk, {ch.FIR_FOLD_MAX} taps", yc, wide)):
        W, n_out = int(tp.shape[0]), v.numel()
        td = torch.from_numpy(tp.copy()).to(dev)
        wt = torch.from_numpy(np.ascontiguousarray(tp[::-1])).to(dev).reshape(1, 1, W)
        cases.append(dict(
            kernel="fir_fold", label=label, shape=f"W={W}, {' x '.join(map(str, v.shape))}",
            run=lambda v=v, td=td: ck.fir_fold(v, td),
            twin=lambda v=v, tp=tp: ch._fir_fold_reference(v, tp),
            library=lambda v=v, wt=wt, W=W: F.conv1d(v.reshape(-1, 1, v.shape[-1]), wt,
                                                     padding=W - 1)[..., :v.shape[-1]],
            patterns=("fir_fold",), per_call=1, ptxas="fir_fold_kernel",
            **bound((2 * W - 1) * n_out, 8.0 * n_out + 4 * W)))

    sq = torch.square(y)
    link = sq[:, :1].contiguous()
    for win, v, label in ((240, link, "insert loop, compressor attack"),
                          (48, sq, "insert loop, compressor detector"),
                          (73, link, "insert loop, limiter ramp")):
        vin = F.pad(v.reshape(-1, 1, v.shape[-1]), (win - 1, 0))
        cases.append(dict(
            kernel="ma_past", label=label, shape=f"win={win}, {tuple(v.shape)}",
            run=lambda v=v, win=win: ck.ma_past(v, win),
            twin=lambda v=v, win=win: ch._uniform_ma_past_reference(v, win),
            library=lambda vin=vin, win=win: F.avg_pool1d(vin, win, stride=1),
            patterns=("ma_past",), per_call=1, ptxas="ma_past_tiles",
            **bound(win * v.numel(), 8.0 * v.numel())))

    # the compressor's level on the linked rows, and the limiter's ring and
    # attenuation after its release
    c_comp, c_lim = comp.release_db_per_s / 48000, lim.release_db_per_s / 48000
    L = lim.lookahead_frames(48000)
    level_loop = 10.0 * torch.log10(torch.clamp(
        ck.ma_past(sq, 48).amax(dim=-2, keepdim=True), min=1e-20))        # (8, 1, T)
    yc1 = yc * 3.0
    level_chunk = 10.0 * torch.log10(torch.clamp(
        torch.square(yc1).amax(dim=-2, keepdim=True), min=1e-20))         # (1, t_chunk)
    pos = 3 * t_chunk
    for label, lv, p0, carried in (("insert loop", level_loop, 0, False),
                                   ("20 s stream chunk", level_chunk, pos, True)):
        lead = tuple(lv.shape[:-1])
        m = torch.full(lead, -40.0 if carried else -1e9, device=dev)
        ec = torch.full(lead, -35.0 if carried else -1e9, device=dev)
        n = lv.numel()
        cases.append(dict(
            kernel="slanted_cummax", label=label, shape=f"{tuple(lv.shape)}, pos {p0}",
            run=lambda lv=lv, p0=p0, m=m, ec=ec: ck.slanted_cummax(
                lv, c_comp, p0, m, ec, ch.Compressor._ENV_BLOCK),
            twin=lambda lv=lv, p0=p0, m=m, ec=ec: ch.Compressor._slanted_cummax_stream_reference(
                lv, c_comp, p0, m, ec),
            library=lambda lv=lv: torch.cummax(lv, dim=-1),
            patterns=("env_scan",), per_call=1,
            ptxas=f"env_scanILi{_env_quads(lv, p0)}E", **bound(8.0 * n, 8.0 * n + 16.0 * lv.numel() / lv.shape[-1])))
    for label, v in (("insert loop", y), ("20 s stream chunk", yc1)):
        lvl = torch.amax(torch.abs(v), dim=-2, keepdim=True)
        atten = torch.clamp(20.0 * torch.log10(torch.clamp(lvl, min=1e-20))
                            - float(np.float32(lim.ceiling_db)), min=0.0)
        init = torch.full(tuple(atten.shape[:-1]), -1e9, device=dev)
        rel = ch.Compressor._slanted_cummax_stream(atten, c_lim, 0, init, init)[0]
        ac = torch.cat([torch.zeros((*rel.shape[:-1], L), device=dev), rel], dim=-1)
        W = L + 1
        levels = int(np.log2(W)) + ((W & (W - 1)) != 0)
        acp = F.pad(ac.reshape(-1, 1, ac.shape[-1]), (W - 1, 0))
        cases.append(dict(
            kernel="window_max", label=label, shape=f"W={W}, {tuple(ac.shape)}",
            run=lambda ac=ac, W=W: ck.window_max(ac, W),
            twin=lambda ac=ac, W=W: ch._window_max_past_reference(ac, W),
            library=lambda acp=acp, W=W: F.max_pool1d(acp, W, stride=1),
            patterns=("wmax_reg",), per_call=1, ptxas="wmax_regILi6ELb1E",
            **bound(levels * ac.numel(), 8.0 * ac.numel())))
    return cases, dict(chain=chain, y=y, W=int(taps.shape[0]), taps=taps)


def chain_device_times_main(dev, runs: int = 10) -> dict:
    """14c's device times, for the child process (``--chain-device-times``):
    {"kernel | label": device ms a call, or None}.  Every case runs ``runs``
    times in one `torch.profiler` trace after a warm-up call each; the
    kernel events, in order of their start, are cut into each case's
    ``runs x per_call`` and each cut must hold only that case's kernels (a
    case whose cut does not is None, and so is every case after a miscount)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.time()
    cases, _ = _chain_cases(dev)
    for c in cases:
        c["run"]()
    torch.cuda.synchronize()
    t1 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for c in cases:
            for _ in range(runs):
                c["run"]()
            torch.cuda.synchronize()
    patterns = {p for c in cases for p in c["patterns"]}
    evs = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                  and any(p in e.name for p in patterns)), key=lambda e: e.time_range.start)
    out, i = {}, 0
    for c in cases:
        cut = evs[i:i + runs * c["per_call"]]
        i += len(cut)
        whole = (len(cut) == runs * c["per_call"]
                 and all(any(p in e.name for p in c["patterns"]) for e in cut))
        out[f"{c['kernel']} | {c['label']}"] = (
            sum(e.time_range.elapsed_us() for e in cut) / 1e3 / runs if whole else None)
        if whole and len(c["patterns"]) > 1:
            each = {p: sum(e.time_range.elapsed_us() for e in cut if p in e.name) / 1e3 / runs
                    for p in c["patterns"]}
            print(f"chain 14c: {c['kernel']}, {c['label']}: device ms a call by kernel "
                  + ", ".join(f"{p} {ms:.4f}" for p, ms in each.items()), flush=True)
    if i != len(evs):
        out = dict.fromkeys(out)
    print(f"chain 14c: profiled child: cases built and warm in {t1 - t0:.1f} s, one trace of "
          f"{len(evs)} kernels in {time.time() - t1:.1f} s", flush=True)
    return out


def _chain_device_times_fresh() -> dict:
    """14c's profiled device times in a process of its own: deep in the
    whole script this process's profiler read no kernel events at phase 14
    (as 11c's traces came out a graph short there), while a fresh process's
    traces are whole.  Raises if the child fails."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--chain-device-times"],
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith("chain 14c"):
            print(line, flush=True)
    result = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    if proc.returncode != 0 or not result:
        raise AssertionError(f"chain 14c: the profiled process failed (exit "
                             f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    return json.loads(result[-1])


def _chain_times(card: str, dev) -> tuple[dict, list[str]]:
    """14c: each kernel against its twin, bitwise (a fault otherwise), at
    the shapes of `_chain_cases`: its one-call time (CUDA events, median of
    10), its device time (`torch.profiler` in a process of its own; a fault
    if it read none), its bound, its twin's time (median of 3), a library
    yardstick the port never calls and ptxas's registers and spills; then
    the stages around them: `_fft_convolve_multi` of the 2.5 s stereo IR,
    the 351-tap EQ's fold, the compressor and the limiter.  Returns the JSON
    summary's numbers (each kernel's first shape, every shape under
    "per_shape"), with the launches of the stage calls as the path
    "chain_stages", and the faults."""
    import torch

    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck

    cases, ctx = _chain_cases(dev)
    faults = []
    t0 = time.time()
    device = _chain_device_times_fresh()
    walls = {"profiled child": time.time() - t0, "envelope and window max": 0.0}
    out = {}
    for c in cases:
        t0 = time.time()
        got, want = c["run"](), c["twin"]()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(float((torch.view_as_real(g) - torch.view_as_real(w)).abs().max()
                        if g.is_complex() else (g - w).abs().max()) for g, w in zip(got, want))
        same = all(_bitwise(g, w) for g, w in zip(got, want))
        if not same:
            faults.append(f"{c['kernel']} != twin at {c['shape']} (max {err:.3g})")
        dev_ms = device.get(f"{c['kernel']} | {c['label']}")
        if dev_ms is None:
            faults.append(f"{c['kernel']}, {c['label']}: the profiler read no device time")
        r = dict(ms=_median_ms(c["run"]), device_ms=dev_ms,
                 plain_ms=_median_ms(c["twin"], runs=3), bound_ms=c["bound_ms"],
                 bound_by=c["bound_by"], library_ms=_median_ms(c["library"]),
                 max_abs_err=err, bitwise=same, ptxas=_ptxas_stats(c["ptxas"]),
                 shape=c["shape"])
        if "bound_ms_8_instructions" in c:
            r["bound_ms_8_instructions"] = c["bound_ms_8_instructions"]
        if c["kernel"] not in out:
            out[c["kernel"]] = dict(r, per_shape={})
        out[c["kernel"]]["per_shape"][c["label"]] = r
        old8 = (f" (old 8-instruction count {r['bound_ms_8_instructions']:.4f})"
                if "bound_ms_8_instructions" in r else "")
        print(f"chain 14c: {c['kernel']}, {c['label']} ({r['shape']}): kernel {r['ms']:.4f} ms "
              f"(device {'none' if dev_ms is None else f'{dev_ms:.4f}'}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}){old8}, twin {r['plain_ms']:.2f} ms, "
              f"library {r['library_ms']:.3f} ms, max |kernel - twin| {err:.3g}, bitwise "
              f"{same}, ptxas {r['ptxas']} [{card}]", flush=True)
        if c["kernel"] in ("slanted_cummax", "window_max"):
            walls["envelope and window max"] += time.time() - t0
    if _ptxas_stats("env_scan") is not None:
        print(f"chain 14c: ptxas env_scan (wide, narrow tile) {_ptxas_stats('env_scanILi16E')}, "
              f"{_ptxas_stats('env_scanILi2E')}; wmax_reg (W = 2, 512, 511) "
              f"{_ptxas_stats('wmax_regILi1ELb0E')}, "
              f"{_ptxas_stats('wmax_regILi9ELb0E')}, {_ptxas_stats('wmax_regILi8ELb1E')}, "
              f"wmax_tile (513 <= W <= {ck.WMAX_STAGED_MAX_W}) {_ptxas_stats('wmax_tile')}, "
              f"ma_past unstaged {_ptxas_stats('ma_past_rows')} [{card}]", flush=True)

    # the stages around them, on the same batch, their launches counted
    chain, y, W, taps = ctx["chain"], ctx["y"], ctx["W"], ctx["taps"]
    _delay, _eq, comp, rev, lim = chain.stages
    files, C, T = CHAIN_SHAPE
    _zero_counts()
    stages = {}
    for label, fn in (("_fft_convolve_multi, 2.5 s stereo IR (UPOLS)",
                       lambda: ch._fft_convolve_multi(y, rev.ir)),
                      (f"_fir_fold, the {W}-tap EQ", lambda: ch._fir_fold(y, taps)),
                      ("Compressor -18:3", lambda: comp.apply(y, 48000)),
                      ("Limiter -0.3", lambda: lim.apply(y, 48000))):
        _, stages[label] = _timed(fn)
    counts = tuple(getattr(ck, name) for name in CHAIN_COUNTERS)
    for label, ms in stages.items():
        print(f"chain 14c: stage {label} on {files} x {C} x {T}: {ms:.2f} ms [{card}]",
              flush=True)
    print(f"chain 14c: launches in the stage calls (3 runs each): "
          + ", ".join(f"{n[len('launches_'):]} {k}" for n, k in zip(CHAIN_COUNTERS, counts))
          + f" [{card}]", flush=True)
    out["stages_ms"] = stages
    out["launches"] = counts
    out["walls"] = walls
    return out, faults


def phase_chain_kernels(card: str, dev) -> dict:
    """Phase 14, the insert chain's kernels: 14a cuFFT's bits against the
    batch count, 14b each kernel against its twin and UPOLS chunked and
    regrouped against whole, 14c each kernel against its twin at the
    insert loop's shapes and the times; held to
    `CHAIN_KERNELS_BUDGET_S`.  Returns 14c's numbers."""
    t_all = time.time()
    walls, faults = {}, []
    t0 = time.time()
    faults += _chain_fft_premise(card, dev)
    walls["14a"] = time.time() - t0
    t0 = time.time()
    faults += _chain_twin_cases(card, dev)
    t1 = time.time()
    faults += _dynamics_twin_cases(card, dev)
    new = {"14b dynamics": time.time() - t1}
    walls["14b"] = time.time() - t0
    t0 = time.time()
    out, times_faults = _chain_times(card, dev)
    faults += times_faults
    walls["14c"] = time.time() - t0
    new.update({f"14c {k}": v for k, v in out["walls"].items()})
    total = time.time() - t_all
    print(f"phase 14 (chain kernels): {total:.1f} s (budget {CHAIN_KERNELS_BUDGET_S:g}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + "; of it the dynamics "
          "kernels' cases and the profiled child: "
          + ", ".join(f"{k} {v:.1f}" for k, v in new.items()) + f" [{card}]", flush=True)
    if total > CHAIN_KERNELS_BUDGET_S:
        faults.append(f"{total:.1f} s > {CHAIN_KERNELS_BUDGET_S:g} s")
    _raise_faults("phase 14", faults)
    out["seconds"] = dict(walls, total=total)
    return out


#: phase 15 (the L < 8 fold kernel) fails past this many seconds (on one
#: H100 33.0-42.1 s alone and 44.3 in the whole script, of it 15f's profiled
#: child process 16.2-22.5)
CYCLE_FOLD_BUDGET_S = 60.0
#: 15a's rows and cycles a bank (fewer cycles past W = 800 taps: the widest
#: bank's twin makes 9,600 passes)
CYCLE_FOLD_SHAPE = (4, 1 << 18)
#: 15a-c's extra banks beside the 48 dense L < 8 banks of the standard rates:
#: the meter's conversions to 48 kHz from 8, 16, 24 and 32 kHz and a Lagrange
#: bank (96 and 192 kHz to 48 kHz high are among the 48), and two that only
#: the generic form takes: M = 3, and the widest, M = 48 at 32 threads a block
CYCLE_FOLD_EXTRA = ((8000, 48000, "high", "sinc"), (16000, 48000, "high", "sinc"),
                    (24000, 48000, "high", "sinc"), (32000, 48000, "high", "sinc"),
                    (48000, 96000, "high", "lagrange"), (48000, 16000, "high", "sinc"),
                    (384000, 8000, "ultra", "sinc"))
#: 15c's banks, the first six also 15d's: the true-peak oversampler (the same
#: bank at every rate: L = 4, M = 1), the stream's 2:1 and 4:1 pairs both
#: ways, the meter's 32 and 8 kHz ones, a Lagrange one
CYCLE_FOLD_CORE = ((44100, 176400, "high", "sinc"), (96000, 48000, "high", "sinc"),
                   (48000, 96000, "ultra", "sinc"), (192000, 48000, "ultra", "sinc"),
                   (48000, 192000, "low", "sinc"), (32000, 48000, "high", "sinc"),
                   (8000, 48000, "high", "sinc"), (48000, 96000, "high", "lagrange"))
#: 15e's source: a 96 kHz stereo 24-bit WAV of this many seconds, streamed to
#: 48 kHz at these chunk sizes
CYCLE_FOLD_STREAM = (30.0, ("20", "7.3"))
#: 15g's batch: files, channels, bucket frames at 96 kHz and the files'
#: seconds, the `studio48.hires_sfx` cell's (zero past each file, as the front
#: end leaves the bucket)
CYCLE_FOLD_BATCH = (8, 2, 1 << 22, (30.0, 43.0))
#: 15g's budget, seconds, apart from 15a-f's `CYCLE_FOLD_BUDGET_S` (on one
#: H100 19.9 s alone, of it the profiled child's torch import ~10)
CYCLE_FOLD_FLAT_BUDGET_S = 30.0
#: the cycle_fold kernel's launches of each main-path drive, as `_read_counts`
#: read them (`main` sums them by path; `EPILOGUE_READS` keeps step with it)
CYCLE_FOLD_READS: list[int] = []
#: the flat form's share of them (`cycle_fold.launches_flat`), read beside them
CYCLE_FOLD_FLAT_READS: list[int] = []


def _fold_banks() -> list[tuple[int, int, str, str]]:
    """15a's banks: every dense L < 8 bank of the standard rates at the four
    sinc presets (48), then `CYCLE_FOLD_EXTRA`."""
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.models.filters import QUALITY_PRESETS, STANDARD_RATES

    std = [(ri, ro, q, "sinc") for ri in STANDARD_RATES for ro in STANDARD_RATES
           for q in QUALITY_PRESETS if ri != ro and design_cycle_bank(ri, ro, quality=q).L < 8]
    return std + list(CYCLE_FOLD_EXTRA)


def _nan_bitwise(a, b) -> bool:
    """float32 tensors equal bit for bit outside their NaNs, NaN at the same
    places (a NaN's payload is the device's own)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(_bits(a[~na]), _bits(b[~nb])))


def _fold_input(rng, rows: int, T: int, dev, level: float = 0.89):
    """``rows`` x ``T`` uniform noise peaking near ``level`` on the card."""
    import numpy as np
    import torch

    return torch.from_numpy(rng.uniform(-level, level, (rows, T)).astype(np.float32)).to(dev)


def _fold_twin_cases(card: str, dev) -> tuple[list[str], float, int]:
    """15a and 15b: on every bank of `_fold_banks`, the kernel in the form
    `fold_form` picks and, where that is the slid form, in the generic form
    too, against its twin on the card at `CYCLE_FOLD_SHAPE` (a NaN and a +inf
    in the last row) and at the edges: one cycle, a tile less one, a tile, a
    tile and one, rows a float off the 16-byte grid with a stride past the
    row, a 3-D chunk; the samples bitwise outside their NaNs (NaN at the
    same places), the fused peak bitwise `torch.max(torch.abs(twin))`; then the peak on
    the true-peak bank with a NaN, +-inf, silence, -0.0 and subnormals.
    Returns (faults, the largest |kernel - twin| outside NaNs, cases)."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr

    rng = np.random.default_rng(SEED + 150)
    rows, Q = CYCLE_FOLD_SHAPE
    faults, worst, n = [], 0.0, 0

    def check(tag, xp, bank, cycles):
        nonlocal worst, n
        n0 = cf.launches
        y = cf.resample_presliced_fold_kernel(xp, bank, cycles)
        pk = cf.presliced_absmax_kernel(xp, bank, cycles)
        yt = tr._presliced_fold(xp, bank, cycles)
        pt = torch.max(torch.abs(yt))
        forms = {cf.fold_form(bank): (y, pk)}
        if cf.fold_form(bank):           # the generic form, which other banks take
            forms[0] = (cf._launch(xp, bank, cycles, False, form=0),
                        cf._launch(xp, bank, cycles, True, form=0))
        torch.cuda.synchronize()
        n += 1
        if cf.launches != n0 + 2 * len(forms):
            faults.append(f"{tag}: {cf.launches - n0} launches for {2 * len(forms)} calls")
        for form, (y, pk) in forms.items():
            ok = torch.isfinite(yt) & torch.isfinite(y)
            if bool(ok.any()):
                worst = max(worst, float((y[ok] - yt[ok]).abs().max()))
            if not _nan_bitwise(y, yt):
                faults.append(f"{tag} form {form}: the samples differ from the twin's "
                              f"({int((_bits(y) != _bits(yt)).sum())} words)")
            if not _nan_bitwise(pk.reshape(1), pt.reshape(1)):
                faults.append(f"{tag} form {form}: peak {float(pk)!r} != twin's {float(pt)!r}")

    for ri, ro, q, kind in _fold_banks():
        bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
        name = f"{ri}->{ro} {q} {kind} (L={bank.L} M={bank.M} W={bank.W})"
        if not cf.fold_kernel_applicable(bank):
            faults.append(f"{name}: not applicable")
            continue
        Qb = min(Q, Q * 800 // bank.W)
        xp = _fold_input(rng, rows, (Qb - 1) * bank.M + bank.W, dev)
        xp[-1, 1000] = float("nan")
        xp[-1, 5000] = float("inf")
        check(f"15a {name} {rows} x {Qb}", xp, bank, Qb)
        tq = cf.FOLD_CYCLES * cf.fold_threads(bank)
        for cycles in (1, tq - 1, tq, tq + 1):
            T = (cycles - 1) * bank.M + bank.W
            flat = _fold_input(rng, 1, 3 * (T + 5) + 1, dev)[0]
            off = flat[1:1 + 3 * (T + 5)].view(3, T + 5)[:, :T]     # a float off the grid
            check(f"15a {name} 3 x {cycles} off the grid", off, bank, cycles)
        T = (tq + 2) * bank.M + bank.W
        check(f"15a {name} 2 x 2 x {tq + 3}", _fold_input(rng, 4, T, dev).view(2, 2, T),
              bank, tq + 3)
    # 15b: the fused peak on special values, the true-peak bank
    tiny = float(np.float32(1e-45))
    for rate in (44100,):
        bank = design_cycle_bank(rate, 4 * rate, quality="high")
        Qc = 20000
        T = (Qc - 1) * bank.M + bank.W
        base = _fold_input(rng, 2, T, dev)
        cases = {"silence": torch.zeros_like(base), "-0.0": torch.full_like(base, -0.0),
                 "subnormals": torch.from_numpy(
                     (rng.integers(-6, 7, (2, T)) * tiny).astype(np.float32)).to(dev)}
        for label, pos, v in (("NaN", 777, float("nan")), ("+inf", 3333, float("inf")),
                              ("-inf", 4444, float("-inf"))):
            cases[label] = base.clone()
            cases[label][1, pos] = v
        cases["NaN and +inf"] = cases["NaN"].clone()
        cases["NaN and +inf"][0, 9] = float("inf")
        for label, xp in cases.items():
            check(f"15b {rate}->{4 * rate} {label}", xp, bank, Qc)
            pk = float(cf.presliced_absmax_kernel(xp, bank, Qc))
            want = {"silence": 0.0, "-0.0": 0.0}.get(label)
            if want is not None and not (pk == 0.0 and not np.signbit(pk)):
                faults.append(f"15b {label}: peak {pk!r}, not +0.0")
            if "NaN" in label and not np.isnan(pk):
                faults.append(f"15b {label}: peak {pk!r}, not NaN")
            if label.endswith("inf") and label != "NaN and +inf" and not np.isinf(pk):
                faults.append(f"15b {label}: peak {pk!r}, not inf")
    print(f"cycle_fold 15a-b: {n} cases over {len(_fold_banks())} banks (the 48 dense L < 8 "
          f"banks of the standard rates, the meter's 8-32 kHz, a Lagrange bank, 48 -> 16 and "
          f"384 -> 8 kHz), each in its form and the slid banks in the generic form too: "
          f"kernel == twin bitwise outside NaNs and the fused peak == torch.max(torch.abs(twin)),"
          f" {len(faults)} faults; max |kernel - twin| {worst:.3g} [{card}]", flush=True)
    return faults, worst, n


def _fold_cpu_cases(card: str, dev) -> list[str]:
    """15c: the card's kernel against the CPU's twin on the same input, bit
    for bit (NaN at the same places), samples and peak, on
    `CYCLE_FOLD_CORE` at 2 x 2^15 cycles with a NaN and an inf."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr

    rng = np.random.default_rng(SEED + 151)
    faults, Q = [], 1 << 15
    for ri, ro, q, kind in CYCLE_FOLD_CORE:
        bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
        x = rng.uniform(-0.89, 0.89, (2, (Q - 1) * bank.M + bank.W)).astype(np.float32)
        x[1, 321], x[0, 4321] = np.nan, np.inf
        y = cf.resample_presliced_fold_kernel(torch.from_numpy(x).to(dev), bank, Q).cpu()
        pk = cf.presliced_absmax_kernel(torch.from_numpy(x).to(dev), bank, Q).cpu()
        yc = tr._presliced_fold(torch.from_numpy(x), bank, Q)
        same = _nan_bitwise(y, yc) and _nan_bitwise(pk.reshape(1),
                                                    torch.max(torch.abs(yc)).reshape(1))
        if not same:
            faults.append(f"15c {ri}->{ro} {q} {kind}: card != CPU twin")
    print(f"cycle_fold 15c: card kernel == CPU twin bitwise on {len(CYCLE_FOLD_CORE) - len(faults)}"
          f" of {len(CYCLE_FOLD_CORE)} banks at 2 x {Q} cycles (a NaN and an inf) [{card}]",
          flush=True)
    return faults


def _fold_chunks(card: str, dev, frames: int = 1 << 22) -> list[str]:
    """15d: a 2^22-frame stereo signal through the kernel whole and as haloed
    chunks of 6000 and 1777 cycles: the samples' sha256 equal, and the
    largest chunk peak the whole one's."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf

    rng = np.random.default_rng(SEED + 152)
    x = torch.from_numpy(_signal(rng, 2, frames, 48000)).to(dev)
    faults = []
    for ri, ro, q, kind in CYCLE_FOLD_CORE[:6]:
        bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
        out_len = bank.out_len(frames)
        Q = -(-out_len // bank.L)
        xp = torch.zeros((2, (Q + 6000) * bank.M + bank.W), device=dev)
        xp[:, bank.pad_front:bank.pad_front + frames] = x
        whole = cf.resample_presliced_fold_kernel(xp, bank, Q)
        pk_whole = cf.presliced_absmax_kernel(xp, bank, Q)
        shas = {"whole": _digest(whole)}
        for cycles in (6000, 1777):
            outs, peaks = [], []
            for q0 in range(0, Q, cycles):
                n = min(cycles, Q - q0)
                span = xp[:, q0 * bank.M:q0 * bank.M + (n - 1) * bank.M + bank.W]
                outs.append(cf.resample_presliced_fold_kernel(span, bank, n))
                peaks.append(cf.presliced_absmax_kernel(span, bank, n))
            shas[str(cycles)] = _digest(torch.cat(outs, dim=-1))
            if not _nan_bitwise(torch.stack(peaks).max().reshape(1), pk_whole.reshape(1)):
                faults.append(f"15d {ri}->{ro} {q} {kind}: chunk peaks {cycles} != whole")
        print(f"cycle_fold 15d: {ri}->{ro} {q} {kind}: 2 x {frames} frames, {Q} cycles whole "
              f"and in chunks of 6000 and 1777: sha256 {shas} [{card}]", flush=True)
        if len(set(shas.values())) != 1:
            faults.append(f"15d {ri}->{ro} {q} {kind}: chunked != whole {shas}")
        del xp, whole
    del x
    torch.cuda.empty_cache()
    return faults


def _fold_oracle(card: str, dev, frames: int = 16384) -> tuple[list[str], dict]:
    """Each fold bank of 15a and phase 3's four `cycle_src` banks against the
    float64 oracle near full scale (two tones and noise scaled to a 0.89
    peak, 16384 frames): dB RMS (<= `ORACLE_DB_MAX`) and the 24-bit LSB
    error, max and RMS; beside each fold bank, the batch graph's `resample`
    on the same input (the flat fold for L = 1, else float32 unfold +
    matmul)."""
    import numpy as np
    import torch

    from f9tpu_torch.models import design_cycle_bank, resample_oracle
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr
    from f9tpu_torch.ops import src_kernel as sk

    rng = np.random.default_rng(SEED + 153)
    faults, rows = [], {}
    worst = {"fold": (-999.0, 0.0), "batch": (-999.0, 0.0), "cycle_src": (-999.0, 0.0)}
    banks = [(b, "fold") for b in _fold_banks()] + [((ri, ro, q, "sinc"), "cycle_src")
                                                    for ri, ro, q in DENSE_BANKS]
    for (ri, ro, q, kind), form in banks:
        x = _signal(rng, 1, frames, ri)
        x *= np.float32(0.89 / np.abs(x).max())
        bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
        ref = resample_oracle(x, ri, ro, quality=q, kind=kind)
        xt = torch.from_numpy(x).to(dev)
        if form == "fold":
            Q = -(-ref.shape[-1] // bank.L)
            xp = torch.zeros((1, (Q - 1) * bank.M + bank.W), device=dev)
            keep = min(frames, xp.shape[-1] - bank.pad_front)
            xp[:, bank.pad_front:bank.pad_front + keep] = xt[:, :keep]
            outs = {"fold": cf.resample_presliced_fold_kernel(xp, bank, Q),
                    "batch": tr.resample(xt, bank)}
        else:
            outs = {"cycle_src": sk.resample_kernel(xt, bank)}
        line = []
        for f, y in outs.items():
            y = y.cpu().numpy()[:, :ref.shape[-1]]
            lsb = np.abs(y.astype(np.float64) - ref) * float(1 << 23)
            db = _db(y - ref, ref)
            rows[f"{ri}->{ro} {q} {kind} {f}"] = dict(db=db, lsb_max=float(lsb.max()),
                                                      lsb_rms=float(np.sqrt(np.mean(lsb ** 2))))
            line.append(f"{f} {db:.1f} dB, {lsb.max():.3f} LSB max, "
                        f"{np.sqrt(np.mean(lsb ** 2)):.3f} RMS")
            worst[f] = (max(worst[f][0], db), max(worst[f][1], float(lsb.max())))
            if f != "batch" and not db <= ORACLE_DB_MAX:
                faults.append(f"oracle {ri}->{ro} {q} {kind} {f}: {db:.1f} dB")
        print(f"cycle_fold oracle: {ri}->{ro} {q} {kind} (L={bank.L} M={bank.M}) at a 0.89 "
              f"peak: " + "; ".join(line) + f" [{card}]", flush=True)
    print("cycle_fold oracle: worst (dB, LSB max) " + ", ".join(
        f"{f} {db:.1f} dB {lsb:.3f} LSB" for f, (db, lsb) in worst.items()) + f" [{card}]",
          flush=True)
    return faults, {"worst": worst, "banks": rows}


def _fold_stream(card: str, work: str, dev) -> tuple[list[str], int]:
    """15e: `cli stream` of a 96 kHz stereo 24-bit WAV to 48 kHz (the 2:1
    bank, L = 1, M = 2) on the card at two chunk sizes, launches counted
    from zero: identical bytes, and the codes against the CPU path (0
    samples expected to differ; <= `LSB_TOL` is the contract).  Returns
    (faults, the kernel's launches)."""
    import numpy as np

    seconds, chunks = CYCLE_FOLD_STREAM
    src = os.path.join(work, "src96k.wav")
    n = _write_long_wav(src, seconds, SEED + 154, rate=96000)
    faults, shas, outs = [], {}, {}
    _zero_counts()
    for cs in chunks:
        out = os.path.join(work, f"s96k_{cs}.wav")
        rc, res, wall = _cli_json(["stream", src, "--out", out, "--rate", "48000", "--json",
                                   "--chunk-seconds", cs])
        shas[cs], outs[cs] = (_sha256(out) if rc == 0 else ""), out
        print(f"cycle_fold 15e: cli stream 96k -> 48k of {seconds:g} s, chunk {cs} s: rc={rc} "
              f"out_frames={res.get('out_frames')} wall={wall:.3f} s sha256={shas[cs][:16]} "
              f"[{card}]", flush=True)
        if rc != 0 or res.get("out_frames") != n // 2:
            faults.append(f"15e: chunk {cs}: rc={rc} {res}")
    _read_counts()
    launches = CYCLE_FOLD_READS[-1]
    if len(set(shas.values())) != 1:
        faults.append(f"15e: bytes depend on the chunk size {shas}")
    out_cpu = os.path.join(work, "s96k_cpu.wav")
    rc, res, wall_c = _cli_json(["stream", src, "--out", out_cpu, "--rate", "48000", "--json",
                                 "--device", "cpu"])
    g, _ = _read_codes(outs[chunks[0]])
    c, _ = _read_codes(out_cpu) if rc == 0 else (np.zeros(0), 0)
    same = g.shape == c.shape
    diff = np.abs(g - c) if same else np.zeros(1)
    print(f"cycle_fold 15e: the card's {launches} fold launches; CPU path rc={rc} in "
          f"{wall_c:.1f} s: {int((diff != 0).sum()) if same else -1} of {g.size} samples differ, "
          f"max {int(diff.max())} LSB (tol {LSB_TOL}) [{card}]", flush=True)
    if rc != 0 or not same or int(diff.max()) > LSB_TOL:
        faults.append("15e: card vs CPU path")
    if launches < 1:
        faults.append("15e: the stream launched no fold kernel")
    return faults, launches


def _fold_batch_input(dev, seed: int):
    """15g's batch (`CYCLE_FOLD_BATCH`) on ``dev``: ``(files, C, frames)``
    float32, each file's samples (a length drawn in the cell's seconds at
    96 kHz) two tones and noise at `_signal`'s levels, made on the device
    and rounded to 24-bit codes, zero past them; and the lengths."""
    import math

    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    files, C, T, (lo, hi) = CYCLE_FOLD_BATCH
    lengths = rng.integers(int(lo * 96000), int(hi * 96000) + 1, size=files)
    f = torch.from_numpy(rng.uniform(80.0, 6000.0, size=(files, C, 2, 1))).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.arange(T, dtype=torch.float64, device=dev) * (2 * math.pi / 96000)
    x = (0.3 * torch.sin(f[:, :, 0] * t) + 0.15 * torch.sin(f[:, :, 1] * t + 0.7)
         + 0.02 * torch.randn((files, C, T), dtype=torch.float64, device=dev, generator=gen))
    x = torch.round(x * (1 << 23)) / (1 << 23)
    valid = torch.arange(T, device=dev) < torch.from_numpy(lengths).to(dev)[:, None, None]
    return torch.where(valid, x, 0.0).to(torch.float32), [int(n) for n in lengths]


def _fold_flat_batch(card: str, dev) -> tuple[list[str], int]:
    """15g: the batch SRC of `CYCLE_FOLD_BATCH` at 96 -> 48 kHz high (the
    `studio48.hires_sfx` cell's graph call: ``resample`` of the front end's
    ``(8, 2, 2^22)`` to whole cycles), launches counted from zero: one flat
    launch, and its samples bit for bit the twin on the padded signal and
    the presliced kernel (the streamed form) on the same padded signal.
    Returns (faults, the flat launches)."""
    import torch
    import torch.nn.functional as F

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr

    bank = design_cycle_bank(96000, 48000, quality="high")
    x, lengths = _fold_batch_input(dev, SEED + 156)
    T = x.shape[-1]
    Q = -(-bank.out_len(T) // bank.L)
    _zero_counts()
    y = tr.resample(x, bank, out_len=Q * bank.L)
    torch.cuda.synchronize()
    flat, total = cf.launches_flat, cf.launches
    _n, Q, keep, pad_front, pad_back = tr._cycle_budget(T, bank, Q * bank.L)
    xp = F.pad(x.reshape(-1, T)[:, :keep], (pad_front, pad_back))
    twin = tr._presliced_fold(xp, bank, Q).reshape(y.shape)
    streamed = cf.resample_presliced_fold_kernel(xp, bank, Q).reshape(y.shape)
    faults = []
    same_twin, same_stream = _nan_bitwise(y, twin), _nan_bitwise(y, streamed)
    silent = int((y == 0).all(dim=-1).sum())
    print(f"cycle_fold 15g: hires batch {tuple(x.shape)} (files of {min(lengths) / 96000:.1f}-"
          f"{max(lengths) / 96000:.1f} s) -> {tuple(y.shape)} through resample: {flat} flat "
          f"launches of {total}; bitwise the twin {same_twin}, the presliced kernel "
          f"{same_stream}; {silent} silent rows [{card}]", flush=True)
    if (flat, total) != (1, 1):
        faults.append(f"15g: {flat} flat launches of {total}, not 1 of 1")
    if not same_twin:
        faults.append(f"15g: the flat form differs from the twin in "
                      f"{int((_bits(y) != _bits(twin)).sum())} words")
    if not same_stream:
        faults.append("15g: the flat form differs from the presliced kernel")
    del x, xp, y, twin, streamed
    torch.cuda.empty_cache()
    return faults, flat


def _fold_time_cases(dev) -> list[dict]:
    """15f's cases, built the same way here and in the profiled child: the
    meter's true-peak chunk (a 20 s chunk at 44.1 kHz, 2 x 882,000 cycles of
    the 4x bank, the fused peak) and a 20 s stream chunk at 96 -> 48 kHz high
    (2 x 960,000 cycles of the 2:1 bank, the samples).  Each: run, twin,
    library (one float64 `F.conv1d` of the chunk by G's columns, stride M:
    the same sums in another order, which the port never calls), bound (the
    larger of rows x cycles x sum(hi - lo) FMAs at `FP64_INSTR_PER_S` and the
    chunk read once, y written once at `HBM_BYTES_PER_S`)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr

    rng = np.random.default_rng(SEED + 155)
    cases = []
    for label, (ri, ro), Q, peak in (("meter true-peak chunk", (44100, 176400), 882000, True),
                                      ("20 s stream chunk 96k->48k", (96000, 48000), 960000,
                                       False)):
        bank = design_cycle_bank(ri, ro, quality="high")
        T = (Q - 1) * bank.M + bank.W
        xp = torch.from_numpy(_signal(rng, 2, T, ri)).to(dev)
        x64 = xp.to(torch.float64)[:, None]
        gt = torch.from_numpy(tr.cycle_matrix_f32(bank).T.copy()).to(dev, torch.float64)[:, None]
        fmas = 2 * Q * sum(hi - lo for _, lo, hi in tr._fold_rows(bank))
        nbytes = 4 * (2 * T + (0 if peak else 2 * Q * bank.L))
        t_ops, t_bytes = fmas / FP64_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
        cases.append(dict(
            label=label, shape=f"L={bank.L} M={bank.M} W={bank.W}, 2 x {Q} cycles"
            + (", fused peak" if peak else ""),
            run=(lambda xp=xp, b=bank, Q=Q: cf.presliced_absmax_kernel(xp, b, Q)) if peak else
            (lambda xp=xp, b=bank, Q=Q: cf.resample_presliced_fold_kernel(xp, b, Q)),
            twin=(lambda xp=xp, b=bank, Q=Q: cf.presliced_absmax_reference(xp, b, Q)) if peak else
            (lambda xp=xp, b=bank, Q=Q: tr._presliced_fold(xp, b, Q)),
            library=lambda x64=x64, gt=gt, M=bank.M: F.conv1d(x64, gt, stride=M),
            bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops > t_bytes else "bytes",
            ptxas=f"cycle_fold_kernelILi{bank.L}ELi{cf.fold_form(bank)}ELb{int(peak)}E"))
    return cases


def _fold_flat_time_cases(dev) -> list[dict]:
    """15g's case, in `_fold_time_cases`' form: the flat form at the hires
    cell's batch (`_fold_batch_input`); its library form is the unfold and
    float32 matmul it replaced, its bound the larger of the FMAs of the
    outputs the files' samples reach at `FP64_INSTR_PER_S` and those samples
    read once, y written once at `HBM_BYTES_PER_S`."""
    import torch.nn.functional as F

    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr

    bank = design_cycle_bank(96000, 48000, quality="high")
    xb, lengths = _fold_batch_input(dev, SEED + 156)
    files, C, T = xb.shape
    Q = -(-bank.out_len(T) // bank.L)
    _n, _Q, keep, pad_front, pad_back = tr._cycle_budget(T, bank, Q * bank.L)
    fmas = C * sum(bank.out_len(n) for n in lengths) * bank.W
    nbytes = 4 * C * (sum(lengths) + files * Q * bank.L)
    t_ops, t_bytes = fmas / FP64_INSTR_PER_S, nbytes / HBM_BYTES_PER_S
    return [dict(
        label="hires batch 96k->48k, flat",
        shape=f"L={bank.L} M={bank.M} W={bank.W}, {files * C} x {Q} cycles, files of "
        f"{min(lengths) / 96000:.1f}-{max(lengths) / 96000:.1f} s in {T / 96000:.1f}",
        run=lambda xb=xb, b=bank, n=Q * bank.L: tr.resample(xb, b, out_len=n),
        twin=lambda xb=xb, b=bank, Q=Q: tr._presliced_fold(F.pad(
            xb.reshape(-1, xb.shape[-1])[:, :keep], (pad_front, pad_back)), b, Q).reshape(
                *xb.shape[:-1], Q * b.L),
        library=lambda xb=xb, b=bank, n=Q * bank.L: tr._unfold_matmul(xb, b, n),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops > t_bytes else "bytes",
        ptxas=f"cycle_fold_kernelILi{bank.L}ELi{cf.fold_form(bank)}ELb0E")]


def cycle_fold_device_times_main(dev, flat: bool = False, runs: int = 20) -> dict:
    """15f's device times, for the child process (``--cycle-fold-device-
    times``; 15g's with ``flat``, ``--cycle-fold-flat-device-times``):
    {label: device ms a call of the kernel, "<label> memset": the memset's},
    from one `torch.profiler` session a case over ``runs`` calls after a
    warm-up."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    tag = "15g" if flat else "15f"
    for c in (_fold_flat_time_cases if flat else _fold_time_cases)(dev):
        c["run"]()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                c["run"]()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        kern = [e for e in evs if "cycle_fold_kernel" in e.name]
        mset = [e for e in evs if "emset" in e.name]
        out[c["label"]] = (sum(e.time_range.elapsed_us() for e in kern) / 1e3 / runs
                           if len(kern) == runs else None)
        out[f"{c['label']} memset"] = sum(e.time_range.elapsed_us() for e in mset) / 1e3 / runs
        print(f"cycle_fold {tag}: profiled child: {c['label']}: {len(kern)} kernel events "
              f"({sorted({e.name for e in kern})}), {len(mset)} memsets", flush=True)
    return out


def _fold_times(card: str, dev, flat: bool = False) -> tuple[dict, list[str]]:
    """15f: at `_fold_time_cases`' two shapes (15g: `_fold_flat_time_cases`'
    one, with ``flat``), the kernel's device time (the profiler in a process
    of its own, ``--cycle-fold-device-times`` or ``--cycle-fold-flat-device-
    times``; a fault if it reads none) and one call's CUDA-event time
    (median of 10) beside its bound, the twin's (median of 3) and the
    library call's; the kernel bitwise the twin there.  Returns the JSON
    summary's numbers (the first case's, and every case's under
    "per_shape") and the faults."""
    import torch

    tag = "15g" if flat else "15f"
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--cycle-fold-flat-device-times" if flat else
                           "--cycle-fold-device-times"], capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith(f"cycle_fold {tag}"):
            print(line, flush=True)
    result = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    faults = []
    if proc.returncode != 0 or not result:
        faults.append(f"{tag}: the profiled process failed (exit {proc.returncode}): "
                      f"{proc.stderr[-2000:]}")
        device = {}
    else:
        device = json.loads(result[-1])
    out = {}
    for c in (_fold_flat_time_cases if flat else _fold_time_cases)(dev):
        got, want = c["run"](), c["twin"]()
        same = _nan_bitwise(got.reshape(-1), want.reshape(-1))
        err = float((got - want).abs().max())
        if not same:
            faults.append(f"{tag} {c['label']}: kernel != twin")
        dev_ms = device.get(c["label"])
        if dev_ms is None:
            faults.append(f"{tag} {c['label']}: the profiler read no device time")
        r = dict(ms=_median_ms(c["run"]), device_ms=dev_ms,
                 memset_ms=device.get(f"{c['label']} memset"),
                 plain_ms=_median_ms(c["twin"], runs=3), library_ms=_median_ms(c["library"]),
                 bound_ms=c["bound_ms"], bound_by=c["bound_by"], max_abs_err=err, bitwise=same,
                 shape=c["shape"], ptxas=_ptxas_stats(c["ptxas"]))
        if not out:
            out = dict(r, per_shape={})
        out["per_shape"][c["label"]] = r
        print(f"cycle_fold {tag}: {c['label']} ({r['shape']}): kernel {r['ms']:.4f} ms (device "
              f"{'none' if dev_ms is None else f'{dev_ms:.4f}'}, memset "
              f"{r['memset_ms'] or 0:.4f}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), twin "
              f"{r['plain_ms']:.2f} ms, {'unfold + matmul' if flat else 'float64 F.conv1d'} "
              f"{r['library_ms']:.3f} ms, bitwise {same}, ptxas {r['ptxas']} [{card}]",
              flush=True)
    torch.cuda.empty_cache()
    return out, faults


def phase_cycle_fold(card: str, work: str, dev) -> dict:
    """Phase 15, the L < 8 fold kernel: 15a-b against its twin on every
    bank, 15c against the CPU's twin, 15d chunked against whole, the banks
    against the float64 oracle near full scale, 15e the 96 kHz stream, 15f
    the times; held to `CYCLE_FOLD_BUDGET_S`.  Returns 15f's numbers with
    15e's launches and 15a's largest difference."""
    t_all = time.time()
    walls, faults = {}, []
    t0 = time.time()
    twin_faults, worst, cases = _fold_twin_cases(card, dev)
    faults += twin_faults
    walls["15a-b"] = time.time() - t0
    t0 = time.time()
    faults += _fold_cpu_cases(card, dev)
    walls["15c"] = time.time() - t0
    t0 = time.time()
    faults += _fold_chunks(card, dev)
    walls["15d"] = time.time() - t0
    t0 = time.time()
    oracle_faults, oracle = _fold_oracle(card, dev)
    faults += oracle_faults
    walls["oracle"] = time.time() - t0
    t0 = time.time()
    stream_faults, stream_launches = _fold_stream(card, work, dev)
    faults += stream_faults
    walls["15e"] = time.time() - t0
    t0 = time.time()
    out, time_faults = _fold_times(card, dev)
    faults += time_faults
    walls["15f"] = time.time() - t0
    total = time.time() - t_all
    t0 = time.time()
    flat_faults, flat_launches = _fold_flat_batch(card, dev)
    flat_out, time_faults = _fold_times(card, dev, flat=True)
    faults += flat_faults + time_faults
    out["per_shape"].update(flat_out["per_shape"])
    walls["15g"] = time.time() - t0
    print(f"phase 15 (cycle_fold): {total:.1f} s (budget {CYCLE_FOLD_BUDGET_S:g}), 15g "
          f"{walls['15g']:.1f} s (budget {CYCLE_FOLD_FLAT_BUDGET_S:g}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" [{card}]", flush=True)
    if total > CYCLE_FOLD_BUDGET_S:
        faults.append(f"{total:.1f} s > {CYCLE_FOLD_BUDGET_S:g} s")
    if walls["15g"] > CYCLE_FOLD_FLAT_BUDGET_S:
        faults.append(f"15g {walls['15g']:.1f} s > {CYCLE_FOLD_FLAT_BUDGET_S:g} s")
    _raise_faults("phase 15", faults)
    out.update(max_abs_err=worst, cases=cases, stream_launches=stream_launches,
               flat_launches=flat_launches, oracle_worst=oracle["worst"],
               seconds=dict(walls, total=total + walls["15g"]))
    return out


#: phase 16's budget, seconds: the case grid, the slice's shape and the timing child
FRONT_END_BUDGET_S = 120.0
#: the front end's launches of each main-path drive, as `_read_counts` read
#: them (`main` sums them by path; `EPILOGUE_READS` keeps step with it)
FRONT_END_READS: list[int] = []
#: the paths whose drives must launch the front-end kernel (16c)
FRONT_END_PATHS = ("default_job", "rows_layout", "stream", "normalize", "insert_loop")
#: the wires of 16a: (bits, big-endian), None for the float32 bucket
FRONT_END_WIRES = ((16, False), (16, True), (24, False), (24, True), None)


def _fe_name(spec) -> str:
    return "float32" if spec is None else f"{spec[0]}-bit {'BE' if spec[1] else 'LE'}"


def _fe_wire(rng, spec, files: int, c_in: int, frames: int, extra: int = 0):
    """Random wire bytes ``(files, frames * c_in * bytes + extra)`` with the
    extreme codes in file 0, or a float32 ``(files, c_in, frames)`` bucket
    with -0.0, NaN and inf in its last file; a CPU tensor."""
    import numpy as np
    import torch

    if spec is None:
        x = (0.5 * rng.standard_normal((files, c_in, frames))).astype(np.float32)
        x[-1, 0, :3] = [-0.0, np.nan, np.inf]
        return torch.from_numpy(x)
    nb = spec[0] // 8
    raw = rng.integers(0, 256, size=(files, frames * c_in * nb + extra), dtype=np.uint8)
    top = 1 if spec[1] else nb - 1
    raw[0, :2 * nb] = 0
    raw[0, top] = 0x80
    raw[0, nb:2 * nb] = 0xFF
    raw[0, nb + top] = 0x7F
    return torch.from_numpy(raw)


def _fe_routings(c_in: int) -> list:
    """(name, routing, out_channels): identity, swap, silent, wider than the
    input, fan-out (`tests/test_torch_frontend.py`'s grid)."""
    cases = [("none", None, None), ("identity", list(range(c_in)), None),
             ("swap", list(range(c_in))[::-1], None),
             ("silent", [-1] + list(range(1, c_in))[::-1], None),
             ("wider", [i % c_in for i in range(c_in + 2)] + [-1], None)]
    if c_in == 1:
        cases += [("fan-out", None, 2), ("fan-out routed", [5, -1, 0, 3], 6)]
    return cases


def _front_end_twin_cases(card: str, dev) -> tuple[list[str], float, int]:
    """16a: the kernel against its twin on the card, bitwise (`torch.equal`
    on the bits): every wire, 1-8 input channels, each routing of
    `_fe_routings`, valid lengths of 0, 1, a tile's edge and one either
    side, part of the bucket, all of it and past it, at a bucket of two tiles
    and three frames; rows 1-15 bytes off the 16-byte grid with a stride past
    the row; the stream form with means, spans and offsets; the slice's
    8 x 2 x 2^22 24-bit wire with 50-60 s files; 65,600 mono 16-bit files.
    Returns the faults, the largest difference and the case count."""
    import numpy as np
    import torch

    from f9tpu_torch.ops import frontend as fe

    rng = np.random.default_rng(SEED + 160)
    faults, worst, n = [], 0.0, 0

    def check(label: str, kernel, twin) -> None:
        nonlocal worst, n
        n += 1
        got, want = kernel(), twin()
        if not _bitwise(got, want):
            faults.append(f"16a {label}: kernel != twin")
            if got.shape == want.shape:
                d = torch.where(torch.isfinite(want), (got - want).abs(), torch.zeros((), device=dev))
                worst = max(worst, float(d.max()))
            else:
                worst = float("inf")

    for spec in FRONT_END_WIRES:
        for c_in in (1, 2, 3, 6, 8):
            bpf = 0 if spec is None else c_in * spec[0] // 8
            tile = fe.front_end_tile(bpf)
            frames = 2 * tile + 3
            x = _fe_wire(rng, spec, 8, c_in, frames, extra=1 if spec else 0).to(dev)
            fv = torch.tensor([0, 1, tile - 1, tile, tile + 1, frames // 2 + 3, frames,
                               frames + 5], dtype=torch.int32, device=dev)
            raw = None if spec is None else (c_in, *spec)
            for name, routing, out_ch in _fe_routings(c_in):
                kw = dict(raw=raw, routing=routing, out_channels=out_ch)
                check(f"{_fe_name(spec)} C_in={c_in} {name}",
                      lambda: fe.front_end(x, fv, **kw),
                      lambda: fe.front_end_reference(x, fv, **kw))
            if spec is None:
                continue
            shift = 1 + (5 * c_in) % 15
            wide = torch.zeros((8, x.shape[1] + 19), dtype=torch.uint8, device=dev)
            wide[:, shift:shift + x.shape[1]] = x
            v = wide[:, shift:shift + x.shape[1]]
            check(f"{_fe_name(spec)} C_in={c_in} rows {shift} bytes off the grid",
                  lambda: fe.front_end(v, fv, raw=raw, routing=[c_in - 1, -1]),
                  lambda: fe.front_end_reference(v, fv, raw=raw, routing=[c_in - 1, -1]))
            routing = list(range(c_in))[::-1] + [-1]
            for (lo, hi), off in (((0, 0), 0), ((3, frames - 4), 0), ((-5, 10 ** 6), 0),
                                  ((100, 400), 250), ((0, 300), -40)):
                mean = torch.from_numpy((0.01 * rng.standard_normal((c_in + 1, 1)))
                                        .astype(np.float32)).to(dev)
                kw = dict(raw=raw, routing=routing, mean=mean, span=(lo, hi), idx_offset=off)
                check(f"{_fe_name(spec)} C_in={c_in} stream span [{lo}, {hi}) offset {off}",
                      lambda: fe.front_end(v[1], **kw), lambda: fe.front_end_reference(v[1], **kw))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    wire = torch.randint(0, 256, (8, 6 << 22), dtype=torch.uint8, device=dev, generator=gen)
    fv = torch.from_numpy(rng.integers(50 * 44100, 60 * 44100, 8).astype(np.int32)).to(dev)
    for routing in (None, [1, 0]):
        check(f"the slice's 8 x 2 x 2^22 24-bit wire, routing {routing}",
              lambda: fe.front_end(wire, fv, raw=(2, 24, False), routing=routing),
              lambda: fe.front_end_reference(wire, fv, raw=(2, 24, False), routing=routing))
    del wire
    mono = torch.randint(0, 256, (65600, 600), dtype=torch.uint8, device=dev, generator=gen)
    fv = torch.from_numpy(rng.integers(0, 301, 65600).astype(np.int32)).to(dev)
    check("65,600 mono 16-bit files of 300 frames, fanned out to 2",
          lambda: fe.front_end(mono, fv, raw=(1, 16, False), out_channels=2),
          lambda: fe.front_end_reference(mono, fv, raw=(1, 16, False), out_channels=2))
    torch.cuda.empty_cache()
    print(f"front_end 16a: {n} cases, {n - len(faults)} bitwise the twin, largest difference "
          f"{worst:g} [{card}]", flush=True)
    return faults, worst, n


def _front_end_times(card: str) -> tuple[dict, list[str]]:
    """16b: `f9tpu_torch/tools/front_end_times.py` on this checkout in a
    process of its own (CUDA events and `torch.profiler`'s device events):
    the raw front end at the slice's shape, routed, at the full bucket, the
    float wire, the raw- and float-wire graphs, a 20 s stream chunk and the
    twin's three cases, each with its device operations a call and peak
    memory.  Returns the cases by name and the faults."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "f9tpu_torch", "tools",
                                                        "front_end_times.py"), "--tag", "change"],
                          capture_output=True, text=True, timeout=600)
    cases, faults = {}, []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            c = json.loads(line)
            cases[c["case"]] = c
            print(f"front_end 16b: {c['case']}: {c['events_ms']:.4f} ms (device "
                  f"{'none' if c['device_ms'] is None else format(c['device_ms'], '.4f')} in "
                  f"{c['device_ops']:g} operations), peak {c['peak_mb']} MB"
                  + (f", bound {c['bound_ms']:.4f} ms" if "bound_ms" in c else "")
                  + f", sha256 {c['sha256']} [{card}]", flush=True)
    if proc.returncode != 0 or "raw" not in cases:
        faults.append(f"16b: the timing process failed (exit {proc.returncode}): "
                      f"{proc.stderr[-2000:]}")
    for name in ("raw", "raw routed", "raw full bucket", "float", "stream chunk"):
        c = cases.get(name)
        if c is not None and (c["device_ms"] is None or c["device_ops"] != 1):
            faults.append(f"16b {name}: {c['device_ops']} device operations a call, not the "
                          f"kernel alone")
    for name in ("raw", "raw routed", "stream chunk"):
        if name in cases and cases.get(f"twin {name}", {}).get("sha256") != cases[name]["sha256"]:
            faults.append(f"16b {name}: the kernel's output differs from the twin's")
    return cases, faults


def phase_front_end(card: str, dev) -> dict:
    """Phase 16, the front end as one kernel: 16a against its twin on the
    case grid, 16b the times in a child process beside the twin, the bound
    and ptxas; held to `FRONT_END_BUDGET_S`.  Returns the JSON summary's
    numbers."""
    t_all = time.time()
    faults, walls = [], {}
    t0 = time.time()
    twin_faults, worst, n_cases = _front_end_twin_cases(card, dev)
    faults += twin_faults
    walls["16a"] = time.time() - t0
    t0 = time.time()
    cases, time_faults = _front_end_times(card)
    faults += time_faults
    walls["16b"] = time.time() - t0
    from f9tpu_torch.ops import _build

    ptxas = {k: v for k, v in _build.ptxas_report(_build.build_log).items()
             if "front_end_kernel" in k}
    print(f"front_end: ptxas {ptxas} [{card}]", flush=True)
    total = time.time() - t_all
    print(f"phase 16 (front end): {total:.1f} s (budget {FRONT_END_BUDGET_S:g}): "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()) + f" [{card}]", flush=True)
    if total > FRONT_END_BUDGET_S:
        faults.append(f"{total:.1f} s > {FRONT_END_BUDGET_S:g} s")
    _raise_faults("phase 16", faults)
    raw, twin = cases["raw"], cases.get("twin raw", {})
    return {"max_abs_err": worst, "cases": n_cases, "ms": raw["events_ms"],
            "device_ms": raw["device_ms"], "plain_ms": twin.get("events_ms"),
            "bound_ms": raw["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "ptxas": ptxas, "per_case": {k: {f: v[f] for f in ("events_ms", "device_ms",
                                                              "device_ops", "peak_mb",
                                                              "bound_ms") if f in v}
                                         for k, v in cases.items()},
            "seconds": dict(walls, total=total)}


def front_end_digests(work: str) -> dict:
    """The sha256 of phase 4's job (8 stereo 24-bit takes, `cli process
    --rate 48000`), phase 6's streams (6b's `cli process` of the 600 s file
    and two 30 s files, 6c's `cli stream` of the 600 s file with the chain at
    20 s chunks) and phase 7d's normalized job, for the `f9tpu_torch` beside
    this script, its inputs made in ``work`` as the phases make theirs.  A
    file's dither is keyed by its path, so trees are compared with the same
    ``work`` (``--front-end-digests DIR``: emptied first)."""
    import numpy as np

    from f9tpu_torch import cli, resolve_device
    from f9tpu_torch.io import wav
    from f9tpu_torch.ops.resample import resample_rates
    from f9tpu_torch.pipeline import calibration

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    def digest(out_dir: str) -> str:
        h = hashlib.sha256()
        for name in sorted(os.listdir(out_dir)):
            if name.endswith((".wav", ".aiff", ".flac")):
                h.update(name.encode() + bytes.fromhex(_sha256(os.path.join(out_dir, name))))
        return h.hexdigest()[:16]

    def run(argv: list[str]) -> None:
        rc, _out, err, _wall = _run_cli(argv)
        if rc != 0:
            raise AssertionError(f"digests: {' '.join(argv[:2])} rc={rc}\n{err[-2000:]}")

    got = {}
    rng = np.random.default_rng(SEED + 1)
    slice_in = os.path.join(work, "slice")
    os.makedirs(slice_in)
    for i in range(8):
        frames = int(rng.integers(50 * 44100, 60 * 44100))
        wav.write_wav(os.path.join(slice_in, f"take{i}.wav"), _signal(rng, 2, frames, 44100),
                      44100, bits=24)
    run(["process", slice_in, "--out", os.path.join(work, "slice_out"), "--rate", "48000"])
    got["default_job"] = digest(os.path.join(work, "slice_out"))

    stream_in = os.path.join(work, "stream")
    os.makedirs(stream_in)
    long_path = os.path.join(stream_in, "long.wav")
    _write_long_wav(long_path, 600.0, SEED + 8)
    for i in range(2):
        _write_long_wav(os.path.join(stream_in, f"short{i}.wav"), 30.0, SEED + 9 + i)
    run(["process", stream_in, "--out", os.path.join(work, "stream_b"), "--rate", "48000"])
    got["stream_6b"] = digest(os.path.join(work, "stream_b"))
    ir_path = os.path.join(work, "IR.wav")
    wav.write_wav(ir_path, _stereo_ir(np.random.default_rng(SEED + 2)), 48000, bits=32)
    chain = cli._build_chain(argparse.Namespace(**_chain_args(ir_path)))
    ring = chain.tail_frames(48000)
    lat = calibration.measure_latency(
        44100, 48000, chain_fn=lambda v: chain.apply(resample_rates(v, 44100, 48000), 48000),
        capture_frames=max(calibration.CAPTURE_FRAMES,
                           -(-(3 * ring + (1 << 15)) * 44100 // 48000)),
        ringout_frames=ring, device=resolve_device("cuda")).latency_frames
    out_c = os.path.join(work, "stream_c")
    os.makedirs(out_c)
    run(["stream", long_path, "--out", os.path.join(out_c, "long_20.wav"), "--rate", "48000",
         "--chain-delay-ms", "5", "--chain-eq", "peaking:1000:1:3", "--chain-comp=-18:3",
         "--chain-ir", ir_path, "--chain-limit=-0.3", "--latency", str(lat),
         "--chunk-seconds", "20"])
    got["stream_6c"] = digest(out_c)

    rng = np.random.default_rng(SEED + 72)
    norm_in = os.path.join(work, "normalize")
    os.makedirs(norm_in)
    levels_db = np.linspace(0.0, -20.0, 8)
    for i in range(8):
        frames = int(rng.integers(50 * 44100, 60 * 44100))
        x = _signal(rng, 2, frames, 44100) * np.float32(10.0 ** (levels_db[i] / 20.0))
        if i == 6:
            x[:, ::22050] = 0.6
        wav.write_wav(os.path.join(norm_in, f"take{i}.wav"), x, 44100, bits=24)
    run(["process", norm_in, "--out", os.path.join(work, "normalize_out"), *NORMALIZE_FLAGS])
    got["normalize"] = digest(os.path.join(work, "normalize_out"))
    shutil.rmtree(work, ignore_errors=True)
    return got


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
    if sys.argv[1:] == ["--chain-device-times"]:
        print(json.dumps(chain_device_times_main(resolve_device("cuda"))), flush=True)
        return 0
    if sys.argv[1:] == ["--cycle-fold-device-times"]:
        print(json.dumps(cycle_fold_device_times_main(resolve_device("cuda"))), flush=True)
        return 0
    if sys.argv[1:] == ["--cycle-fold-flat-device-times"]:
        print(json.dumps(cycle_fold_device_times_main(resolve_device("cuda"), flat=True)),
              flush=True)
        return 0
    if sys.argv[1:] == ["--cycle-fold"]:
        card = _card()
        print(card, flush=True)
        _build.load_library()
        print(_build.build_log.strip(), flush=True)
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        try:
            out = phase_cycle_fold(card, work, resolve_device("cuda"))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({k: out[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                              "bound_ms", "max_abs_err", "cases",
                                              "stream_launches", "seconds")}), flush=True)
        return 0
    if sys.argv[1:] == ["--front-end"]:
        card = _card()
        print(card, flush=True)
        _build.load_library()
        print(_build.build_log.strip(), flush=True)
        out = phase_front_end(card, resolve_device("cuda"))
        print(json.dumps({k: out[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                              "max_abs_err", "cases", "ptxas", "per_case",
                                              "seconds")}), flush=True)
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--front-end-digests":
        card = _card()
        t0 = time.time()
        got = front_end_digests(os.path.abspath(sys.argv[2]))
        print(json.dumps({"tree": ROOT, **got, "seconds": time.time() - t0, "card": card}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--graph-profile"]:
        print(json.dumps(graph_profile_main(resolve_device("cuda"))), flush=True)
        return 0
    if sys.argv[1:] == ["--sweep"]:
        card = _card()
        print(card, flush=True)
        _build.load_library()
        print(_build.build_log.strip(), flush=True)
        out = phase_sweep(card, resolve_device("cuda"))
        print(json.dumps({k: out[k] for k in ("dense_banks", "windowed_banks", "dense_err",
                                              "windowed_err", "launches", "job", "seconds")}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--fuzz"]:
        card = _card()
        print(card, flush=True)
        _build.load_library()
        print(_build.build_log.strip(), flush=True)
        out = phase_fuzz(card, resolve_device("cuda"))
        print(json.dumps({k: out[k] for k in ("launches", "worst", "trials", "seconds")}),
              flush=True)
        return 0
    if sys.argv[1:] == ["--chain-kernels"]:
        card = _card()
        print(card, flush=True)
        _build.load_library()
        print(_build.build_log.strip(), flush=True)
        out = phase_chain_kernels(card, resolve_device("cuda"))
        print(json.dumps({k: out[k] for k in ("upols_mac", "fir_fold", "ma_past",
                                              "slanted_cummax", "window_max")}), flush=True)
        return 0
    if sys.argv[1:] == ["--epilogue"]:
        _build.load_library()
        print(_build.build_log.strip(), flush=True)
        out = phase_epilogue(_card(), resolve_device("cuda"))
        print(json.dumps({k: out[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms")}),
              flush=True)
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
    epilogue_by_path = {}
    chain_by_path = {}
    fold_by_path = {}
    flat_by_path = {}
    front_by_path = {}
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
        reads = len(EPILOGUE_READS)
        try:
            # each phase sets the counts to 0 just before it drives its
            # path and reads them just after: a launch is the dense form's
            # unless it was counted as the windowed form's
            total, windowed[path] = phase(card, work)
            epilogue_by_path[path] = sum(EPILOGUE_READS[reads:])
            chain_by_path[path] = _chain_sum(reads)
            fold_by_path[path] = sum(CYCLE_FOLD_READS[reads:])
            flat_by_path[path] = sum(CYCLE_FOLD_FLAT_READS[reads:])
            front_by_path[path] = sum(FRONT_END_READS[reads:])
            dense[path] = total - windowed[path]
            if path == "default_job":
                slice_work, work = work, None    # phase 9a holds its outputs to these
        finally:
            if work is not None:
                shutil.rmtree(work, ignore_errors=True)
        print(f"phase {n} ({path}): {time.time() - t0:.1f} s", flush=True)

    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    t0 = time.time()
    reads = len(EPILOGUE_READS)
    try:
        for path, (total, win) in phase_tools(card, work, dev).items():
            dense[path], windowed[path] = total - win, win
        epilogue_by_path["tools"] = sum(EPILOGUE_READS[reads:])
        chain_by_path["tools"] = _chain_sum(reads)
        fold_by_path["tools"] = sum(CYCLE_FOLD_READS[reads:])
        flat_by_path["tools"] = sum(CYCLE_FOLD_FLAT_READS[reads:])
        front_by_path["tools"] = sum(FRONT_END_READS[reads:])
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 8 (tool path): {time.time() - t0:.1f} s", flush=True)

    try:
        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        t0 = time.time()
        reads = len(EPILOGUE_READS)
        try:
            for path, (total, win) in phase_multi_device(card, work, slice_work, dev).items():
                dense[path], windowed[path] = total - win, win
            epilogue_by_path["multi_device"] = sum(EPILOGUE_READS[reads:])
            chain_by_path["multi_device"] = _chain_sum(reads)
            fold_by_path["multi_device"] = sum(CYCLE_FOLD_READS[reads:])
            flat_by_path["multi_device"] = sum(CYCLE_FOLD_FLAT_READS[reads:])
            front_by_path["multi_device"] = sum(FRONT_END_READS[reads:])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"phase 9 (multi-device): {time.time() - t0:.1f} s", flush=True)

        work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
        t0 = time.time()
        reads = len(EPILOGUE_READS)
        try:
            for path, (total, win) in phase_rows(card, work, slice_work, dev).items():
                dense[path], windowed[path] = total - win, win
            epilogue_by_path["rows_layout"] = sum(EPILOGUE_READS[reads:])
            chain_by_path["rows_layout"] = _chain_sum(reads)
            fold_by_path["rows_layout"] = sum(CYCLE_FOLD_READS[reads:])
            flat_by_path["rows_layout"] = sum(CYCLE_FOLD_FLAT_READS[reads:])
            front_by_path["rows_layout"] = sum(FRONT_END_READS[reads:])
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(f"phase 10 (rows layout): {time.time() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(slice_work, ignore_errors=True)

    print(f"epilogue: launches by path {epilogue_by_path} [{card}]", flush=True)
    idle = [p for p, n in epilogue_by_path.items() if n < 1]
    if idle:
        raise AssertionError(f"epilogue: no launch on the paths {idle}")
    t0 = time.time()
    ke = phase_epilogue(card, dev)
    print(f"phase 11 (epilogue): {time.time() - t0:.1f} s", flush=True)
    # phase 12 drives two paths: 12a's `resample_rates` per bank and 12e's
    # batch job per pair, each read around every call
    ks = phase_sweep(card, dev)
    dense["sweep_src"] = ks["launches"][0] - ks["launches"][1]
    windowed["sweep_src"] = ks["launches"][1]
    dense["sweep_job"] = ks["job"]["src"]
    epilogue_by_path["sweep_job"] = ks["job"]["epilogue"]
    # phase 13 drives three paths, each read around every run on the card
    kf = phase_fuzz(card, dev)
    for path, (d, w, e) in kf["launches"].items():
        dense[path], windowed[path], epilogue_by_path[path] = d, w, e
    t0 = time.time()
    kc = phase_chain_kernels(card, dev)
    print(f"phase 14 (chain kernels): {time.time() - t0:.1f} s", flush=True)
    chain_by_path["chain_stages"] = kc["launches"]
    chain_kernels = []
    for i, (name, source, replaces) in enumerate((
            ("upols_mac", "f9tpu_torch/csrc/upols.cu", "f9tpu/ops/chain.py:128"),
            ("fir_fold", "f9tpu_torch/csrc/fold.cu", "f9tpu/ops/chain.py:85"),
            ("ma_past", "f9tpu_torch/csrc/fold.cu", "f9tpu/ops/chain.py:873"),
            ("slanted_cummax", "f9tpu_torch/csrc/dynamics.cu", "f9tpu/ops/chain.py:733"),
            ("window_max", "f9tpu_torch/csrc/dynamics.cu", "f9tpu/ops/chain.py:902"))):
        by_path = {p: n[i] for p, n in chain_by_path.items()}
        print(f"{name}: launches by path {by_path} [{card}]", flush=True)
        need = ("insert_loop", "stream") + (("normalize",) if name == "upols_mac" else ())
        idle = [p for p in need if by_path.get(p, 0) < 1]
        if idle:
            raise AssertionError(f"{name}: no launch on the paths {idle}")
        k14 = kc[name]
        chain_kernels.append({
            # no TPU kernel computes it: XLA compiles the scan or fuses the
            # shifted terms (`replaces` names the JAX function)
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            **{k: k14[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")},
            **{k: k14[k] for k in ("device_ms", "bound_ms_8_instructions", "per_shape")
               if k in k14}})
    chain_kernels[0]["also_replaces"] = "f9tpu/ops/chain.py:160"
    chain_kernels[3]["also_replaces"] = "f9tpu/ops/chain.py:703"
    work = tempfile.mkdtemp(prefix=".smoke-", dir=ROOT)
    t0 = time.time()
    try:
        kfold = phase_cycle_fold(card, work, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"phase 15 (cycle_fold): {time.time() - t0:.1f} s", flush=True)
    fold_by_path["cycle_fold_stream"] = kfold["stream_launches"]
    fold_by_path["cycle_fold_flat_batch"] = flat_by_path["cycle_fold_flat_batch"] = \
        kfold["flat_launches"]
    print(f"cycle_fold: launches by path {fold_by_path} [{card}]", flush=True)
    print(f"cycle_fold: launches_flat (the batch SRC of L = 1 banks) by path {flat_by_path} "
          f"[{card}]", flush=True)
    idle = [p for p in ("normalize", "cycle_fold_stream") if fold_by_path.get(p, 0) < 1]
    if idle:
        raise AssertionError(f"cycle_fold: no launch on the paths {idle}")
    t0 = time.time()
    kfe = phase_front_end(card, dev)
    print(f"phase 16 (front end): {time.time() - t0:.1f} s", flush=True)
    print(f"front_end: launches by path {front_by_path} [{card}]", flush=True)
    idle = [p for p in FRONT_END_PATHS if front_by_path.get(p, 0) < 1]
    if idle:
        raise AssertionError(f"front_end: no launch on the paths {idle}")
    chain_kernels.append({
        # no TPU kernel computes it: XLA's convolution of the streamed SRC
        # and the true peak's max |y| (`replaces` names the JAX functions)
        "name": "cycle_fold", "route": "cuda", "source": "f9tpu_torch/csrc/cycle_fold.cu",
        "replaces": "f9tpu/ops/resample.py:307", "also_replaces": "f9tpu/ops/loudness.py:363",
        "launches": sum(fold_by_path.values()), "launches_by_path": fold_by_path,
        "launches_flat_by_path": flat_by_path,
        **{k: kfold[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_ms", "per_shape", "cases",
                                 "oracle_worst")}})
    chain_kernels.append({
        # no TPU kernel computes it: one XLA fusion of the JAX graph's front
        # end and of the stream's (`replaces` names the JAX functions)
        "name": "front_end", "route": "cuda", "source": "f9tpu_torch/csrc/frontend.cu",
        "replaces": "f9tpu/pipeline/graph.py:63",
        "also_replaces": ["f9tpu/ops/devcodec.py:32", "f9tpu/pipeline/stream.py:229"],
        "launches": sum(front_by_path.values()), "launches_by_path": front_by_path,
        **{k: kfe[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "device_ms", "cases", "ptxas", "per_case")}})

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
        "sweep_banks": ks["dense_banks"],
        "sweep_max_abs_err": ks["dense_err"],
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
        "sweep_banks": ks["windowed_banks"],
        "sweep_max_abs_err": ks["windowed_err"],
    }, {
        # no TPU kernel computes it: XLA fuses the JAX graph's epilogue
        "name": "epilogue",
        "route": "cuda",
        "source": "f9tpu_torch/csrc/epilogue.cu",
        "replaces": "f9tpu/pipeline/graph.py:188",
        "also_replaces": "f9tpu/ops/devcodec.py:100",
        "launches": sum(epilogue_by_path.values()),
        "launches_by_path": epilogue_by_path,
        "max_abs_err": ke["max_abs_err"],
        "ms": ke["ms"],
        "plain_ms": ke["plain_ms"],
        "bound_ms": ke["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "per_shape": ke["per_shape"],
        "per_graph": ke["per_graph"],
    }, *chain_kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
