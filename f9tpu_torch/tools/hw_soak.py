"""Streaming soak of the port: the chain's and the stream's byte-exactness
properties, run on a device (the port's twin of the JAX package's
`tools/hw_soak.py`).

1. the pinned repro: FIRInsert of 64 taps in 997-frame chunks, Biquad
   peaking 1 kHz q=2 +6 dB in 997- and 4096-frame chunks; streamed ==
   whole at 0 ULP, the same 24-bit codes, and the two chunkings equal;
2. random chain stacks of every built-in stage through `Chain.apply_stream`
   in random grid-respecting chunkings, each equal to `Chain.apply` at
   0 ULP;
3. random end-to-end configs through `stream_resample_file` (WAV, AIFF and
   FLAC in and out, routing and fan-out, latency, reverb tails, 16 and 24
   bits, a 2x upsampling bank the kernel does not take; every third trial
   the varispeed pair 44.1k -> 44056, every third a loudness-normalized
   one), each written at two chunk sizes: identical bytes and the exact
   frame count.

    python -m f9tpu_torch.tools.hw_soak [--seed S] [--chain-trials N] \\
        [--stream-trials N] [--device cuda|cpu]

Each part raises AssertionError on the first divergence; the last line is a
one-line summary.  The CPU tests call the parts with a fixed seed and few
trials.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device

RATE = 48000


def _stream(chain, x: torch.Tensor, bounds: list[int], dev) -> torch.Tensor:
    """``chain`` over ``x (channels, T)`` in the chunks ``bounds``."""
    st = chain.stream_init(RATE, x.shape[0], dev)
    outs = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        o, st = chain.apply_stream(x[:, a:b], st, RATE, a)
        outs.append(o)
    return torch.cat(outs, dim=-1)


def pinned_repro(device=None) -> None:
    """Part 1: a 64-tap FIR and a peaking biquad (an 858-tap fold), each
    streamed in fixed chunks against the whole signal."""
    from ..ops.chain import Biquad, Chain, FIRInsert

    dev = resolve_device(device)
    rng = np.random.default_rng(40)
    T = 80000
    x = torch.from_numpy((0.5 * rng.standard_normal((2, T))).astype(np.float32)).to(dev)
    for name, chain, chunks in (
            ("fir64", Chain(FIRInsert(rng.standard_normal(64).astype(np.float32))), (997,)),
            ("biquad_peak1k_q2", Chain(Biquad("peaking", 1000.0, 2.0, 6.0)), (997, 4096))):
        whole = chain.apply(x, RATE)
        runs = []
        for chunk in chunks:
            got = _stream(chain, x, list(range(0, T, chunk)) + [T], dev)
            bad = int((got != whole).sum())
            codes = int((torch.round(got * (1 << 23)) != torch.round(whole * (1 << 23))).sum())
            assert bad == 0, (name, chunk, "float diffs", bad, "code diffs", codes)
            runs.append(got)
        assert all(torch.equal(r, runs[0]) for r in runs), (name, "chunk-size variant")
        print(f"  pinned [{name}]: 0 ULP whole vs streamed at {chunks}", flush=True)


def chain_fuzz(seed: int, trials: int, device=None) -> None:
    """Part 2: random stacks of 1-4 stages from every built-in kind (the
    FIR length crosses `FIR_FOLD_MAX`), streamed in 1-3 random cuts on the
    chain's grid, against the whole signal at 0 ULP."""
    from ..ops.chain import (Biquad, Chain, Compressor, ConvolutionReverb, Delay,
                             Expander, FIRInsert, Gain, Limiter, Saturator,
                             StereoWidth)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def pool():
        ir = (0.05 * np.exp(-np.arange(9000) / 3000.0)
              * rng.standard_normal(9000)).astype(np.float32)
        return [
            lambda: Gain(float(rng.uniform(-6, 6))),
            lambda: Delay(float(rng.uniform(0.0, 0.01))),
            lambda: FIRInsert(np.hanning(int(rng.integers(3, 1400))).astype(np.float32)),
            lambda: Biquad("peaking", float(rng.uniform(100, 8000)),
                           float(rng.uniform(0.5, 4.0)), float(rng.uniform(-6, 6))),
            lambda: Saturator(("tanh", "soft", "hard")[rng.integers(3)],
                              drive_db=float(rng.uniform(-6, 9)),
                              mix=float(rng.uniform(0.2, 1.0))),
            lambda: Compressor(threshold_db=float(rng.uniform(-30, -10)),
                               ratio=float(rng.uniform(1.5, 8.0)),
                               attack_ms=float(rng.uniform(0.0, 8.0)),
                               release_db_per_s=float(rng.uniform(60, 600)),
                               knee_db=float(rng.uniform(0, 8))),
            lambda: StereoWidth(float(rng.uniform(0.2, 1.8))),
            lambda: ConvolutionReverb(ir, wet=float(rng.uniform(0.2, 0.8)),
                                      dry=float(rng.uniform(0.0, 0.8))),
            lambda: Expander(threshold_db=float(rng.uniform(-60, -30)),
                             ratio=float(rng.uniform(1.5, 6.0)),
                             release_db_per_s=float(rng.uniform(100, 500)),
                             range_db=float(rng.uniform(20, 70))),
            lambda: Limiter(ceiling_db=float(rng.uniform(-6, -0.1)),
                            lookahead_ms=float(rng.uniform(0.5, 4.0)),
                            release_db_per_s=float(rng.uniform(100, 600))),
        ]

    for trial in range(trials):
        makers = pool()
        chain = Chain(*(makers[rng.integers(len(makers))]()
                        for _ in range(int(rng.integers(1, 5)))))
        g = max(1, chain.stream_grid(RATE))
        T = 5 * max(g, 4000)
        T -= T % g
        x = torch.from_numpy((0.4 * rng.standard_normal((2, T))).astype(np.float32)).to(dev)
        whole = chain.apply(x, RATE)
        cuts = sorted({int(c) * g for c in rng.integers(1, T // g, size=int(rng.integers(1, 4)))})
        bounds = [0] + [c for c in cuts if 0 < c < T] + [T]
        got = _stream(chain, x, bounds, dev)
        assert torch.equal(whole, got), (
            f"trial {trial}: {chain!r} split {bounds} diverged by "
            f"{float((whole - got).abs().max())}")
        print(f"  chain trial {trial}: {chain!r} split {bounds}: 0 ULP", flush=True)


def stream_fuzz(seed: int, trials: int, work: str, device=None) -> None:
    """Part 3: random configs through `stream_resample_file` at chunk
    0.11 s and 0.34 s: identical bytes, the exact frame count (within the
    tail cap in reverb mode), routed-silent channels zero.  Trial 1 of
    every three streams the varispeed pair 44.1k -> 44056 at chunks of
    0.26 s and 0.8 s (one and three cycles of 11025 frames), trial 2
    normalizes to a LUFS target (and, half the time, under a dBTP
    ceiling)."""
    from ..config import ProcessingConfig
    from ..io import codec
    from ..io.aiff import write_aiff
    from ..io.flac import write_flac_codes
    from ..io.wav import write_wav
    from ..models.filters import design_cycle_bank
    from ..pipeline.stream import stream_resample_file

    dev = resolve_device(device)
    for t in range(trials):
        rng = np.random.default_rng(seed + 13 * t)
        ch = int(rng.choice([1, 2, 4]))
        vari, norm = t % 3 == 1, t % 3 == 2
        frames = int(rng.integers(40_000, 60_000) if (vari or norm)
                     else rng.integers(3000, 30_000))
        x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
        container = str(rng.choice(["wav", "aiff", "flac"]))
        src = os.path.join(work, f"s{t}.{container}")
        if container == "flac":
            codes24 = np.clip(np.round(x.astype(np.float64) * (1 << 23)),
                              -(1 << 23), (1 << 23) - 1).astype(np.int64)
            write_flac_codes(src, codes24, 44100, bits=24)
        else:
            (write_wav if container == "wav" else write_aiff)(src, x, 44100, bits=24)
        kw = dict(output_dir=work, quality="low",
                  target_rate=44056 if vari else int(rng.choice([48000, 32000, 88200])),
                  kind=str(rng.choice(["sinc", "minphase"])),
                  bits=int(rng.choice([16, 24])),
                  dither=bool(rng.integers(2)),
                  remove_dc=bool(rng.integers(2)),
                  seed=int(rng.integers(100)),
                  gain_db=float(rng.choice([0.0, -3.0])),
                  output_format=str(rng.choice(["wav", "aiff", "flac"])))
        lat = int(rng.integers(-200, 300)) if rng.integers(2) else 0
        if ch == 1 and rng.integers(2):
            kw["output_channels"] = 2
        elif ch == 4 and rng.integers(2):
            kw["channel_routing"] = [3, 0, -1, 1]
        if norm:
            kw["normalize_lufs"] = float(rng.choice([-23.0, -16.0]))
            if rng.integers(2):
                kw["normalize_tp_db"] = -1.0
        reverb = bool(rng.integers(3) == 0)
        if reverb:
            kw.update(reverb_mode=True, noise_floor_db=-85.0, max_tail_seconds=0.3)
        cfg = ProcessingConfig(**kw)
        ext = {"aiff": "aiff", "flac": "flac"}.get(cfg.output_format, "wav")
        outs = [os.path.join(work, f"o{t}_{i}.{ext}") for i in range(2)]
        n1, n2 = (stream_resample_file(src, o, cfg, chunk_seconds=cs,
                                       latency_frames=lat, device=dev)
                  for o, cs in zip(outs, (0.26, 0.8) if vari else (0.11, 0.34)))
        assert n1 == n2, (t, kw, lat, n1, n2)
        with open(outs[0], "rb") as f1, open(outs[1], "rb") as f2:
            assert f1.read() == f2.read(), (t, kw, lat, "bytes depend on the chunk size")
        expect = design_cycle_bank(44100, cfg.target_rate, quality="low",
                                   kind=cfg.kind).out_len(frames)
        if reverb:
            assert expect <= n1 <= expect + int(0.3 * cfg.target_rate), (t, n1, expect)
        else:
            assert n1 == expect, (t, n1, expect)
        y, r = codec.read_audio(outs[0])
        assert r == cfg.target_rate and y.shape[1] == n1 and np.isfinite(y).all()
        if "channel_routing" in kw:
            assert not y[2].any()
        print(f"  stream trial {t}: {container} -> {ext} {kw['bits']} bit, "
              f"rate {cfg.target_rate}, normalize {cfg.normalize_lufs}, "
              f"latency {lat}, reverb {reverb}: bytes chunk-size invariant", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m f9tpu_torch.tools.hw_soak")
    ap.add_argument("--seed", type=int, default=int(time.time()) % 100000)
    ap.add_argument("--chain-trials", type=int, default=8)
    ap.add_argument("--stream-trials", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"hw_soak: device={dev} ({name}) seed={args.seed}", flush=True)
    t0 = time.time()
    print("[1/3] pinned repro", flush=True)
    pinned_repro(dev)
    print(f"[2/3] chain fuzz: {args.chain_trials} stacks", flush=True)
    chain_fuzz(args.seed, args.chain_trials, dev)
    print(f"[3/3] stream fuzz: {args.stream_trials} configs", flush=True)
    with tempfile.TemporaryDirectory() as work:
        stream_fuzz(args.seed, args.stream_trials, work, dev)
    print(f"hw_soak PASS: device={dev} ({name}) seed={args.seed} "
          f"chain_trials={args.chain_trials} stream_trials={args.stream_trials} "
          f"wall={time.time() - t0:.1f}s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
