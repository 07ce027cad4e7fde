#!/usr/bin/env python3
"""The insert chain's device times, for this checkout or another.

    python3 f9tpu_torch/tools/chain_times.py [--root DIR] [--tag NAME]

Times, on the card, with the `f9tpu_torch` of the checkout at ``--root``
(default: the one holding this file) and `chip_smoke.py` phase 5's chain
(5 ms delay, peaking EQ 1 kHz / Q 1 / +3 dB, compressor -18:3, a stereo
2.5 s IR, limiter -0.3): the insert loop's batch graph (8 stereo files in
the 60 s capture bucket at 44.1 kHz, reverb mode) and each chain stage alone
on its 48 kHz output; one 20 s chunk of the stream with the chain (SRC,
chain, finish); and one 54.6 s stereo file's loudness meter
(`meter_source_streamed` with the true peak, host clock), its true peak
alone (each 20 s chunk's `_tp_step`, summed) and its K-weighting of one
20 s chunk; then the delay-line MAC and the fold kernel
alone at three shapes each (the MAC: one group of the insert loop's reverb,
of the stream chunk's and of the meter's K-weighting; the fold: the EQ's
taps on the insert loop's batch and on the stream chunk, and `FIR_FOLD_MAX`
taps on the chunk), and the dynamics kernels at the insert loop's and the
chunk's linked rows (the moving average at the compressor's and the
limiter's windows, the release envelope, the windowed maximum; a tree
without the envelope or the windowed-maximum kernel skips them).  Device
times are CUDA events, the median of 5 calls after a warm-up; the kernels
also get the ms a call of a back-to-back loop and their device time from
`torch.profiler` (a small launch's events time the host's launch too).  A
sha256 of the graph's outputs, of the stream chunk's payload, of the
meter's result and its chunks' true peaks, and of the chunk's K-weighting
shows whether two trees compute the same bytes.  It prints one JSON line
with the card's name and power limit.  Run it as a script, not with
``-m``, so that ``--root`` decides which ``f9tpu_torch`` is imported:
comparing two trees takes one process each, in turns (parent, change,
change, parent) on one card.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        import torch

        return torch.cuda.get_device_name(0)


def _ms(fn, runs: int = 5) -> float:
    """Median CUDA-event ms of ``fn()`` over ``runs`` calls after one."""
    import numpy as np
    import torch

    fn()
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


def _device_ms(fn, pattern, runs: int = 20) -> float:
    """Device ms a call of the kernels whose names hold ``pattern`` (a
    string or a tuple of them), from `torch.profiler` over ``runs`` calls
    after one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    def device_us(e):
        t = getattr(e, "device_time_total", None)
        return e.cuda_time_total if t is None else t

    us = sum(device_us(e) for e in prof.key_averages()
             if any(p in e.key for p in ((pattern,) if isinstance(pattern, str) else pattern)))
    return us / 1e3 / runs


def _loop_ms(fn, calls: int = 50) -> float:
    """ms a call over ``calls`` back-to-back calls (CUDA events around the
    loop): where a launch is shorter than its host work, the host's cost."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / calls


def _sha(*parts) -> str:
    """sha256 (first 16 hex digits) of tensors' bytes and numbers as
    float64, in order."""
    import numpy as np
    import torch

    h = hashlib.sha256()
    for v in parts:
        if isinstance(v, torch.Tensor):
            h.update(v.detach().contiguous().cpu().numpy().tobytes())
        else:
            h.update(np.asarray(np.nan if v is None else v, np.float64).tobytes())
    return h.hexdigest()[:16]


def _stereo_ir(rng, rate: int = 48000, seconds: float = 2.5):
    """`chip_smoke.py`'s IR: decaying noise, 90 dB down at its end, unit
    energy per channel, behind a 0.5 direct-sound spike."""
    import numpy as np

    n = int(seconds * rate)
    tau = seconds / (90.0 / (20.0 * np.log10(np.e)))
    ir = rng.standard_normal((2, n)) * np.exp(-np.arange(n) / (tau * rate))
    ir /= np.sqrt(np.sum(np.square(ir), axis=-1, keepdims=True))
    ir[:, 0] = 0.5
    return ir.astype(np.float32)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the checkout whose f9tpu_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the checkout in the output")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import tempfile

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chain_times: no CUDA GPU available", file=sys.stderr)
        return 1
    from f9tpu_torch import cli, resolve_device
    from f9tpu_torch.config import ProcessingConfig
    from f9tpu_torch.io import wav
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import dither
    from f9tpu_torch.ops import loudness as ld
    from f9tpu_torch.ops.resample import resample_presliced
    from f9tpu_torch.ops.src_kernel import resample_auto
    from f9tpu_torch.pipeline import graph
    from f9tpu_torch.pipeline import stream as st

    dev = resolve_device("cuda")
    rng = np.random.default_rng(20260116)
    with tempfile.TemporaryDirectory() as work:
        ir_path = os.path.join(work, "IR.wav")
        wav.write_wav(ir_path, _stereo_ir(rng), 48000, bits=32)
        chain = cli._build_chain(argparse.Namespace(
            rate=48000, chain_delay_ms=5.0, chain_gate=None, chain_eq=["peaking:1000:1:3"],
            chain_fir=None, chain_comp="-18:3", chain_sat=None, chain_width=None,
            chain_ir=ir_path, chain_wet=1.0, chain_dry=0.0, chain_limit="-0.3"))
    out = {"tag": args.tag, "root": os.path.abspath(args.root), "card": _card()}

    # the insert loop's batch graph, and each stage on its 48 kHz output
    lat = 312
    cfg = ProcessingConfig(output_dir="unused", target_rate=48000, reverb_mode=True,
                           channel_routing=[1, 0], chain=chain)
    blen = 60 * 44100
    t = np.arange(blen) / 44100.0
    valid = rng.integers(20 * 44100, 40 * 44100, 8).astype(np.int32)
    x = np.where(np.arange(blen)[None, None, :] < valid[:, None, None],
                 0.3 * np.sin(2 * np.pi * 441.0 * t)
                 + 0.05 * rng.standard_normal((8, 2, blen)), 0.0).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    vd = torch.from_numpy(valid).to(dev)
    seeds = np.arange(1, 9, dtype=np.int32)
    def run_graph():
        return graph.process_batch(xd, vd, cfg, 44100, seeds, latency_frames=lat, device=dev)

    r = run_graph()
    out["insert_loop_graph_sha256"] = _sha(r.codes, r.out_frames, r.tail_terminated, r.peak_db,
                                           r.rms_db, r.noise_floor_db)
    out["insert_loop_graph_ms"] = _ms(run_graph)
    pad = graph._default_pad_frames(cfg, 44100, lat)
    y = resample_auto(torch.nn.functional.pad(xd[:, [1, 0]], (0, pad)),
                      design_cycle_bank(44100, 48000))
    out["stage_ms"] = {type(s).__name__: _ms(lambda s=s: s.apply(y, 48000))
                       for s in chain.stages}
    out["capture_frames_48k"] = int(y.shape[-1])

    # one 20 s chunk of the stream with the chain
    scfg = ProcessingConfig(output_dir="unused", target_rate=48000, chain=chain,
                            latency_frames=lat)
    bank = design_cycle_bank(44100, 48000)
    cycles = st._chunk_cycles(bank, scfg, 20.0, 44100)
    xp = torch.from_numpy(x[0, :, :(cycles - 1) * bank.M + bank.W].copy()).to(dev)
    seeds_c = dither.channel_seeds(torch.tensor(12345, device=dev), 2)
    states = chain.stream_init(48000, 2, dev)

    def run_chunk():
        return st._finish_chunk(resample_presliced(xp, bank, cycles), states, seeds_c, 0, 1.0,
                                rate_out=48000, bits=24, do_dither=True, chain=chain,
                                wire="pack24")[0]

    out["stream_chunk_sha256"] = _sha(run_chunk())
    out["stream_chunk_ms"] = _ms(run_chunk)
    out["stream_chunk_frames"] = int(cycles * bank.L)

    # one file's meter: the whole call (host clock) and one chunk's K-weighting
    T = int(54.6 * 44100)
    src = np.ascontiguousarray(x[1, :, :T])
    read = ld.array_reader(src)
    walls = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.time()
        m = ld.meter_source_streamed(read, 2, T, 44100, want_tp=True, device=dev)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.time() - t0))
    out["meter_sha256"] = _sha(m["lufs"], m["true_peak_db"])
    out["meter"] = m
    out["meter_file_ms"] = float(np.median(walls[1:]))
    # the meter's true peak alone: each 20 s chunk's `_tp_step` on its haloed
    # span, as `meter_source_streamed` cuts it
    ctx = int(ld.k_weighting_ir().shape[0]) - 1
    chunk_in = ld._meter_chunk_plan(44100, 20.0, ctx)[0]
    th_l, th_r = ld._halos(design_cycle_bank(44100, 4 * 44100, quality="high"))
    tp_ms, peaks = 0.0, []
    for start in range(0, T, chunk_in):
        xtp = torch.from_numpy(ld._read_span(read, 2, T, start - th_l,
                                             th_l + chunk_in + th_r)).to(dev)
        peaks.append(ld._tp_step(xtp, cycles=chunk_in, rate_in=44100, oversample=4))
        tp_ms += _ms(lambda: ld._tp_step(xtp, cycles=chunk_in, rate_in=44100, oversample=4))
    out["meter_true_peak_ms"] = tp_ms
    out["meter_true_peak_sha256"] = _sha(*peaks)
    z = torch.from_numpy(np.ascontiguousarray(x[2, :, :20 * 48000 + 5000])).to(dev)
    out["k_weight_20s_sha256"] = _sha(ld.k_weight(z))
    out["k_weight_20s_ms"] = _ms(lambda: ld.k_weight(z))

    # the two kernels alone, three shapes each
    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck

    gen = torch.Generator(device=dev).manual_seed(15)
    rev, eq = chain.stages[3], chain.stages[1]
    B = rev.stream_grid(48000)
    H = rev._spectrum(B, dev).to(torch.complex64).contiguous()         # (30, 2, 1, Nf)
    kw = ld.k_weighting_ir().astype(np.float32)
    Bk = ch._fft_block_size(int(kw.shape[0]))
    Hk = ch._spectrum([ch._partition_ir(kw, Bk)], dev)[:, 0].contiguous()   # (2, 1, Nf)
    G = ch.UPOLS_GROUP
    kernels = {}
    for label, Hs, lead in (("upols_mac, insert loop", H, (2, 8)),
                            ("upols_mac, 20 s stream chunk", H, (2, 1)),
                            ("upols_mac, meter", Hk, (2,))):
        buf = torch.randn((Hs.shape[0] - 1 + G, *lead, Hs.shape[-1]), dtype=torch.complex64,
                          device=dev, generator=gen)
        kernels[label] = dict(
            shape=f"K={Hs.shape[0]}, G={G}, rows {lead}, {Hs.shape[-1]} bins",
            sha256=_sha(ck.upols_mac(buf, Hs, G)),
            ms=_ms(lambda: ck.upols_mac(buf, Hs, G)),
            loop_ms=_loop_ms(lambda: ck.upols_mac(buf, Hs, G)),
            device_ms=_device_ms(lambda: ck.upols_mac(buf, Hs, G), "upols_mac"))
    chunk = y[0, :, :out["stream_chunk_frames"]].contiguous()
    taps = eq._taps(48000)
    wide = (rng.standard_normal(ch.FIR_FOLD_MAX) / np.sqrt(ch.FIR_FOLD_MAX)).astype(np.float32)
    for label, v, tp in (("fir_fold, insert loop", y, taps),
                         ("fir_fold, 20 s stream chunk", chunk, taps),
                         (f"fir_fold, 20 s stream chunk, {ch.FIR_FOLD_MAX} taps", chunk, wide)):
        td = torch.from_numpy(tp.copy()).to(dev)
        kernels[label] = dict(
            shape=f"W={tp.shape[0]}, {tuple(v.shape)}", sha256=_sha(ck.fir_fold(v, td)),
            ms=_ms(lambda: ck.fir_fold(v, td)),
            loop_ms=_loop_ms(lambda: ck.fir_fold(v, td), calls=10),
            device_ms=_device_ms(lambda: ck.fir_fold(v, td), "fir_fold", runs=5))
    # the dynamics kernels on the insert loop's linked rows and a 20 s
    # chunk's: the moving averages (the compressor's detector on both
    # channels, its attack and the limiter's ramp), the compressor's release
    # envelope and the limiter's windowed maximum; a tree without a kernel
    # skips it
    comp, lim = chain.stages[2], chain.stages[4]
    sq = torch.square(y)
    link = sq[:, :1].contiguous()
    sqc = torch.square(chunk)
    for label, v, win in (("ma_past, insert loop, win 48", sq, 48),
                          ("ma_past, insert loop, win 240", link, 240),
                          ("ma_past, insert loop, win 73", link, 73),
                          ("ma_past, 20 s stream chunk, win 240", sqc[:1].contiguous(), 240)):
        kernels[label] = dict(
            shape=f"win={win}, {tuple(v.shape)}", sha256=_sha(ck.ma_past(v, win)),
            ms=_ms(lambda: ck.ma_past(v, win)), loop_ms=_loop_ms(lambda: ck.ma_past(v, win)),
            device_ms=_device_ms(lambda: ck.ma_past(v, win), "ma_past"))
    c_comp, c_lim = comp.release_db_per_s / 48000, lim.release_db_per_s / 48000
    L = lim.lookahead_frames(48000)
    for where, v, pos in (("insert loop", y, 0), ("20 s stream chunk", chunk[None], 3 * 960000)):
        lead = (v.shape[0], 1)
        level = (10.0 * torch.log10(torch.clamp(
            torch.square(v).amax(dim=-2, keepdim=True), min=1e-20))).contiguous()
        init = torch.full(lead, -1e9, device=dev)
        lvl = torch.abs(v).amax(dim=-2, keepdim=True)
        atten = torch.clamp(20.0 * torch.log10(torch.clamp(lvl, min=1e-20))
                            - float(np.float32(lim.ceiling_db)), min=0.0).contiguous()
        ac = torch.cat([torch.zeros((*lead, L), device=dev),
                        ch.Compressor._slanted_cummax_stream(atten, c_lim, 0, init, init)[0]],
                       dim=-1)
        if hasattr(ck, "slanted_cummax"):
            def env(level=level, init=init, pos=pos):
                return ck.slanted_cummax(level, c_comp, pos, init, init, ch.Compressor._ENV_BLOCK)

            # the first design's three launches and the one-pass kernel, and
            # the memset of the latter's flags beside it
            kernels[f"slanted_cummax, {where}"] = dict(
                shape=f"{tuple(level.shape)}, pos {pos}", sha256=_sha(*env()), ms=_ms(env),
                loop_ms=_loop_ms(env),
                device_ms=_device_ms(env, ("env_tile_max", "env_walk", "env_write", "env_scan")),
                memset_ms=_device_ms(env, "Memset"))
        if hasattr(ck, "window_max"):
            kernels[f"window_max, {where}"] = dict(
                shape=f"W={L + 1}, {tuple(ac.shape)}", sha256=_sha(ck.window_max(ac, L + 1)),
                ms=_ms(lambda: ck.window_max(ac, L + 1)),
                loop_ms=_loop_ms(lambda: ck.window_max(ac, L + 1)),
                device_ms=_device_ms(lambda: ck.window_max(ac, L + 1), ("wmax_tile", "wmax_reg")))
    out["kernels"] = kernels
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
