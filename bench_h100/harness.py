"""The benchmark of `f9tpu_torch`'s batch device path: one cell, one run.

The window drives `f9tpu_torch.pipeline.graph.process_batch_raw` as the batch
job's dispatch thread and collector drive it for an integer-PCM bucket: the
24-bit wire in a pinned buffer (`link.host_empty`), the graph enqueued with
the calibrated latency and noise floor, all six results copied to the host
by `link.Download` on a side stream, results queued for a collector thread
two deep (the scheduler's ``res_q``), and a batch counted when its results
are on the host.  Set-up (timed as ``setup_s``): imports, the CUDA context,
the kernels' build (a cache hit after a checkout's first run), the library
made on the card from the seed and copied once into pinned buffers, the
calibration through the program, and a warm-up of the cell's own shapes.

``--trace 0`` measures the end-to-end metrics over ``--seconds``; ``--trace 1``
wraps a fixed number of batches of the same loop in `torch.profiler` and
prints the per-layer metrics (``metrics/<name>.py``) and a breakdown.  Either
run judges a sample of its own batches, drawn from the seed, against the
plain reference (``reference/``) once the window has closed.  The last line
of standard output is the result's JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import random
import sys
import threading
import time

import numpy as np

from . import cell as cells

FORBIDDEN = ("jax", "jaxlib", "flax", "f9tpu")
#: results waiting for the collector, as the batch job's ``res_q``
QUEUE_DEPTH = 2


def _err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Modules loaded whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Program:
    """The system under test, set up for one cell: the program's
    configuration and chain, the library in pinned buffers, the calibration."""

    def __init__(self, c: cells.Cell, seed: int, dev, irs: dict):
        import torch

        from f9tpu_torch.config import ProcessingConfig
        from f9tpu_torch.pipeline import graph, link

        self.c, self.seed, self.dev, self.torch = c, seed, dev, torch
        self.graph, self.link = graph, link
        cfg = c.config
        self.cfg = ProcessingConfig(
            target_rate=cfg["target_rate"], quality=cfg["quality"], kind=cfg["kind"],
            bits=cfg["bits"], dither=cfg["dither"], remove_dc=cfg["remove_dc"],
            gain_db=cfg.get("gain_db", 0.0), trim_enabled=cfg.get("trim_enabled", True),
            chain=self._chain(cfg.get("chain"), irs), reverb_mode=cfg.get("reverb_mode", False),
            noise_floor_margin_pct=cfg.get("noise_floor_margin_pct", 10.0),
            tail_mode=cfg.get("tail_mode", "peak"), tail_window_ms=cfg.get("tail_window_ms", 100),
            tail_hop_ms=cfg.get("tail_hop_ms", 50),
            tail_consecutive=cfg.get("tail_consecutive", 3),
            max_tail_seconds=cfg.get("max_tail_seconds", 60.0),
            channel_routing=cfg.get("channel_routing"), batch_size=cfg["batch_size"],
            bucket_frames=tuple(cfg["bucket_frames"]), output_dir="unused")
        self.side = link.side_stream(dev)
        self.phases = {}
        for name, step in (("library", self._make_library), ("calibration", self._calibrate)):
            t = time.perf_counter()
            step()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            self.phases[name] = time.perf_counter() - t

    @staticmethod
    def _chain(stages, irs):
        if not stages:
            return None
        from f9tpu_torch.ops import chain as ch

        made = []
        for i, s in enumerate(stages):
            kw = {k: v for k, v in s.items() if k != "stage"}
            kind = s["stage"]
            if kind == "delay":
                made.append(ch.Delay(kw["ms"] / 1000.0))
            elif kind == "biquad":
                made.append(ch.Biquad(kw["kind"], kw["freq_hz"], q=kw["q"], gain_db=kw["gain_db"]))
            elif kind == "compressor":
                made.append(ch.Compressor(**kw))
            elif kind == "reverb":
                made.append(ch.ConvolutionReverb(irs[i], wet=kw["wet"], dry=kw["dry"]))
            elif kind == "limiter":
                made.append(ch.Limiter(**kw))
            else:
                raise ValueError(f"no stage {kind!r}")
        return ch.Chain(*made)

    def _make_library(self) -> None:
        """The mix's files as 24-bit interleaved PCM, made on the device
        from the seed (two tones and noise per channel), each library batch
        in one pinned buffer of the bucket's width, zero past each file."""
        torch, tr = self.torch, self.c.traffic
        C, nb, rate = tr["channels"], tr["bits"] // 8, tr["rate_in"]
        files, bs = tr["files"], self.c.config["batch_size"]
        bucket = self.c.bucket()
        lengths = self.c.lengths(self.seed)
        gen = torch.Generator(device=self.dev).manual_seed(cells.mix64(self.seed, 3) >> 1)
        f_lo, f_hi = tr["freq_hz"]
        a0, a1 = tr["tones"]
        s = float(1 << (tr["bits"] - 1))
        self.wire, self.valid = [], []
        for b in range(files // bs):
            buf = self.link.host_empty((bs, bucket * C * nb), torch.uint8, self.dev)
            host = buf.numpy()
            valid = np.zeros(bs, np.int32)
            for i in range(bs):
                n = lengths[b * bs + i]
                f = f_lo + (f_hi - f_lo) * torch.rand((C, 2), generator=gen, device=self.dev,
                                                      dtype=torch.float64)
                t = torch.arange(n, device=self.dev, dtype=torch.float64) / rate
                x = (a0 * torch.sin(2 * np.pi * f[:, :1] * t)
                     + a1 * torch.sin(2 * np.pi * f[:, 1:] * t + 0.7)
                     + tr["noise"] * torch.randn((C, n), generator=gen, device=self.dev,
                                                 dtype=torch.float64))
                codes = torch.clamp(torch.round(x * s), -s, s - 1).to(torch.int32)
                wire = codes.t().contiguous().view(torch.uint8).reshape(n, C, 4)[..., :nb]
                buf[i, :n * C * nb].copy_(wire.reshape(-1))
                host[i, n * C * nb:] = 0
                valid[i] = n
            self.wire.append(buf)
            self.valid.append(valid)

    def _calibrate(self) -> None:
        """Latency and noise floor as the batch job measures them: one
        impulse through the SRC (and the chain), cached per rate pair; a
        numerically silent floor leaves the tail detector at its fallback."""
        from f9tpu_torch.ops.resample import resample_rates
        from f9tpu_torch.pipeline.calibration import CAPTURE_FRAMES, CalibrationCache

        cfg, rate_in = self.cfg, self.c.traffic["rate_in"]
        chain_fn, sig, capture, ringout = None, "", CAPTURE_FRAMES, 0
        if cfg.chain is not None:
            ringout = int(cfg.chain.tail_frames(cfg.target_rate))
            sig = cfg.chain.sig_str()
            capture = max(CAPTURE_FRAMES,
                          -(-(3 * ringout + (1 << 15)) * rate_in // cfg.target_rate))

            def chain_fn(x):
                y = resample_rates(x, rate_in, cfg.target_rate, quality=cfg.quality,
                                   kind=cfg.kind)
                return cfg.chain.apply(y, cfg.target_rate)

        cal = CalibrationCache().get_or_measure(
            rate_in, cfg.target_rate, quality=cfg.quality, kind=cfg.kind, chain_fn=chain_fn,
            chain_sig=sig, capture_frames=capture, ringout_frames=ringout, device=self.dev)
        if not cal.detected:
            raise RuntimeError("calibration impulse not detected")
        self.latency = cal.latency_frames
        self.noise_floor = (cal.noise_floor_db if cfg.reverb_mode and cal.noise_floor_db > -150.0
                            else None)

    def dispatch(self, k: int):
        """Enqueue dispatch ``k``: library batch ``k % batches`` with its own
        dither seeds, and the six downloads behind it."""
        b = k % len(self.wire)
        tr = self.c.traffic
        res = self.graph.process_batch_raw(
            self.wire[b], self.valid[b], self.cfg, tr["rate_in"],
            self.c.dither_seeds(self.seed, k), in_channels=tr["channels"],
            in_bits=tr["bits"], latency_frames=self.latency, noise_floor_db=self.noise_floor,
            device=self.dev)
        return self.link.Download(res.codes, res.out_frames, res.peak_db, res.rms_db,
                                  res.noise_floor_db, res.tail_terminated, side=self.side)


class Loop:
    """Dispatches on the calling thread, a collector thread that waits for
    each batch's results; keeps a reservoir sample of finished batches."""

    def __init__(self, prog: Program, sample: int, rng: random.Random, k0: int = 0):
        self.prog, self.sample, self.rng = prog, sample, rng
        self.span = lambda name: contextlib.nullcontext()
        self.done: list[tuple] = []   # (k, t_dispatch, t_done, audio-s out, files, out_frames)
        self.kept: list[tuple] = []           # (k, host results)
        self.errors: list[str] = []
        self.k = k0                   # the next dispatch: no two dispatches of a run alike

    def _collect(self, q: queue.Queue) -> None:
        rate = self.prog.cfg.target_rate
        seen = 0
        while True:
            item = q.get()
            if item is None:
                return
            k, t0, dl = item
            try:
                with self.span("bench.collect"):
                    host = dl.get()
            except Exception as err:          # a batch that fails counts as failed files
                self.errors.append(f"dispatch {k}: {err}")
                continue
            t1 = time.perf_counter()
            frames = np.array(host[1], np.int64)
            self.done.append((k, t0, t1, float(frames.sum()) / rate, len(frames), frames))
            if seen < self.sample:
                self.kept.append((k, host))
            else:
                j = self.rng.randrange(seen + 1)
                if j < self.sample:
                    self.kept[j] = (k, host)
            seen += 1

    def run(self, until: float | None = None, batches: int | None = None) -> tuple[int, int]:
        """Dispatch until the clock passes ``until`` or ``batches`` are out;
        returns the (first, end) dispatch indices; waits for every result."""
        q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        th = threading.Thread(target=self._collect, args=(q,), daemon=True)
        th.start()
        first = self.k
        try:
            while ((until is None or time.perf_counter() < until)
                   and (batches is None or self.k - first < batches)):
                t0 = time.perf_counter()
                try:
                    with self.span("bench.process_batch_raw"):
                        dl = self.prog.dispatch(self.k)
                except Exception as err:
                    self.errors.append(f"dispatch {self.k}: {err}")
                    self.k += 1
                    continue
                with self.span("bench.queue_put"):
                    q.put((self.k, t0, dl))
                self.k += 1
        finally:
            q.put(None)
            th.join()
        return first, self.k


def _ref_info(c: cells.Cell, ref) -> dict:
    """Static sizes of the cell for the roofline counts, from the
    reference's own design."""
    from .reference import chain as plain_chain
    from .reference import design, pipeline, src

    cfg, tr = c.config, c.traffic
    rate_in, rate_out = tr["rate_in"], cfg["target_rate"]
    L, M = design.ratio(rate_in, rate_out)
    bucket = c.bucket()
    pad = pipeline.capture_pad(cfg, rate_in, ref.latency, ref.ringout)
    n_out = src.out_len(bucket + pad, rate_in, rate_out)
    whole = not ref.stages and not cfg.get("reverb_mode") and ref.latency_trim == 0
    info = dict(files=cfg["batch_size"], channels_in=tr["channels"],
                channels=len(cfg["channel_routing"]) if cfg.get("channel_routing")
                else tr["channels"], bytes_in=tr["bits"] // 8, bytes_out=cfg["bits"] // 8,
                bucket=bucket, pad=pad, rate_in=rate_in, rate_out=rate_out, L=L, M=M,
                taps=[int(t) for t in src.taps_per_output(rate_in, rate_out, cfg["quality"],
                                                          cfg["kind"])],
                src_out=-(-n_out // L) * L if whole else n_out, out_total=n_out, chain=[])
    for i, s in enumerate(ref.stages):
        st = dict(stage=s["stage"])
        if s["stage"] == "delay":
            st["frames"] = int(round(s["ms"] / 1000.0 * rate_out))
        elif s["stage"] == "biquad":
            st["taps"] = len(plain_chain.biquad_ir(s, rate_out))
        elif s["stage"] == "reverb":
            st["ir_channels"], st["ir_frames"] = ref.irs[i].shape
        info["chain"].append(st)
    return info


def _judge(c: cells.Cell, prog: Program, kept, ref, control: bool = False):
    """The reference ``ref`` over the sampled batches: ``(checks,
    correct)``.  With ``control`` the reference in TF32 stands in the
    program's place."""
    from . import judge
    from .reference.pipeline import Reference

    cfg, tr = c.config, c.traffic
    stand_in = Reference(cfg, tr["rate_in"], ref.irs, ref.dev, tf32=True) if control else None
    out_channels = len(cfg.get("channel_routing") or ()) or tr["channels"]
    readings = []
    for k, host in kept:
        b = k % len(prog.wire)
        args = (prog.wire[b], prog.valid[b], c.dither_seeds(prog.seed, k),
                tr["channels"], tr["bits"])
        got = (stand_in.batch(*args)["files"] if stand_in is not None
               else judge.from_program(host, cfg["bits"], out_channels))
        want = ref.batch(*args, verdicts=[(g["out_frames"], g["terminated"]) for g in got],
                         slack_db=c.limits.get("floor_db", 0.0))
        readings.append(judge.compare(got, want))
    return judge.verdict(readings, c.limits)


def _percentile(v, q: float) -> float:
    return float(np.percentile(np.asarray(v, np.float64), q))


def main(argv=None, t0: float | None = None, device=None, overrides=None) -> int:
    """Run one cell once and print its result; the exit code is 0 when the
    run measured (``correct`` is in the result).  ``device`` and
    ``overrides`` serve the harness's CPU tests."""
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="bench_h100/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the reference in TF32 in the program's place (not a benchmark run)")
    args = ap.parse_args(argv)
    c = cells.load(args.workload, overrides=overrides)

    import torch

    t_torch = time.perf_counter()
    if device is None:
        chips = c.workload.get("chips", 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            _err(f"no result: the cell needs {chips} CUDA device(s), "
                 f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
            return 2
        device = "cuda"
    from f9tpu_torch.device import resolve_device
    from f9tpu_torch.ops import chain_kernels, cycle_fold, epilogue, frontend, src_kernel

    t_port = time.perf_counter()
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.zeros(1, device=dev)
    t_ctx = time.perf_counter()
    irs = c.impulse_responses()
    prog = Program(c, args.seed, dev, irs)
    counters = (src_kernel, frontend, epilogue, cycle_fold, chain_kernels)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    rng = random.Random(cells.mix64(args.seed, 4))
    from . import tracing

    launches = tracing.read_counters(counters)
    t_warm = time.perf_counter()
    # the warm-up runs the window's loop, a sample kept as the window keeps
    # it, so the pinned pool of the downloads is full before the window
    warm = c.traffic["warmup_batches"]
    Loop(prog, c.traffic["check_batches"], random.Random(0)).run(batches=warm)
    launched = tracing.counters_moved(launches, tracing.read_counters(counters))
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    _err("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in (
        ("torch import", t_torch - t0), ("program import", t_port - t_torch),
        ("CUDA context", t_ctx - t_port), *prog.phases.items(),
        ("warm-up", time.perf_counter() - t_warm), ("in all", setup_s))))

    sample = c.traffic["check_batches"]
    loop = Loop(prog, sample, rng, k0=warm)
    result: dict = {}
    if args.trace:
        prof, span = tracing.profiler(on_card)
        loop.span = span
        with prof:
            first, end = loop.run(batches=c.traffic["trace_batches"])
            if on_card:
                torch.cuda.synchronize()
    else:
        t_start = time.perf_counter()
        t_end = t_start + args.seconds
        first, end = loop.run(until=t_end)
    peak = int(torch.cuda.max_memory_allocated(dev)) if on_card else 0
    attempted = (end - first) * c.config["batch_size"]
    done = sorted(loop.done)
    failed = attempted - sum(d[4] for d in done)
    kept = sorted(loop.kept, key=lambda kv: kv[0])
    errors = loop.errors
    del loop
    if on_card:
        torch.cuda.empty_cache()
    from .reference.pipeline import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(c.config, c.traffic["rate_in"], irs, dev)
    if args.trace:
        info = _ref_info(c, ref)
        shapes = [dict(info, valid=[int(v) for v in prog.valid[d[0] % len(prog.wire)]],
                       out_frames=[int(v) for v in d[5]]) for d in done]
        rec = tracing.record(prof, shapes, tracing.port_kernel_names())
        missing = tracing.missing_kernels(rec, launched)
        if missing or (on_card and not 0 < rec["busy_s"] <= rec["window_s"]):
            _err(f"no result: the trace lacks {missing} or its busy time "
                 f"{rec['busy_s']} s is no union inside its {rec['window_s']} s window; of "
                 f"the program's kernels it holds {tracing.port_kernels_seen(rec)}")
            return 4
        metrics = {}
        for m in c.per_layer:
            mod = tracing.load_file(os.path.join(cells.HERE, "metrics", m["name"] + ".py"))
            v = mod.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
        result["breakdown"] = tracing.breakdown(rec)
    else:
        lat = [(d[2] - d[1]) * 1e3 for d in done]
        xrt = sum(d[3] for d in done if d[2] <= t_end) / args.seconds
        metrics = {"xrt": {"value": xrt, "unit": "audio-s/s"},
                   "batch_p95_ms": {"value": _percentile(lat, 95) if lat else None,
                                    "unit": "ms"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items() if any(m["name"] == k for m in c.end_to_end)}
        per_s = np.bincount([int(d[2] - t_start) for d in done if d[2] <= t_end],
                            minlength=int(args.seconds))
        first_s = np.bincount([int(10 * (d[2] - t_start)) for d in done if d[2] < t_start + 1],
                              minlength=10)
        _err(f"window: {len(done)} batches, latency median {_percentile(lat, 50):.3f} ms, "
             f"batches done a second {per_s.tolist()}, in tenths of the first "
             f"{first_s.tolist()}")
        device_info = {}
    checks, correct = _judge(c, prog, kept, ref, control=args.control)
    correct = correct and not errors and failed == 0 and bool(done)
    for e in errors[:5]:
        _err(f"batch error: {e}")
    for name, (value, limit) in checks.items():
        _err(f"check {name} {value!r} limit {limit!r}")
    found = forbidden_modules()
    if found:
        _err(f"no result: the run loaded {', '.join(found)}")
        return 3
    result.update({
        "correct": bool(correct), "attempted": attempted, "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": peak, **device_info},
    })
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    print(json.dumps(result), flush=True)
    return 0
