#!/usr/bin/env python3
"""What holds the cycle_src kernel back: time it with parts cut out.

    python3 -m f9tpu_torch.tools.cycle_src_ablation [--bank IN:OUT[:QUALITY]]

Runs on one CUDA GPU from the root of a checkout.  It builds copies of
`f9tpu_torch/csrc/cycle_src.cu` with one part of the work removed each
(nvcc, all at once, into `f9tpu_torch/_build/ablation/`), launches every
copy through the same C entry point and launch plan as the port on 32
signals x 2^20 frames of ``--bank`` (default 44100:48000:high; a varispeed
pair such as 44100:44056 times the windowed form), and prints the median
CUDA-event time of each beside the whole kernel's, with the card's name and
power limit.  A copy that skips loads computes on stale shared memory: only
its time means anything.  The whole kernel is also read through
`torch.profiler` as a cross-check of the event times.

The span form's cuts: `one_pass` keeps only the xh*gh mma of the three;
`plain_sum` adds each fragment to the sum with no compensation; `no_span`
and `no_ring` skip the signal span's and the bank ring's loads; `no_math`
skips every shared-memory read, split and mma (loads and stores only);
`math_only` skips both loads (math and stores only).  The windowed form's:
`no_windows` (the producer warp stages nothing and releases the windows at
once), `no_ring` (the band's loads), `no_math` and `math_only` as above.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_MMA = """                mma_acc(nc[n], ah, b0l, b1l);   // + xh * gl
                mma_acc(nc[n], al, b0h, b1h);   // + xl * gh
"""
_JOIN = """                    const float tk = __fadd_rn(sum[n][r], d);
                    nc[n][r] = __fsub_rn(d, __fsub_rn(tk, sum[n][r]));
                    sum[n][r] = tk;"""
_SPAN = "        for (int k = tid; k < n4; k += nthreads) {"
_NO_SPAN = "        for (int k = tid; k < 0; k += nthreads) {"
_RING = "        for (int i = tid; i < STAGE_F4; i += nthreads) cp_async16(dst + i, src + i);"
_MATH = """#pragma unroll
        for (int kk = 0; kk < KC8; ++kk) {"""
_MATH_END = """            }
        }
    }
    // ---- the block's (TQ, 8*NT) outputs"""
_WIN_TX = "if (lane == 0) mbar_arrive_expect_tx(full, total);"
_WIN_BULK = "if (s < ROWS && rs[i].bulk)"
_WIN_FILL = "uint32_t todo = __ballot_sync(0xffffffffu, (edge >> i) & 1u);"
_NO_WINS = [(_WIN_TX, "if (lane == 0) mbar_arrive_expect_tx(full, 0u);"),
            (_WIN_BULK, "if (false)"), (_WIN_FILL, "uint32_t todo = 0;")]
_WIN_MATH = "            // ---- the stage's math\n"
_WIN_MATH_END = "            // ---- end of the stage's math\n"
_NO_WIN_MATH = [(_WIN_MATH, "#if 0\n"), (_WIN_MATH_END, "#endif\n")]

CUTS = {
    "whole": [],
    "one_pass": [(_MMA, "")],
    "plain_sum": [(_JOIN, """                    sum[n][r] = __fadd_rn(sum[n][r], d);
                    nc[n][r] = 0.f;""")],
    "no_span": [(_SPAN, _NO_SPAN)],
    "no_ring": [(_RING, "")],
    "no_math": [(_MATH, "#if 0\n" + _MATH), (_MATH_END, """            }
        }
#endif
    }
    // ---- the block's (TQ, 8*NT) outputs""")],
    "math_only": [(_SPAN, _NO_SPAN), (_RING, "")],
}
#: the windowed form's cuts
WIN_CUTS = {
    "whole": [],
    "no_windows": _NO_WINS,
    "no_ring": [(_RING, "")],
    "no_math": _NO_WIN_MATH,
    "math_only": _NO_WINS + [(_RING, "")],
}


def _build_all(out_dir: str, cuts_by_name: dict) -> dict:
    from f9tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "cycle_src.cu")).read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, cuts in cuts_by_name.items():
        text = src
        for old, new in cuts:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source changed; update the cut")
            text = text.replace(old, new)
        cu = os.path.join(out_dir, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build.CSRC, "-o", so, cu,
             os.path.join(_build.CSRC, "epilogue.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        regs = [line.split(":", 1)[1].strip() for line in err.splitlines()
                if "registers" in line]
        libs[name] = (_build._declare(ctypes.CDLL(so)), regs[0] if regs else "")
    return libs


def _median_ms(fn, runs: int = 20) -> float:
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


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m f9tpu_torch.tools.cycle_src_ablation")
    ap.add_argument("--bank", default="44100:48000:high", metavar="IN:OUT[:QUALITY]",
                    help="rate pair and quality of the bank (a varispeed pair "
                         "such as 44100:44056 times the windowed form)")
    args = ap.parse_args(argv)
    parts = args.bank.split(":")
    if len(parts) not in (2, 3):
        ap.error(f"--bank expects IN:OUT[:QUALITY], got {args.bank!r}")
    rate_in, rate_out, quality = int(parts[0]), int(parts[1]), (parts + ["high"])[2]

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cycle_src_ablation: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from f9tpu_torch import resolve_device
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import src_kernel as sk

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    dev = resolve_device("cuda")
    bank = design_cycle_bank(rate_in, rate_out, quality=quality)
    plan = sk.kernel_plan(bank)
    if plan is None:
        print(f"cycle_src_ablation: the kernel does not take bank {args.bank}",
              file=sys.stderr)
        return 1
    n_sig, frames = 32, 1 << 20
    rng = np.random.default_rng(0)
    x = torch.from_numpy((0.3 * rng.standard_normal((n_sig, frames))).astype(np.float32)).to(dev)
    out_len = bank.out_len(frames)
    Q = -(-out_len // bank.L)
    print(card, flush=True)
    libs = _build_all(os.path.join(ROOT, "f9tpu_torch", "_build", "ablation"),
                      WIN_CUTS if plan.pitch else CUTS)
    gp, tiles = sk._device_bank(bank, dev)
    y = torch.empty((n_sig, out_len), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    if plan.pitch:
        warps, rowmap, group, pitch, smem = sk._win_launch(plan, n_sig * Q, sk._sm_count(dev))
    else:
        warps, smem = plan.warps, plan.smem_bytes

    def launch(lib):
        if plan.pitch:
            err = lib.f9_cycle_src_win(
                x.data_ptr(), gp.data_ptr(), tiles.data_ptr(), y.data_ptr(), n_sig,
                frames, frames, bank.pad_front, bank.M, bank.L, Q, out_len, out_len,
                plan.nt, len(plan.bands), warps, pitch, group, rowmap, smem, stream)
        else:
            err = lib.f9_cycle_src(
                x.data_ptr(), gp.data_ptr(), tiles.data_ptr(), y.data_ptr(), n_sig, frames,
                frames, bank.pad_front, bank.M, bank.L, Q, out_len, out_len, plan.nt,
                len(plan.bands), plan.warps, plan.skew, plan.rowmap, plan.ring_off,
                plan.smem_bytes, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    print(f"{rate_in}->{rate_out} {quality} (L={bank.L} M={bank.M}), {n_sig} x 2^20 frames, "
          f"{'windowed' if plan.pitch else 'span'} form, plan nt={plan.nt} warps={warps} "
          + (f"group={group} pitch={pitch} " if plan.pitch else "") + f"smem={smem} B", flush=True)
    times = {}
    for turn in range(2):
        for name, (lib, _) in libs.items():
            for _ in range(3):
                launch(lib)
            torch.cuda.synchronize()
            times.setdefault(name, []).append(_median_ms(lambda: launch(lib)))
    for name, (lib, regs) in libs.items():
        t = min(times[name])
        print(f"ablation {name:10s} {t:.4f} ms ({100 * t / min(times['whole']):.0f} % of "
              f"whole; turns {times[name][0]:.4f}/{times[name][1]:.4f}; {regs}) [{card}]",
              flush=True)
    from torch.profiler import ProfilerActivity, profile

    lib = libs["whole"][0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            launch(lib)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "cycle_src" in e.key]
    for e in rows:
        total_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        print(f"profiler: {e.key[:60]} calls={e.count} mean "
              f"{total_us / max(e.count, 1) / 1e3:.4f} ms [{card}]", flush=True)
    if not rows:
        print("profiler: no device time recorded for the kernel", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
