#!/usr/bin/env python3
"""What the chain's MAC, fold, moving-average and windowed-maximum kernels
are held back by: time them with one design choice changed.

    python3 -m f9tpu_torch.tools.chain_kernel_ablation

Runs on one CUDA GPU from the root of a checkout.  It builds copies of
`f9tpu_torch/csrc/upols.cu`, `csrc/fold.cu` and `csrc/dynamics.cu` with one
choice changed each
(nvcc, all at once, into `f9tpu_torch/_build/chain_ablation/`, with ptxas's
register and spill report), launches every copy through its C entry point
at `chip_smoke.py` 14c's shapes (the MAC: one group of the insert loop's
reverb, K = 30 over 2 x 8 rows, of a stream chunk's, 2 x 1 rows, and of the
meter's K-weighting, K = 1 over 2 rows; the fold: 351 taps on 8 x 2 x
2,903,040 and on 2 x 962,560, and 1024 taps on the latter; the moving
average at the compressor's windows 240 and 48 and the limiter's 73 on
the insert loop's rows; the windowed maximum at W = 73 on the limiter's
8 x 1 x 2,903,112), holds each
output to its plain twin bit for bit, and prints each copy's device time
(`torch.profiler`, the median of 10 launches, the lesser of two turns),
with the card's name and power limit, then one JSON line.

The MAC's copies: `four_outputs` (4 outputs a lane, not 2),
`no_barrier` (no empty asm before each leaf, so the compiler may hoist the
leaves' loads), both together (this kernel's first form), and `stage_8` /
`stage_20` (loads a thread keeps in flight while staging, not 12).  The
fold's: `all_registers` (the counter's nine levels in registers, not three),
`one_register_level` and `four_outputs` (4 outputs a thread, not 8).  The
moving average's and the windowed maximum's: `checked_staging` (every tile
stages and stores with a bounds check a sample, not only the row's edges).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_GN = "constexpr int MAC_GN = 2;"
_BARRIER = '        asm volatile("" ::: "memory");\n'
_BATCH = "constexpr int MAC_STAGE_BATCH = 12;"
_LEVELS = "constexpr int REG_LEVELS = 3;"
_R = "constexpr int FOLD_R = 8;"
_MA_INSIDE = "const bool inside = n0 - pre >= 0 && n0 + MA_TILE <= T;"
_MA_STORE = "if (n0 + MA_TILE <= T) {"
_WMAX_INSIDE = "if (n0 - (W - 1) >= 0 && n0 + WMAX_TILE <= T) {"
_WMAX_STORE = "if (n0 + WMAX_TILE <= T) {"

#: (source, [(text, replacement), ...]) by copy name
VARIANTS = {
    "mac": ("upols.cu", {
        "whole": [],
        "four_outputs": [(_GN, "constexpr int MAC_GN = 4;")],
        "no_barrier": [(_BARRIER, "")],
        "four_outputs_no_barrier": [(_GN, "constexpr int MAC_GN = 4;"), (_BARRIER, "")],
        "stage_8": [(_BATCH, "constexpr int MAC_STAGE_BATCH = 8;")],
        "stage_20": [(_BATCH, "constexpr int MAC_STAGE_BATCH = 20;")],
    }),
    "fold": ("fold.cu", {
        "whole": [],
        "all_registers": [(_LEVELS, "constexpr int REG_LEVELS = 9;")],
        "one_register_level": [(_LEVELS, "constexpr int REG_LEVELS = 1;")],
        "four_outputs": [(_R, "constexpr int FOLD_R = 4;")],
    }),
    "ma": ("fold.cu", {
        "whole": [],
        "checked_staging": [(_MA_INSIDE, "const bool inside = false;"),
                            (_MA_STORE, "if (false) {")],
    }),
    "wmax": ("dynamics.cu", {
        "whole": [],
        "checked_staging": [(_WMAX_INSIDE, "if (false) {"), (_WMAX_STORE, "if (false) {")],
    }),
}
#: each kernel's C entry point and the name its profiler events hold
ENTRY = {"mac": ("f9_upols_mac", "upols_mac"), "fold": ("f9_fir_fold", "fir_fold"),
         "ma": ("f9_ma_past", "ma_past"), "wmax": ("f9_window_max", "wmax_tile")}


def variant_sources() -> dict:
    """{(kernel, copy): source text}; raises if a change no longer applies to
    the kernel's source."""
    from f9tpu_torch.ops import _build

    out = {}
    for kernel, (name, copies) in VARIANTS.items():
        with open(os.path.join(_build.CSRC, name)) as f:
            src = f.read()
        for copy, cuts in copies.items():
            text = src
            for old, new in cuts:
                if old not in text:
                    raise RuntimeError(f"{kernel} {copy}: {old.strip()!r} is not in {name}; "
                                       f"update the change")
                text = text.replace(old, new)
            out[(kernel, copy)] = text
    return out


def _ptxas(log: str, pattern: str) -> str:
    """ptxas's registers and spills for the first kernel named like
    ``pattern``."""
    from f9tpu_torch.ops import _build

    r = next((v for k, v in _build.ptxas_report(log).items() if pattern in k), {})
    spills = (f", spills {r['spill_stores']}/{r['spill_loads']} B"
              if r.get("spill_stores") or r.get("spill_loads") else "")
    return f"{r.get('registers')} registers{spills}"


def _build_all(out_dir: str) -> dict:
    from f9tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for (kernel, copy), text in variant_sources().items():
        cu = os.path.join(out_dir, f"{kernel}_{copy}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out_dir, f"lib_{kernel}_{copy}.so")
        procs[(kernel, copy)] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", _build.CSRC, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for (kernel, copy), (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {copy}:\n{err}")
        lib = ctypes.CDLL(so)
        if kernel == "mac":
            lib.f9_upols_mac.argtypes = [vp, vp, vp, i64, i64, i64, i32, i32, i32, vp]
        elif kernel == "fold":
            lib.f9_fir_fold.argtypes = [vp, vp, vp, i64, i64, i32, vp]
        elif kernel == "ma":
            lib.f9_ma_past.argtypes = [vp, vp, i64, i64, i32, ctypes.c_float, vp]
        elif kernel == "wmax":
            lib.f9_window_max.argtypes = [vp, vp, vp, i64, i64, i32, vp]
        # the K = 30 instance of the MAC, each other kernel's staged form
        regs = _ptxas(err, {"mac": "upols_mac_regILi30E", "fold": "fir_fold_kernel",
                            "ma": "ma_past_tiles", "wmax": "wmax_tile"}[kernel])
        libs[(kernel, copy)] = (lib, regs)
    return libs


def _bits(t):
    """The int32 view of a float32 or complex64 tensor (equal bits, signed
    zeros told apart)."""
    import torch

    return (torch.view_as_real(t) if t.is_complex() else t).contiguous().view(torch.int32)


def _device_ms(fn, name: str, runs: int = 10) -> float:
    """The median device ms of the kernel events named like ``name``."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ts = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
          if e.device_type == DeviceType.CUDA and name in e.name]
    return float(np.median(ts)) if ts else float("nan")


def main(argv: list[str] | None = None) -> int:
    argparse.ArgumentParser(prog="python3 -m f9tpu_torch.tools.chain_kernel_ablation",
                            description=__doc__.split("\n")[0]).parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chain_kernel_ablation: no CUDA GPU available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from f9tpu_torch import resolve_device
    from f9tpu_torch.ops import chain as ch
    from f9tpu_torch.ops import chain_kernels as ck

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    dev = resolve_device("cuda")
    libs = _build_all(os.path.join(ROOT, "f9tpu_torch", "_build", "chain_ablation"))
    gen = torch.Generator(device=dev).manual_seed(15)
    G, Nf = ch.UPOLS_GROUP, 4097
    cases = {}
    for label, K, lead, hlead in (("insert loop", 30, (2, 8), (2, 1)),
                                  ("20 s stream chunk", 30, (2, 1), (2, 1)),
                                  ("meter", 1, (2,), (1,))):
        buf = torch.randn((K - 1 + G, *lead, Nf), dtype=torch.complex64, device=dev,
                          generator=gen)
        H = torch.randn((K, *hlead, Nf), dtype=torch.complex64, device=dev, generator=gen)
        rows, h_rows = int(np.prod(lead)), int(np.prod(hlead))
        Y = torch.empty((G, *lead, Nf), dtype=torch.complex64, device=dev)
        args = (buf.data_ptr(), H.data_ptr(), Y.data_ptr(), rows, rows // h_rows, h_rows, Nf, K, G)
        # the tensors stay referenced while their pointers are launched
        cases[("mac", label)] = (args, Y, ck.upols_mac_reference(buf, H, G), (buf, H))
    x8 = 0.1 * torch.randn((8, 2, 2_903_040), device=dev, generator=gen)
    x2 = 0.1 * torch.randn((2, 962_560), device=dev, generator=gen)
    rng = np.random.default_rng(15)
    for label, x, W in (("insert loop", x8, 351), ("20 s stream chunk", x2, 351),
                        ("20 s stream chunk, 1024 taps", x2, 1024)):
        taps = (rng.standard_normal(W) / np.sqrt(W)).astype(np.float32)
        tp = torch.from_numpy(taps).to(dev)
        y = torch.empty_like(x)
        T = x.shape[-1]
        args = (x.data_ptr(), tp.data_ptr(), y.data_ptr(), x.numel() // T, T, W)
        cases[("fold", label)] = (args, y, ch._fir_fold_reference(x, taps), (x, tp))
    sq = torch.square(x8)
    link = sq[:, :1].contiguous()
    for label, x, win in (("win 240, 8 x 1 x 2,903,040", link, 240),
                          ("win 48, 8 x 2 x 2,903,040", sq, 48),
                          ("win 73, 8 x 1 x 2,903,040", link, 73)):
        y = torch.empty_like(x)
        T = x.shape[-1]
        args = (x.data_ptr(), y.data_ptr(), x.numel() // T, T, win, float(np.float32(1.0 / win)))
        cases[("ma", label)] = (args, y, ch._uniform_ma_past_reference(x, win), (x,))
    a = torch.clamp(torch.randn((8, 1, 2_903_112), device=dev, generator=gen), min=0.0)
    y = torch.empty_like(a)
    args = (a.data_ptr(), y.data_ptr(), None, 8, a.shape[-1], 73)
    cases[("wmax", "W 73, 8 x 1 x 2,903,112")] = (args, y, ch._window_max_past_reference(a, 73),
                                                  (a,))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, kernel, args):
        fn = getattr(lib, ENTRY[kernel][0])
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    times, bitwise = {}, {}
    for _turn in range(2):
        for (kernel, copy), (lib, _) in libs.items():
            for (k, label), (args, out, want, _inputs) in cases.items():
                if k != kernel:
                    continue
                launch(lib, kernel, args)
                torch.cuda.synchronize()
                same = torch.equal(_bits(out), _bits(want))
                bitwise[(kernel, copy, label)] = bitwise.get((kernel, copy, label), True) and same
                t = _device_ms(lambda: launch(lib, kernel, args), ENTRY[kernel][1])
                times.setdefault((kernel, copy, label), []).append(t)
    summary = []
    for (kernel, copy, label), ts in times.items():
        regs = libs[(kernel, copy)][1]
        ok = bitwise[(kernel, copy, label)]
        summary.append(dict(kernel=kernel, copy=copy, shape=label, device_ms=min(ts),
                            turns=ts, ptxas=regs, bitwise=ok))
        print(f"ablation {kernel} {copy:24s} {label:30s} {min(ts):.4f} ms (turns "
              f"{ts[0]:.4f}/{ts[1]:.4f}; {regs}; bitwise {ok}) [{card}]", flush=True)
    print(json.dumps({"card": card, "copies": summary}), flush=True)
    return 0 if all(bitwise.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
