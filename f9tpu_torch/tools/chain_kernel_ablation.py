#!/usr/bin/env python3
"""What the chain's MAC, fold, moving-average, envelope and windowed-maximum
kernels and the L < 8 SRC fold are held back by: time them with one design
choice changed.

    python3 -m f9tpu_torch.tools.chain_kernel_ablation [--kernels env,wmax]

Runs on one CUDA GPU from the root of a checkout.  It builds copies of
`f9tpu_torch/csrc/upols.cu`, `csrc/fold.cu`, `csrc/dynamics.cu` and
`csrc/cycle_fold.cu` with one choice changed each
(nvcc, all at once, into `f9tpu_torch/_build/chain_ablation/`, with ptxas's
register and spill report), launches every copy through its C entry point
at `chip_smoke.py` 14c's shapes (the MAC: one group of the insert loop's
reverb, K = 30 over 2 x 8 rows, of a stream chunk's, 2 x 1 rows, and of the
meter's K-weighting, K = 1 over 2 rows; the fold: 351 taps on 8 x 2 x
2,903,040 and on 2 x 962,560, and 1024 taps on the latter; the moving
average at the compressor's windows 240 and 48 and the limiter's 73 on
the insert loop's rows; the release envelope on the compressor's linked
rows, 8 x 1 x 2,903,040 from position 0 and a 20 s chunk's 1 x 962,560 from
mid-grid; the windowed maximum at W = 73 on the limiter's 8 x 1 x 2,903,112
and the chunk's 1 x 962,632; the L < 8 fold at `chip_smoke.py` 15f's shapes,
the meter's true-peak chunk fused with its peak and as samples, 2 x 882,000
cycles of the 4x bank, and a 20 s stream chunk at 96 -> 48 kHz, 2 x 960,000
cycles of the 2:1 bank), holds each
output to its plain twin bit for bit, and prints each copy's device time
(`torch.profiler`, the median of 10 launches, the lesser of two turns),
with the card's name and power limit, then one JSON line.

The MAC's copies: `four_outputs` (4 outputs a lane, not 2),
`no_barrier` (no empty asm before each leaf, so the compiler may hoist the
leaves' loads), both together (this kernel's first form), and `stage_8` /
`stage_20` (loads a thread keeps in flight while staging, not 12).  The
fold's: `all_registers` (the counter's nine levels in registers, not three),
`one_register_level` and `four_outputs` (4 outputs a thread, not 8).  The
moving average's: `checked_staging` (every tile stages and stores with a
bounds check a sample, not only the row's edges).  The envelope's:
`wide_4096` and `wide_8192` (the wide tile, the frames one look-back
publishes, of 4 or 8 quads a thread, not 16), `narrow_1024` and
`narrow_4096` (the narrow one of 1 or 4, not 2), `exact_always` (torch's
NaN rule at every maximum, not only where a NaN may meet it) and
`release_acquire` (the flags stored with release and read with acquire
semantics, not relaxed); and the whole copy with the other tile than
`chain_kernels.env_tile_frames` picks.  The windowed
maximum's: `staged` (W = 73 through the shared-memory form, this kernel's
first design), `exact_always` (torch's NaN rule at every maximum, not only
in steps whose windows hold a NaN) and the register form's segments of 8,
16 and 172 steps besides `chain_kernels.wmax_segment_steps`' choice.  The
L < 8 fold's: `generic` (the generic form where `cycle_fold.fold_form`
picks the slid one: a thread's cycles a block apart, every sample loaded and
converted for every row), `four_cycles` (4 cycles a thread, not 8),
`predicated_rows` (every row through the predicated columns, no branch for
the rows that take every column), and the generic form with 8 and with 4
cycles a thread and predicated rows (this kernel's first form).
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
_ENV_WIDE = "constexpr int ENV_Q_WIDE = 16;"
_ENV_NARROW = "constexpr int ENV_Q_NARROW = 2;"
_ENV_EXACT1 = "if (__any_sync(FULL, nan))"
_ENV_EXACT2 = "if (tile_nan || s_P != s_P || carry != carry)"
_ENV_LD, _ENV_ST = "ld.relaxed.gpu", "st.relaxed.gpu"
_WMAX_REG = "if (W <= WMAX_REG_MAX_W) {"
_WMAX_EXACT = "if (nans & window)"
_FOLD_C = "constexpr int FOLD_C = 8;"
_FOLD_FULL = "if ((e & 63) == L) {"
_FOLD_FORM = "const int form = ms;"

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
    "env": ("dynamics.cu", {
        "whole": [],
        "wide_4096": [(_ENV_WIDE, "constexpr int ENV_Q_WIDE = 4;")],
        "wide_8192": [(_ENV_WIDE, "constexpr int ENV_Q_WIDE = 8;")],
        "narrow_1024": [(_ENV_NARROW, "constexpr int ENV_Q_NARROW = 1;")],
        "narrow_4096": [(_ENV_NARROW, "constexpr int ENV_Q_NARROW = 4;")],
        "exact_always": [(_ENV_EXACT1, "if (true)"), (_ENV_EXACT2, "if (true)")],
        "release_acquire": [(_ENV_LD, "ld.acquire.gpu"), (_ENV_ST, "st.release.gpu")],
    }),
    "wmax": ("dynamics.cu", {
        "whole": [],
        "staged": [(_WMAX_REG, "if (false) {")],
        "exact_always": [(_WMAX_EXACT, "if (true)")],
    }),
    "cycle_fold": ("cycle_fold.cu", {
        "whole": [],
        "generic": [(_FOLD_FORM, "const int form = 0;")],
        "four_cycles": [(_FOLD_C, "constexpr int FOLD_C = 4;")],
        "predicated_rows": [(_FOLD_FULL, "if (false) {")],
        "generic_predicated_four_cycles": [(_FOLD_FORM, "const int form = 0;"),
                                           (_FOLD_C, "constexpr int FOLD_C = 4;"),
                                           (_FOLD_FULL, "if (false) {")],
    }),
}
#: the windowed maximum's register-form segment lengths (steps a warp) timed
#: beside `wmax_segment_steps`' choice (0), on the whole copy
WMAX_SEGMENTS = (0, 8, 16, 172)
#: the envelope copies' (wide, narrow) tiles, where their quads a thread differ
ENV_COPY_TILES = {"wide_4096": (4096, 2048), "wide_8192": (8192, 2048),
                  "narrow_1024": (16384, 1024), "narrow_4096": (16384, 4096)}
#: each kernel's C entry point and the name its profiler events hold
ENTRY = {"mac": ("f9_upols_mac", "upols_mac"), "fold": ("f9_fir_fold", "fir_fold"),
         "ma": ("f9_ma_past", "ma_past"), "env": ("f9_slanted_cummax", "env_scan"),
         "wmax": ("f9_window_max", "wmax_"), "cycle_fold": ("f9_cycle_fold", "cycle_fold_kernel")}


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


def _build_all(out_dir: str, kernels) -> dict:
    from f9tpu_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for (kernel, copy), text in variant_sources().items():
        if kernel not in kernels:
            continue
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
        elif kernel == "env":
            lib.f9_slanted_cummax.argtypes = [vp] * 7 + [i64, i64, i64, i32, i32, i32,
                                                         ctypes.c_float, vp]
        elif kernel == "wmax":
            lib.f9_window_max.argtypes = [vp, vp, vp, i64, i64, i32, i32, vp]
        elif kernel == "cycle_fold":
            lib.f9_cycle_fold.argtypes = [vp] * 5 + [i64, i64, i64, i64, i32, i32, i32, i32,
                                                     i32, i32, vp]
        # the K = 30 instance of the MAC, W = 73's windowed maximum, each other
        # kernel's staged form
        regs = _ptxas(err, {"mac": "upols_mac_regILi30E", "fold": "fir_fold_kernel",
                            "ma": "ma_past_tiles", "env": "env_scan",
                            "wmax": "wmax_tile" if copy == "staged" else "wmax_regILi6ELb1E",
                            "cycle_fold": "cycle_fold_kernelILi4ELi1ELb1E"
                            if copy != "generic" else "cycle_fold_kernelILi4ELi0ELb1E"}[kernel])
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
    ap = argparse.ArgumentParser(prog="python3 -m f9tpu_torch.tools.chain_kernel_ablation",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", default=",".join(VARIANTS),
                    help=f"the kernels to time, of {','.join(VARIANTS)} (default: all)")
    args = ap.parse_args(argv)
    kernels = args.kernels.split(",")
    if set(kernels) - set(VARIANTS):
        ap.error(f"--kernels takes {','.join(VARIANTS)}")
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
    libs = _build_all(os.path.join(ROOT, "f9tpu_torch", "_build", "chain_ablation"), kernels)
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
    B = ch.Compressor._ENV_BLOCK
    c = float(np.float32(80.0 / 48000))
    for label, rows, T, pos in (("8 x 1 x 2,903,040 from 0", 8, 2_903_040, 0),
                                ("1 x 962,560 from 2,887,680", 1, 962_560, 2_887_680)):
        lv = 10.0 * torch.log10(torch.clamp(link[:rows, :, :T] if rows == 8 else
                                            torch.square(x2[:1]), min=1e-20)).contiguous()
        init = torch.full((rows, 1) if rows == 8 else (1,), -40.0 if pos else -1e9, device=dev)
        env, m_out, c_out = torch.empty_like(lv), torch.empty_like(init), torch.empty_like(init)
        ntiles = -(-(pos % B + T) // 1024) - (pos % B) // 1024    # the smallest copy's tiles
        scratch = torch.empty(2 * (1 + rows * ntiles), device=dev)
        want = ch.Compressor._slanted_cummax_stream_reference(lv, c, pos, init, init)
        chosen = ck.env_tile_frames(rows, T, pos % B, B)
        for tile in (chosen, ck.ENV_TILE_NARROW if chosen == ck.ENV_TILE else ck.ENV_TILE):
            # the last argument the tile, which the copies of other tiles replace
            args = (lv.data_ptr(), init.data_ptr(), init.data_ptr(), env.data_ptr(),
                    m_out.data_ptr(), c_out.data_ptr(), scratch.data_ptr(), scratch.numel(), rows,
                    T, pos % B, B, c, min(tile, B))
            cases[("env", f"{label}, tile {tile}")] = (args, (env, m_out, c_out), want,
                                                       (lv, init, scratch))
    a = torch.clamp(torch.randn((8, 1, 2_903_112), device=dev, generator=gen), min=0.0)
    for label, v in (("W 73, 8 x 1 x 2,903,112", a), ("W 73, 1 x 962,632", a[0, :, :962_632])):
        v = v.contiguous()
        for seg in WMAX_SEGMENTS:
            y = torch.empty_like(v)
            rows, T = v.numel() // v.shape[-1], v.shape[-1]
            args = (v.data_ptr(), y.data_ptr(), None, rows, T, 73,
                    seg or ck.wmax_segment_steps(rows, T))
            cases[("wmax", f"{label}, segments of {seg or args[-1]}")] = (
                args, y, ch._window_max_past_reference(v, 73), (v,))
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops import cycle_fold as cf
    from f9tpu_torch.ops import resample as tr

    for label, (ri, ro), Q, peak in (("meter chunk, fused peak", (44100, 176400), 882_000, True),
                                      ("meter chunk, samples", (44100, 176400), 882_000, False),
                                      ("20 s stream chunk 96k->48k", (96000, 48000), 960_000,
                                       False)):
        bank = design_cycle_bank(ri, ro, quality="high")
        T = (Q - 1) * bank.M + bank.W
        xp = 0.5 * torch.randn((2, T), device=dev, generator=gen)
        g, tab = cf._device_operands(bank, dev)
        y = torch.empty((2, Q * bank.L), device=dev)
        out = torch.empty(1, dtype=torch.int32, device=dev) if peak else y
        want = tr._presliced_fold(xp, bank, Q)
        want = torch.max(torch.abs(want)).reshape(1) if peak else want
        # 128 threads a block fit every copy at these banks
        args = (xp.data_ptr(), g.data_ptr(), tab.data_ptr(), None if peak else y.data_ptr(),
                out.data_ptr() if peak else None, 2, T, T, Q, bank.L, bank.M, bank.W,
                int(tab.shape[0]), 128, cf.fold_form(bank))
        cases[("cycle_fold", label)] = (args, out.view(torch.float32) if peak else out, want,
                                        (xp, g, tab, y))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, kernel, args):
        fn = getattr(lib, ENTRY[kernel][0])
        if kernel == "env":              # the tile goes before fl(c)
            args = (*args[:12], args[13], args[12])
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    times, bitwise = {}, {}
    for _turn in range(2):
        for (kernel, copy), (lib, _) in libs.items():
            for (k, label), (args, out, want, _inputs) in cases.items():
                if k != kernel or (kernel == "wmax" and copy != "whole"
                                   and args[-1] != ck.wmax_segment_steps(args[3], args[4])):
                    continue                  # other segment lengths: the whole copy only
                if kernel == "env":
                    rows, T, p0, B = args[8:12]
                    chosen = ck.env_tile_frames(rows, T, p0, B)
                    if copy != "whole" and args[-1] != min(chosen, B):
                        continue              # the other tile: the whole copy only
                    if copy in ENV_COPY_TILES:
                        wide, narrow = ENV_COPY_TILES[copy]
                        args = (*args[:-1], min(wide if chosen == ck.ENV_TILE else narrow, B))
                launch(lib, kernel, args)
                torch.cuda.synchronize()
                same = all(torch.equal(_bits(o), _bits(w)) for o, w in
                           zip(*((out, want) if isinstance(out, tuple) else ((out,), (want,)))))
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
