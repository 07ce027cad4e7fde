#!/usr/bin/env python3
"""Measured converter characteristics of the port, per preset, filter kind
and rate pair (the port's twin of `tools/gen_quality.py`).

    python -m f9tpu_torch.tools.gen_quality [--device cuda|cpu] [--out PATH]
        [--pairs 44100:48000,96000:44100]

Measures through the port's production path,
`f9tpu_torch.ops.resample.resample_rates`, on ``--device`` (default
``cuda``: the `cycle_src` kernel, dense or windowed, where it takes the
bank; for L < 8 the `cycle_fold` kernel where L = 1, else the unfold +
matmul form), with the JAX tool's pairs,
presets, test tones and FFT analysis under the same names:
`passband_ripple_db`, `edge_frac`, `alias_rejection_db`,
`image_suppression_db`, `thdn_db` and `oracle_db` (RMS error against the
float64 oracle `f9tpu_torch.models.oracle`).  It writes the same tables as
`docs/QUALITY.md` (four sinc presets, minphase at high, lagrange) into
``--out`` (default `docs/QUALITY_TORCH.md`, never `docs/QUALITY.md`, which
is the JAX package's), headed by the card's name and power limit as
``nvidia-smi`` gives them, or "CPU".  ``--pairs`` keeps a subset of the
pairs, in the tool's order.

`read_tables` parses a file of either tool, and `compare` holds one
table's figures to another's within the tolerances below.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..models.filters import QUALITY_PRESETS
from ..models.oracle import resample_oracle
from ..ops.resample import resample_rates

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PAIRS = [
    (44100, 48000), (48000, 44100),
    (44100, 96000), (96000, 44100),
    (44100, 192000), (192000, 44100),
    (176400, 48000), (48000, 176400),
    (88200, 96000), (96000, 88200),
    # varispeed / NTSC pull-down: no dense cycle matrix, the kernel's
    # windowed form on the card, the float64 gather form on the CPU
    (44100, 44056), (44056, 44100),
]
PRESETS = ["low", "medium", "high", "ultra"]
N = 1 << 15

#: the tolerances one table's figures are held to another's (`compare`):
#: passband ripple (dB), the -1 dB edge (fraction of Nyquist), alias
#: rejection, image suppression and THD+N (dB, unless both lie past
#: DEEP_DB, where the fp32 floor and not the design sets the figure), and
#: the bound on the error against the oracle (dB)
RIPPLE_TOL_DB = 0.01
EDGE_TOL = 0.002
LEVEL_TOL_DB = 3.0
DEEP_DB = 130.0
ORACLE_DB_MAX = -120.0

COLUMNS = ("pair", "passband ripple (≤0.8 Nyq)", "-1 dB edge", "alias rejection",
           "image suppression", "THD+N", "vs oracle")
_HEADER = "| " + " | ".join(COLUMNS) + " |"
_RULE = "|" + "---|" * len(COLUMNS)


def _mid(y: np.ndarray) -> np.ndarray:
    return y[len(y) // 4 : -len(y) // 4].astype(np.float64)


def _rms(x) -> float:
    return float(np.sqrt((np.asarray(x, np.float64) ** 2).mean()) + 1e-300)


def _tone(freq: float, rate: int, n: int = N, amp: float = 0.5) -> np.ndarray:
    t = np.arange(n) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _resample(x: np.ndarray, rate_in, rate_out, quality, kind, device) -> np.ndarray:
    """``x`` through `resample_rates` on ``device``, back as numpy.  The
    device goes through `resolve_device`, which switches TF32 off before
    any matmul of the L < 8 banks runs."""
    xt = torch.from_numpy(x).to(resolve_device(device))
    return resample_rates(xt, rate_in, rate_out, quality=quality, kind=kind).cpu().numpy()


def _tone_gain_db(f, rate_in, rate_out, quality, kind, device) -> float:
    y = _resample(_tone(f, rate_in), rate_in, rate_out, quality, kind, device)
    return 20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))


def passband_ripple_db(rate_in, rate_out, quality, kind="sinc", device="cuda") -> float:
    """Max |gain deviation| (dB) over tones up to 0.8x the shared Nyquist."""
    ny = 0.5 * min(rate_in, rate_out)
    freqs = [100.0, 997.0] + [f * ny for f in (0.25, 0.5, 0.65, 0.8)]
    return max(abs(_tone_gain_db(f, rate_in, rate_out, quality, kind, device))
               for f in freqs)


def edge_frac(rate_in, rate_out, quality, kind="sinc", device="cuda") -> float:
    """-1 dB bandwidth edge as a fraction of the shared Nyquist (bisection)."""
    ny = 0.5 * min(rate_in, rate_out)
    lo, hi = 0.5, 1.0
    for _ in range(10):
        mid = 0.5 * (lo + hi)
        if _tone_gain_db(mid * ny, rate_in, rate_out, quality, kind, device) > -1.0:
            lo = mid
        else:
            hi = mid
    return lo


def alias_rejection_db(rate_in, rate_out, quality, kind="sinc",
                       device="cuda") -> float | None:
    """Downsampling only: residual level of a tone above the output Nyquist."""
    if rate_out >= rate_in:
        return None
    ny_out, ny_in = 0.5 * rate_out, 0.5 * rate_in
    f = ny_out + 0.35 * (ny_in - ny_out)
    y = _resample(_tone(f, rate_in), rate_in, rate_out, quality, kind, device)
    return -20 * np.log10(_rms(_mid(y)) / (0.5 / np.sqrt(2)))


def image_suppression_db(rate_in, rate_out, quality, kind="sinc",
                         device="cuda") -> float | None:
    """Upsampling only: the fundamental over the worst spectral image above
    the input Nyquist; None where no image band fits below the output
    Nyquist (near-unity upsampling)."""
    if rate_out <= rate_in or 0.5 * rate_out <= 0.5 * rate_in * 1.02:
        return None
    f = 0.45 * rate_in
    y = _mid(_resample(_tone(f, rate_in), rate_in, rate_out, quality, kind, device))
    spec = np.abs(np.fft.rfft(y * np.hanning(len(y))))
    freqs = np.fft.rfftfreq(len(y), 1.0 / rate_out)
    fund = spec[(freqs > f * 0.98) & (freqs < f * 1.02)].max()
    imgs = spec[freqs > 0.5 * rate_in * 1.02]
    return float(20 * np.log10(fund / (imgs.max() + 1e-300)))


def thdn_db(rate_in, rate_out, quality, kind="sinc", device="cuda") -> float:
    """THD+N of a -6 dBFS ~1 kHz tone snapped to an FFT bin of a 2^14
    output section, rectangular window (coherent: the floor is the
    converter's arithmetic, not a window's sidelobes)."""
    n2 = 1 << 14
    m = round(997.0 * n2 / rate_out)
    f = m * rate_out / n2
    n_in = int(2.2 * n2 * rate_in / rate_out)
    y = _resample(_tone(f, rate_in, n=n_in), rate_in, rate_out, quality, kind, device)
    off = (len(y) - n2) // 2
    y = y[off : off + n2].astype(np.float64)
    spec = np.abs(np.fft.rfft(y)) ** 2
    guard = 2   # residual leakage from the fp32 tone synthesis itself
    fund = spec[max(0, m - guard) : m + guard + 1].sum()
    resid = spec.sum() - fund - spec[:2].sum()   # drop DC too
    return float(10 * np.log10(max(resid, 1e-300) / fund))


def oracle_db(rate_in, rate_out, quality, kind="sinc", device="cuda") -> float:
    """RMS error against the float64 oracle on noise at 0.3 (dB)."""
    x = (0.3 * np.random.default_rng(0).standard_normal(N)).astype(np.float32)
    y = _resample(x, rate_in, rate_out, quality, kind, device)
    ref = resample_oracle(x, rate_in, rate_out, quality=quality, kind=kind)
    return float(20 * np.log10(_rms(y.astype(np.float64) - ref) / _rms(ref)))


def pair_label(rate_in: int, rate_out: int) -> str:
    return f"{rate_in / 1000:g}k→{rate_out / 1000:g}k"


def measure_row(rate_in, rate_out, quality, kind="sinc", device="cuda") -> str:
    """One table row: every figure of one bank."""
    args = (rate_in, rate_out, quality, kind, device)
    rip, edge, ali, img, thd, orc = (f(*args) for f in (
        passband_ripple_db, edge_frac, alias_rejection_db, image_suppression_db,
        thdn_db, oracle_db))
    return (f"| {pair_label(rate_in, rate_out)} | {rip:.4f} dB | {edge:.3f}·Nyq | "
            f"{'—' if ali is None else f'{ali:.1f} dB'} | "
            f"{'—' if img is None else f'{img:.1f} dB'} | "
            f"{thd:.1f} dB | {orc:.1f} dB |")


#: the tables in order: (heading, the lines between heading and table,
#: quality, kind); the headings are `docs/QUALITY.md`'s
SECTIONS = [(f"## Preset `{q}` (Z = {QUALITY_PRESETS[q]})", [], q, "sinc") for q in PRESETS] + [
    ("## Kind `minphase` (minimum-phase sinc, quality=high)",
     ["Same Kaiser magnitude as the linear-phase presets, energy packed causally",
      "(real-cepstrum transform): no pre-ringing ahead of transients."],
     "high", "minphase"),
    ("## Kind `lagrange` (order-4 = JUCE LagrangeInterpolator's 5-point form)",
     ["No anti-alias bank — polynomial interpolation only, for the varispeed/preview",
      "role the JUCE interpolator serves.  Expect shallow rejection by design:"],
     "high", "lagrange"),
]


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "CPU"."""
    if device.type != "cuda":
        return "CPU"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0]


def render(device: torch.device, pairs=PAIRS, log=None) -> str:
    """The whole document, measured on ``device`` (each row also written to
    ``log`` as it is measured)."""
    lines = [
        "# QUALITY_TORCH — measured converter characteristics of the PyTorch / CUDA port",
        "",
        f"Generated by `python -m f9tpu_torch.tools.gen_quality --device {device.type}` on "
        f"**{card_name(device)}**",
        "through the port's production path (`f9tpu_torch.ops.resample.resample_rates`: the",
        "`cycle_src` kernel, dense or windowed, where it takes the bank; for L < 8 the",
        "`cycle_fold` kernel where L = 1, else the unfold + matmul form), with the pairs,",
        "tones and FFT analysis of `tools/gen_quality.py`,",
        "whose JAX figures are `docs/QUALITY.md`.  Presets are Kaiser windowed-sinc designs",
        "parameterised by zero-crossings-per-side at the limiting rate:",
        "",
        "| preset | zero crossings/side |",
        "|---|---|",
    ]
    lines += [f"| {p} | {QUALITY_PRESETS[p]} |" for p in PRESETS]
    lines += [
        "",
        "Measurements (test tones at -6 dBFS; 'mid' region analysed to exclude edge transients):",
        "",
        "- **passband ripple**: max |gain error| over tones up to 0.8x the shared Nyquist",
        "- **-1 dB edge**: measured -1 dB bandwidth as a fraction of the shared Nyquist",
        "- **alias rejection** (downsampling): suppression of a tone above the output Nyquist",
        "- **image suppression** (upsampling): fundamental-to-worst-image ratio above the "
        "input Nyquist",
        "- **THD+N**: ~1 kHz bin-aligned tone, rectangular FFT (coherent)",
        "- **vs oracle**: RMS error against the float64 reference design "
        "(`f9tpu_torch.models.oracle`)",
        "",
    ]
    for heading, intro, quality, kind in SECTIONS:
        lines += [heading, ""]
        if intro:
            lines += intro + [""]
        lines += [_HEADER, _RULE]
        for rate_in, rate_out in pairs:
            lines.append(measure_row(rate_in, rate_out, quality, kind, device))
            if log is not None:
                print(lines[-1], file=log, flush=True)
        lines.append("")
    lines += [
        "## Reading the table",
        "",
        "- Each figure is held to the same row of `docs/QUALITY.md` (the JAX package on the",
        "  CPU) by `compare`: ripple within 0.01 dB, the edge within 0.002 of Nyquist, alias",
        "  rejection, image suppression and THD+N within 3 dB or both past 130 dB, and vs",
        "  oracle at or below -120 dB.",
        "- Past ~130 dB the figures measure float32 arithmetic, not the design: the port's",
        "  kernel sums in split TF32 with compensated partials and its CPU twin in float64,",
        "  where the JAX package sums in float32, so those figures may differ by more.",
        "- Image suppression is '—' for near-unity upsampling: no image band above the input",
        "  Nyquist fits below the output Nyquist.",
        "",
    ]
    return "\n".join(lines)


_NUM = re.compile(r"-?\d+(?:\.\d+)?")


def read_tables(text: str) -> dict[str, list[tuple[str, dict]]]:
    """The tables of a QUALITY file (either tool's): heading -> rows in
    order, each ``(pair, {column: float or None})``.  Raises ValueError on
    a table whose header is not `COLUMNS`."""
    out: dict[str, list[tuple[str, dict]]] = {}
    heading = None
    for line in text.splitlines():
        if line.startswith("## "):
            heading = line
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if heading is None or not line.startswith("|") or len(cells) != len(COLUMNS):
            continue
        if cells[0] == COLUMNS[0]:
            if tuple(cells) != COLUMNS:
                raise ValueError(f"{heading}: columns {cells}")
            out[heading] = []
            continue
        if heading not in out or set(cells[0]) <= set("-"):
            continue
        vals = {}
        for name, cell in zip(COLUMNS[1:], cells[1:]):
            m = _NUM.search(cell)
            vals[name] = None if cell == "—" else float(m.group()) if m else None
        out[heading].append((cells[0], vals))
    return out


def figure_ok(column: str, got: float | None, want: float | None) -> bool:
    """Is one figure within its tolerance of the reference's?  The vs
    oracle column is held to `ORACLE_DB_MAX` alone."""
    if column == COLUMNS[6]:
        return got <= ORACLE_DB_MAX
    if (got is None) != (want is None):
        return False
    if got is None:
        return True
    if column in (COLUMNS[1], COLUMNS[2]):
        tol = RIPPLE_TOL_DB if column == COLUMNS[1] else EDGE_TOL
        return abs(got - want) <= tol + 1e-9
    sign = -1 if column == COLUMNS[5] else 1       # THD+N is a negative level
    return abs(got - want) <= LEVEL_TOL_DB or min(sign * got, sign * want) >= DEEP_DB


def compare(got: dict, want: dict) -> list[str]:
    """Every figure of ``got`` (`read_tables`) that `figure_ok` refuses
    against its twin in ``want``, one line each; a row of ``got`` absent
    from ``want`` is a fault too."""
    faults = []
    for heading, rows in got.items():
        ref = dict(want.get(heading, []))
        for pair, v in rows:
            w = ref.get(pair)
            if w is None:
                faults.append(f"{heading} {pair}: no such row in the reference")
                continue
            faults += [f"{heading} {pair}: {col} {v[col]} vs {w[col]}"
                       for col in COLUMNS[1:] if not figure_ok(col, v[col], w[col])]
    return faults


def _parse_pairs(text: str) -> list[tuple[int, int]]:
    pairs = [tuple(int(r) for r in p.split(":")) for p in text.split(",") if p]
    unknown = [p for p in pairs if p not in PAIRS]
    if unknown:
        raise SystemExit(f"gen_quality: pairs {unknown} are not among the tool's {PAIRS}")
    return [p for p in PAIRS if p in pairs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(ROOT, "docs", "QUALITY_TORCH.md"))
    ap.add_argument("--pairs", default="", help="IN:OUT,... a subset of the tool's pairs")
    args = ap.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(os.path.join(ROOT, "docs", "QUALITY.md")):
        raise SystemExit("gen_quality: docs/QUALITY.md is the JAX package's; pick another --out")
    device = resolve_device(args.device)
    text = render(device, _parse_pairs(args.pairs) if args.pairs else PAIRS, log=sys.stderr)
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
