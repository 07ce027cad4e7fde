"""What decides ``correct``: each judged file of the program set beside the
plain reference's, as numbers each held to a limit of the cell's
(``limits/<workload>.json``).

- ``code_lsb``: the widest gap between a program code and the reference's,
  in LSB, over every frame both keep;
- ``peak_db``, ``rms_db``, ``floor_db``: the widest gap of the per-file
  figures, in dB;
- ``dither_gap``: the widest over the files of ``|1 - slope|``, the slope
  that of the program's codes less the reference's value before the dither,
  fitted by least squares on the reference's dither: about 0 where the
  program adds that file's dither, about 1 where it adds none or another
  seed's (a dither is at most 1 LSB, which the code gap hides);
- ``frames_bad``: files whose length or tail verdict the reference cannot
  accept (limit 0).

A number the cell's limits do not name is not judged.
"""

from __future__ import annotations

import numpy as np


def decode_payload(row: np.ndarray, frames: int, channels: int, bits: int) -> np.ndarray:
    """One file's little-endian interleaved payload -> ``(channels, frames)``
    int64 codes."""
    nb = bits // 8
    b = np.asarray(row[:frames * channels * nb], np.int64).reshape(frames, channels, nb)
    v = sum(b[..., k] << (8 * k) for k in range(nb))
    return (v - ((v >> (bits - 1)) << bits)).T


def from_program(host, bits: int, channels: int) -> list[dict]:
    """The six downloaded results of one batch as one dict a file."""
    payload, frames, peak, rms, floor, term = host
    return [dict(codes=decode_payload(payload[i], int(frames[i]), channels, bits),
                 out_frames=int(frames[i]), peak_db=float(peak[i]), rms_db=float(rms[i]),
                 noise_floor_db=float(floor[i]), terminated=bool(term[i]))
            for i in range(len(frames))]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def dither_slope(codes: np.ndarray, exact: np.ndarray, noise: np.ndarray) -> float | None:
    """Least-squares slope of ``codes - exact`` on ``noise``; None where the
    dither is all zero."""
    dd = float(np.sum(noise * noise))
    return float(np.sum((codes - exact) * noise)) / dd if dd > 0 else None


def compare(got: list[dict], want: dict) -> dict:
    """The readings of one batch."""
    r = dict(code_lsb=0, peak_db=0.0, rms_db=0.0, floor_db=0.0, dither_gap=0.0,
             frames_bad=int(want["frames_bad"]))
    for g, w in zip(got, want["files"]):
        wc, gc = _host(w["codes"]), _host(g["codes"])
        n = min(gc.shape[-1], wc.shape[-1])
        if n:
            r["code_lsb"] = max(r["code_lsb"], int(np.abs(gc[:, :n] - wc[:, :n]).max()))
        if n and w.get("dither") is not None:
            slope = dither_slope(gc[:, :n], _host(w["exact"])[:, :n], _host(w["dither"])[:, :n])
            if slope is not None:
                r["dither_gap"] = max(r["dither_gap"], abs(1.0 - slope))
        for key, name in (("peak_db", "peak_db"), ("rms_db", "rms_db"),
                          ("noise_floor_db", "floor_db")):
            gap = abs(float(g[key]) - float(w[key]))
            r[name] = max(r[name], gap if np.isfinite(gap) else float("inf"))
    return r


def verdict(readings: list[dict], limits: dict) -> tuple[dict, bool]:
    """``({name: (widest reading, limit)}, every reading within its limit)``
    over the judged batches; no batch judged is not correct."""
    checks = {}
    for name, limit in limits.items():
        vals = [r[name] for r in readings]
        checks[name] = (max(vals) if vals else None, limit)
    ok = bool(readings) and all(v is not None and v <= lim for v, lim in checks.values())
    return checks, ok
