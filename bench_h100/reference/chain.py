"""The plain insert chain in float64, from the configuration's stage list.

Each stage is its published equation over the whole capture, evaluated
directly: the delay as a shift, the EQ as the RBJ cookbook biquad's impulse
response truncated where its envelope falls below 1e-10, the compressor and
the limiter as moving windows, running maxima and their gain laws, and the
reverb as a full-length FFT convolution.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

COMPRESSOR = dict(threshold_db=-24.0, ratio=4.0, attack_ms=5.0, release_db_per_s=80.0,
                  knee_db=6.0, makeup_db=0.0, detector_ms=1.0)
LIMITER = dict(ceiling_db=-0.3, lookahead_ms=1.5, release_db_per_s=300.0)


def biquad_coefficients(kind: str, freq_hz: float, q: float, gain_db: float, rate: int):
    """Normalised ``(b, a)`` of the RBJ audio-EQ-cookbook section."""
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * min(freq_hz, 0.49 * rate) / rate
    cw, sw = np.cos(w0), np.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "peaking":
        b = np.array([1 + alpha * A, -2 * cw, 1 - alpha * A])
        a = np.array([1 + alpha / A, -2 * cw, 1 - alpha / A])
    elif kind == "lowpass":
        b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
        a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    elif kind == "highpass":
        b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
        a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    else:
        raise ValueError(f"no plain biquad of kind {kind!r}")
    return b / a[0], a / a[0]


def biquad_ir(stage: dict, rate: int) -> np.ndarray:
    """The section's impulse response, cut where the rest of its envelope
    stays under 1e-10 (the render window sized from the pole radius)."""
    from scipy.signal import lfilter

    b, a = biquad_coefficients(stage["kind"], stage["freq_hz"], stage["q"],
                               stage["gain_db"], rate)
    r = min(0.999999, float(np.sqrt(max(a[2], 0.0))))
    need = int(np.log(1e-10) / np.log(r)) + 16 if 0.0 < r < 1.0 else 16
    n = max(16, int(stage.get("max_ir_seconds", 2.0) * rate), min(need, 64 * rate))
    imp = np.zeros(n)
    imp[0] = 1.0
    h = lfilter(b, a, imp)
    env = np.maximum.accumulate(np.abs(h)[::-1])[::-1]
    past = np.nonzero(env < 1e-10)[0]
    if past.size and past[0] > 8:
        h = h[: past[0] + 1]
    return h


def _params(stage: dict, defaults: dict) -> dict:
    return {k: float(stage.get(k, v)) for k, v in defaults.items()}


def _frames(ms: float, rate: int) -> int:
    return max(1, int(round(ms * rate / 1000.0)))


def tail_frames(stages: list, rate: int, irs: dict) -> int:
    """The chain's worst-case ring-out at ``rate``: the sum of its stages'."""
    total = 0
    for i, s in enumerate(stages):
        kind = s["stage"]
        if kind == "delay":
            total += int(round(s["ms"] / 1000.0 * rate))
        elif kind == "biquad":
            total += len(biquad_ir(s, rate)) - 1
        elif kind == "compressor":
            p = _params(s, COMPRESSOR)
            total += (int(np.ceil(120.0 / p["release_db_per_s"] * rate))
                      + _frames(p["detector_ms"], rate) + _frames(p["attack_ms"], rate))
        elif kind == "reverb":
            total += irs[i].shape[-1] - 1
        elif kind == "limiter":
            p = _params(s, LIMITER)
            total += (3 * _frames(p["lookahead_ms"], rate)
                      + int(np.ceil(120.0 / p["release_db_per_s"] * rate)))
        else:
            raise ValueError(f"no plain stage {kind!r}")
    return total


def fft_convolve(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Causal convolution of ``x (..., T)`` with ``h (..., n)`` (broadcast),
    truncated to ``T``, by one float64 FFT of a power-of-two length."""
    T, n = x.shape[-1], h.shape[-1]
    nfft = 1 << math.ceil(math.log2(T + n - 1))
    y = torch.fft.irfft(torch.fft.rfft(x, nfft) * torch.fft.rfft(h.to(x.dtype), nfft), nfft)
    return y[..., :T]


def _ma_past(x: torch.Tensor, win: int) -> torch.Tensor:
    """``out[n] = sum_{k<win} x[n-k] / win``, zeros before the start."""
    if win <= 1:
        return x
    lead = x.shape[:-1]
    xf = F.pad(x.reshape(-1, 1, x.shape[-1]), (win - 1, 0))
    return (F.avg_pool1d(xf, win, stride=1)).reshape(*lead, -1)


def _max_past(x: torch.Tensor, win: int) -> torch.Tensor:
    """``out[n] = max x[n-win+1 .. n]``, zeros before the start (``x >= 0``)."""
    if win <= 1:
        return x
    lead = x.shape[:-1]
    xf = F.pad(x.reshape(-1, 1, x.shape[-1]), (win - 1, 0))
    return F.max_pool1d(xf, win, stride=1).reshape(*lead, -1)


def _release(level: torch.Tensor, c: float) -> torch.Tensor:
    """``env[n] = max_{k <= n} (level[k] - c*(n - k))``."""
    ramp = c * torch.arange(level.shape[-1], dtype=level.dtype, device=level.device)
    return torch.cummax(level + ramp, dim=-1).values - ramp


def _db_pow(p: torch.Tensor, scale: float) -> torch.Tensor:
    return scale * torch.log10(torch.clamp(p, min=1e-20))


def compressor(y: torch.Tensor, stage: dict, rate: int) -> torch.Tensor:
    """Feed-forward compressor linked over channels: mean square over the
    detector window, instant attack and linear-in-dB release, soft knee,
    the gain smoothed over the attack window."""
    p = _params(stage, COMPRESSOR)
    ms = _ma_past(y * y, _frames(p["detector_ms"], rate)).amax(dim=-2, keepdim=True)
    env = _release(_db_pow(ms, 10.0), p["release_db_per_s"] / rate)
    over = env - p["threshold_db"]
    slope = 1.0 - 1.0 / p["ratio"]
    k2 = p["knee_db"] / 2.0
    if p["knee_db"] > 0:
        gr = torch.where(over <= -k2, torch.zeros_like(over),
                         torch.where(over >= k2, -slope * over,
                                     -slope * (over + k2) ** 2 / (2.0 * p["knee_db"])))
    else:
        gr = torch.clamp(-slope * over, max=0.0)
    gr = _ma_past(gr, _frames(p["attack_ms"], rate))
    return y * torch.pow(10.0, (gr + p["makeup_db"]) / 20.0)


def limiter(y: torch.Tensor, stage: dict, rate: int) -> torch.Tensor:
    """Lookahead limiter linked over channels: the signal delayed by the
    lookahead ``L``, its gain the ceiling overshoot of the undelayed peak,
    released linearly in dB, spread by a maximum over ``L + 1`` and ramped
    by a mean over ``L + 1``."""
    p = _params(stage, LIMITER)
    L = _frames(p["lookahead_ms"], rate)
    level = _db_pow(y.abs().amax(dim=-2, keepdim=True), 20.0)
    atten = _release(torch.clamp(level - p["ceiling_db"], min=0.0),
                     p["release_db_per_s"] / rate)
    s = _ma_past(_max_past(atten, L + 1), L + 1)
    delayed = F.pad(y, (L, 0))[..., :y.shape[-1]]
    return delayed * torch.pow(10.0, -s / 20.0)


def apply(y: torch.Tensor, stages: list, rate: int, irs: dict) -> torch.Tensor:
    """The chain over ``y (files, C, T)`` float64; ``irs`` maps a reverb
    stage's index to its ``(C, n)`` impulse response."""
    for i, s in enumerate(stages):
        kind = s["stage"]
        if kind == "delay":
            d = int(round(s["ms"] / 1000.0 * rate))
            y = F.pad(y, (d, 0))[..., :y.shape[-1]]
        elif kind == "biquad":
            y = fft_convolve(y, torch.from_numpy(biquad_ir(s, rate)).to(y.device))
        elif kind == "compressor":
            y = compressor(y, s, rate)
        elif kind == "reverb":
            ir = torch.from_numpy(np.asarray(irs[i], np.float64)).to(y.device)
            wet = torch.cat([fft_convolve(y[:, c:c + 1], ir[c]) for c in range(y.shape[1])],
                            dim=1)
            y = float(s.get("wet", 1.0)) * wet + float(s.get("dry", 0.0)) * y
        elif kind == "limiter":
            y = limiter(y, s, rate)
        else:
            raise ValueError(f"no plain stage {kind!r}")
    return y
