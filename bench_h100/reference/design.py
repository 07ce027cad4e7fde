"""The plain SRC's filter design, in float64 NumPy.

A frozen copy of the published design (Kaiser-windowed sinc, ``Z`` zero
crossings a side at the lower rate, 140 dB stopband), written out here so
that the reference designs its own banks and imports nothing of the program.
Output sample ``n`` estimates the input at exact position ``n * M / L``:

    y[n] = sum_j H[p, j] * x[b - j],   u = n*M + delay,  b = u // L,  p = u % L
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np

QUALITY_ZERO_CROSSINGS = {"low": 16, "medium": 32, "high": 64, "ultra": 100}
ATTEN_DB = 140.0


def ratio(rate_in: int, rate_out: int) -> tuple[int, int]:
    """``(L, M)`` with ``rate_out / rate_in = L / M`` in lowest terms."""
    f = (Fraction(rate_out) / Fraction(rate_in)).limit_denominator(1 << 16)
    return f.numerator, f.denominator


def _i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel function of the first kind, order 0 (power series)."""
    x = np.asarray(x, dtype=np.float64)
    half = x / 2.0
    term = np.ones_like(x)
    acc = np.ones_like(x)
    for k in range(1, 64):
        term = term * (half / k) ** 2
        acc = acc + term
        if np.all(term < 1e-24 * acc):
            break
    return acc


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50.0:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21.0:
        return 0.5842 * (atten_db - 21.0) ** 0.4 + 0.07886 * (atten_db - 21.0)
    return 0.0


def sinc_bank(L: int, M: int, K: int, atten_db: float = ATTEN_DB) -> np.ndarray:
    """``H (L, K)``: ``H[p, j] = h[j*L + p]`` of a Kaiser-windowed sinc
    prototype of ``K*L`` taps, centred on ``K*L // 2``, cut off half a
    transition band below the lower Nyquist and scaled to unity DC gain."""
    N = K * L
    beta = _kaiser_beta(atten_db)
    n_eff = N / max(L, M)
    half_trans = (atten_db - 7.95) / (2.285 * 2.0 * math.pi * max(n_eff, 1.0))
    wc = max(0.5, 1.0 - half_trans) * 0.5 / max(L, M)
    pos = np.arange(N, dtype=np.float64) - N // 2
    r = np.clip(pos / (N / 2.0), -1.0, 1.0)
    window = _i0(beta * np.sqrt(np.maximum(0.0, 1.0 - r * r))) / _i0(np.asarray(beta))
    h = 2.0 * wc * np.sinc(2.0 * wc * pos) * window * L
    h /= np.sum(h) / L
    return h.reshape(K, L).T.copy()


def design(rate_in: int, rate_out: int, quality: str = "high", kind: str = "sinc"):
    """``(L, M, K, H, delay)`` of the linear-phase sinc resampler."""
    if kind != "sinc":
        raise ValueError(f"the plain reference designs sinc banks only, not {kind!r}")
    L, M = ratio(rate_in, rate_out)
    if L == 1 and M == 1:
        return 1, 1, 1, np.ones((1, 1)), 0
    Z = QUALITY_ZERO_CROSSINGS[quality]
    K = max(4, int(math.ceil(2.0 * Z * max(L, M) / L)))
    K += K % 2
    return L, M, K, sinc_bank(L, M, K), (K * L) // 2


def cycle_form(L: int, M: int, K: int, H: np.ndarray, delay: int):
    """The direct form regrouped by cycles of ``L`` outputs:
    ``y[q*L + p] = sum_w C[w, p] * x[q*M + lead + w]``, returned as
    ``(C (W, L), lead)``; ``lead`` is <= 0 and ``W`` the window width."""
    p = np.arange(L, dtype=np.int64)
    u = p * M + delay
    s, ph = u // L, u % L
    lead = int(s.min()) - (K - 1)
    W = int(s.max()) - lead + 1
    C = np.zeros((W, L), dtype=np.float64)
    for q in range(L):
        for j in range(K):
            C[s[q] - j - lead, q] = H[ph[q], j]
    return C, lead


def taps_per_output(L: int, M: int, K: int, H: np.ndarray, delay: int) -> np.ndarray:
    """``(L,)`` non-zero taps of each output phase ``n % L``."""
    p = np.arange(L, dtype=np.int64)
    return np.count_nonzero(H[(p * M + delay) % L], axis=1)
