"""The plain latency calibration: an impulse of 0.9 in the middle of a
capture, through the plain SRC (and chain), its peak found and refined by a
parabola through ``|y|``, and the RMS away from the peak and the chain's
ring-out as the noise floor."""

from __future__ import annotations

import numpy as np
import torch

from . import chain as plain_chain
from . import design, src

IMPULSE_AMP = 0.9
CAPTURE_FRAMES = 1 << 16
GUARD = 4096


def measure(rate_in: int, rate_out: int, quality: str, kind: str, stages: list, irs: dict,
            device) -> tuple[int, float]:
    """``(latency in output frames, noise floor dB)``."""
    ringout, capture = 0, CAPTURE_FRAMES
    if stages:
        ringout = plain_chain.tail_frames(stages, rate_out, irs)
        capture = max(CAPTURE_FRAMES, -(-(3 * ringout + (1 << 15)) * rate_in // rate_out))
    pos = capture // 2
    x = torch.zeros((1, capture), dtype=torch.float64, device=device)
    x[0, pos] = IMPULSE_AMP
    y = src.resample(x, rate_in, rate_out, src.out_len(capture, rate_in, rate_out),
                     quality, kind)
    if stages:
        y = plain_chain.apply(y[None], stages, rate_out, irs)[0]
    y = y[0].cpu().numpy()
    a = np.abs(y)
    k = int(a.argmax())
    refined = float(k)
    if 0 < k < len(a) - 1:
        den = a[k - 1] - 2 * a[k] + a[k + 1]
        if abs(den) > 1e-12:
            refined = k + float(np.clip(0.5 * (a[k - 1] - a[k + 1]) / den, -0.5, 0.5))
    L, M = design.ratio(rate_in, rate_out)
    latency = int(round(refined - pos * L / M))
    keep = np.ones(len(y), bool)
    keep[max(0, k - GUARD - ringout):k + GUARD + ringout] = False
    rest = y[keep]
    rms = float(np.sqrt(np.mean(rest ** 2))) if rest.size else 0.0
    return latency, (20.0 * np.log10(max(rms, 1e-30)) if rms > 0 else -200.0)
