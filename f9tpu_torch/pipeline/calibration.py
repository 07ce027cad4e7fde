"""Latency calibration: impulse -> SRC [-> insert chain] -> peak find, with
cached results (port of `f9tpu/pipeline/calibration.py`; same cache JSON
format and keys).

The SRC is group-delay compensated by construction, so a bare resampler
measures a latency of 0; measuring it is the calibration test.  Through an
insert chain (``chain_fn``) the impulse measures the chain's real delay,
which the batch graph then trims.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading

import numpy as np
import torch

from ..models.filters import resolve_ratio

from ..device import resolve_device
from ..ops.resample import resample_rates
from ..ops.signal import IMPULSE_AMP, impulse

__all__ = ["CalibrationResult", "CalibrationCache", "measure_latency",
           "CAPTURE_FRAMES", "PEAK_THRESHOLD"]

#: Peak threshold of the impulse detector.
PEAK_THRESHOLD = 0.1
CAPTURE_FRAMES = 1 << 16


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    latency_frames: int        # chain delay at the OUTPUT rate, in frames
    noise_floor_db: float      # RMS dB of the response away from the peak
    peak_amplitude: float      # detected peak (must exceed PEAK_THRESHOLD)

    @property
    def detected(self) -> bool:
        return self.peak_amplitude > PEAK_THRESHOLD


def measure_latency(
    rate_in: int,
    rate_out: int,
    quality: str = "high",
    kind: str = "sinc",
    chain_fn=None,
    capture_frames: int = CAPTURE_FRAMES,
    ringout_frames: int = 0,
    device: torch.device | str | None = None,
) -> CalibrationResult:
    """Group delay of the processing chain in output frames, measured with
    a mid-buffer impulse on ``device`` (default CUDA, raising without a GPU;
    mid-buffer, so an acausal chain measures too).  ``chain_fn(x) -> y`` defaults to the bare resampler.
    ``ringout_frames`` (output rate) keeps the chain's known decay out of
    the noise-floor estimate, on both sides of the peak: a reverb tail is
    signal, and a linear-phase FIR pre-rings."""
    pos = capture_frames // 2
    x = impulse(capture_frames, amp=IMPULSE_AMP, position=pos,
                device=resolve_device(device))
    if chain_fn is None:
        y = resample_rates(x, rate_in, rate_out, quality=quality, kind=kind)
    else:
        y = chain_fn(x)
    yn = y.cpu().numpy()               # one device-to-host copy
    ya = np.abs(yn)
    peak_idx = int(ya.argmax())
    peak_amp = float(ya[peak_idx])
    # sub-sample peak refinement (parabolic fit on |y|): a short kernel's
    # argmax can sit a sample off the true zero-delay position
    if 0 < peak_idx < len(ya) - 1:
        a, b, c = ya[peak_idx - 1], ya[peak_idx], ya[peak_idx + 1]
        denom = a - 2 * b + c
        frac = 0.5 * (a - c) / denom if abs(denom) > 1e-12 else 0.0
        refined = peak_idx + float(np.clip(frac, -0.5, 0.5))
    else:
        refined = float(peak_idx)
    L, M = resolve_ratio(rate_in, rate_out)
    latency = int(round(refined - pos * L / M))
    # noise floor: RMS away from the response's main lobe, on both sides
    guard = 4096
    mask = np.ones(len(yn), bool)
    mask[max(0, peak_idx - guard - int(ringout_frames)):
         peak_idx + guard + int(ringout_frames)] = False
    tail = yn[mask]
    rms = float(np.sqrt(np.mean(tail**2))) if tail.size else 0.0
    nf_db = 20.0 * np.log10(max(rms, 1e-30)) if rms > 0 else -200.0
    return CalibrationResult(latency_frames=latency, noise_floor_db=nf_db,
                             peak_amplitude=peak_amp)


class CalibrationCache:
    """Persistent {chain-signature -> CalibrationResult}: a changed
    signature misses the cache and is re-measured."""

    def __init__(self, path: str | None = None):
        self._path = path
        self._lock = threading.Lock()
        self._data: dict[str, CalibrationResult] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    raw = json.load(f)
                self._data = {k: CalibrationResult(**v) for k, v in raw.items()}
            except (json.JSONDecodeError, TypeError, AttributeError, KeyError):
                self._data = {}  # corrupt cache self-heals (re-measured)

    @staticmethod
    def key(rate_in: int, rate_out: int, quality: str, kind: str, chain_sig: str = "") -> str:
        """The JAX package's key; ``chain_sig`` is empty for a bare SRC."""
        return f"{rate_in}->{rate_out}:{kind}:{quality}:{chain_sig}"

    def get_or_measure(
        self, rate_in: int, rate_out: int, quality: str = "high", kind: str = "sinc",
        chain_fn=None, chain_sig: str = "",
        capture_frames: int = CAPTURE_FRAMES, ringout_frames: int = 0,
        device: torch.device | str | None = None,
    ) -> CalibrationResult:
        """The cached result for this key, else a measurement on ``device``
        (default CUDA; then cached).  A custom ``chain_fn`` without a ``chain_sig`` is
        measured uncached: it cannot share the bare resampler's slot."""
        k = (self.key(rate_in, rate_out, quality, kind, chain_sig)
             if (chain_fn is None or chain_sig) else None)
        if k is not None:
            with self._lock:
                if k in self._data:
                    return self._data[k]
        res = measure_latency(rate_in, rate_out, quality=quality, kind=kind,
                              chain_fn=chain_fn, capture_frames=capture_frames,
                              ringout_frames=ringout_frames, device=device)
        if k is not None:
            with self._lock:
                self._data[k] = res
                self._save_locked()
        return res

    def invalidate(self, prefix: str | None = None) -> None:
        """Drop entries whose key starts with ``prefix`` at a ':' field
        boundary (or equals it); ``None`` clears all."""
        with self._lock:
            if prefix is None:
                self._data = {}
            else:
                pat = prefix if prefix.endswith(":") else prefix + ":"
                self._data = {k: v for k, v in self._data.items()
                              if not (k == prefix or k.startswith(pat))}
            self._save_locked()

    def _save_locked(self) -> None:
        if not self._path:
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({k: dataclasses.asdict(v) for k, v in self._data.items()}, f, indent=1)
        os.replace(tmp, self._path)
