"""The loop self-test: a 1 kHz tone through the device's SRC, judged by its
level and frequency at the other end (port of `f9tpu/pipeline/selftest.py`).

The same tri-state verdict as the JAX package's: loop detected, no output
(the tone was not generated), no input (nothing came back), or degraded (a
signal came back at the wrong frequency).  The tone is made and resampled
on ``device`` (default CUDA, raising without a GPU; ``"cpu"`` only when
asked), so on the card the SRC is the kernel `src_route` names; the zero
crossings are counted on the host copy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..device import resolve_device
from ..ops import analysis
from ..ops.resample import resample_rates
from ..ops.signal import DEFAULT_TEST_FREQ, sine

__all__ = ["LoopTestVerdict", "LoopTestReport", "run_loop_test"]


class LoopTestVerdict(enum.Enum):
    LOOP_DETECTED = "loop_detected"       # output and matching input
    NO_INPUT = "no_input"                 # generated but nothing came back
    NO_OUTPUT = "no_output"               # generation itself failed
    DEGRADED = "degraded"                 # signal returned but wrong (freq)


@dataclasses.dataclass
class LoopTestReport:
    verdict: LoopTestVerdict
    output_rms_db: float
    input_rms_db: float
    measured_freq_hz: float
    detail: str


def run_loop_test(
    rate_in: int = 48000,
    rate_out: int = 44100,
    seconds: float = 1.0,
    freq: float = DEFAULT_TEST_FREQ,
    quality: str = "high",
    kind: str = "sinc",
    device: torch.device | str | None = None,
) -> LoopTestReport:
    """Run the tone through the SRC on ``device`` and classify the result."""
    dev = resolve_device(device)
    frames = int(seconds * rate_in)
    tone, _ = sine(frames, rate_in, freq=freq, device=dev)
    out_rms = float(analysis.rms_db(tone))
    if not np.isfinite(out_rms) or out_rms < -60:
        return LoopTestReport(LoopTestVerdict.NO_OUTPUT, out_rms, -200.0, 0.0,
                              "tone generation failed")
    back = resample_rates(tone, rate_in, rate_out, quality=quality, kind=kind)
    in_rms = float(analysis.rms_db(back))
    if not np.isfinite(in_rms) or in_rms < out_rms - 20:
        return LoopTestReport(LoopTestVerdict.NO_INPUT, out_rms, in_rms, 0.0,
                              "signal lost through the device loop")
    # the frequency from the zero crossings of the middle 80 %
    y = back.cpu().numpy()
    n = len(y)
    mid = y[n // 10: n - n // 10]
    if len(mid) < 4:
        return LoopTestReport(LoopTestVerdict.DEGRADED, out_rms, in_rms, 0.0,
                              f"capture too short for frequency analysis "
                              f"({n} frames)")
    crossings = np.count_nonzero(np.diff(np.signbit(mid)))
    measured = crossings / 2.0 * rate_out / len(mid)
    ok = abs(measured - freq) < freq * 0.01
    detail = (f"loop OK: {out_rms:.1f} dB out, {in_rms:.1f} dB back, "
              f"{measured:.1f} Hz (expect {freq:.0f})")
    if not ok:
        detail = f"frequency mismatch: {measured:.1f} Hz vs {freq:.0f} Hz"
    return LoopTestReport(
        LoopTestVerdict.LOOP_DETECTED if ok else LoopTestVerdict.DEGRADED,
        out_rms, in_rms, measured, detail,
    )
