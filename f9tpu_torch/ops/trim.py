"""Latency trimming and per-file length masks (port of `mask_beyond` and
`trim_latency` from `f9tpu/ops/trim.py`; reverb-tail detection waits for
the reverb port)."""

from __future__ import annotations

import torch

__all__ = ["mask_beyond", "trim_latency"]


def mask_beyond(x: torch.Tensor, end_frame: torch.Tensor) -> torch.Tensor:
    """Zero samples at/after each file's ``end_frame`` (``x`` is
    ``(files, ...)``, ``end_frame`` ``(files,)``)."""
    frames = x.shape[-1]
    pos = torch.arange(frames, dtype=torch.int64, device=x.device)
    shape = [x.shape[0]] + [1] * (x.ndim - 1)
    keep = pos < end_frame.to(torch.int64).reshape(shape)
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def trim_latency(captured: torch.Tensor, latency_frames, out_frames: int) -> torch.Tensor:
    """Drop ``latency_frames`` from the head of the last axis and return
    exactly ``out_frames`` (zero-padded on under-run).  Negative latency
    delays the output by ``|latency|`` frames behind a zero head.  A scalar
    or per-file ``(files,)`` latency."""
    t = captured.shape[-1]
    bound = max(t - 1, 0)
    dev = captured.device
    lat = torch.as_tensor(latency_frames, dtype=torch.int64, device=dev)
    lat = torch.clamp(lat, -bound, bound).reshape(-1, 1)
    if t < out_frames:
        captured = torch.nn.functional.pad(captured, (0, out_frames - t))
        t = out_frames
    flat = captured.reshape(-1, t)
    b = flat.shape[0]
    idx = torch.arange(out_frames, dtype=torch.int64, device=dev)[None, :] + lat
    if idx.shape[0] == 1 and b > 1:
        idx = idx.expand(b, out_frames)
    elif idx.shape[0] != b:
        idx = idx.repeat_interleave(b // idx.shape[0], dim=0)   # over channels
    valid = (idx >= 0) & (idx < t)
    got = torch.gather(flat, -1, idx.clamp(0, t - 1))
    got = torch.where(valid, got, torch.zeros((), dtype=got.dtype, device=dev))
    return got.reshape(*captured.shape[:-1], out_frames)
