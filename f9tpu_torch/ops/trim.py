"""Latency trimming, padding, per-file length masks and reverb-tail
detection (port of `f9tpu/ops/trim.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["interleaved_to_frames", "mask_beyond", "trim_latency", "pad_tail",
           "detect_tail_end"]


def interleaved_to_frames(latency_samples, num_channels: int) -> torch.Tensor:
    """Interleaved-sample latency -> frames (floor division)."""
    return torch.as_tensor(latency_samples) // num_channels


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
        captured = F.pad(captured, (0, out_frames - t))
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


def pad_tail(x: torch.Tensor, frames: int) -> torch.Tensor:
    """Append ``frames`` of silence to the last axis."""
    return F.pad(x, (0, frames))


def detect_tail_end(x: torch.Tensor, noise_floor_db, margin_pct, rate: int,
                    window_ms: int = 100, hop_ms: int = 50, consecutive: int = 3,
                    min_frames=0, mode: str = "peak"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-file reverb-tail end on ``x (files, channels, frames)`` (or
    ``(files, frames)``): ``(end_frame int32 (files,), terminated bool
    (files,))``.

    Levels of hop-aligned windows are checked every hop; ``consecutive``
    quiet windows in a row confirm silence and the capture ends where the
    last of them ends.  A window counts only if it ends at or after the
    file's ``min_frames``.  Threshold: ``nf + nf * margin / 100`` for a
    negative noise floor ``nf``, else -80 dB.  A tail that never falls
    quiet returns ``frames`` and ``terminated=False``.

    ``mode="peak"``: the loudest channel's peak; ``"rms"``: the mean square
    over all channels.  A window is ``ceil(window / hop)`` whole hop chunks
    (so a window that is not a multiple of the hop rounds up), reduced per
    chunk first and then combined over adjacent chunks, as the JAX graph
    does, so both packages see the same windows."""
    if x.ndim == 2:
        x = x[:, None, :]
    files, _chans, frames = x.shape
    dev = x.device
    win = max(1, rate * window_ms // 1000)
    hop = max(1, rate * hop_ms // 1000)

    nf = torch.as_tensor(noise_floor_db, dtype=torch.float32, device=dev)
    margin = torch.as_tensor(margin_pct, dtype=torch.float32, device=dev)
    threshold_db = torch.where(nf < 0, nf + nf * margin / 100.0,
                               torch.full_like(nf, -80.0))

    if mode == "rms":
        stream = torch.mean(torch.square(x), dim=1)
    elif mode == "peak":
        stream = torch.amax(torch.abs(x), dim=1)
    else:
        raise ValueError(f"mode must be 'peak' or 'rms', got {mode!r}")
    factor = -(-win // hop)               # chunks per window
    win = factor * hop                    # the effective hop-aligned window
    n_hops = (frames - win) // hop + 1
    if n_hops <= 0:                       # capture shorter than one window
        return (torch.full((files,), frames, dtype=torch.int32, device=dev),
                torch.zeros((files,), dtype=torch.bool, device=dev))
    n_chunks = n_hops + factor - 1
    pad_to = n_chunks * hop
    stream_p = F.pad(stream, (0, max(0, pad_to - frames)))[:, :pad_to]
    chunks = stream_p.reshape(files, n_chunks, hop)

    def _combine(per_chunk, reduce_fn):
        out = per_chunk[:, 0:n_hops]
        for s in range(1, factor):
            out = reduce_fn(out, per_chunk[:, s:s + n_hops])
        return out

    floor = torch.full((), -200.0, dtype=torch.float32, device=dev)
    if mode == "rms":
        energy = _combine(torch.sum(chunks, dim=-1), torch.add) / float(factor * hop)
        level_db = torch.where(
            energy > 0, 10.0 * torch.log10(torch.clamp(energy, min=1e-30)), floor)
    else:
        peaks = _combine(torch.amax(chunks, dim=-1), torch.maximum)
        level_db = torch.where(
            peaks > 0, 20.0 * torch.log10(torch.clamp(peaks, min=1e-30)), floor)

    n_win = level_db.shape[-1]
    quiet = level_db < threshold_db                      # (files, n_win)
    # window w ends at frame w*hop + win; earlier ends do not count
    ends = torch.arange(n_win, dtype=torch.int64, device=dev) * hop + win
    min_f = torch.as_tensor(min_frames, dtype=torch.int64, device=dev)
    quiet = quiet & (ends[None, :] >= min_f.reshape(-1, 1))
    # `consecutive` quiet windows in a row: AND of right-shifted copies
    run = quiet
    for s in range(1, consecutive):
        shifted = torch.zeros_like(quiet)
        if s < n_win:
            shifted[:, s:] = quiet[:, :n_win - s]
        run = run & shifted
    hit = torch.any(run, dim=-1)
    # torch.argmax has no CUDA kernel for bool; on int32 it returns the
    # first maximum, as jnp.argmax does
    first = torch.argmax(run.to(torch.int32), dim=-1)
    end = torch.clamp(first * hop + win, max=frames)
    end_frame = torch.where(hit, end, torch.full_like(end, frames))
    return end_frame.to(torch.int32), hit
