"""Channel routing, fan-out and interleave conversions (port of
`f9tpu/ops/routing.py`).

Layout is planar ``(..., channels, frames)``; a routing map is a gather
over the channel axis, ``-1`` meaning a silent output channel.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "stereo_pairs",
    "route_channels",
    "fan_out_mono",
    "mixdown_monitor",
    "interleave",
    "deinterleave",
]


def stereo_pairs(num_channels: int) -> list[tuple[int, int]]:
    """Odd/even (0-indexed) channel pairs: (0, 1), (2, 3), ..."""
    return [(c, c + 1) for c in range(0, num_channels - 1, 2)]


def route_channels(x: torch.Tensor, routing, num_out: int | None = None) -> torch.Tensor:
    """Output channel ``i`` is input channel ``routing[i]`` (``-1`` =
    silence).  ``num_out`` pads the map with silent channels or cuts it.

    Entries past the input's channel count raise ValueError before any
    gather: ``torch.index_select`` is never handed a bad index."""
    routing = np.asarray(routing, dtype=np.int32).reshape(-1)
    if num_out is None:
        num_out = len(routing)
    if num_out != len(routing):
        padded = np.full(num_out, -1, np.int32)
        padded[: min(num_out, len(routing))] = routing[:num_out]
        routing = padded
    c_in = int(x.shape[-2])
    if routing.size and int(routing.max()) >= c_in:
        raise ValueError(
            f"routing entry {int(routing.max())} out of range for a "
            f"{c_in}-channel input")
    silent = routing < 0
    shape = (*x.shape[:-2], len(routing), x.shape[-1])
    if c_in == 0 or silent.all():
        return x.new_zeros(shape)
    src = torch.as_tensor(np.where(silent, 0, routing).astype(np.int64),
                          device=x.device)
    out = torch.index_select(x, -2, src)
    mask = torch.as_tensor(silent.reshape(-1, 1), device=x.device)
    return torch.where(mask, torch.zeros((), dtype=x.dtype, device=x.device), out)


def fan_out_mono(x: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Mono ``(..., frames)`` -> ``(..., num_channels, frames)`` (a view)."""
    return x[..., None, :].expand(*x.shape[:-1], num_channels, x.shape[-1])


def mixdown_monitor(x: torch.Tensor) -> torch.Tensor:
    """``(..., channels, frames)`` -> ``(..., 2, frames)``: the first two
    channels pass; more than two are averaged in pairs onto L/R, the even
    channels onto L and the odd onto R.

    Each mean is explicit adds in channel order and one division, so every
    frame takes the same operations whatever the frame count (a library
    reduction's order can follow the tensor's shape): a block's mixdown
    equals the whole programme's frames bit for bit."""
    c = x.shape[-2]
    if c == 1:
        return fan_out_mono(x[..., 0, :], 2)
    if c == 2:
        return x

    def mean(rows: range) -> torch.Tensor:
        acc = x[..., rows[0], :]
        for i in rows[1:]:
            acc = acc + x[..., i, :]
        return acc / len(rows)

    return torch.stack([mean(range(0, c, 2)), mean(range(1, c, 2))], dim=-2)


def interleave(x: torch.Tensor) -> torch.Tensor:
    """``(..., channels, frames)`` -> ``(..., frames * channels)``."""
    moved = torch.swapaxes(x, -1, -2)
    return moved.reshape(*x.shape[:-2], x.shape[-1] * x.shape[-2])


def deinterleave(x: torch.Tensor, num_channels: int) -> torch.Tensor:
    """Inverse of :func:`interleave`; a torn buffer raises ValueError."""
    if x.shape[-1] % num_channels:
        raise ValueError(
            f"interleaved length {x.shape[-1]} is not a multiple of "
            f"{num_channels} channels")
    frames = x.shape[-1] // num_channels
    return torch.swapaxes(x.reshape(*x.shape[:-1], frames, num_channels), -1, -2)
