"""The front end of the batch graph and of the stream as one hand-written
CUDA kernel (`csrc/frontend.cu`, ``f9_front_end``), and its plain twin.

The front end turns what the host uploads into the float32 planar signal
the SRC reads: interleaved 16- or 24-bit PCM, little- or big-endian (or a
float32 planar bucket), decoded, a mono input fanned out to
``out_channels``, routed (output ``i`` is channel ``routing[i]`` of that,
-1 silent), and then either zeroed at and past each file's
``frames_valid`` (the batch graph) or, in the stream, the DC mean taken
off over the real span ``[lo, hi)`` of frames shifted by ``idx_offset``.
The JAX package gets it from one XLA fusion of `f9tpu/pipeline/graph.py:63
_front_end` (`f9tpu/ops/devcodec.py:32`, `f9tpu/ops/routing.py:37`,
`f9tpu/ops/trim.py:195`) and of `f9tpu/pipeline/stream.py:229 _raw_front`;
no Pallas kernel computes it.  `front_end_reference` is the port's eager
form of those, moved here as it was (`devcodec.unpack_pcm_interleaved`,
the graph's fan-out and `routing.route_channels`, `trim.mask_beyond`, and
the stream's mean), and the kernel equals it bit for bit: the decode is an
exact integer to float32 conversion times a power of two, the rest copies,
zeros and one float32 subtraction in the twin's order.

The wrapper rule, as for `epilogue` and `src_kernel`: `front_end` launches
the kernel on a CUDA tensor or raises, and runs the twin on a CPU tensor,
never one for the other.  The channel map lives on the device, cached per
(device, map) as `epilogue` caches its mute masks, so no call copies it.
``launches`` counts the calls that launched.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from .devcodec import unpack_pcm_interleaved
from .routing import route_channels
from .trim import mask_beyond

__all__ = ["front_end", "front_end_reference", "channel_map", "front_end_tile",
           "front_end_smem", "launches"]

#: kernel launches since the count was last reset
launches = 0
_launch_lock = threading.Lock()
#: (device, C_in, fan-out, routing) -> the kernel's (C_out,) int32 channel
#: map on the device
_maps: dict = {}

#: the most frames a tile takes (`csrc/frontend.cu` FE_MAX_TILE)
FE_MAX_TILE = 4096
#: the wire bytes a tile stages at most, unless one frame is wider
FE_STAGE_BYTES = 16384
#: the shared memory a block may use without raising its limit
FE_SMEM_MAX = 49152
#: the float wire's tile (nothing is staged)
FE_FLOAT_TILE = 2048


def front_end_smem(tile: int, bpf: int) -> int:
    """A block's shared memory for ``tile`` frames of ``bpf`` wire bytes:
    the staged bytes sit at their address's offset from the 16-byte grid
    (`csrc/frontend.cu` fe_smem)."""
    return (tile * bpf + 30) & ~15


def front_end_tile(bpf: int) -> int:
    """Frames a block takes on a wire of ``bpf`` bytes a frame (0: the
    float wire): the largest power of two up to `FE_MAX_TILE` whose bytes
    fit `FE_STAGE_BYTES`, at least 1."""
    if bpf == 0:
        return FE_FLOAT_TILE
    tile = FE_MAX_TILE
    while tile > 1 and tile * bpf > FE_STAGE_BYTES:
        tile //= 2
    return tile


def _fan_out(c_in: int, out_channels) -> int:
    """The graph's rule: a mono input fans out to ``out_channels`` (0: no
    fan-out)."""
    return out_channels if (out_channels is not None and c_in == 1
                            and out_channels != 1) else 0


def channel_map(c_in: int, out_channels=None, routing=None) -> np.ndarray:
    """The kernel's ``(C_out,)`` int32 map: the input channel of each output
    channel, -1 silent, for the fan-out then the routing.  A routing entry
    past the fanned-out channels raises ValueError, as `route_channels`
    does."""
    fan = _fan_out(c_in, out_channels)
    c_eff = fan or c_in
    base = np.zeros(c_eff, np.int32) if fan else np.arange(c_in, dtype=np.int32)
    if routing is None:
        return base
    r = np.asarray(routing, dtype=np.int32).reshape(-1)
    if r.size and int(r.max()) >= c_eff:
        raise ValueError(f"routing entry {int(r.max())} out of range for a "
                         f"{c_eff}-channel input")
    return np.where(r < 0, -1, base[np.where(r < 0, 0, r)]).astype(np.int32)


def front_end_reference(x, frames_valid=None, *, raw=None, routing=None, out_channels=None,
                        mean=None, span=(0, 0), idx_offset: int = 0):
    """The plain PyTorch twin of `front_end` (same arguments and result)."""
    _check(x, frames_valid, raw, mean)
    if raw is not None:
        c_in, bits, big = raw
        x = unpack_pcm_interleaved(x, c_in, bits, big_endian=big)
    fan = _fan_out(x.shape[-2], out_channels)
    if fan:
        x = x.expand(*x.shape[:-2], fan, x.shape[-1])
    if routing is not None:
        x = route_channels(x, list(routing))
    if frames_valid is not None:
        x = mask_beyond(x, frames_valid)
    if mean is not None:
        i = torch.arange(x.shape[-1], device=x.device) + idx_offset
        real = (i >= span[0]) & (i < span[1])
        x = x - torch.where(real, mean, torch.zeros((), device=x.device))
    return x


def _check(x, frames_valid, raw, mean) -> None:
    if raw is not None:
        if raw[1] not in (16, 24):
            raise ValueError(f"unsupported on-device bit depth {raw[1]}")
        if x.dtype != torch.uint8 or x.ndim not in (1, 2):
            raise ValueError(f"the front end takes a uint8 (bytes,) or (files, bytes) wire, "
                             f"got {x.dtype} {tuple(x.shape)}")
    elif x.dtype != torch.float32 or x.ndim not in (2, 3):
        raise ValueError(f"the front end takes a float32 (C, frames) or (files, C, frames) "
                         f"signal, got {x.dtype} {tuple(x.shape)}")
    single = x.ndim == (1 if raw is not None else 2)
    if frames_valid is not None and (single or mean is not None):
        raise ValueError("frames_valid masks a (files, ...) batch, and not beside a mean")


def _device_map(dev, c_in: int, out_channels, routing) -> torch.Tensor:
    """`channel_map` on ``dev``, built and copied once per (device, map) and
    kept (the copy is synchronous, so any stream may read it)."""
    key = (dev, c_in, _fan_out(c_in, out_channels),
           None if routing is None else tuple(int(r) for r in routing))
    with _launch_lock:
        t = _maps.get(key)
    if t is None:
        t = torch.from_numpy(channel_map(c_in, out_channels, routing)).to(dev)
        with _launch_lock:
            t = _maps.setdefault(key, t)
    return t


def _launch(x, frames_valid, *, raw, routing, out_channels, mean, span, idx_offset):
    """One launch on ``x``'s device and current stream."""
    global launches
    from ._build import load_library

    lib = load_library()
    dev = x.device
    single = x.ndim == (1 if raw is not None else 2)
    xs = x[None] if single else x
    if raw is not None:
        c_in, bits, big = raw
        nbytes = bits // 8
        if xs.stride(1) != 1:
            xs = xs.contiguous()
        frames = xs.shape[1] // (c_in * nbytes)
        strides = (xs.stride(0), 0)
    else:
        c_in, nbytes, big = xs.shape[1], 0, False
        if xs.stride(2) != 1:
            xs = xs.contiguous()
        frames = xs.shape[2]
        strides = (xs.stride(0), xs.stride(1))
    dmap = _device_map(dev, c_in, out_channels, routing)
    files, c_out = xs.shape[0], dmap.numel()
    out = torch.empty((files, c_out, frames), dtype=torch.float32, device=dev)
    if files * c_out * frames == 0:
        return out[0] if single else out
    if frames_valid is not None:
        if tuple(frames_valid.shape) != (files,) or frames_valid.device != dev:
            raise ValueError(f"frames_valid: expected ({files},) on {dev}, got "
                             f"{tuple(frames_valid.shape)} on {frames_valid.device}")
        frames_valid = frames_valid.to(torch.int32).contiguous()
    if mean is not None:
        if mean.numel() != c_out or mean.device != dev or mean.dtype != torch.float32:
            raise ValueError(f"mean: expected {c_out} float32 values on {dev}, got "
                             f"{mean.dtype} {tuple(mean.shape)} on {mean.device}")
        mean = mean.reshape(-1).contiguous()
    tile = front_end_tile(c_in * nbytes)
    if nbytes and front_end_smem(tile, c_in * nbytes) > FE_SMEM_MAX:
        raise ValueError(f"a frame of {c_in} x {nbytes} bytes is wider than the kernel stages")

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())

    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        err = lib.f9_front_end(ptr(xs), ptr(dmap), ptr(frames_valid), ptr(mean), ptr(out),
                               files, frames, strides[0], strides[1], c_in, c_out, nbytes,
                               int(big), tile, int(span[0]), int(span[1]), int(idx_offset),
                               stream)
    if err != 0:
        raise RuntimeError(f"front-end kernel launch failed: CUDA error {err}")
    with _launch_lock:
        launches += 1
    return out[0] if single else out


def front_end(x, frames_valid=None, *, raw=None, routing=None, out_channels=None, mean=None,
              span=(0, 0), idx_offset: int = 0):
    """The front end: float32 ``(files, C_out, frames)``, or ``(C_out,
    frames)`` for a single row.

    ``x`` is the uint8 wire ``(files, bytes)`` or ``(bytes,)`` with ``raw =
    (channels, bits, big_endian)`` (bits 16 or 24; a trailing partial frame
    is dropped), or float32 ``(files, C, frames)`` or ``(C, frames)``.  A
    mono input fans out to ``out_channels`` (where that is not None or 1);
    ``routing`` then picks each output's channel (-1: +0.0).  Batch form:
    ``frames_valid (files,)`` zeroes each file's frames at and past its
    length.  Stream form: ``mean`` (C_out values, float32) is subtracted at
    the frames ``t`` with ``span[0] <= t + idx_offset < span[1]``, and
    nothing is zeroed.  On a CPU tensor the twin runs; on another the
    kernel launches or this raises."""
    _check(x, frames_valid, raw, mean)
    kw = dict(raw=raw, routing=routing, out_channels=out_channels, mean=mean, span=span,
              idx_offset=idx_offset)
    if x.device.type == "cpu":
        return front_end_reference(x, frames_valid, **kw)
    return _launch(x, frames_valid, **kw)
