"""The sharded paths of the batch job (port of `f9tpu/parallel/sharding.py`):
files-axis data parallelism, channel-axis sharding of a bus, and frames-axis
overlap-save with halo exchange, each through `run_sharded`.

- **files**: a batch ``(files, channels, frames)`` split over devices; files
  are independent, so nothing crosses shards.
- **channels**: an 8/16-channel bus split over devices.  Routing stays local
  because routing maps are per bus; the per-file reductions (peak, RMS, the
  loudest-channel envelopes of the reverb detector and the tail floor) are
  ``psum`` / ``pmax`` over the channels axis, and dither is keyed by the
  global channel, so the codes equal the unsharded graph's.
- **frames**: one long signal cut into contiguous chunks of whole cycles.
  The SRC needs only a halo of input frames on each side of a chunk: each
  shard sends its tail to its right neighbour and its head to its left one
  (``ppermute``), and only the outermost shards take the caller's halos.
  Each shard runs `resample_presliced` on its haloed chunk, which computes
  every output in the same order wherever its chunk starts, so the output
  equals the unsharded one bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.filters import CycleBank, design_cycle_bank
from ..ops.resample import resample_presliced
from .mesh import Mesh, P
from .shard import run_sharded

__all__ = [
    "channels_shardable",
    "process_batch_channels_sharded",
    "process_files_sharded",
    "required_frames_padding",
    "resample_frames_sharded",
    "shard_halos",
]


def process_files_sharded(mesh: Mesh, fn, x, *args) -> list:
    """Run ``fn(x, *args)`` with ``x (files, ...)`` split over the mesh's
    files axis, each shard on its device (the other axes keep their first
    device: files are independent, one copy of each is enough).  An
    argument that is an array with ``x``'s files dimension (per-file
    lengths, seeds, gains) is split with it; any other is passed whole.

    Returns the shards' outputs as they are, on their devices, in file
    order (the scheduler downloads each shard's results itself)."""
    sub = mesh.sub(("files",))
    files = x.shape[0]

    def split(a):
        per_file = (isinstance(a, (np.ndarray, torch.Tensor)) and a.ndim >= 1
                    and a.shape[0] == files)
        return P("files") if per_file else P()

    return run_sharded(sub, lambda ctx, *a: fn(*a), (x, *args),
                       (P("files"), *(split(a) for a in args)), None)


def channels_shardable(cfg, num_channels: int, mesh: Mesh) -> tuple[bool, str]:
    """Can this (config, channel count) batch run channel-sharded on
    ``mesh``?  ``(ok, reason)``, so the scheduler can log why not."""
    nc = mesh.shape.get("channels", 1)
    if nc <= 1:
        return False, "mesh has no channels axis"
    if num_channels % nc:
        return False, f"{num_channels} channels not divisible by {nc} shards"
    c_local = num_channels // nc
    if cfg.channel_routing is not None:
        r = np.asarray(cfg.channel_routing, np.int32)
        if len(r) != num_channels:
            return False, "routing changes the bus width"
        ok = (r < 0) | ((r // c_local) == (np.arange(num_channels) // c_local))
        if not ok.all():
            return False, "routing crosses channel shards"
    if cfg.output_channels not in (None, num_channels):
        return False, "mono fan-out not channel-shardable"
    if cfg.chain is not None:
        for s in getattr(cfg.chain, "stages", ()):
            ir = getattr(s, "ir", None)
            if ir is not None and ir.shape[0] > 1:
                return False, "per-channel IR not channel-shardable"
            if not getattr(s, "channel_local", False):
                # a stage that couples channels (linked compressor, M/S
                # width) would see only its shard's channels; one that does
                # not declare the flag is not trusted to be channel-local
                return False, (f"{type(s).__name__} couples channels (or "
                               "does not declare channel_local); "
                               "not channel-shardable")
    return True, ""


def _host(a, dtype) -> np.ndarray:
    """A host array or CPU tensor as a contiguous numpy array (device
    tensors stay where they are)."""
    if isinstance(a, torch.Tensor):
        return a if a.is_cuda else a.numpy().astype(dtype, copy=False)
    return np.array(a, dtype=dtype, order="C")


def process_batch_channels_sharded(x, frames_valid, cfg, rate_in: int, seeds, mesh: Mesh,
                                   latency_frames=0, noise_floor_db: float | None = None):
    """The batch graph with ``(files, channels)`` split over the mesh's
    files x channels axes: an 8/16-channel bus spread over devices.

    Per-channel stages (SRC, chain, DC, dither) run on each shard; the
    per-file reductions over channels ride ``psum`` / ``pmax`` over the
    channels axis, so every shard reaches the same per-file verdict.
    Routing must be bus-local (each output's source on its own shard,
    `channels_shardable`); the local gather uses the shard's channel
    offset.  Returns a `ProcessResult` with int32 codes ``(files, channels,
    out_frames)`` gathered on the mesh's first device."""
    from ..pipeline.graph import (ProcessResult, _cfg_key, _default_pad_frames,
                                  _process_impl)

    files, C = x.shape[0], x.shape[1]
    nf_shards = mesh.shape.get("files", 1)
    if files % nf_shards:
        raise ValueError(f"{files} files not divisible by {nf_shards} file shards")
    ok, reason = channels_shardable(cfg, C, mesh)
    if not ok:
        raise ValueError(f"not channel-shardable: {reason}")
    c_local = C // mesh.shape["channels"]
    route = (np.asarray(cfg.channel_routing, np.int64)
             if cfg.channel_routing is not None else None)
    lat_static = latency_frames if isinstance(latency_frames, int) else 0
    pad = _default_pad_frames(cfg, rate_in, lat_static)
    # routing and fan-out run in the local step below; the graph sees neither
    base_key = _cfg_key(dataclasses.replace(cfg, channel_routing=None, output_channels=None),
                        pad)
    if noise_floor_db is None:
        noise_floor_db = cfg.noise_floor_db
    nf = np.array(noise_floor_db if noise_floor_db is not None else 1.0, np.float32)
    static_zero = isinstance(latency_frames, int) and latency_frames == 0
    # a per-file vector split over the files axis, like the batch: a whole
    # vector on every shard would pair latencies with the wrong files
    lat = (latency_frames.to(torch.int64).broadcast_to((files,)).contiguous()
           if isinstance(latency_frames, torch.Tensor)
           else np.broadcast_to(np.asarray(latency_frames, np.int64), (files,)).copy())
    x = _host(x, np.float32)

    def local(ctx, xc, v, sd, lat_, nf_):
        silent = None
        if route is not None:
            ci = ctx.axis_index("channels") * c_local
            rl = route[ci:ci + c_local]
            src = np.clip(np.where(rl < 0, 0, rl) - ci, 0, c_local - 1)
            xc = xc.index_select(1, torch.from_numpy(src).to(xc.device))
            silent = torch.from_numpy(rl < 0).to(xc.device).reshape(1, -1, 1)
            xc = xc.masked_fill(silent, 0.0)
        codes, out_frames, term, pk, lvl, nf_est = _process_impl(
            xc, v, lat_, nf_, sd, rate_in=rate_in, rate_out=cfg.target_rate,
            cfg_key=base_key, static_zero_latency=static_zero, chain=cfg.chain,
            channel_axis=ctx.axis("channels"))
        if silent is not None:
            # routed-silent channels stay digital zero even under dither
            codes = codes.masked_fill(silent, 0)
        return codes, out_frames, term, pk, lvl, nf_est

    per_file = P("files")
    codes, out_frames, term, pk, lvl, nf_est = run_sharded(
        mesh.sub(("files", "channels")), local,
        (x, _host(frames_valid, np.int32), _host(seeds, np.int32), lat, nf),
        (P("files", "channels"), per_file, per_file, per_file, P()),
        (P("files", "channels"), per_file, per_file, per_file, per_file, per_file))
    return ProcessResult(codes=codes, out_frames=out_frames, tail_terminated=term,
                         peak_db=pk, rms_db=lvl, noise_floor_db=nf_est)


def shard_halos(bank: CycleBank) -> tuple[int, int]:
    """(halo_left, halo_right) in input frames for overlap-save sharding;
    the right halo is clamped at 0 (heavy downsampling with few taps makes
    ``W - M - pad_front`` negative)."""
    halo_left = bank.pad_front
    halo_right = max(0, bank.W - bank.M - halo_left)
    return halo_left, halo_right


def required_frames_padding(in_len: int, bank: CycleBank, n_shards: int) -> int:
    """Frames to append so the input splits into ``n_shards`` equal chunks
    of whole cycles, each at least one filter halo long (the least
    `resample_frames_sharded` takes)."""
    unit = n_shards * bank.M
    min_chunk_cycles = -(-max(shard_halos(bank)) // bank.M)
    min_len = n_shards * max(1, min_chunk_cycles) * bank.M
    padded = max(min_len, in_len + ((-in_len) % unit))
    return padded - in_len


def frames_local(ctx, xc: torch.Tensor, outer_left, outer_right, bank: CycleBank):
    """One frames shard's SRC: its chunk ``xc (..., chunk)`` with the halos
    its neighbours send (``ppermute``; the outermost shards take the outer
    halos instead), through `resample_presliced`."""
    halo_left, halo_right = shard_halos(bank)
    n = ctx.axis_size("frames")
    idx = ctx.axis_index("frames")
    parts = []
    if halo_left:
        # my head comes from the left neighbour's tail
        lh = ctx.ppermute(xc[..., -halo_left:], "frames", [(i, i + 1) for i in range(n - 1)])
        parts.append(outer_left if idx == 0 else lh)
    parts.append(xc)
    if halo_right:
        # my lookahead comes from the right neighbour's head
        rh = ctx.ppermute(xc[..., :halo_right], "frames", [(i + 1, i) for i in range(n - 1)])
        parts.append(outer_right if idx == n - 1 else rh)
    return resample_presliced(torch.cat(parts, dim=-1), bank, xc.shape[-1] // bank.M)


def resample_frames_sharded(x, rate_in: int, rate_out: int, mesh: Mesh,
                            quality: str = "high", kind: str = "sinc",
                            left_halo=None, right_halo=None) -> torch.Tensor:
    """Resample ``x (..., frames)`` with the frames axis split over the
    mesh's frames axis (overlap-save, halos by ``ppermute``).  ``frames``
    must be a multiple of ``n_shards * M`` (`required_frames_padding`);
    the output has ``frames * L / M`` samples, on the mesh's first device.

    ``left_halo`` / ``right_halo`` ``(..., halo)`` are the signal outside the
    span (a stream's file context around a super-chunk); None is silence.
    Inner shard boundaries always exchange; only the outermost shards take
    these."""
    bank = design_cycle_bank(rate_in, rate_out, quality=quality, kind=kind)
    M = bank.M
    n = mesh.shape["frames"]
    T = x.shape[-1]
    if T % (n * M):
        raise ValueError(f"frames {T} not a multiple of shards*M = {n * M}")
    halo_left, halo_right = shard_halos(bank)
    chunk = T // n
    if max(halo_left, halo_right) > chunk:
        raise ValueError(
            f"per-shard chunk of {chunk} frames is smaller than the filter "
            f"halo ({max(halo_left, halo_right)}); use fewer frames shards "
            f"or pad the input (see required_frames_padding)")
    lead = tuple(x.shape[:-1])

    def outer(h, width):
        if h is None:
            return np.zeros((*lead, width), np.float32)
        if tuple(h.shape) != (*lead, width):
            raise ValueError(
                f"outer halos must be {(*lead, halo_left)} / {(*lead, halo_right)}; "
                f"got {tuple(h.shape)}")
        return h

    ol, orr = outer(left_halo, halo_left), outer(right_halo, halo_right)
    spec = P(*([None] * len(lead)), "frames")
    return run_sharded(mesh.sub(("frames",)),
                       lambda ctx, xc, a, b: frames_local(ctx, xc, a, b, bank),
                       (x, ol, orr), (spec, P(), P()), spec)
