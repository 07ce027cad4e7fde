"""The device mesh of the batch job (port of `f9tpu/parallel/mesh.py`).

A `Mesh` is a numpy grid of ``torch.device`` objects with the JAX package's
three axes:

- ``files``    — independent files over devices (data parallelism: no
                 traffic between shards);
- ``frames``   — one long signal's frames axis cut into contiguous chunks
                 that trade filter halos with their neighbours
                 (`f9tpu_torch.parallel.sharding.resample_frames_sharded`);
- ``channels`` — the channels of an 8/16-channel bus over devices, the
                 per-file metrics reduced across shards.

One process drives every device of the grid (`f9tpu_torch.parallel.shard`:
a thread and a CUDA stream per shard), as JAX's ``shard_map`` drives its
mesh.  A grid may name one device several times: that is how one card
rehearses a multi-card mesh (its shards then share that card, each on a
stream of its own, so a time taken so says nothing of scaling).  The
default device list, every CUDA card, never repeats a device.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..device import NoDeviceError

__all__ = ["Mesh", "NamedSharding", "P", "files_sharding", "make_mesh",
           "make_multislice_mesh"]

AXES = ("files", "frames", "channels")


class P(tuple):
    """A partition spec (JAX's ``PartitionSpec``): one entry per leading
    dimension of an array, the mesh axis that splits it or None; dimensions
    past the spec's length are not split, and ``P()`` replicates."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A ``(files, frames, channels)`` grid of ``torch.device`` objects.

    ``shape`` maps each axis name to its size, as JAX's does.  The mesh also
    owns one thread and one CUDA stream per grid cell (made at the first
    run), so every run on it puts a shard's work on the same thread and
    stream."""

    axis_names = AXES

    def __init__(self, grid):
        grid = np.asarray(grid, dtype=object)
        if grid.ndim != 3 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty 3-D device grid, got shape {grid.shape}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            self.devices[idx] = d
        self.shape = dict(zip(AXES, self.devices.shape))
        # what `run_sharded` keeps from run to run: a stream per cell, a
        # thread per cell, and the lock that makes runs take turns
        self._streams: dict = {}
        self._pool = None
        self._run_lock = threading.Lock()
        self._subs: dict = {}

    def sub(self, axes: tuple[str, ...]) -> "Mesh":
        """The mesh of work that splits only ``axes``: the other axes keep
        their first index (JAX replicates such work over them; one copy
        does).  Made once per axes, so its streams are reused."""
        keep = tuple(a for a in AXES if a in axes or self.shape[a] == 1)
        if keep == AXES:
            return self
        if axes not in self._subs:
            idx = tuple(slice(None) if a in keep else slice(0, 1) for a in AXES)
            self._subs[axes] = Mesh(self.devices[idx])
        return self._subs[axes]

    def __repr__(self) -> str:
        return (f"Mesh({' x '.join(f'{a}={n}' for a, n in self.shape.items())}, "
                f"devices={[str(d) for d in self.devices.flat]})")


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (JAX's ``NamedSharding``)."""

    mesh: Mesh
    spec: P


def _device_list(devices) -> list:
    if devices is not None:
        return [torch.device(d) for d in devices]
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise NoDeviceError(
            "make_mesh: no CUDA GPU is available (pass devices=['cpu'] * n "
            "for a mesh on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(num_files_shards: int | None = None, num_frames_shards: int = 1,
              num_channel_shards: int = 1, devices=None) -> Mesh:
    """A ``(files, frames, channels)`` mesh over ``devices`` (default: every
    CUDA card, each once; `NoDeviceError` without one).  The default puts
    every device on the files axis.

    ``devices`` may name one device more than once: ``make_mesh(4,
    devices=["cuda:0"] * 4)`` runs four shards on one card, the way one card
    rehearses a four-card mesh, and ``devices=["cpu"] * n`` is the CPU's
    mesh."""
    devs = _device_list(devices)
    n = len(devs)
    if num_files_shards is None:
        num_files_shards = n // (num_frames_shards * num_channel_shards)
    total = num_files_shards * num_frames_shards * num_channel_shards
    if total != n:
        raise ValueError(
            f"mesh {num_files_shards}x{num_frames_shards}x{num_channel_shards}"
            f" != {n} devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(num_files_shards, num_frames_shards, num_channel_shards))


def make_multislice_mesh(num_frames_shards: int = 1, num_channel_shards: int = 1,
                         devices=None, slice_ids=None) -> Mesh:
    """A mesh whose frames x channels blocks never straddle a slice (a node,
    or a group of cards joined by NVLink): the halo exchanges and metric
    reductions stay inside a slice, and only the files axis, which carries
    no traffic, spans slices.  ``slice_ids`` gives each device's slice
    (default: all in one); raises if a block would straddle a slice."""
    devs = _device_list(devices)
    if slice_ids is None:
        slice_ids = [0] * len(devs)
    if len(slice_ids) != len(devs):
        raise ValueError("slice_ids must match devices")
    groups: dict = {}
    for d, s in zip(devs, slice_ids):
        groups.setdefault(s, []).append(d)
    inner = num_frames_shards * num_channel_shards
    blocks: list = []
    for sid in sorted(groups):
        g = groups[sid]
        if len(g) % inner:
            raise ValueError(
                f"slice {sid} has {len(g)} devices, not a multiple of the "
                f"intra-slice frames*channels block ({inner}); halo/metric "
                f"collectives must not cross DCN")
        blocks.extend(g[i:i + inner] for i in range(0, len(g), inner))
    grid = np.empty((len(blocks), inner), dtype=object)
    for i, b in enumerate(blocks):
        grid[i, :] = b
    return Mesh(grid.reshape(len(blocks), num_frames_shards, num_channel_shards))


def files_sharding(mesh: Mesh) -> NamedSharding:
    """A ``(files, channels, frames)`` batch split over the files axis."""
    return NamedSharding(mesh, P("files", None, None))
