"""One program over a mesh of devices, driven from one process: the port's
counterpart of ``jax.shard_map`` and the ``jax.lax`` collectives.

`run_sharded` splits each argument by its partition spec, runs ``fn`` once
per grid cell on a thread of its own (as ``torch.nn.parallel.parallel_apply``
runs one thread per device), each under ``torch.cuda.device(d)`` and the
cell's own CUDA stream, and gathers the outputs by their specs.  The `Mesh`
owns the cells' threads (a pool of one per cell, made at the first run) and
streams, so a run starts no thread; runs on one mesh take turns.  ``fn``
receives a `ShardContext` first: its shard's device and the collectives
over a mesh axis.

- ``psum`` / ``pmax`` take every member's tensor in shard order 0..n-1 on the
  axis group's first shard (its device and stream, after waiting for each
  contributor's CUDA event), then copy the result back to every member: the
  result's bytes do not depend on which thread came first.
- ``ppermute`` hands each member the tensor of the member that sends to it
  (zeros if none does), as ``jax.lax.ppermute``.
- A tensor given to a collective, and a reduction's result, may be written
  in place once the collective returns: a ``psum`` / ``pmax`` member returns
  only after the first shard's reads of its tensor (the result's event
  follows them), and the first shard's result and a ``ppermute``'d tensor
  are offered as copies made on the giver's stream.

Every wait in a collective has a timeout.  A shard that raises aborts the
run: the others raise `ShardAborted` from their next or current wait, and
`run_sharded` raises the first shard's own error.  A fault fails; it never
hangs.

Streams and memory: each shard's stream first waits for the caller's
current stream, so inputs the caller made on the card are complete; the
caller's stream waits for every shard's stream before `run_sharded`
returns.  A tensor one stream made and another reads is marked with
``record_stream`` (outputs read by the caller, tensors a collective hands to
another shard), so the caching allocator does not give its memory away
while a read is still queued.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..pipeline import link
from .mesh import AXES, Mesh, P

__all__ = ["ShardAborted", "ShardContext", "run_sharded", "DEFAULT_TIMEOUT"]

#: seconds a shard waits in a collective for the other members
DEFAULT_TIMEOUT = 600.0


class ShardAborted(RuntimeError):
    """Another shard of the run failed; this one stopped at a collective."""


class _Rendezvous:
    """One axis group's meeting point: each member posts an item, and once
    all have, every member gets the list of items in member order."""

    def __init__(self, n: int, abort: threading.Event, timeout: float):
        self.n = n
        self._cond = threading.Condition()
        self._rounds: dict[int, list] = {}     # seq -> [items, posted, taken]
        self._abort = abort
        self._timeout = timeout

    def exchange(self, seq: int, idx: int, item) -> list:
        with self._cond:
            r = self._rounds.setdefault(seq, [[None] * self.n, 0, 0])
            r[0][idx] = item
            r[1] += 1
            self._cond.notify_all()
            deadline = time.monotonic() + self._timeout
            while r[1] < self.n:
                if self._abort.is_set():
                    raise ShardAborted("another shard of this run failed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"shard waited {self._timeout:.0f} s in a collective for "
                        f"{self.n - r[1]} of {self.n} members")
                self._cond.wait(left)
            r[2] += 1
            if r[2] == self.n:
                del self._rounds[seq]
            return r[0]

    def wake(self) -> None:
        with self._cond:
            self._cond.notify_all()


class _Run:
    """The shared state of one `run_sharded` call: the rendezvous of each
    axis group that meets (made at its first collective) and the abort
    flag."""

    def __init__(self, mesh: Mesh, timeout: float):
        self.mesh = mesh
        self.timeout = timeout
        self.abort_event = threading.Event()
        self._lock = threading.Lock()
        self._groups: dict[tuple, _Rendezvous] = {}

    def group(self, key: tuple) -> _Rendezvous:
        with self._lock:
            if key not in self._groups:
                self._groups[key] = _Rendezvous(self.mesh.shape[key[0]], self.abort_event,
                                                self.timeout)
            return self._groups[key]

    def abort(self) -> None:
        self.abort_event.set()
        with self._lock:
            groups = list(self._groups.values())
        for g in groups:
            g.wake()


class ShardContext:
    """What ``fn`` knows of its shard: ``device``, ``stream`` (None on the
    CPU), its index and the size of each mesh axis, and the collectives."""

    def __init__(self, run: _Run, coord: tuple, device: torch.device, stream):
        self._run = run
        self.coord = coord
        self.device = device
        self.stream = stream
        self._seq = dict.fromkeys(AXES, 0)

    def axis_index(self, name: str) -> int:
        return self.coord[AXES.index(name)]

    def axis_size(self, name: str) -> int:
        return self._run.mesh.shape[name]

    def axis(self, name: str) -> "Axis":
        """The collectives over one named axis (what the graph takes as its
        ``channel_axis``)."""
        return Axis(self, name)

    # ---- the exchange under every collective
    def _exchange(self, name: str, item) -> list:
        a = AXES.index(name)
        group = self._run.group((name, self.coord[:a] + self.coord[a + 1:]))
        seq = self._seq[name]
        self._seq[name] += 1
        return group.exchange(seq, self.coord[a], item)

    def _post(self, t: torch.Tensor, copy: bool = False):
        """``t`` (or, with ``copy``, a copy of it that the poster never
        writes) offered to the group, with an event after the work that made
        it."""
        if copy:
            t = t.clone()
        ev = torch.cuda.current_stream(t.device).record_event() if t.is_cuda else None
        return t, ev

    def _take(self, item) -> torch.Tensor:
        """Another member's tensor copied onto this shard's device, on this
        shard's stream, once the work that made it is done."""
        t, ev = item
        if self.stream is not None:
            if ev is not None:
                self.stream.wait_event(ev)
            if t.is_cuda:
                t.record_stream(self.stream)
        return t.to(self.device, copy=True)

    def _reduce(self, t: torch.Tensor, name: str, op) -> torch.Tensor:
        items = self._exchange(name, self._post(t))
        first = self.axis_index(name) == 0
        if first:
            acc = t
            for item in items[1:]:
                acc = op(acc, self._take(item))
        # the others read acc after this shard has returned it: a copy
        out = self._exchange(name, self._post(acc, copy=True) if first else None)[0]
        return acc if first else self._take(out)

    def psum(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The sum over the axis group, added in shard order 0..n-1."""
        return self._reduce(t, name, torch.add)

    def pmax(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The elementwise maximum over the axis group."""
        return self._reduce(t, name, torch.maximum)

    def ppermute(self, t: torch.Tensor, name: str, perm) -> torch.Tensor:
        """``perm`` is a list of (source, destination) axis indices: each
        member gets its source's tensor, or zeros if none sends to it."""
        me = self.axis_index(name)
        sends = any(s == me for s, _ in perm)
        # the receiver reads after this shard has returned: a copy
        items = self._exchange(name, self._post(t, copy=True) if sends else None)
        src = [s for s, d in perm if d == me]
        return self._take(items[src[0]]) if src else torch.zeros_like(t)


@dataclasses.dataclass(frozen=True)
class Axis:
    """The collectives of one `ShardContext` over one named axis."""

    ctx: ShardContext
    name: str

    @property
    def index(self) -> int:
        return self.ctx.axis_index(self.name)

    @property
    def size(self) -> int:
        return self.ctx.axis_size(self.name)

    def psum(self, t):
        return self.ctx.psum(t, self.name)

    def pmax(self, t):
        return self.ctx.pmax(t, self.name)


def _local_part(a, spec, coord: tuple, mesh: Mesh, dev: torch.device):
    """Shard ``coord``'s part of argument ``a`` on ``dev``: arrays are cut
    along each dimension the spec names (host data goes up through the
    pinned link); a None spec passes ``a`` through untouched."""
    if spec is None:
        return a
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    if not isinstance(a, torch.Tensor):
        if any(s is not None for s in spec):
            raise TypeError(f"only an array can be split, got {type(a).__name__}")
        return a
    if len(spec) > a.dim():
        raise ValueError(f"spec {spec!r} has more entries than the array's {a.dim()} dimensions")
    for d, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.shape[name]
        if a.shape[d] % n:
            raise ValueError(f"dimension {d} of size {a.shape[d]} does not split "
                             f"over {n} {name} shards")
        k = a.shape[d] // n
        a = a.narrow(d, coord[AXES.index(name)] * k, k)
    if a.device == dev:
        return a
    if a.device.type == "cpu" and dev.type == "cuda":
        return link.upload(a.contiguous(), dev)
    return a.to(dev)


def _tensors(obj):
    """Every tensor in a shard's output (tuples, lists, dataclasses)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _gather(outs: np.ndarray, spec: P, dev: torch.device) -> torch.Tensor:
    """One output of every shard (an object grid of tensors) as one tensor
    on ``dev``: concatenated along each dimension the spec names, in shard
    order; an axis the spec does not name is replicated, and its first
    shard's output is taken."""
    grid = outs
    for a, name in enumerate(AXES):
        if name not in spec:
            grid = grid.take([0], axis=a)
    for d in reversed(range(len(spec))):
        name = spec[d]
        if name is None:
            continue
        a = AXES.index(name)
        shape = list(grid.shape)
        shape[a] = 1
        merged = np.empty(shape, dtype=object)
        for idx in np.ndindex(*shape):
            parts = [grid[idx[:a] + (i,) + idx[a + 1:]].to(dev)
                     for i in range(grid.shape[a])]
            merged[idx] = torch.cat(parts, dim=d)
        grid = merged
    return grid.flat[0].to(dev)


def run_sharded(mesh: Mesh, fn, args, in_specs, out_specs, timeout: float = DEFAULT_TIMEOUT):
    """Run ``fn(ctx, *local_args)`` once per cell of ``mesh``, each on its
    own thread and stream, and gather the results.

    ``in_specs`` holds one `P` per argument (None: pass it untouched).
    ``out_specs`` is a `P` for a tensor output, a tuple of them for a tuple
    output (each gathered on the mesh's first device), or None: then the
    shards' outputs come back as they are, a list in grid order.  A shard
    that raises makes the call raise its error once every shard has stopped.
    ``fn`` must not call `run_sharded` on the same mesh."""
    if len(in_specs) != len(args):
        raise ValueError(f"{len(args)} arguments but {len(in_specs)} specs")
    run = _Run(mesh, timeout)
    coords = list(np.ndindex(mesh.devices.shape))
    cells = [(c, mesh.devices[c]) for c in coords]
    streams, entry = mesh._streams, {}
    results = [None] * len(cells)
    errors = [None] * len(cells)
    ends = [None] * len(cells)

    def body(i: int) -> None:
        coord, d = cells[i]
        s = streams.get(i)
        ctx = ShardContext(run, coord, d, s)
        try:
            if s is None:
                local = [_local_part(a, sp, coord, mesh, d) for a, sp in zip(args, in_specs)]
                results[i] = fn(ctx, *local)
                return
            with torch.cuda.device(d), torch.cuda.stream(s):
                s.wait_event(entry[d])
                local = [_local_part(a, sp, coord, mesh, d) for a, sp in zip(args, in_specs)]
                results[i] = fn(ctx, *local)
                ends[i] = s.record_event()
        except BaseException as err:   # handed to the caller below
            errors[i] = err
            run.abort()

    with mesh._run_lock:
        for i, (c, d) in enumerate(cells):
            if d.type == "cuda":
                if i not in streams:
                    streams[i] = torch.cuda.Stream(device=d)
                if d not in entry:
                    entry[d] = torch.cuda.current_stream(d).record_event()
        # every cell's body runs at once: the pool has one thread per cell
        # and the lock keeps other runs on this mesh out of it
        if mesh._pool is None:
            mesh._pool = ThreadPoolExecutor(max_workers=len(cells),
                                            thread_name_prefix="f9tpu-shard")
        for f in [mesh._pool.submit(body, i) for i in range(len(cells))]:
            f.result()
    failed = [e for e in errors if e is not None]
    if failed:
        raise next((e for e in failed if not isinstance(e, ShardAborted)), failed[0])
    for (_, d), ev in zip(cells, ends):
        if ev is not None:
            torch.cuda.current_stream(d).wait_event(ev)
    for r in results:
        for t in _tensors(r):
            if t.is_cuda:
                t.record_stream(torch.cuda.current_stream(t.device))
    if out_specs is None:
        return results
    grid = np.empty(mesh.devices.shape, dtype=object)
    dev = mesh.devices.flat[0]
    if isinstance(out_specs, P):
        for c, r in zip(coords, results):
            grid[c] = r
        return _gather(grid, out_specs, dev)
    gathered = []
    for k, spec in enumerate(out_specs):
        for c, r in zip(coords, results):
            grid[c] = r[k]
        gathered.append(_gather(grid, spec, dev))
    return tuple(gathered)
