"""Host <-> card copies of the batch job and the stream.

Every copy of batch or chunk data between the host and the card goes
through pinned (page-locked) host memory, so it is one DMA that does not
hold the host thread, never a pageable copy bounced through a staging buffer:

- `host_empty` gives a host tensor to build a batch in (pinned when the
  batch is for the card), and `upload` sends a host array or tensor to the
  device without waiting for the work already queued.  A buffer that was
  not pinned is copied into a pinned one first.  The caching host allocator
  records an event for each copy and does not hand the buffer out again
  before the copy is done.
- `upload_rows` is the one way to send a row-ragged buffer, such as the
  batch job's wire, where only each row's head carries data: one copy a
  row of its first ``row_bytes[i]`` bytes (none for an empty row) into a
  device tensor of the whole shape, on the current stream.  The device
  bytes past each row's head are left uninitialised, so the reader must
  read no further (the front end reads only each file's valid frames).
- `Download` queues device tensors for the host: on the card each goes into
  a pinned buffer with ``non_blocking=True``, on a side stream when one is
  given (it waits for an event recorded after the work that made the
  tensors, and each tensor is marked as used by it, so the device allocator
  does not give its memory to the next batch while the copy still reads
  it).  `Download.get` waits for the copies and returns numpy views.  The
  tensors go down as the caller made them: the batch graph's payload is no
  wider than its longest file where the host knows the lengths
  (`graph.process_batch_raw`), else the bucket's whole output row.

On the CPU all of it is a passthrough: no copy, no event.  Pinning that
fails raises; there is no pageable fallback.

Counters, plain integers raised under a lock and set to 0 by whoever reads
them: ``bytes_up`` and ``bytes_down``, the bytes each direction was handed
since the last reset, and ``ragged_uploads``, the `upload_rows` calls.  They
count the same on the CPU, where the passthrough moves nothing, so a test
there reads what a card's copies would carry.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..spans import spanned

__all__ = ["host_empty", "upload", "upload_rows", "side_stream", "Download", "bytes_up",
           "bytes_down", "ragged_uploads"]

#: bytes handed to `upload` / `upload_rows` since the count was last reset
bytes_up = 0
#: bytes handed to `Download` since the count was last reset
bytes_down = 0
#: `upload_rows` calls since the count was last reset
ragged_uploads = 0
_count_lock = threading.Lock()


def _count(up: int = 0, down: int = 0, ragged: int = 0) -> None:
    global bytes_up, bytes_down, ragged_uploads
    with _count_lock:
        bytes_up += up
        bytes_down += down
        ragged_uploads += ragged


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def host_empty(shape, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """An uninitialised host tensor for data bound for ``dev``: pinned when
    ``dev`` is a card (``.numpy()`` views it, so a batch is built in place)."""
    return torch.empty(shape, dtype=dtype, pin_memory=dev.type == "cuda")


@spanned("f9.link.upload")
def upload(a, dev: torch.device) -> torch.Tensor:
    """Host numpy array or CPU tensor -> ``dev``; to the card through a
    pinned buffer (``a`` itself when it is pinned), without waiting for the
    work already queued."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    _count(up=_nbytes(t))
    if dev.type != "cuda":
        return t.to(dev)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


@spanned("f9.link.upload")
def upload_rows(a, row_bytes, dev: torch.device) -> torch.Tensor:
    """Host ``(rows, width)`` uint8 array or CPU tensor -> ``dev``, each
    row's first ``row_bytes[i]`` bytes only (0 <= ``row_bytes[i]`` <=
    ``width``): on the card one non-blocking copy a non-empty row from a
    pinned buffer into ``torch.empty`` of the whole shape, the bytes past
    each row's head uninitialised; elsewhere ``a`` as `upload` gives it."""
    t = torch.from_numpy(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
    n = np.asarray(row_bytes, np.int64)
    if t.ndim != 2 or t.dtype != torch.uint8 or n.shape != (t.shape[0],):
        raise ValueError(f"upload_rows takes a uint8 (rows, width) buffer and one byte "
                         f"count a row, got {t.dtype} {tuple(t.shape)} and {n.shape}")
    if ((n < 0) | (n > t.shape[1])).any():
        raise ValueError(f"row byte counts {n.tolist()} outside [0, {t.shape[1]}]")
    _count(up=int(n.sum()), ragged=1)
    if dev.type != "cuda":
        return t.to(dev)
    if not t.is_pinned():
        t = t.pin_memory()
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    for i, k in enumerate(n.tolist()):
        if k:
            out[i, :k].copy_(t[i, :k], non_blocking=True)
    return out


def side_stream(dev: torch.device):
    """A stream of its own for a job's downloads on a card, None elsewhere."""
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


class Download:
    """Device tensors queued for the host (None stays None).  On the card
    the copies start at once, into pinned buffers behind an event, on
    ``side`` if given (behind the work queued so far on the current
    stream), else on the current stream; `get` waits for them and returns
    numpy arrays."""

    @spanned("f9.link.download")
    def __init__(self, *tensors, side=None):
        self._event = None
        _count(down=sum(_nbytes(t) for t in tensors if t is not None))
        if any(t is not None and t.is_cuda for t in tensors):
            dev = next(t.device for t in tensors if t is not None)
            if side is not None:
                made = torch.cuda.current_stream(dev).record_event()
                side.wait_event(made)
            with torch.cuda.stream(side if side is not None
                                   else torch.cuda.current_stream(dev)):
                host = []
                for t in tensors:
                    if t is None:
                        host.append(None)
                        continue
                    if side is not None:
                        t.record_stream(side)
                    host.append(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                .copy_(t, non_blocking=True))
                self._event = torch.cuda.Event()
                self._event.record()
            tensors = tuple(host)
        self._tensors = tensors

    def get(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        return [None if t is None else t.numpy() for t in self._tensors]
