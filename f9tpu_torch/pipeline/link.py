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
- `Download` queues device tensors for the host: on the card each goes into
  a pinned buffer with ``non_blocking=True``, on a side stream when one is
  given (it waits for an event recorded after the work that made the
  tensors, and each tensor is marked as used by it, so the device allocator
  does not give its memory to the next batch while the copy still reads
  it).  `Download.get` waits for the copies and returns numpy views.

On the CPU all of it is a passthrough: no copy, no event.  Pinning that
fails raises; there is no pageable fallback.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spans import spanned

__all__ = ["host_empty", "upload", "side_stream", "Download"]


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
    if dev.type != "cuda":
        return t.to(dev)
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


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
