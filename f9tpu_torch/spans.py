"""Named host spans of the batch device path, recorded only while a
`torch.profiler` session records.

``span(name)`` returns one shared no-op context unless a profiler records
in this process (the process-wide flag, true on every thread while a
session runs); then it returns a record of ``name`` on the profiler's own
clock, beside the device operations launched inside it.  With nothing
recording a span costs one flag check: no allocation, no formatting (names
are constants, or are made once, as a chain stage's), no record.  There is
no switch of its own: the spans are on exactly when a profile records, as
under ``cli process --profile DIR``.

The record is torch's `_RecordFunctionFast`, the profiler's range entered
from C++: on an H100 a traced batch of the default job spends ~0.8 ms more
on its ~12 spans as ``torch.profiler.record_function``, which dispatches a
profiler operation on entry and on exit, and none measurable as this.

The spans, all on the thread that dispatches the batch: ``f9.graph``
(one `process_batch` / `process_batch_raw` call) holding
``f9.link.upload``, ``f9.front_end``, ``f9.src``, ``f9.chain`` (and an
``f9.chain.<stage>`` for each stage), ``f9.trim``, ``f9.tail``,
``f9.epilogue`` and ``f9.tail_floor``; ``f9.link.download`` where the
caller queues a batch's results for the host.

``spanned(name)`` makes a function's whole body the span ``name``; a span
over part of a function is a ``with span(name):`` block.

This module imports nothing of the package, so every layer can use it.
"""

from __future__ import annotations

import contextlib
import functools

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

__all__ = ["span", "spanned"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` as a host range while a profiler
    records, else the shared no-op context."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap
