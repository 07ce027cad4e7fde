"""Copy of `f9tpu/pipeline/logbook.py`, which is jax-free but sits in a
package whose `__init__` imports jax.

Timestamped status log + structured event journal.

The reference's observability is an in-app timestamped log pane
(``AppState::appendLog`` Source/AppState.h:382-387; ISO8601 variant
``MainViewModel.appendLog`` ViewModels/MainViewModel.swift:381-384, rendered
with copy-to-clipboard in FileListAndLogComponent).  Here: the same
human-readable line log, plus a JSONL event journal and per-stage throughput
counters (decoded/resampled/encoded audio-seconds) — the profiling the
reference lists as TODO (Docs/debug-notes.md:80-83) made first-class.
The device path's named spans, for a `torch.profiler` trace, are
`f9tpu_torch.spans`.
"""

from __future__ import annotations

import datetime
import json
import threading
from typing import Callable

__all__ = ["StatusLog", "Throughput"]


class StatusLog:
    """Thread-safe append-only log with ISO8601 timestamps."""

    def __init__(self, sink: Callable[[str], None] | None = None,
                 jsonl_path: str | None = None,
                 max_lines: int | None = None):
        """``max_lines``: in-memory retention cap (oldest lines dropped) for
        long-running daemons (watch mode) where the sink/JSONL already
        persists every line; None keeps everything (batch runs)."""
        self._lines: list[str] = []
        self._lock = threading.Lock()
        self._sink = sink
        self._jsonl_path = jsonl_path
        self._max_lines = max_lines

    def append(self, message: str, **fields) -> str:
        ts = datetime.datetime.now().isoformat(timespec="seconds")
        line = f"[{ts}] {message}"
        with self._lock:
            self._lines.append(line)
            if self._max_lines and len(self._lines) > self._max_lines:
                del self._lines[: len(self._lines) - self._max_lines]
            if self._jsonl_path:
                with open(self._jsonl_path, "a") as f:
                    f.write(json.dumps({"ts": ts, "msg": message, **fields}) + "\n")
        if self._sink:
            self._sink(line)
        return line

    @property
    def lines(self) -> list[str]:
        with self._lock:
            return list(self._lines)

    def text(self) -> str:
        """Full log text (the copy-to-clipboard payload,
        Source/MainComponent.cpp:63-70)."""
        return "\n".join(self.lines)


class Throughput:
    """Per-stage counters: audio-seconds in/out per wall second."""

    def __init__(self):
        self._lock = threading.Lock()
        self._audio_seconds: dict[str, float] = {}
        self._wall: dict[str, float] = {}

    def add(self, stage: str, audio_seconds: float, wall_seconds: float) -> None:
        with self._lock:
            self._audio_seconds[stage] = self._audio_seconds.get(stage, 0.0) + audio_seconds
            self._wall[stage] = self._wall.get(stage, 0.0) + wall_seconds

    def summary(self) -> dict[str, dict[str, float]]:
        with self._lock:
            return {
                stage: {
                    "audio_seconds": a,
                    "wall_seconds": self._wall[stage],
                    "x_realtime": (a / self._wall[stage]) if self._wall[stage] > 0 else 0.0,
                }
                for stage, a in self._audio_seconds.items()
            }
