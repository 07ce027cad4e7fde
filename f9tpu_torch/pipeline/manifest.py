"""Copy of `f9tpu/pipeline/manifest.py`, which is jax-free but sits in a
package whose `__init__` imports jax.

Job manifest: per-file status machine with checkpoint/resume.

The reference tracks each file through
``pending -> processing -> completed | failed | invalidSampleRate``
(Source/AppState.h:23-30; Models/AudioFile.swift:19-25) but keeps it only in
memory — a killed batch restarts from scratch.  Here the manifest is persisted
as JSON after every status change, so a batch resumes at file granularity
(SURVEY.md section 5 'checkpoint/resume': the one aux subsystem the reference
lacks outright).  A completed entry is trusted only if its recorded output
file still exists with the recorded size.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import json
import os
import threading
import time

__all__ = ["FileStatus", "JobEntry", "JobManifest", "file_crc32"]


def file_crc32(path: str, chunk_bytes: int = 1 << 20) -> int:
    """Streaming CRC-32 of a file (constant memory; reads straight from the
    page cache right after an encode).  Fast enough to run per completion and
    per resume-verification — the content check SURVEY section 5 asks for
    ('per-file done/failed + output hash')."""
    import zlib

    c = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk_bytes)
            if not b:
                break
            c = zlib.crc32(b, c)
    return c & 0xFFFFFFFF


class FileStatus(str, enum.Enum):
    PENDING = "pending"
    PROCESSING = "processing"
    COMPLETED = "completed"
    FAILED = "failed"
    INVALID_SAMPLE_RATE = "invalid_sample_rate"


@dataclasses.dataclass
class JobEntry:
    path: str
    status: FileStatus = FileStatus.PENDING
    output_path: str | None = None
    output_size: int | None = None
    output_crc32: int | None = None
    """Content hash of the finished output: resume re-processes a
    truncated-but-right-size or corrupted file instead of trusting it
    (with seeded deterministic outputs, re-processing reproduces the same
    bytes, so verification is sound)."""
    output_mtime_ns: int | None = None
    """Output mtime at completion: resume skips the CRC re-read when both
    size and mtime are unchanged (a `watch` loop resumes every sweep —
    re-hashing every deliverable each time would be O(library) I/O).  Any
    rewrite bumps mtime and re-triggers the content check; `f9tpu verify`
    remains the unconditional audit."""
    input_size: int | None = None
    input_mtime_ns: int | None = None
    """Input signature recorded at probe time: resume re-processes a file
    whose CONTENT changed since completion (same path, new size/mtime —
    the `watch` re-drop case), instead of trusting the old deliverable."""
    error: str | None = None
    sample_rate: int | None = None
    num_channels: int | None = None
    num_frames: int | None = None
    progress: float = 0.0   # per-file progress double (Source/AppState.h:294-298)
    metrics: dict | None = None
    """Device metrics recorded at completion (out_frames, peak_db, rms_db,
    noise_floor_db) — the file-list readouts, persisted for tooling."""

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["status"] = self.status.value
        return d

    @classmethod
    def from_json(cls, d: dict) -> "JobEntry":
        d = dict(d)
        d["status"] = FileStatus(d["status"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class JobManifest:
    """Thread-safe ordered collection of job entries with JSON persistence.

    Disk writes are throttled (at most one per ``save_interval`` seconds):
    every status change re-serialises the whole file, which is O(n) per
    update and would serialise all pipeline threads on file I/O for large
    libraries.  A crash can lose at most the last interval of progress;
    callers flush with :meth:`save` at batch end.
    """

    def __init__(self, entries: list[JobEntry], path: str | None = None,
                 save_interval: float = 0.5):
        self._entries = {e.path: e for e in entries}
        self._path = path
        self._lock = threading.Lock()
        self._save_interval = save_interval
        self._last_save = 0.0
        self._dirty = False
        self._timer: threading.Timer | None = None
        self._save_gen = 0          # bumps on every actual disk write
        if path:
            self._clean_stale_tmp(path)

    @staticmethod
    def _clean_stale_tmp(path: str) -> None:
        """Unlink orphaned ``<path>.tmp-<pid>-<id>`` staging files left by
        DEAD processes (a repeatedly-killed watch daemon accumulated them
        forever).  Only dead owners: a live sibling process
        may be mid-write, and removing its staging file would break its
        os.replace."""
        import glob

        for tmp in glob.glob(glob.escape(path) + ".tmp-*"):
            try:
                pid = int(os.path.basename(tmp).rsplit("-", 2)[-2])
            except (ValueError, IndexError):
                continue
            if pid == os.getpid():
                continue
            try:
                os.kill(pid, 0)     # raises if the owner is gone
            except ProcessLookupError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
            except OSError:
                pass                # no permission to signal: assume live

    # -- construction --------------------------------------------------------

    @classmethod
    def from_files(cls, files: list[str], manifest_path: str | None = None) -> "JobManifest":
        return cls([JobEntry(path=p) for p in files], path=manifest_path)

    @classmethod
    def load(cls, manifest_path: str) -> "JobManifest":
        with open(manifest_path) as f:
            data = json.load(f)
        return cls([JobEntry.from_json(d) for d in data["files"]], path=manifest_path)

    @classmethod
    def load_or_create(cls, files: list[str], manifest_path: str) -> "JobManifest":
        """Resume semantics: reuse stored statuses for paths in the file list;
        verify completed outputs still exist (and their inputs unchanged);
        everything else pending.  Entries NOT in ``files`` are kept verbatim:
        the manifest is cumulative, so a `watch` sweep that passes only the
        newly-landed files does not discard earlier sweeps' history (a
        restart would otherwise reprocess the whole library).  The scheduler
        restricts its own iteration/counts to the requested files."""
        if os.path.exists(manifest_path):
            try:
                old = cls.load(manifest_path)
            except (json.JSONDecodeError, KeyError, ValueError, OSError):
                # corrupt / truncated / foreign manifest: losing resume
                # history beats wedging a watch daemon in a fail-every-sweep
                # loop; keep the bad file for forensics
                try:
                    os.replace(manifest_path, manifest_path + ".corrupt")
                except OSError:
                    pass
                return cls.from_files(files, manifest_path)
            listed = set(files)
            entries = [e for e in old._entries.values() if e.path not in listed]
            for p in files:
                prev = old._entries.get(p)
                if prev is not None and prev.status == FileStatus.COMPLETED:
                    ok = True
                    if prev.input_size is not None:
                        # input signature changed (re-dropped file with new
                        # content) -> reprocess regardless of output state
                        try:
                            ist = os.stat(p)
                            ok = (ist.st_size == prev.input_size
                                  and (prev.input_mtime_ns is None
                                       or ist.st_mtime_ns == prev.input_mtime_ns))
                        except OSError:
                            # input gone: nothing to reprocess from — keep
                            # the COMPLETED record if the output still
                            # verifies below (flipping it to pending would
                            # only fail the probe and destroy a valid record)
                            pass
                    if ok:
                        try:
                            st = os.stat(prev.output_path) if prev.output_path \
                                else None
                        except OSError:
                            st = None
                        ok = (st is not None
                              and (prev.output_size is None
                                   or st.st_size == prev.output_size))
                        if ok and prev.output_crc32 is not None and (
                                prev.output_mtime_ns is None
                                or st.st_mtime_ns != prev.output_mtime_ns):
                            # size matched (cheap guard) but the file has been
                            # touched since completion (or no mtime was
                            # recorded) — verify content so a corrupted output
                            # re-processes on resume; untouched files skip the
                            # re-read entirely
                            ok = file_crc32(prev.output_path) == prev.output_crc32
                    entries.append(prev if ok else JobEntry(path=p))
                else:
                    entries.append(JobEntry(path=p))
            return cls(entries, path=manifest_path)
        return cls.from_files(files, manifest_path)

    # -- state transitions ---------------------------------------------------

    def update(self, path: str, status: FileStatus, **fields) -> JobEntry:
        with self._lock:
            e = self._entries[path]
            e.status = status
            for k, v in fields.items():
                setattr(e, k, v)
            self._save_locked()
            return e

    def set_progress(self, path: str, progress: float) -> None:
        with self._lock:
            self._entries[path].progress = progress

    def fail_remaining(self, error: str, paths=None) -> None:
        """Batch-failure semantics: mark every non-terminal file failed and
        abort (MainViewModel.swift:233-250).  ``paths`` restricts the sweep
        to the current run's files — entries carried over from earlier runs
        (cumulative manifests) are not this batch's to fail."""
        with self._lock:
            for e in self._entries.values():
                if paths is not None and e.path not in paths:
                    continue
                if e.status in (FileStatus.PENDING, FileStatus.PROCESSING):
                    e.status = FileStatus.FAILED
                    e.error = error
            self._save_locked(force=True)

    # -- queries -------------------------------------------------------------

    def entries(self) -> list[JobEntry]:
        with self._lock:
            return list(self._entries.values())

    def get(self, path: str) -> JobEntry:
        with self._lock:
            return self._entries[path]

    def pending(self) -> list[JobEntry]:
        with self._lock:
            return [e for e in self._entries.values() if e.status == FileStatus.PENDING]

    def counts(self, paths=None) -> dict[str, int]:
        """Status histogram; ``paths`` restricts it to the current run's
        files so cumulative manifests don't inflate a sweep's totals."""
        with self._lock:
            out: dict[str, int] = {}
            for e in self._entries.values():
                if paths is not None and e.path not in paths:
                    continue
                out[e.status.value] = out.get(e.status.value, 0) + 1
            return out

    @property
    def overall_progress(self) -> float:
        """Batch progress double (Source/AppState.h:294-298)."""
        with self._lock:
            if not self._entries:
                return 0.0
            done = sum(
                1.0 if e.status in (FileStatus.COMPLETED, FileStatus.FAILED,
                                    FileStatus.INVALID_SAMPLE_RATE)
                else e.progress
                for e in self._entries.values()
            )
            return done / len(self._entries)

    # -- persistence ---------------------------------------------------------

    def _save_locked(self, force: bool = False) -> None:
        if not self._path:
            return
        now = time.monotonic()
        if not force and now - self._last_save < self._save_interval:
            if not self._dirty:
                # schedule a deferred flush so throttled updates in the last
                # interval survive even when the caller exits via an
                # exception path that skips the batch-end save().  The timer
                # carries the CURRENT save generation: if any real save
                # flushes before it fires, the stale timer becomes a no-op
                # instead of overwriting newer on-disk state (the
                # exception-exit path leaves the timer alive, and a
                # later manifest instance on the same path may have saved).
                self._dirty = True
                self._timer = threading.Timer(
                    self._save_interval,
                    functools.partial(self._deferred_save, self._save_gen))
                self._timer.daemon = True
                self._timer.start()
            return
        if self._timer is not None:
            # a real save supersedes any pending deferred flush — and a
            # timer left alive past the batch-end save() would RACE the
            # next run's manifest on the same path (same tmp file: one
            # os.replace removes it under the other -> FileNotFoundError;
            # worse, a stale fire could overwrite the newer run's state)
            self._timer.cancel()
            self._timer = None
        # instance-unique tmp name: two manifests on the same path (resume
        # run, watch sweeps) must never share a staging file
        tmp = f"{self._path}.tmp-{os.getpid():d}-{id(self):x}"
        with open(tmp, "w") as f:
            json.dump({"files": [e.to_json() for e in self._entries.values()]}, f, indent=1)
            f.flush()
            os.fsync(f.fileno())   # rename-before-data on a crash would
            # leave a truncated manifest after the "atomic" replace
        os.replace(tmp, self._path)
        self._last_save = now
        self._dirty = False
        self._save_gen += 1

    def _deferred_save(self, gen: int) -> None:
        with self._lock:
            if self._save_gen != gen:
                return  # a newer save already flushed: stale timer, no-op
            try:
                self._save_locked(force=True)
            except OSError:
                pass    # out dir vanished under the timer (shutdown/cleanup)

    def save(self) -> None:
        """Force a flush to disk (batch end / abort)."""
        with self._lock:
            self._save_locked(force=True)

    def close(self) -> None:
        """Cancel any pending deferred-save timer (flushing throttled state
        first if one was armed).  Call from a ``finally``: an exception exit
        must not leave a live timer that could fire up to save_interval
        later and overwrite a NEWER manifest instance's state on the same
        path — the cross-instance half of that race (the generation
        check in `_deferred_save` only covers this instance's own saves)."""
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            if self._dirty:
                try:
                    self._save_locked(force=True)
                except OSError:
                    pass
