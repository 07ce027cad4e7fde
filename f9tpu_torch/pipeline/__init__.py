"""Host pipeline of the port (counterpart of `f9tpu.pipeline`): the batch
graph, calibration, the manifest and log, the batch scheduler, the
constant-memory stream, the playlist preview and the loop self-test."""

from .calibration import CalibrationCache, CalibrationResult, measure_latency  # noqa: F401
from .graph import (ProcessResult, build_process_fn, process_batch,  # noqa: F401
                    process_batch_raw)
from .logbook import StatusLog, Throughput  # noqa: F401
from .manifest import FileStatus, JobEntry, JobManifest  # noqa: F401
from .preview import PlaylistItem, render_playlist, stream_playlist  # noqa: F401
from .scheduler import BatchProcessor, BatchResult, build_output_path  # noqa: F401
from .selftest import LoopTestReport, LoopTestVerdict, run_loop_test  # noqa: F401
from .stream import stream_resample_file  # noqa: F401
