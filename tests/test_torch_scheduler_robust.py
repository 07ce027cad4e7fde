"""The port's scheduler retries a failed device step once, as the JAX
package's does (`f9tpu/pipeline/scheduler.py`, `tests/test_scheduler_robust.py`
``TestDispatchRetry``).

Both `BatchProcessor`s run on the CPU over the same WAV with the same fault
injected into their graph entry points; ``time.sleep`` is patched out.
- transient: the first ``process_batch_raw`` call raises, the batch
  completes after 2 calls, and the log says it retried;
- persistent: every call raises, so 0 files complete and 1 fails;
- the transient fault on a 4-shard CPU mesh: the failing shard aborts the
  first dispatch, the whole batch is dispatched again and completes.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.io import write_wav  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.parallel import make_mesh  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

#: (scheduler module, config class, BatchProcessor keywords) of each package
PACKAGES = {"jax": (jsched, ProcessingConfig, {}),
            "torch": (tsched, TConfig, {"device": "cpu"})}


def _wav(tmp_path, name, seed, frames=4_000):
    """A 24-bit stereo WAV (the raw-bytes route: ``process_batch_raw``)."""
    rng = np.random.default_rng(seed)
    x = (0.25 * rng.standard_normal((2, frames))).astype(np.float32)
    p = str(tmp_path / name)
    write_wav(p, x, 44100, bits=24)
    return p


def _flaky(real, fail_first: int):
    """``real`` wrapped to raise on its first ``fail_first`` calls (every
    call when negative); ``calls["n"]`` counts them, from any thread."""
    calls = {"n": 0}
    lock = threading.Lock()

    def fn(*a, **k):
        with lock:
            calls["n"] += 1
            n = calls["n"]
        if fail_first < 0 or n <= fail_first:
            raise RuntimeError("INTERNAL: injected device step failure")
        return real(*a, **k)
    return fn, calls


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_transient_device_failure_retries_once(tmp_path, monkeypatch, pkg):
    sched, conf, extra = PACKAGES[pkg]
    src = _wav(tmp_path, "t.wav", seed=1)
    flaky, calls = _flaky(sched.process_batch_raw, 1)
    monkeypatch.setattr(sched, "process_batch_raw", flaky)
    monkeypatch.setattr(sched.time, "sleep", lambda s: None)
    cfg = conf(output_dir=str(tmp_path / "out"), target_rate=48000, quality="low", seed=1)
    bp = sched.BatchProcessor(cfg, **extra)
    res = bp.run([src])
    assert res.completed == 1 and res.failed == 0 and calls["n"] == 2
    log = bp.log.text()
    assert "retrying once" in log and "BATCH ABORT" not in log


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_persistent_device_failure_aborts(tmp_path, monkeypatch, pkg):
    sched, conf, extra = PACKAGES[pkg]
    src = _wav(tmp_path, "t2.wav", seed=2)
    dead, calls = _flaky(sched.process_batch, -1)
    dead_raw, calls_raw = _flaky(sched.process_batch_raw, -1)
    monkeypatch.setattr(sched, "process_batch", dead)
    monkeypatch.setattr(sched, "process_batch_raw", dead_raw)
    monkeypatch.setattr(sched.time, "sleep", lambda s: None)
    cfg = conf(output_dir=str(tmp_path / "out"), target_rate=48000, quality="low", seed=1)
    bp = sched.BatchProcessor(cfg, **extra)
    res = bp.run([src])
    assert res.completed == 0 and res.failed == 1
    assert calls["n"] + calls_raw["n"] == 2
    assert "BATCH ABORT" in bp.log.text()


def test_transient_failure_on_a_files_mesh_retries_the_batch(tmp_path, monkeypatch):
    """Four files over four CPU shards: the first shard call raises, which
    aborts the first dispatch; the second dispatches all four shards again
    from the same host buffer and every file completes, with the bytes of a
    run that never failed."""
    src = [_wav(tmp_path, f"m{i}.wav", seed=10 + i, frames=3_000 + 500 * i) for i in range(4)]
    mesh = make_mesh(4, devices=["cpu"] * 4)

    def run(out):
        cfg = TConfig(output_dir=str(tmp_path / out), target_rate=48000, quality="low",
                      seed=3, batch_size=4)
        bp = tsched.BatchProcessor(cfg, mesh=mesh)
        return bp, bp.run(src)

    _, clean = run("clean")
    flaky, calls = _flaky(tsched.process_batch_raw, 1)
    monkeypatch.setattr(tsched, "process_batch_raw", flaky)
    monkeypatch.setattr(tsched.time, "sleep", lambda s: None)
    bp, res = run("retried")
    assert clean.completed == 4 and res.completed == 4 and res.failed == 0
    # 1 to 4 shard calls in the failed dispatch, then all 4 again
    assert 5 <= calls["n"] <= 8
    log = bp.log.text()
    assert "retrying once" in log and "BATCH ABORT" not in log
    for p in src:
        name = p.rsplit("/", 1)[1].replace(".wav", "_processed.wav")
        a = (tmp_path / "clean" / name).read_bytes()
        assert a == (tmp_path / "retried" / name).read_bytes()
