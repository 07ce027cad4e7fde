"""The port's scheduler against the JAX package's robustness cases
(`tests/test_scheduler_robust.py`), each run through both packages on the
CPU with the same assertions.

The dispatch retry: the same fault injected into both
packages' graph entry points, ``time.sleep`` patched out.
- transient: the first ``process_batch_raw`` call raises, the batch
  completes after 2 calls, and the log says it retried;
- persistent: every call raises, so 0 files complete and 1 fails;
- the transient fault on a 4-shard CPU mesh: the failing shard aborts the
  first dispatch, the whole batch is dispatched again and completes.

The other 25 cases, parametrised over the package (``pkg``): oversized files
routed to the stream (with latency, a long-ring chain, and the reduced batch
width of a stream-ineligible config); several buckets in one run; a slow
decode that must not hold up the other files; a dead encoder and a failed
encode that must leave no partial file; resume by content hash, untouched
outputs resumed without a CRC read, suffixed and reprocessed output names;
`cli verify`; random decode failures over mixed buckets; a stream that leaves
no ``.part``; and the manifest's staging, timer and recovery cases, on each
package's own `manifest` module (the port's is a copy).  Each asserts the
completed and failed counts, log lines, manifest states and errors, output
names, and that no ``.part`` or staging file is left.
"""

import json
import os
import struct
import threading
import time as _time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu import cli as jcli  # noqa: E402
from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.io import codec as jcodec  # noqa: E402
from f9tpu.io import wav as jwav  # noqa: E402
from f9tpu.io import write_wav  # noqa: E402
from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.pipeline import logbook as jlogbook  # noqa: E402
from f9tpu.pipeline import manifest as jmanifest  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu.pipeline import stream as jstream  # noqa: E402
from f9tpu_torch import cli as tcli  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io import codec as tcodec  # noqa: E402
from f9tpu_torch.io import wav as twav  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.parallel import make_mesh  # noqa: E402
from f9tpu_torch.pipeline import logbook as tlogbook  # noqa: E402
from f9tpu_torch.pipeline import manifest as tmanifest  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402

@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite runs files in parallel processes, and an
    idle OpenMP pool spin-waits beside them (`tests/test_torch_stream.py`)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


# ------------------------------------------------ the robustness cases' twins

#: the other modules a case drives, by package, and the keywords that put a
#: direct stream or the CLI on the CPU
MODULES = {
    "jax": types.SimpleNamespace(stream=jstream, manifest=jmanifest, wav=jwav, codec=jcodec,
                                 chain=jchain, logbook=jlogbook, cli=jcli, stream_kw={},
                                 cli_args=[]),
    "torch": types.SimpleNamespace(stream=tstream, manifest=tmanifest, wav=twav, codec=tcodec,
                                   chain=tchain, logbook=tlogbook, cli=tcli,
                                   stream_kw={"device": "cpu"}, cli_args=["--device", "cpu"]),
}
PKGS = pytest.mark.parametrize("pkg", sorted(PACKAGES))


def _mk(d, name, frames, rate=44100, channels=2, seed=0, amp=0.25):
    """A 24-bit WAV of white noise (the JAX tests' ``_mk``)."""
    rng = np.random.default_rng(seed)
    x = (amp * rng.standard_normal((channels, frames))).astype(np.float32)
    p = str(d / name)
    write_wav(p, x, rate, bits=24)
    return p


def _processor(pkg, log=None, **cfg):
    """``pkg``'s `BatchProcessor` for the config keywords, on the CPU."""
    sched, conf, extra = PACKAGES[pkg]
    kw = dict(extra, log=log) if log is not None else dict(extra)
    return sched.BatchProcessor(conf(**cfg), **kw)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _leftovers(out_dir) -> list[str]:
    return [n for n in os.listdir(out_dir) if n.endswith(".part") or ".tmp-" in n]


@PKGS
def test_oversized_file_streams(tmp_path, pkg):
    """A file beyond the largest bucket takes the streaming path (the
    ``streamed`` flag), with the bytes of a direct stream of the same config."""
    m = MODULES[pkg]
    big = _mk(tmp_path, "long.wav", 90_000, seed=1)
    small = _mk(tmp_path, "short.wav", 10_000, seed=2)
    cfg = dict(target_rate=48000, quality="low", seed=5, bucket_frames=(16_384, 32_768),
               batch_size=4)
    bp = _processor(pkg, output_dir=str(tmp_path / "out"), **cfg)
    res = bp.run([big, small])
    assert res.completed == 2 and res.failed == 0
    assert res.per_file[big].get("streamed") is True
    assert "streamed" not in res.per_file[small]
    assert "Completed (streamed): long_processed.wav" in bp.log.text()
    ref = str(tmp_path / "direct.wav")
    m.stream.stream_resample_file(big, ref, PACKAGES[pkg][1](output_dir=str(tmp_path), **cfg),
                                  **m.stream_kw)
    assert _read(str(tmp_path / "out" / "long_processed.wav")) == _read(ref)
    assert _leftovers(tmp_path / "out") == []


@PKGS
def test_oversized_ineligible_gets_reduced_batch(tmp_path, pkg):
    """Reverb mode cannot stream: the oversized file takes an exact-fit
    bucket at a reduced batch width, and the log says so."""
    big = _mk(tmp_path, "long2.wav", 80_000, seed=3)
    log = MODULES[pkg].logbook.StatusLog()
    res = _processor(pkg, log=log, output_dir=str(tmp_path / "out"), target_rate=48000,
                     quality="low", seed=5, bucket_frames=(16_384,), batch_size=8,
                     reverb_mode=True, noise_floor_db=-90.0).run([big])
    assert res.completed == 1 and res.failed == 0
    assert "batch width reduced" in "\n".join(log.lines)
    _, rate = MODULES[pkg].wav.read_wav(str(tmp_path / "out" / "long2_processed.wav"))
    assert rate == 48000 and "streamed" not in res.per_file[big]


@PKGS
def test_oversized_with_latency_still_streams(tmp_path, pkg):
    big = _mk(tmp_path, "long3.wav", 80_000, seed=4)
    res = _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000, quality="low",
                     seed=5, bucket_frames=(16_384,), batch_size=4,
                     latency_frames=64).run([big])
    assert res.completed == 1 and res.per_file[big].get("streamed") is True


@PKGS
def test_multiple_buckets_one_run(tmp_path, pkg):
    """Two rates, two channel counts and two buckets through one stage set."""
    files = [_mk(tmp_path, "a.wav", 5_000, seed=10),
             _mk(tmp_path, "b.wav", 30_000, seed=11),
             _mk(tmp_path, "c.wav", 5_000, rate=48000, seed=12),
             _mk(tmp_path, "d.wav", 30_000, rate=48000, channels=1, seed=13)]
    out = tmp_path / "out"
    res = _processor(pkg, output_dir=str(out), target_rate=44100, quality="low", seed=1,
                     bucket_frames=(8_192, 65_536), batch_size=2).run(files)
    assert res.completed == 4 and res.failed == 0
    assert sorted(os.listdir(out)) == [f"{s}_processed.wav" for s in "abcd"]


@PKGS
def test_slow_decode_does_not_block_other_files(tmp_path, monkeypatch, pkg):
    """Decode workers drain one shared queue: every other file starts
    decoding before a slow file's decode ends."""
    m = MODULES[pkg]
    rng = np.random.default_rng(5)
    paths = []
    for i in range(4):                      # float WAVs: the host decode path
        p = str(tmp_path / f"q{i}.wav")
        write_wav(p, (0.2 * rng.standard_normal((2, 4000))).astype(np.float32), 44100,
                  bits=32)
        paths.append(p)
    slow = paths[0]
    starts: dict[str, float] = {}
    slow_done = [None]
    lock = threading.Lock()
    real = m.codec.read_audio

    def spy(path, *a, **k):
        with lock:
            starts.setdefault(path, _time.time())
        if path == slow:
            _time.sleep(1.0)
            out = real(path, *a, **k)
            slow_done[0] = _time.time()
            return out
        return real(path, *a, **k)

    monkeypatch.setattr(m.codec, "read_audio", spy)
    sched = PACKAGES[pkg][0]
    monkeypatch.setattr(sched.codec, "read_audio", spy)
    bp = _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000, quality="low",
                    dither=False)
    bp.decode_workers = 2
    assert bp.run(paths).completed == 4
    assert slow_done[0] is not None
    late = [p for p in paths[1:] if starts[p] >= slow_done[0]]
    assert not late, f"{late} waited for the slow decode"


@PKGS
def test_dead_encoder_fails_files_without_hanging(tmp_path, monkeypatch, pkg):
    """A writer that raises fails its files (manifest status and error) and
    the run ends."""
    m = MODULES[pkg]
    files = [_mk(tmp_path, f"f{i}.wav", 4_000, seed=i) for i in range(6)]

    def boom(*a, **k):
        raise struct.error("'I' format requires 0 <= number <= 4294967295")

    monkeypatch.setattr(m.wav, "write_wav_codes", boom)
    monkeypatch.setattr(m.wav, "write_wav_payload", boom)
    mpath = str(tmp_path / "m.json")
    bp = _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000, quality="low",
                    seed=1, batch_size=2)
    res = bp.run(files, manifest_path=mpath)
    assert res.completed == 0 and res.failed == 6
    with open(mpath) as f:
        saved = json.load(f)
    assert [r["status"] for r in saved["files"]] == ["failed"] * 6
    assert all("4294967295" in r["error"] for r in saved["files"])
    assert bp.log.text().count("Encode failed:") == 6
    assert os.listdir(tmp_path / "out") == []


@PKGS
def test_corrupted_output_reprocesses_on_resume(tmp_path, pkg):
    """A payload byte flipped at the same size fails the content hash: the
    file is pending again and the seeded rerun gives the same bytes."""
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "r.wav", 9_000, seed=7)
    cfg = dict(output_dir=str(tmp_path / "out"), target_rate=48000, quality="low", seed=9)
    mpath = str(tmp_path / "manifest.json")
    assert _processor(pkg, **cfg).run([src], manifest_path=mpath).completed == 1
    out = str(tmp_path / "out" / "r_processed.wav")
    good = _read(out)
    with open(mpath) as f:
        assert json.load(f)["files"][0]["output_crc32"] == man.file_crc32(out)
    bad = bytearray(good)
    bad[len(bad) // 2] ^= 0xFF
    with open(out, "wb") as f:
        f.write(bytes(bad))
    m = man.JobManifest.load_or_create([src], mpath)
    assert m.get(src).status == man.FileStatus.PENDING
    m.close()
    res = _processor(pkg, **cfg).run([src], manifest_path=mpath)
    assert res.completed == 1 and res.skipped == 0
    assert _read(out) == good


@PKGS
def test_intact_output_skips_on_resume(tmp_path, pkg):
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "s.wav", 9_000, seed=8)
    mpath = str(tmp_path / "manifest.json")
    assert _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000,
                      quality="low", seed=9).run([src], manifest_path=mpath).completed == 1
    m = man.JobManifest.load_or_create([src], mpath)
    assert m.get(src).status == man.FileStatus.COMPLETED
    m.close()


@PKGS
def test_old_manifest_without_hash_still_loads(tmp_path, pkg):
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "t.wav", 4_000, seed=9)
    out = _mk(tmp_path, "t_old_out.wav", 4_000, seed=9)
    mpath = str(tmp_path / "old.json")
    with open(mpath, "w") as f:
        json.dump({"files": [{"path": src, "status": "completed", "output_path": out,
                              "output_size": os.path.getsize(out)}]}, f)
    m = man.JobManifest.load_or_create([src], mpath)
    assert m.get(src).status == man.FileStatus.COMPLETED
    m.close()


@PKGS
def test_cli_verify_audits_outputs(tmp_path, capsys, pkg):
    """`cli verify`: all ok, then a flipped byte (crc_mismatch, exit 1), then
    a deleted output (missing, exit 1)."""
    m = MODULES[pkg]
    src = _mk(tmp_path, "v.wav", 8_000, seed=20)
    out_dir = str(tmp_path / "out")
    assert m.cli.main(["process", src, "--out", out_dir, "--rate", "48000", "--quality",
                       "low", "--seed", "3", "--resume", *m.cli_args]) == 0
    mpath = os.path.join(out_dir, ".manifest.json")
    capsys.readouterr()
    assert m.cli.main(["verify", mpath]) == 0
    assert "1 ok, 0 corrupt" in capsys.readouterr().out
    out = os.path.join(out_dir, "v_processed.wav")
    raw = bytearray(_read(out))
    raw[len(raw) // 2] ^= 0x55
    with open(out, "wb") as f:
        f.write(bytes(raw))
    assert m.cli.main(["verify", mpath, "--json"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert got["counts"]["corrupt"] == 1 and got["files"][0]["status"] == "crc_mismatch"
    os.unlink(out)
    assert m.cli.main(["verify", mpath]) == 1
    assert "1 missing" in capsys.readouterr().out


@PKGS
def test_mixed_buckets_with_random_decode_failures(tmp_path, monkeypatch, pkg):
    """40 files over two rates, two channel counts and three buckets, every
    seventh decode failing: the counts reconcile, each manifest row has its
    status, and every completed output passes its own content hash."""
    m = MODULES[pkg]
    rng = np.random.default_rng(42)
    files = [_mk(tmp_path, f"c{i}.wav", int(rng.integers(1_000, 20_000)),
                 rate=[44100, 48000][i % 2], channels=[1, 2][(i // 2) % 2], seed=i)
             for i in range(40)]
    fail_set = {f for i, f in enumerate(files) if i % 7 == 3}
    real_read, real_raw = m.codec.read_audio, m.codec.read_raw_pcm

    def flaky(real):
        def fn(path):
            if path in fail_set:
                raise RuntimeError(f"injected decode failure: {path}")
            return real(path)
        return fn

    monkeypatch.setattr(m.codec, "read_audio", flaky(real_read))
    monkeypatch.setattr(m.codec, "read_raw_pcm", flaky(real_raw))
    mpath = str(tmp_path / "m.json")
    bp = _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000, quality="low",
                    seed=5, bucket_frames=(4_096, 16_384, 32_768), batch_size=4)
    bp.decode_workers = bp.encode_workers = 3
    res = bp.run(files, manifest_path=mpath)
    assert res.completed == len(files) - len(fail_set) and res.failed == len(fail_set)
    with open(mpath) as f:
        saved = json.load(f)
    statuses = {row["path"]: row["status"] for row in saved["files"]}
    assert statuses == {f: "failed" if f in fail_set else "completed" for f in files}
    for row in saved["files"]:
        if row["status"] == "completed":
            assert os.path.getsize(row["output_path"]) == row["output_size"]
            assert m.manifest.file_crc32(row["output_path"]) == row["output_crc32"]
        else:
            assert "injected decode failure" in row["error"]
    assert bp.log.text().count("Decode failed:") == len(fail_set)
    assert _leftovers(tmp_path / "out") == []


@PKGS
def test_untouched_output_skips_crc_read(tmp_path, monkeypatch, pkg):
    """Resume re-hashes an output only when its size or mtime changed."""
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "w.wav", 5_000, seed=30)
    mpath = str(tmp_path / "m.json")
    assert _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000,
                      quality="low", seed=9).run([src], manifest_path=mpath).completed == 1
    calls = {"n": 0}
    real = man.file_crc32

    def counting(path, *a, **k):
        calls["n"] += 1
        return real(path, *a, **k)

    monkeypatch.setattr(man, "file_crc32", counting)
    m = man.JobManifest.load_or_create([src], mpath)
    assert m.get(src).status == man.FileStatus.COMPLETED and calls["n"] == 0
    m.close()
    os.utime(str(tmp_path / "out" / "w_processed.wav"), ns=(1, 1))
    m2 = man.JobManifest.load_or_create([src], mpath)
    assert calls["n"] == 1 and m2.get(src).status == man.FileStatus.COMPLETED
    m2.close()


@PKGS
def test_suffixed_names_respect_earlier_reservations(tmp_path, pkg):
    """Three same-stem inputs over three runs sharing a manifest get three
    deliverables; no later suffix overwrites an earlier one."""
    outs = str(tmp_path / "out")
    mpath = str(tmp_path / "m.json")
    paths = []
    for i in range(3):
        d = tmp_path / f"in{i}"
        d.mkdir()
        paths.append(_mk(d, "f.wav", 3000 + 100 * i, seed=40 + i))
    logs = []
    for p in paths:
        bp = _processor(pkg, output_dir=outs, target_rate=48000, quality="low", seed=3)
        assert bp.run([p], manifest_path=mpath).completed == 1
        logs.append(bp.log.text())
    names = sorted(o for o in os.listdir(outs) if o.endswith(".wav"))
    assert names == ["f_processed.wav", "f_processed_2.wav", "f_processed_3.wav"], names
    assert "Output name collision: f.wav -> f_processed_3.wav" in logs[2]
    lens = {MODULES[pkg].wav.read_wav(os.path.join(outs, n))[0].shape[-1] for n in names}
    assert len(lens) == 3


@PKGS
def test_reprocessed_file_keeps_its_name(tmp_path, pkg):
    outs = str(tmp_path / "out")
    mpath = str(tmp_path / "m.json")
    cfg = dict(output_dir=outs, target_rate=48000, quality="low", seed=4)
    p = _mk(tmp_path, "g.wav", 3000, seed=50)
    assert _processor(pkg, **cfg).run([p], manifest_path=mpath).completed == 1
    _mk(tmp_path, "g.wav", 4000, seed=51)          # replaced content
    res = _processor(pkg, **cfg).run([p], manifest_path=mpath)
    assert res.completed == 1 and res.skipped == 0
    names = sorted(o for o in os.listdir(outs) if o.endswith(".wav"))
    assert names == ["g_processed.wav"], names
    y, _ = MODULES[pkg].wav.read_wav(os.path.join(outs, names[0]))
    assert y.shape[-1] == round(4000 * 48000 / 44100)


@PKGS
def test_oversized_long_ring_chain_streams(tmp_path, pkg):
    """A chain whose ring-out outgrows the streaming chunk: the chunk grows
    and the file streams; its wall is booked to the "stream" stage."""
    chain = MODULES[pkg].chain
    big = _mk(tmp_path, "ring.wav", 80_000, seed=6)
    res = _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000, quality="low",
                     seed=5, bucket_frames=(16_384,), batch_size=4,
                     chain=chain.Chain(chain.Delay(21.0)), latency_frames=0).run([big])
    assert res.completed == 1 and res.failed == 0
    assert res.per_file[big].get("streamed") is True and "stream" in res.throughput


@PKGS
def test_encode_failure_leaves_no_partial_file(tmp_path, monkeypatch, pkg):
    """A writer that dies mid-file leaves neither a deliverable nor a .part."""
    m = MODULES[pkg]
    src = _mk(tmp_path, "p.wav", 4_000, seed=1)

    def half_then_boom(path, *a, **k):
        with open(path, "wb") as f:
            f.write(b"RIFF\x00\x00\x00\x00WAVEjunk")
        raise struct.error("mid-write failure")

    monkeypatch.setattr(m.wav, "write_wav_codes", half_then_boom)
    monkeypatch.setattr(m.wav, "write_wav_payload", half_then_boom)
    out = tmp_path / "out"
    bp = _processor(pkg, output_dir=str(out), target_rate=48000, quality="low", seed=1)
    res = bp.run([src])
    assert res.failed == 1 and res.completed == 0
    assert "Encode failed:" in bp.log.text() and "mid-write failure" in bp.log.text()
    assert [n for n in os.listdir(out) if not n.startswith(".")] == []


@PKGS
def test_stream_success_leaves_no_part(tmp_path, pkg):
    m = MODULES[pkg]
    src = _mk(tmp_path, "s.wav", 20_000, seed=2)
    cfg = PACKAGES[pkg][1](output_dir=str(tmp_path), target_rate=48000, quality="low", seed=2)
    out = str(tmp_path / "s48.wav")
    n = m.stream.stream_resample_file(src, out, cfg, chunk_seconds=0.2, **m.stream_kw)
    assert n == -(-20_000 * 160 // 147) and os.path.exists(out)
    assert not os.path.exists(out + ".part")


@PKGS
def test_stale_tmp_staging_cleaned_on_init(tmp_path, pkg):
    """Staging files of dead processes are swept; a live pid's are kept."""
    man = MODULES[pkg].manifest
    mpath = str(tmp_path / "m.json")
    dead = mpath + ".tmp-999999-deadbeef"
    mine = mpath + f".tmp-{os.getpid()}-cafe"
    for p in (dead, mine):
        with open(p, "w") as f:
            f.write("{}")
    man.JobManifest.load_or_create([], mpath).close()
    assert not os.path.exists(dead) and os.path.exists(mine)


@PKGS
def test_stale_deferred_timer_does_not_overwrite_newer_save(tmp_path, pkg):
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "g.wav", 1_000, seed=9)
    mpath = str(tmp_path / "mg.json")
    m = man.JobManifest.load_or_create([src], mpath)
    m.save()                                   # the throttle window opens
    m.update(src, man.FileStatus.PROCESSING)   # throttled: arms a timer
    assert m._timer is not None
    m.update(src, man.FileStatus.COMPLETED)
    m.save()                                   # a real save: the generation advances
    gen = m._save_gen
    m._deferred_save(gen - 1)                  # the stale timer's callback
    assert m._save_gen == gen
    assert man.JobManifest.load(mpath).get(src).status == man.FileStatus.COMPLETED
    m.close()


@PKGS
def test_corrupt_manifest_recovers(tmp_path, pkg):
    """A garbage manifest is kept as ``.corrupt`` and a fresh one starts."""
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "c.wav", 4_000, seed=3)
    mpath = str(tmp_path / "m.json")
    with open(mpath, "w") as f:
        f.write('{"files": [{"status": "not-a-')
    m = man.JobManifest.load_or_create([src], mpath)
    assert m.get(src).status == man.FileStatus.PENDING
    m.close()
    assert os.path.exists(mpath + ".corrupt")
    assert _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000,
                      quality="low", seed=3).run([src], manifest_path=mpath).completed == 1
    with open(mpath) as f:
        assert [r["status"] for r in json.load(f)["files"]] == ["completed"]
    assert _leftovers(tmp_path) == []


@PKGS
def test_missing_input_keeps_completed_record(tmp_path, pkg):
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "d.wav", 4_000, seed=4)
    mpath = str(tmp_path / "m.json")
    assert _processor(pkg, output_dir=str(tmp_path / "out"), target_rate=48000,
                      quality="low", seed=4).run([src], manifest_path=mpath).completed == 1
    os.unlink(src)
    m = man.JobManifest.load_or_create([src], mpath)
    assert m.get(src).status == man.FileStatus.COMPLETED
    m.close()


@PKGS
def test_throttled_updates_flush_without_final_save(tmp_path, pkg):
    """An update inside the save interval is written by the deferred timer."""
    man = MODULES[pkg].manifest
    src = _mk(tmp_path, "e.wav", 1_000, seed=5)
    mpath = str(tmp_path / "m.json")
    m = man.JobManifest.from_files([src], mpath)
    m._save_interval = 0.2
    m.update(src, man.FileStatus.PROCESSING)          # written at once
    m.update(src, man.FileStatus.FAILED, error="late")  # throttled
    with open(mpath) as f:
        assert json.load(f)["files"][0]["status"] == "processing"
    _time.sleep(0.5)                                  # the timer fires
    with open(mpath) as f:
        row = json.load(f)["files"][0]
    assert row["status"] == "failed" and row["error"] == "late"
    m.close()


@PKGS
def test_resume_skips_reported_separately(tmp_path, pkg):
    src = _mk(tmp_path, "k.wav", 4_000, seed=6)
    cfg = dict(output_dir=str(tmp_path / "out"), target_rate=48000, quality="low", seed=6)
    mpath = str(tmp_path / "m.json")
    r1 = _processor(pkg, **cfg).run([src], manifest_path=mpath)
    assert r1.completed == 1 and r1.skipped == 0 and not r1.aborted
    bp = _processor(pkg, **cfg)
    r2 = bp.run([src], manifest_path=mpath)
    assert r2.completed == 1 and r2.skipped == 1
    assert "Skip (already completed)" in bp.log.text()


@PKGS
def test_forced_save_cancels_pending_timer(tmp_path, pkg):
    man = MODULES[pkg].manifest
    m = man.JobManifest.from_files(["a", "b"], str(tmp_path / "m.json"))
    m.update("a", man.FileStatus.PROCESSING)      # written at once
    m.update("b", man.FileStatus.PROCESSING)      # throttled: a timer is armed
    t = m._timer
    assert t is not None
    m.save()                                      # the batch-end forced save
    assert m._timer is None
    assert not t.is_alive() or t.finished.is_set()


@PKGS
def test_two_manifests_same_path_interleave(tmp_path, pkg):
    """Two instances on one path: neither removes the other's staging file."""
    man = MODULES[pkg].manifest
    p = str(tmp_path / "m.json")
    m1 = man.JobManifest.from_files(["a"], p)
    m2 = man.JobManifest.from_files(["a"], p)
    for _ in range(50):
        m1.update("a", man.FileStatus.PROCESSING)
        m2.update("a", man.FileStatus.COMPLETED)
        m1.save()
        m2.save()
    assert man.JobManifest.load(p).get("a").status == man.FileStatus.COMPLETED
    m1.close()
    m2.close()
    assert _leftovers(tmp_path) == []
