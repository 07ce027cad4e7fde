"""The port's default batch job end to end, against the JAX package's.

Both `BatchProcessor`s run on the CPU over the same small WAVs with the
same seed; the outputs must have identical headers and frame counts,
samples within 2 LSB, and the same manifest statuses.  Also: the port
never imports jax, refuses CUDA without a GPU, and switches TF32 off."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.io import wav  # noqa: E402
from f9tpu.pipeline import calibration as jcal  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu_torch import cli, resolve_device  # noqa: E402
from f9tpu_torch.pipeline import calibration as tcal  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_inputs(d) -> list[str]:
    rng = np.random.default_rng(21)

    def sig(ch, n):
        t = np.arange(n) / 44100
        return (0.3 * np.sin(2 * np.pi * 523.0 * t)
                + 0.05 * rng.standard_normal((ch, n)) + 0.02).astype(np.float32)

    paths = [os.path.join(d, n) for n in ("s24.wav", "m16.wav", "f32.wav")]
    wav.write_wav(paths[0], sig(2, 9000), 44100, bits=24)
    wav.write_wav(paths[1], sig(1, 7001), 44100, bits=16)
    wav.write_wav(paths[2], sig(2, 5003), 44100, bits=32)      # float32 WAV
    return paths


def _header_and_codes(path):
    with open(path, "rb") as f:
        blob = f.read()
    head = blob[: blob.index(b"data") + 8]
    x, rate = wav.read_wav(path)
    return head, np.round(np.asarray(x, np.float64) * (1 << 23)).astype(np.int64), rate


def test_batch_job_matches_jax(tmp_path):
    src = _write_inputs(str(tmp_path))
    runs = {}
    for name, mod, extra in (("jax", jsched, {}), ("torch", tsched, {"device": "cpu"})):
        out = str(tmp_path / f"out_{name}")
        cfg = ProcessingConfig(output_dir=out, target_rate=48000, seed=5)
        bp = mod.BatchProcessor(cfg, **extra)
        res = bp.run(src, manifest_path=os.path.join(out, ".manifest.json"))
        assert res.completed == 3 and res.failed == 0, (name, res)
        with open(os.path.join(out, ".manifest.json")) as f:
            statuses = {e["path"]: e["status"] for e in json.load(f)["files"]}
        runs[name] = (out, res, statuses)
    assert runs["jax"][2] == runs["torch"][2]
    for p in src:
        stem = os.path.splitext(os.path.basename(p))[0]
        jh, jc, jr = _header_and_codes(os.path.join(runs["jax"][0], f"{stem}_processed.wav"))
        th, tc, tr = _header_and_codes(os.path.join(runs["torch"][0], f"{stem}_processed.wav"))
        assert th == jh and tr == jr == 48000 and tc.shape == jc.shape, stem
        diff = np.abs(tc - jc)
        assert diff.max() <= 2, (
            f"{stem}: {int((diff != 0).sum())} of {diff.size} samples differ, "
            f"max {diff.max()} LSB")
        assert (runs["torch"][1].per_file[p]["out_frames"]
                == runs["jax"][1].per_file[p]["out_frames"])


def test_cli_process_on_cpu(tmp_path, capsys):
    src = _write_inputs(str(tmp_path))
    out = str(tmp_path / "out")
    rc = cli.main(["process", *src, "--out", out, "--device", "cpu", "--json",
                   "--bits", "16", "--resume"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["completed"] == 3 and summary["device"] == "cpu"
    # a resumed run skips the finished files
    rc = cli.main(["process", *src, "--out", out, "--device", "cpu", "--json",
                   "--bits", "16", "--resume"])
    assert rc == 0 and json.loads(capsys.readouterr().out)["skipped"] == 3
    assert cli.main(["stream", src[0], "--out", out]) == 2
    assert "not yet ported" in capsys.readouterr().err


def test_oversized_file_fails_alone(tmp_path):
    src = _write_inputs(str(tmp_path))
    cfg = ProcessingConfig(output_dir=str(tmp_path / "out"), target_rate=48000,
                           bucket_frames=(1 << 13,))
    res = tsched.BatchProcessor(cfg, device="cpu").run(src)
    assert res.completed == 2 and res.failed == 1       # s24.wav: 9000 frames


@pytest.mark.parametrize("kw", [
    {"mesh": object()}, {"normalize_lufs": -14.0}, {"device_layout": "rows"},
    {"native_loader": True}, {"reverb_mode": True}, {"channel_routing": [0, 1]}])
def test_unported_options_are_refused(tmp_path, kw):
    mesh = kw.pop("mesh", None)
    cfg = ProcessingConfig(output_dir=str(tmp_path), **kw)
    with pytest.raises(NotImplementedError, match="not ported"):
        tsched.BatchProcessor(cfg, mesh=mesh, device="cpu")


def test_calibration_matches_jax(tmp_path):
    want = jcal.measure_latency(44100, 48000)
    got = tcal.measure_latency(44100, 48000, device="cpu")
    assert got.latency_frames == want.latency_frames == 0
    assert abs(got.peak_amplitude - want.peak_amplitude) <= 1e-6
    assert abs(got.noise_floor_db - want.noise_floor_db) <= 1.0
    # the cache file is interchangeable between the packages
    path = str(tmp_path / "cal.json")
    tcal.CalibrationCache(path).get_or_measure(44100, 48000, device="cpu")
    k = jcal.CalibrationCache.key(44100, 48000, "high", "sinc")
    assert jcal.CalibrationCache(path)._data[k].latency_frames == 0


def test_port_never_imports_jax(tmp_path):
    """tests/conftest.py imports jax into this process, so the check runs
    the port's whole job in a fresh interpreter."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from f9tpu.io import wav
import f9tpu_torch, f9tpu_torch.cli, f9tpu_torch.pipeline
from f9tpu_torch.ops import analysis, devcodec, dither, resample, signal, src_kernel, trim, _build
wav.write_wav({str(tmp_path / "a.wav")!r}, np.zeros((2, 3000), np.float32) + 0.1, 44100, bits=24)
rc = f9tpu_torch.cli.main(["process", {str(tmp_path / "a.wav")!r}, "--out",
                           {str(tmp_path / "o")!r}, "--device", "cpu"])
assert rc == 0, rc
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
print("NO_JAX_OK")
"""
    env = dict(os.environ)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_resolve_device_refuses_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tsched.BatchProcessor(ProcessingConfig(output_dir="/tmp/x"))


def test_resolve_device_switches_tf32_off():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        assert resolve_device("cpu") == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
