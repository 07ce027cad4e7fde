"""The port's batch jobs end to end, against the JAX package's.

Both `BatchProcessor`s (or both CLIs) run on the CPU over the same small
WAVs with the same seed; the outputs must have identical headers and frame
counts, samples within 2 LSB, and the same manifest statuses.  That holds
for the default job and for the insert-loop job (reverb mode, channel
routing and an insert chain of delay, EQ, compressor, convolution reverb
and limiter).  Also: the port never imports jax, refuses CUDA without a
GPU, and switches TF32 off."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu import cli as jcli  # noqa: E402
from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.io import wav  # noqa: E402
from f9tpu.pipeline import calibration as jcal  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu_torch import cli, resolve_device  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
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
    for name, mod, conf, extra in (("jax", jsched, ProcessingConfig, {}),
                                   ("torch", tsched, TConfig, {"device": "cpu"})):
        out = str(tmp_path / f"out_{name}")
        cfg = conf(output_dir=out, target_rate=48000, seed=5)
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
    # preview renders (it was "not yet ported"): the playlist of the three
    # inputs, mixed rates and channel counts, onto a stereo bus
    pv = str(tmp_path / "preview.wav")
    assert cli.main(["preview", *src, "--out", pv, "--rate", "48000", "--device", "cpu"]) == 0
    assert "rendered 3 item(s)" in capsys.readouterr().out
    y, rate = wav.read_wav(pv)
    assert rate == 48000 and y.shape[0] == 2 and np.abs(y).max() > 0.1


def test_oversized_file_fails_alone(tmp_path):
    """The file past the largest bucket (s24.wav: 9000 frames > 2^13) no
    longer fails: both schedulers stream it, after the batches, and mark it
    ``streamed``.  Same frame counts and statuses; codes <= 2 LSB at 24 bits
    (the JAX stream's float32 convolution against the port's float64 fold;
    measured 2 on this -9 dBFS input).  Undithered: the JAX stream's float
    error reaches 2 LSB here, so under dither keyed by the temporary path
    the codes differed by 2 or 3 from run to run."""
    src = _write_inputs(str(tmp_path))
    runs = {}
    for name, mod, conf, extra in (("jax", jsched, ProcessingConfig, {}),
                                   ("torch", tsched, TConfig, {"device": "cpu"})):
        out = str(tmp_path / f"out_{name}")
        cfg = conf(output_dir=out, target_rate=48000, dither=False,
                   bucket_frames=(1 << 13,))
        res = mod.BatchProcessor(cfg, **extra).run(src)
        assert res.completed == 3 and res.failed == 0, (name, res)
        assert res.per_file[src[0]]["streamed"] is True
        assert "stream" in res.throughput
        runs[name] = (out, res)
    for p in src:
        assert (runs["torch"][1].per_file[p]["out_frames"]
                == runs["jax"][1].per_file[p]["out_frames"])
        stem = os.path.splitext(os.path.basename(p))[0]
        jh, jc, _ = _header_and_codes(os.path.join(runs["jax"][0], f"{stem}_processed.wav"))
        th, tc, _ = _header_and_codes(os.path.join(runs["torch"][0], f"{stem}_processed.wav"))
        assert th == jh and tc.shape == jc.shape
        assert np.abs(tc - jc).max() <= 2, (stem, np.abs(tc - jc).max())


@pytest.mark.parametrize("kw", [
    {"mesh": 2}, {"normalize_lufs": -14.0}, {"device_layout": "rows"},
    {"native_loader": True}])
def test_unported_options_are_refused(tmp_path, kw):
    """The rows layout and the native loader are refused when the processor
    is built; loudness normalization and a mesh were, and now build (a mesh
    of 2 CPU shards; the processor's device is then the mesh's first)."""
    kw = dict(kw)
    shards = kw.pop("mesh", None)
    cfg = TConfig(output_dir=str(tmp_path), **kw)
    if "normalize_lufs" in kw:
        assert tsched.BatchProcessor(cfg, device="cpu").cfg.normalize_lufs == -14.0
        return
    if shards:
        from f9tpu_torch.parallel import make_mesh

        mesh = make_mesh(shards, devices=["cpu"] * shards)
        bp = tsched.BatchProcessor(cfg, mesh=mesh)
        assert bp.mesh is mesh and bp.device.type == "cpu"
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        tsched.BatchProcessor(cfg, device="cpu")


def _write_irs(d) -> tuple[str, str]:
    """A mono and a stereo 0.2 s IR of decaying noise, float32 at 48 kHz,
    at a wet gain of about 0.75 (energy 0.56)."""
    rng = np.random.default_rng(8)
    env = np.exp(-np.arange(9600) / 700.0)
    paths = []
    for name, ch in (("ir_mono.wav", 1), ("ir_stereo.wav", 2)):
        ir = (0.04 * rng.standard_normal((ch, 9600)) * env).astype(np.float32)
        paths.append(os.path.join(d, name))
        wav.write_wav(paths[-1], ir, 48000, bits=32)
    return paths[0], paths[1]


INSERT_LOOP_FLAGS = ["--rate", "48000", "--reverb", "--chain-delay-ms", "5",
                     "--chain-eq", "peaking:1000:1:3", "--chain-comp=-18:3:1:400",
                     "--chain-limit=-0.3", "--seed", "9", "--json"]


@pytest.mark.parametrize("ir,routing", [("mono", "1,0,-1"), ("stereo", "1,0")])
def test_insert_loop_cli_matches_jax(tmp_path, capsys, ir, routing):
    """`cli process --reverb --routing ... --chain-*` on both packages:
    identical headers, frame counts and manifest statuses, codes <= 2 LSB at
    24 bits (measured: 2), every tail terminated past its source, silent
    channels digital zero.

    On the CPU the port's FFT is MKL's and JAX's is pocketfft; they round
    apart at about -137 dB RMS, which the convolution's gain carries to the
    output: with this IR at twice the level the reverb alone differed by up
    to 3 LSB (peak 0.7) and the codes by 4."""
    src = _write_inputs(str(tmp_path))
    ir_path = _write_irs(str(tmp_path))[0 if ir == "mono" else 1]
    flags = INSERT_LOOP_FLAGS + ["--routing", routing, "--chain-ir", ir_path]
    out = {}
    for name, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"out_{name}")
        rc = mod.main(["process", *src, "--out", out[name], *flags, *extra])
        summary = json.loads(capsys.readouterr().out)
        # m16.wav is mono: a 2-channel routing map fails it alone, per file
        assert rc == 1 and summary["completed"] == 2 and summary["failed"] == 1, summary
        out[name] = (out[name], summary["per_file"])
    assert out["torch"][1].keys() == out["jax"][1].keys()
    for p, metrics in out["torch"][1].items():
        assert metrics["out_frames"] == out["jax"][1][p]["out_frames"]
        assert metrics["tail_terminated"] is True
        n_in = wav.read_wav(p)[0].shape[-1]
        assert metrics["out_frames"] > -(-n_in * 160 // 147)
        stem = os.path.splitext(os.path.basename(p))[0]
        jh, jc, _ = _header_and_codes(os.path.join(out["jax"][0], f"{stem}_processed.wav"))
        th, tc, _ = _header_and_codes(os.path.join(out["torch"][0], f"{stem}_processed.wav"))
        assert th == jh and tc.shape == jc.shape == (len(routing.split(",")),
                                                      metrics["out_frames"])
        assert np.abs(tc - jc).max() <= 2          # 24-bit codes
        if routing.endswith("-1"):
            assert not tc[-1].any()


def test_insert_loop_usage_errors(tmp_path, capsys):
    src = _write_inputs(str(tmp_path))[:1]
    out = str(tmp_path / "o")
    for bad in (["--routing", "1,x"], ["--chain-comp=-18"], ["--chain-eq", "peaking"],
                ["--chain-limit=-0.3:1:2:3"], ["--chain-sat", "tanh"],
                ["--chain-gate=-40"], ["--chain-ir", str(tmp_path / "none.wav")],
                ["--chain-width", "9"], ["--chain-delay-ms", "-1"],
                ["--chain-eq", "notch:100"]):
        with pytest.raises(SystemExit):
            cli.main(["process", *src, "--out", out, "--device", "cpu", *bad])
    capsys.readouterr()


def test_reverb_cap_and_routing_bound_match_jax(tmp_path):
    """Per-file routing failures and the reverb capture cap, both schedulers."""
    src = _write_inputs(str(tmp_path))
    runs = {}
    for name, mod, conf, extra in (("jax", jsched, ProcessingConfig, {}),
                                   ("torch", tsched, TConfig, {"device": "cpu"})):
        cfg = conf(output_dir=str(tmp_path / name), target_rate=48000,
                   reverb_mode=True, max_tail_seconds=0.15,
                   channel_routing=[1, 0], seed=2)
        res = mod.BatchProcessor(cfg, **extra).run(src)
        assert res.completed == 2 and res.failed == 1
        runs[name] = res.per_file
    assert runs["torch"].keys() == runs["jax"].keys()
    for p, m in runs["torch"].items():
        assert m["out_frames"] == runs["jax"][p]["out_frames"]
        # source and head-room are each capped at 0.15 s, too short for the
        # 200 ms detection run: the whole capped capture is kept
        assert m["out_frames"] == -(-2 * int(0.15 * 44100) * 160 // 147)
        assert m["tail_terminated"] is False


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
    the port's whole job in a fresh interpreter; neither jax nor any module
    of the JAX package may load."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
import numpy as np
from f9tpu_torch.io import wav
import f9tpu_torch, f9tpu_torch.cli, f9tpu_torch.pipeline
from f9tpu_torch.ops import (analysis, chain, devcodec, dither, resample, routing,
                             signal, src_kernel, trim, _build)
wav.write_wav({str(tmp_path / "a.wav")!r}, np.zeros((2, 3000), np.float32) + 0.1, 44100, bits=24)
rc = f9tpu_torch.cli.main(["process", {str(tmp_path / "a.wav")!r}, "--out",
                           {str(tmp_path / "o")!r}, "--device", "cpu"])
assert rc == 0, rc
ir = np.exp(-np.arange(2000) / 300.0)[None].astype(np.float32) * 0.5
wav.write_wav({str(tmp_path / "ir.wav")!r}, ir, 48000, bits=32)
rc = f9tpu_torch.cli.main(["process", {str(tmp_path / "a.wav")!r}, "--out",
                           {str(tmp_path / "o2")!r}, "--device", "cpu", "--reverb",
                           "--routing", "1,0,-1", "--chain-delay-ms", "5",
                           "--chain-eq", "peaking:1000:1:3", "--chain-comp=-18:3",
                           "--chain-ir", {str(tmp_path / "ir.wav")!r},
                           "--chain-limit=-0.3"])
assert rc == 0, rc
bad = sorted(m for m in sys.modules
             if m in ("jax", "f9tpu") or m.startswith(("jax.", "jaxlib", "f9tpu.")))
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
        tsched.BatchProcessor(TConfig(output_dir="/tmp/x"))


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


def test_insert_loop_bytes_do_not_follow_the_batch_width(tmp_path):
    """One file's bytes through the insert loop (a K = 7 stereo reverb IR,
    EQ, compressor, limiter, calibration through the chain) are the same in
    a 2-file and in an 8-file batch on the CPU: the UPOLS delay-line sum
    and products no longer depend on the row count.  Float32 output, where
    an ulp shows (at 24 bits few of these samples sit near a code's edge)."""
    rng = np.random.default_rng(31)
    src = []
    for i in range(8):
        t = np.arange(int(0.4 * 44100) + 101 * i) / 44100
        x = (0.1 * np.sin(2 * np.pi * (300 + 40 * i) * t)
             + 0.02 * rng.standard_normal((2, t.size))).astype(np.float32)
        src.append(os.path.join(tmp_path, f"take{i}.wav"))
        wav.write_wav(src[-1], x, 44100, bits=24)
    n_ir = 7 * 4096 - 1000
    ir = (rng.standard_normal((2, n_ir)) * np.exp(-np.arange(n_ir) / 4000.0) * 0.05)
    ir[:, 0] = 0.5
    ir_path = os.path.join(tmp_path, "ir.wav")
    wav.write_wav(ir_path, ir.astype(np.float32), 48000, bits=32)
    flags = ["--device", "cpu", "--rate", "48000", "--chain-eq", "peaking:1000:1:3",
             "--chain-comp=-18:3", "--chain-ir", ir_path, "--chain-limit=-0.3", "--bits", "32"]
    for n, bs in ((8, "8"), (2, "2")):
        assert cli.main(["process", *src[:n], "--out", str(tmp_path / f"out{n}"),
                         "--batch-size", bs, *flags]) == 0
    for i in range(2):
        a = (tmp_path / "out8" / f"take{i}_processed.wav").read_bytes()
        b = (tmp_path / "out2" / f"take{i}_processed.wav").read_bytes()
        assert a == b, i
