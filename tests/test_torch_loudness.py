"""The port's BS.1770 / R128 meter and loudness normalization against the
JAX package's, on the CPU.

Tolerances, each with its reason:

- `k_weighting_ir`, `surround_weights`, the constants, `normalization_gain_db`
  (notes included): equal (host-side code copied).
- `integrated_lufs`, `loudness_range`, `block_loudness`, `true_peak_db`,
  `meter_source_streamed`: within 0.01 LU / 0.01 dB of JAX.  The port
  K-weights by FFT at every length and sums in float64 inside its SRC twins,
  JAX convolves directly below 2^16 frames and sums in float32; measured
  differences are below 1e-5.
- The normalized batch job and stream against the JAX package: equal frame
  counts, logged gains within 0.01 dB, codes <= 2 LSB at 24 bits (dither
  off, inputs near -20 dBFS before the gain).
- Within the port, a file's gain from the batch scheduler and from the
  stream's pre-pass: the same float.

The 4x true-peak oversampler runs as a float64 fold on the CPU (~2.5 s per
channel per 20 s meter chunk, whatever the file's length), so only a few
cases ask for the true peak.  Every test runs torch on one CPU thread, as
`tests/test_torch_stream.py` explains."""

import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu import cli as jcli  # noqa: E402
from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import wav  # noqa: E402
from f9tpu.pipeline import graph as jgraph  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu.pipeline import stream as jstream  # noqa: E402
from f9tpu_torch import cli  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io import codec as tcodec  # noqa: E402
from f9tpu_torch.ops import loudness as tl  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402

jl = importlib.import_module("f9tpu.ops.loudness")

TOL = 0.01


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _program(rate, seconds, ch, seed, level=0.1):
    """A tone under a slow swell plus noise: gated blocks, a non-zero LRA."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    env = 0.2 + np.sin(2 * np.pi * 0.13 * t) ** 2
    x = level * env * (np.sin(2 * np.pi * 440.0 * t)[None]
                       + 0.3 * rng.standard_normal((ch, t.size)))
    return x.astype(np.float32)


def test_constants_and_k_weighting_ir_are_the_jax_package_s():
    assert np.array_equal(tl.k_weighting_ir(), jl.k_weighting_ir())
    for name in ("K_STAGE1_B", "K_STAGE1_A", "K_STAGE2_B", "K_STAGE2_A", "_RATE", "_HOP",
                 "_I_BLOCK_HOPS", "_ST_BLOCK_HOPS", "_ST_STRIDE_HOPS", "_ABS_GATE_LUFS",
                 "_REL_GATE_LU", "_LRA_REL_GATE_LU", "_OFFSET", "_TP_CHUNK_THRESHOLD"):
        assert getattr(tl, name) == getattr(jl, name), name
    for ch in range(1, 10):
        assert tl.surround_weights(ch) == jl.surround_weights(ch)
    for rate in (48000, 44100, 96000):
        assert tl._meter_chunk_plan(rate, 20.0, 3546)[:2] == jl._meter_chunk_plan(
            rate, 20.0, 3546)[:2]


@pytest.mark.parametrize("rate,seconds,ch", [(48000, 4.0, 2), (44100, 9.0, 2), (48000, 35.0, 1),
                                             (96000, 3.3, 2)])
def test_statistics_match_jax(rate, seconds, ch):
    x = _program(rate, seconds, ch, seed=rate % 97)
    xj = jnp.asarray(x)
    assert abs(float(tl.integrated_lufs(x, rate, device="cpu"))
               - float(jl.integrated_lufs(xj, rate))) <= TOL
    assert abs(float(tl.loudness_range(x, rate, device="cpu"))
               - float(jl.loudness_range(xj, rate))) <= TOL
    lufs, lra = tl.r128_stats(x, rate, device="cpu")
    jlufs, jlra = jl.r128_stats(xj, rate)
    assert abs(lufs - jlufs) <= TOL and abs(lra - jlra) <= TOL
    assert lufs == float(tl.integrated_lufs(torch.from_numpy(x), rate))   # a tensor's own device
    assert abs(float(tl.true_peak_db(x, rate, device="cpu"))
               - float(jl.true_peak_db(xj, rate))) <= TOL
    if rate == 48000:
        got = tl.block_loudness(x, device="cpu").numpy()
        want = np.asarray(jl.block_loudness(xj))
        assert got.shape == want.shape and np.abs(got - want).max() <= TOL
    assert sk.launches == 0


def test_surround_weights_on_six_channels_match_jax():
    x = _program(48000, 5.0, 6, seed=8)
    w = tl.surround_weights(6)
    got = float(tl.integrated_lufs(x, 48000, weights=w, device="cpu"))
    assert abs(got - float(jl.integrated_lufs(jnp.asarray(x), 48000, weights=w))) <= TOL
    # the LFE (weight 0) does not count, the surrounds count 1.41 times
    x2 = x.copy()
    x2[3] *= 10.0
    assert abs(float(tl.integrated_lufs(x2, 48000, weights=w, device="cpu")) - got) <= 1e-4
    assert float(tl.integrated_lufs(x, 48000, device="cpu")) != got
    with pytest.raises(ValueError, match="channel weights"):
        tl.integrated_lufs(x[:2], 48000, weights=w, device="cpu")


def test_floors_and_short_inputs():
    """-200 LUFS for silence and for less than one 400 ms block, LRA 0.0
    below one 3 s window, no blocks for a sub-block signal: the JAX
    package's values."""
    silent = np.zeros((2, 48000 * 4), np.float32)
    short = _program(48000, 0.35, 2, seed=1)
    for x in (silent, short):
        got = float(tl.integrated_lufs(x, 48000, device="cpu"))
        assert got == float(jl.integrated_lufs(jnp.asarray(x), 48000)) == -200.0
    two_s = _program(48000, 2.0, 2, seed=2)
    assert float(tl.loudness_range(two_s, 48000, device="cpu")) == 0.0
    assert float(jl.loudness_range(jnp.asarray(two_s), 48000)) == 0.0
    assert tl.block_loudness(short, device="cpu").shape == (0,)
    assert tl.r128_stats(np.zeros((1, 100), np.float32), 48000, device="cpu") == (-200.0, 0.0)
    assert tl.meter_source_streamed(tl.array_reader(short), 2, short.shape[1], 48000,
                                    device="cpu") == {"lufs": -200.0, "true_peak_db": None}
    # digital silence: the true peak sits at the 1e-30 floor, -600 dB
    assert abs(float(tl.true_peak_db(silent[:, :5000], 48000, device="cpu")) + 600.0) < 1e-3
    assert tl.true_peak_db(np.zeros((1, 0), np.float32), 48000, device="cpu").ndim == 0


def test_nan_propagates_through_the_true_peak():
    x = 0.1 * np.ones((1, 60000), np.float32)
    x[0, 31000] = np.nan
    assert np.isnan(tl._true_peak_chunked(tl.array_reader(x), 1, x.shape[1], 48000,
                                          chunk_seconds=0.25, device="cpu"))
    assert np.isnan(jl._true_peak_chunked(jl.array_reader(x), 1, x.shape[1], 48000,
                                          chunk_seconds=0.25))
    assert np.isnan(float(tl.true_peak_db(x, 48000, device="cpu")))
    assert tl._peak_to_db([0.0, 0.5]) == float(20.0 * np.log10(0.5))
    assert np.isnan(tl._peak_to_db([0.0, float("nan"), 0.5]))


def test_long_true_peak_slices_the_tensor_it_was_given(monkeypatch):
    """Past the chunk threshold `true_peak_db` scans haloed slices of its
    tensor where it lies: the same float as the reader form on the same
    samples; the whole-signal form takes its logarithm in float32 and so
    may round one ulp apart (max is order-independent, overlap-save chunks
    reproduce the oversampled samples exactly)."""
    x = _program(8000, 52.0, 2, seed=11)          # 2.6 chunks of 20 s
    whole = float(tl.true_peak_db(x, 8000, device="cpu"))
    monkeypatch.setattr(tl, "_TP_CHUNK_THRESHOLD", 1000)
    got = float(tl.true_peak_db(torch.from_numpy(x), 8000))
    want = tl._true_peak_chunked(tl.array_reader(x), 2, x.shape[1], 8000, device="cpu")
    assert got == np.float32(want)
    assert abs(got - whole) <= 2e-6


@pytest.mark.parametrize("rate,seconds,ch,weights,want_tp", [
    (48000, 7.0, 2, False, False), (44100, 26.0, 2, False, False),
    (44100, 4.0, 2, False, True), (48000, 6.0, 6, True, False)],
    ids=["48k", "44k1_two_chunks", "44k1_true_peak", "48k_surround"])
def test_meter_source_streamed_matches_jax(rate, seconds, ch, weights, want_tp):
    x = _program(rate, seconds, ch, seed=ch + rate % 89)
    w = tl.surround_weights(ch) if weights else None
    got = tl.meter_source_streamed(tl.array_reader(x), ch, x.shape[1], rate,
                                   want_tp=want_tp, weights=w, device="cpu")
    want = jl.meter_source_streamed(jl.array_reader(x), ch, x.shape[1], rate,
                                    want_tp=want_tp, weights=w)
    assert abs(got["lufs"] - want["lufs"]) <= TOL
    if want_tp:
        assert abs(got["true_peak_db"] - want["true_peak_db"]) <= TOL
    else:
        assert got["true_peak_db"] is None and want["true_peak_db"] is None
    # the streamed meter agrees with the whole-signal statistic
    assert abs(got["lufs"] - float(tl.integrated_lufs(x, rate, weights=w, device="cpu"))) <= TOL
    assert sk.launches == 0


def test_meter_streamed_tp_single_pass_counts_reads():
    """want_tp shares the loudness pass's host reads, and matches the
    whole-signal `true_peak_db`."""
    x = (0.5 * np.random.default_rng(6).standard_normal((2, 44100 * 3))).astype(np.float32)
    reads = {"n": 0}
    base = tl.array_reader(x)

    def counting(start, count):
        reads["n"] += 1
        return base(start, count)

    m = tl.meter_source_streamed(counting, 2, x.shape[1], 44100, want_tp=True, device="cpu")
    assert reads["n"] <= 2 + x.shape[1] // (44100 * 20) + 1
    assert abs(m["true_peak_db"] - float(tl.true_peak_db(x, 44100, device="cpu"))) < 1e-3
    assert m["lufs"] > -30.0


def test_meter_grid_is_its_own():
    """The meter's result is a function of the samples and its own grid:
    the reader's block size (a file reader, an array) does not move it."""
    x = _program(44100, 3.0, 2, seed=4)
    base = tl.array_reader(x)

    def short_reads(start, count):
        return base(start, min(count, 7001))      # a reader that returns less than asked

    a = tl.meter_source_streamed(base, 2, x.shape[1], 44100, device="cpu")
    parts = tl.meter_source_streamed(
        lambda s, c: np.concatenate([short_reads(s + o, c - o) for o in range(0, c, 7001)],
                                    axis=1), 2, x.shape[1], 44100, device="cpu")
    assert a == parts
    b = tl.meter_source_streamed(base, 2, x.shape[1], 44100, chunk_seconds=1.0, device="cpu")
    assert abs(a["lufs"] - b["lufs"]) <= TOL       # another grid: close, not the same float


@pytest.mark.parametrize("args", [
    (-16.0, -20.0), (-16.0, -20.0, 3.0), (-14.0, -70.0), (-30.0, 20.0),
    (-16.0, -30.0, 0.0, -1.0, -6.0), (-16.0, -30.0, 2.0, -1.0, -20.0),
    (-5.0, -60.0, 0.0, -1.0, -30.0), (-16.0, -20.0, 0.0, -1.0, None)])
def test_normalization_gain_rule_is_the_jax_package_s(args):
    assert tl.normalization_gain_db(*args) == jl.normalization_gain_db(*args)


def test_default_device_is_cuda():
    x = np.zeros((1, 48000), np.float32)
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    for fn in (lambda: tl.integrated_lufs(x, 48000), lambda: tl.true_peak_db(x, 48000),
               lambda: tl.r128_stats(x, 48000),
               lambda: tl.meter_source_streamed(tl.array_reader(x), 1, 48000, 48000)):
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            fn()


# ------------------------------------------------------- graph, job, stream


def test_graph_applies_per_file_gains_like_jax():
    """`process_batch(per_file_gain_db=...)` on both graphs: codes <= 1 LSB
    (the SRC forms' float difference), and the gain is composed in float32
    from one helper that the stream shares."""
    x = np.stack([_program(44100, 0.3, 2, seed=s) for s in (1, 2, 3)])
    valid = np.array([x.shape[-1], 9000, 5000], np.int32)
    gains = np.array([6.02, -3.5, 0.0], np.float32)
    seeds = np.arange(3, dtype=np.int32)
    kw = dict(output_dir="unused", target_rate=48000, dither=False, gain_db=1.5)
    got = tgraph.process_batch(x, valid, TConfig(**kw), 44100, seeds,
                               per_file_gain_db=gains, device="cpu")
    want = jgraph.process_batch(jnp.asarray(x), jnp.asarray(valid), JConfig(**kw), 44100,
                                jnp.asarray(seeds), per_file_gain_db=gains)
    assert np.array_equal(got.out_frames.numpy(), np.asarray(want.out_frames))
    assert np.abs(got.codes.numpy().astype(np.int64) - np.asarray(want.codes)).max() <= 1
    assert np.abs(got.peak_db.numpy() - np.asarray(want.peak_db)).max() <= 1e-3
    plain = tgraph.process_batch(x, valid, TConfig(**kw), 44100, seeds, device="cpu")
    assert abs(float(got.peak_db[0] - plain.peak_db[0]) - 6.02) <= 1e-3
    lin = tgraph.gain_lin_f32(gains)
    assert lin.dtype == np.float32 and all(
        tgraph.gain_lin_f32(g)[0] == v for g, v in zip(gains, lin))
    with pytest.raises(ValueError, match="per-file gains"):
        tgraph.process_batch(x, valid, TConfig(**kw), 44100, seeds,
                             per_file_gain_db=gains[:2], device="cpu")


def _write(d, name, x, rate=44100, bits=24):
    path = os.path.join(str(d), name)
    wav.write_wav(path, x, rate, bits=bits)
    return path


def _codes(path):
    x, rate = wav.read_wav(path)
    return np.round(np.asarray(x, np.float64) * (1 << 23)).astype(np.int64), rate


def test_normalized_batch_job_matches_jax(tmp_path):
    """Two files, the second a quiet one with clicks so that the dBTP cap
    engages: the same statuses, frame counts, logged LUFS and gains (0.01)
    and notes, codes <= 2 LSB below -12 dBFS; the normalized output reads
    the target."""
    a = _program(44100, 2.5, 2, seed=11, level=0.1)
    b = _program(44100, 2.0, 2, seed=12, level=0.01)
    b[:, ::9000] = 0.5
    src = [_write(tmp_path, "a.wav", a), _write(tmp_path, "b.wav", b)]
    runs = {}
    for name, mod, conf, extra in (("jax", jsched, JConfig, {}),
                                   ("torch", tsched, TConfig, {"device": "cpu"})):
        out = str(tmp_path / f"out_{name}")
        cfg = conf(output_dir=out, target_rate=48000, dither=False, batch_size=2,
                   bucket_frames=(1 << 17,), normalize_lufs=-16.0, normalize_tp_db=-1.0)
        bp = mod.BatchProcessor(cfg, **extra)
        res = bp.run(src)
        assert res.completed == 2 and res.failed == 0, (name, res)
        runs[name] = (out, res, [ln.split("] ", 1)[1] for ln in bp.log.lines
                                 if "Normalize:" in ln])
    assert sorted(runs["torch"][2]) == sorted(runs["jax"][2])
    assert any("capped at -1.0 dBTP" in ln for ln in runs["torch"][2])
    for p in src:
        mt, mj = runs["torch"][1].per_file[p], runs["jax"][1].per_file[p]
        assert mt["out_frames"] == mj["out_frames"]
        assert abs(mt["source_lufs"] - mj["source_lufs"]) <= TOL
        assert abs(mt["applied_gain_db"] - mj["applied_gain_db"]) <= TOL
        stem = os.path.splitext(os.path.basename(p))[0]
        tc, _ = _codes(os.path.join(runs["torch"][0], f"{stem}_processed.wav"))
        jc, _ = _codes(os.path.join(runs["jax"][0], f"{stem}_processed.wav"))
        # b.wav's clicks land at the -1 dBTP ceiling, where a float32 ulp is
        # half an LSB and the two meters' 1e-6 dB apart moves a code by one:
        # 2 LSB plus 2^-21 of the code's magnitude (5.6 at the clicks; measured 4)
        tol = 2 + np.abs(jc) * 2.0 ** -21
        assert tc.shape == jc.shape and (np.abs(tc - jc) <= tol).all(), np.abs(tc - jc).max()
        assert np.abs(tc - jc)[np.abs(jc) < (1 << 21)].max() <= 2
    y, r = wav.read_wav(os.path.join(runs["torch"][0], "a_processed.wav"))
    assert abs(float(tl.integrated_lufs(y, r, device="cpu")) + 16.0) <= 0.1
    assert sk.launches == 0


def test_batch_and_stream_give_a_file_the_same_gain(tmp_path):
    """The scheduler's worker (decoded array) and the stream's pre-pass (the
    file reader) meter with one function on one grid: the same float, so the
    same float32 factor; and the stream's chunk size does not reach it."""
    x = _program(44100, 1.6, 2, seed=13, level=0.05)
    src = _write(tmp_path, "g.wav", x)
    cfg = TConfig(output_dir=str(tmp_path), target_rate=48000, dither=False,
                  normalize_lufs=-18.0, gain_db=-1.0)
    data, rate = tcodec.read_audio(src)
    info: dict = {}
    g_batch = tsched.BatchProcessor(cfg, device="cpu")._normalization_gain(src, data, rate, info)
    gains, blobs = [], []
    for cs in (0.2, 0.7):
        norm: dict = {}
        out = str(tmp_path / f"s_{cs}.wav")
        tstream.stream_resample_file(src, out, cfg, chunk_seconds=cs, device="cpu",
                                     norm_info=norm)
        gains.append(norm["applied_gain_db"])
        with open(out, "rb") as f:
            blobs.append(f.read())
    assert gains[0] == gains[1] == g_batch
    assert blobs[0] == blobs[1]
    assert info[src] == {"source_lufs": round(norm["source_lufs"], 2),
                         "applied_gain_db": round(g_batch, 2)}
    # too short to meter: no gain, no note
    tiny = _write(tmp_path, "tiny.wav", x[:, :9000])
    norm = {}
    tstream.stream_resample_file(tiny, str(tmp_path / "tiny_o.wav"), cfg, device="cpu",
                                 norm_info=norm)
    assert norm == {}


def test_normalized_stream_matches_jax(tmp_path):
    x = _program(44100, 2.2, 2, seed=14, level=0.05)
    src = _write(tmp_path, "n.wav", x)
    kw = dict(output_dir=str(tmp_path), target_rate=48000, dither=False, normalize_lufs=-20.0)
    jout, tout = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    n_j = jstream.stream_resample_file(src, jout, JConfig(**kw), chunk_seconds=0.5)
    n_t = tstream.stream_resample_file(src, tout, TConfig(**kw), chunk_seconds=0.5,
                                       device="cpu")
    assert n_t == n_j
    tc, _ = _codes(tout)
    jc, _ = _codes(jout)
    assert tc.shape == jc.shape and np.abs(tc - jc).max() <= 2, np.abs(tc - jc).max()
    y, r = wav.read_wav(tout)
    assert abs(float(tl.integrated_lufs(y, r, device="cpu")) + 20.0) <= 0.1


def test_normalization_turns_the_raw_upload_off(tmp_path):
    """The meter needs decoded floats: with normalize_lufs a 24-bit WAV is
    grouped for the float upload (raw_bits 0), as in the JAX scheduler."""
    from f9tpu_torch.pipeline.manifest import JobManifest

    src = _write(tmp_path, "r.wav", _program(44100, 0.5, 2, seed=15))
    for norm, want_bits in ((None, 24), (-16.0, 0)):
        bp = tsched.BatchProcessor(
            TConfig(output_dir=str(tmp_path), normalize_lufs=norm), device="cpu")
        groups, _ = bp._probe([src], JobManifest.from_files([src]))
        assert [k[2] for k in groups] == [want_bits]


def test_cli_normalize_flags_and_probe_match_the_jax_cli(tmp_path, capsys):
    x = _program(44100, 2.4, 2, seed=16, level=0.05)
    src = _write(tmp_path, "p.wav", x)
    rows, streams = {}, {}
    for name, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        assert mod.main(["probe", src, "--loudness", "--json", "--pairs",
                         "--require-rate", "44100", *extra]) == 0
        (rows[name],) = json.loads(capsys.readouterr().out)
        out = str(tmp_path / f"{name}.wav")
        assert mod.main(["stream", src, "--out", out, "--normalize-lufs=-16", "--no-dither",
                         "--json", *extra]) == 0
        streams[name] = (out, json.loads(capsys.readouterr().out))
    assert list(rows["torch"]) == list(rows["jax"])
    for k, v in rows["jax"].items():
        if k in ("lufs", "true_peak_db", "lra_lu"):
            assert abs(rows["torch"][k] - v) <= TOL + 0.005, k      # both rounded to 0.01
        else:
            assert rows["torch"][k] == v, k
    tc, _ = _codes(streams["torch"][0])
    jc, _ = _codes(streams["jax"][0])
    assert tc.shape == jc.shape and np.abs(tc - jc).max() <= 2
    assert abs(streams["torch"][1]["source_lufs"] - rows["torch"]["lufs"]) <= 0.02
    assert abs(streams["torch"][1]["applied_gain_db"]
               - (-16.0 - streams["torch"][1]["source_lufs"])) <= 0.011
    # text form, and the JAX CLI's validation
    assert cli.main(["probe", src, "--loudness", "--device", "cpu"]) == 0
    line = capsys.readouterr().out
    assert " LUFS, " in line and " dBTP, LRA " in line and "44100 Hz, 2 ch" in line
    assert cli.main(["probe", str(tmp_path / "missing.wav"), "--json", "--device", "cpu"]) == 1
    assert "error" in json.loads(capsys.readouterr().out)[0]
    for flags in (["--normalize-lufs=3"], ["--normalize-tp=-1"]):
        for sub in (["process", src, "--out", str(tmp_path / "o")],
                    ["stream", src, "--out", str(tmp_path / "o.wav")]):
            assert cli.main([*sub, "--device", "cpu", *flags]) == 2
            assert "normalize" in capsys.readouterr().err


def test_cli_process_normalizes_and_logs(tmp_path, capsys):
    x = _program(44100, 1.5, 2, seed=17, level=0.05)
    src = _write(tmp_path, "q.wav", x)
    out = str(tmp_path / "out")
    rc = cli.main(["process", src, "--out", out, "--device", "cpu", "--normalize-lufs=-16",
                   "--batch-size", "1", "--json"])
    cap = capsys.readouterr()
    assert rc == 0
    m = json.loads(cap.out)["per_file"][src]
    assert abs(m["source_lufs"] + m["applied_gain_db"] + 16.0) <= 0.011
    assert "Normalize: q.wav" in cap.err and "-> -16.0" in cap.err
    y, r = wav.read_wav(os.path.join(out, "q_processed.wav"))
    assert abs(float(tl.integrated_lufs(y, r, device="cpu")) + 16.0) <= 0.1
