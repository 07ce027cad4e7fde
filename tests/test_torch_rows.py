"""The rows device layout (`device_layout="rows"`) of the port, on the CPU.

- Within the port, rows == packed bit for bit: codes (the rows tiling read
  flat up to the packed length, zeros past it), ``out_frames``, peak, RMS
  and tail floor, on every route the rows layout has (the bucket, the raw
  wire, the JAX package's dense and varispeed host-marshalled rows) for
  44.1k -> 48k low / high / ultra, 176.4k -> 48k high and 44.1k -> 44,056,
  with dither, DC removal, a routing map with a silent bus, mono fan-out,
  16 and 24 bits and a per-file gain.
- Against the JAX package's rows layout on the same numpy input (its 4-D
  marshalled rows, its raw wire with Pallas in interpret mode, its banded
  varispeed rows): the same ``out_frames``, codes <= 2 LSB at 24 bits,
  peak within 1e-3 dB and RMS within 1e-2 dB.
- The scheduler and the CLI under ``device_layout="rows"`` write the packed
  run's bytes (sha256) for float32 WAVs (host-marshalled rows), 24-bit WAVs
  (the raw wire) and ``--rate 44056``, also over a files mesh of 2 CPU
  shards; with reverb or a chain the layout runs packed, and a 4-D input
  there raises ValueError.
"""

import hashlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.models import design_cycle_bank as jbank  # noqa: E402
from f9tpu.ops.pallas_src import rows_marshal_plan as j_rows_marshal_plan  # noqa: E402
from f9tpu.ops.pallas_src import rows_pre_applicable as j_rows_pre_applicable  # noqa: E402
from f9tpu.pipeline import graph as jgraph  # noqa: E402
from f9tpu_torch import cli  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io import wav as twav  # noqa: E402
from f9tpu_torch.models import design_cycle_bank as tbank  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops import resample as tres  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

jres = __import__("importlib").import_module("f9tpu.ops.resample")

FILES, T = 2, 5000
VALID = np.array([5000, 3777], np.int32)
SEEDS = np.array([3, 11], np.int32)
GAINS = np.array([-4.5, 2.0], np.float32)

#: (rate_in, rate_out, quality): R = 1, 1, 2, 4, and a varispeed bank
BANKS = [(44100, 48000, "low"), (44100, 48000, "high"), (44100, 48000, "ultra"),
         (176400, 48000, "high"), (44100, 44056, "low")]
#: option sets: (config keywords, input channels, per-file gains)
OPTIONS = {
    "default": ({}, 2, None),
    "no_dither_no_dc": ({"dither": False, "remove_dc": False}, 2, None),
    "routing_silent_bus": ({"channel_routing": [1, -1, 0]}, 2, None),
    "mono_fan_out": ({"output_channels": 2}, 1, None),
    "bits16_gain": ({"bits": 16, "gain_db": -2.0}, 2, None),
    "per_file_gain": ({}, 2, GAINS),
}
METRICS = ("out_frames", "peak_db", "rms_db", "noise_floor_db")


def _batch(channels: int, seed: int) -> np.ndarray:
    """A tone, noise and a DC offset near -14 dBFS, zero past each file's
    valid length (as the scheduler stages a bucket)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    x = (0.15 * np.sin(2 * np.pi * 997.0 * t)
         + 0.05 * rng.standard_normal((FILES, channels, T)) + 0.01)
    for i, n in enumerate(VALID):
        x[i, :, n:] = 0.0
    return x.astype(np.float32)


def _dense_rows(x: np.ndarray, bank) -> np.ndarray:
    """The JAX scheduler's dense marshal: each file at ``pad_front`` of a
    zero ``(n_rows, M)`` tiling."""
    n_rows, pf = j_rows_marshal_plan(bank, x.shape[-1])
    st = np.zeros((*x.shape[:2], n_rows * bank.M), np.float32)
    for i, n in enumerate(VALID):
        st[i, :, pf:pf + n] = x[i, :, :n]
    return st.reshape(*x.shape[:2], n_rows, bank.M)


def _banded_staging(x: np.ndarray, bank) -> np.ndarray:
    """The flat zero staging the JAX scheduler cuts varispeed rows from."""
    n_rows, w_rows, pf = tres.banded_rows_plan(bank, x.shape[-1])
    st = np.zeros((*x.shape[:2], (n_rows - 1) * bank.M + w_rows), np.float32)
    for i, n in enumerate(VALID):
        st[i, :, pf:pf + n] = x[i, :, :n]
    return st


def _marshalled(x: np.ndarray, rate_in: int, rate_out: int, quality: str):
    """The JAX package's host-marshalled rows of ``x`` for the bank, or None
    where its scheduler stages the bucket."""
    bank = jbank(rate_in, rate_out, quality=quality)
    if j_rows_pre_applicable(bank):
        return _dense_rows(x, bank)
    if jres.banded_rows_applicable(bank):
        return jres.marshal_banded_rows(_banded_staging(x, bank), bank)
    return None


def _assert_rows_equal_packed(rows, packed):
    """rows == packed bitwise: the tiling read flat up to the packed length,
    zeros past it, and every metric."""
    assert rows.layout == "rows" and packed.layout == "flat"
    flat = rows.codes.reshape(*rows.codes.shape[:2], -1)
    n = packed.codes.shape[-1]
    assert torch.equal(flat[..., :n], packed.codes)
    assert not flat[..., n:].any()
    for name in METRICS:
        assert torch.equal(getattr(rows, name), getattr(packed, name)), name


@pytest.mark.parametrize("bank", BANKS, ids=lambda b: f"{b[0]}-{b[1]}-{b[2]}")
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_rows_equal_packed_bitwise(bank, opt):
    """Every route of the rows layout gives the packed layout's codes,
    out_frames and metrics bit for bit: the bucket itself, the JAX
    package's host-marshalled rows as numpy, and the same rows as a view of
    their flat staging (`marshalled_rows`, as the scheduler passes them)."""
    rate_in, rate_out, quality = bank
    kw, channels, gains = OPTIONS[opt]
    cfg = TConfig(output_dir="/tmp/x", target_rate=rate_out, quality=quality, **kw)
    x = _batch(channels, seed=len(opt))
    run = dict(per_file_gain_db=gains, device="cpu")
    packed = tgraph.process_batch(x, VALID, cfg, rate_in, SEEDS, **run)
    rows = tgraph.process_batch(x, VALID, cfg, rate_in, SEEDS, rows_layout=True, **run)
    _assert_rows_equal_packed(rows, packed)
    marshalled = _marshalled(x, rate_in, rate_out, quality)
    assert marshalled is not None
    staged = tgraph.process_batch(marshalled, VALID, cfg, rate_in, SEEDS,
                                  rows_layout=True, **run)
    _assert_rows_equal_packed(staged, packed)
    # the scheduler's form: the rows as a view of their flat staging, which
    # the SRC reads in place
    bank_t = tbank(rate_in, rate_out, quality=quality)
    total, pf = tgraph.rows_staging_plan(bank_t, T)
    st = torch.zeros((FILES, channels, total))
    for i, n in enumerate(VALID):
        st[i, :, pf:pf + n] = torch.from_numpy(x[i, :, :n])
    view = tgraph.marshalled_rows(st, bank_t)
    assert torch.equal(view, torch.from_numpy(np.array(marshalled)))
    staging, _ = tgraph._rows_staging(view, bank_t)
    assert staging.data_ptr() == st.data_ptr()                  # no copy
    _assert_rows_equal_packed(tgraph.process_batch(
        view, VALID, cfg, rate_in, SEEDS, rows_layout=True, **run), packed)


def _check_vs_jax(got, want):
    """Port against the JAX package: the same out_frames, peak within 1e-3
    dB, RMS and floor within 1e-2 dB, codes within 2 LSB at 24 bits (read
    up to the shorter tiling; past out_frames both are zero)."""
    assert np.array_equal(got.out_frames.numpy(), np.asarray(want.out_frames))
    assert np.abs(got.peak_db.numpy() - np.asarray(want.peak_db)).max() <= 1e-3
    for name in ("rms_db", "noise_floor_db"):
        assert np.abs(getattr(got, name).numpy()
                      - np.asarray(getattr(want, name))).max() <= 1e-2, name
    g = got.codes.numpy().reshape(FILES, got.codes.shape[1], -1).astype(np.int64)
    w = np.asarray(want.codes).reshape(FILES, g.shape[1], -1).astype(np.int64)
    n = min(g.shape[-1], w.shape[-1])
    assert not g[..., n:].any() and not w[..., n:].any()
    assert np.abs(g[..., :n] - w[..., :n]).max() <= 2


@pytest.mark.parametrize("bank", BANKS, ids=lambda b: f"{b[0]}-{b[1]}-{b[2]}")
@pytest.mark.parametrize("opt", ["default", "routing_silent_bus", "mono_fan_out",
                                 "per_file_gain"])
def test_marshalled_rows_match_jax(bank, opt):
    """The JAX package's `process_batch(rows_layout=True)` on its
    host-marshalled rows (`resample_rows_pre`, or the banded rows of a
    varispeed bank) against the port's on the same numpy rows."""
    rate_in, rate_out, quality = bank
    kw, channels, gains = OPTIONS[opt]
    x = _batch(channels, seed=7 + len(opt))
    rows = _marshalled(x, rate_in, rate_out, quality)
    want = jgraph.process_batch(
        jnp.asarray(rows), VALID,
        ProcessingConfig(output_dir="/tmp/x", target_rate=rate_out, quality=quality, **kw),
        rate_in, jnp.asarray(SEEDS), rows_layout=True, per_file_gain_db=gains)
    got = tgraph.process_batch(
        rows, VALID, TConfig(output_dir="/tmp/x", target_rate=rate_out, quality=quality, **kw),
        rate_in, SEEDS, rows_layout=True, per_file_gain_db=gains, device="cpu")
    assert want.layout == got.layout == "rows"
    _check_vs_jax(got, want)


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("quality", ["low", "ultra"])
def test_bucket_rows_match_jax(bits, quality):
    """The bucket through the rows layout (JAX: the Pallas kernel in
    interpret mode, `resample_rows`) against the port's, 16 and 24 bits."""
    x = _batch(2, seed=bits)
    kw = dict(output_dir="/tmp/x", target_rate=48000, quality=quality, bits=bits)
    want = jgraph.process_batch(jnp.asarray(x), VALID, ProcessingConfig(**kw), 44100,
                                jnp.asarray(SEEDS), rows_layout=True)
    got = tgraph.process_batch(x, VALID, TConfig(**kw), 44100, SEEDS, rows_layout=True,
                               device="cpu")
    _check_vs_jax(got, want)


def _raw(x: np.ndarray, bits: int) -> np.ndarray:
    """Interleaved little-endian integer PCM of ``x``, zero past each file."""
    codes = np.round(x * (1 << (bits - 1))).astype(np.int64)
    inter = np.swapaxes(codes, 1, 2) & ((1 << bits) - 1)
    b = np.stack([(inter >> (8 * k)) & 0xFF for k in range(bits // 8)], axis=-1)
    return b.astype(np.uint8).reshape(x.shape[0], -1)


@pytest.mark.parametrize("in_bits,out_bits", [(24, 24), (16, 24), (24, 16)])
def test_raw_rows_payload_equals_packed_and_jax(in_bits, out_bits):
    """The raw wire under the rows layout packs whole cycles on the device
    (layout "flat"): its payload's first ``out_len`` frames are the packed
    path's bytes, byte for byte, zeros past them, the metrics the same bits;
    against the JAX package's rows raw path (Pallas in interpret mode) the
    codes within 2 LSB up to each file's end."""
    x = _batch(2, seed=in_bits + out_bits)
    raw = _raw(x, in_bits)
    kw = dict(output_dir="/tmp/x", target_rate=48000, bits=out_bits, quality="low")
    args = (VALID, TConfig(**kw), 44100, SEEDS)
    rw = dict(in_channels=2, in_bits=in_bits, device="cpu")
    packed = tgraph.process_batch_raw(raw, *args, **rw)
    rows = tgraph.process_batch_raw(raw, *args, rows_layout=True, **rw)
    assert rows.layout == packed.layout == "flat"
    n = packed.codes.shape[-1]
    assert torch.equal(rows.codes[:, :n], packed.codes) and not rows.codes[:, n:].any()
    for name in METRICS:
        assert torch.equal(getattr(rows, name), getattr(packed, name)), name
    want = jgraph.process_batch_raw(jnp.asarray(raw), VALID, ProcessingConfig(**kw), 44100,
                                    jnp.asarray(SEEDS), in_channels=2, in_bits=in_bits,
                                    rows_layout=True)
    assert want.layout == "flat"
    nb = out_bits // 8
    for i, of in enumerate(rows.out_frames.numpy()):
        assert of == int(np.asarray(want.out_frames)[i])
        g = rows.codes[i, :of * 2 * nb].numpy().reshape(-1, nb).astype(np.int64)
        w = np.asarray(want.codes)[i, :of * 2 * nb].reshape(-1, nb).astype(np.int64)
        gv, wv = (sum(a[:, k] << (8 * k) for k in range(nb)) for a in (g, w))
        gv, wv = (v - ((v >> (out_bits - 1)) << out_bits) for v in (gv, wv))
        assert np.abs(gv - wv).max() <= 2


def test_rows_runs_packed_with_reverb_or_a_chain():
    """With a chain (or reverb mode, or a latency) the rows layout does not
    apply: the batch runs packed, as in the JAX package, and a 4-D rows input
    raises ValueError."""
    x = _batch(2, seed=1)
    chain = tchain.Chain(tchain.Delay(0.001))
    for kw, lat in (({"chain": chain}, 0), ({}, 5)):
        cfg = TConfig(output_dir="/tmp/x", target_rate=48000, quality="low", **kw)
        rows = tgraph.process_batch(x, VALID, cfg, 44100, SEEDS, latency_frames=lat,
                                    rows_layout=True, device="cpu")
        packed = tgraph.process_batch(x, VALID, cfg, 44100, SEEDS, latency_frames=lat,
                                      device="cpu")
        assert rows.layout == "flat" and torch.equal(rows.codes, packed.codes)
        bank = tbank(44100, 48000, quality="low")
        with pytest.raises(ValueError, match="rows layout"):
            tgraph.process_batch(_dense_rows(x, bank), VALID, cfg, 44100, SEEDS,
                                 latency_frames=lat, rows_layout=True, device="cpu")


def test_rows_staging_rejects_bad_rows():
    """The staging checks the JAX package's row widths and counts."""
    dense = tbank(44100, 48000, quality="low")
    with pytest.raises(ValueError, match="rows width"):
        tgraph._rows_staging(torch.zeros((1, 1, 9, dense.M + 1)), dense)
    with pytest.raises(ValueError, match="more than R"):
        tgraph._rows_staging(torch.zeros((1, 1, 1, dense.M)), dense)
    vari = tbank(44100, 44056, quality="low")
    with pytest.raises(ValueError, match="cycle-row width"):
        tgraph._rows_staging(torch.zeros((1, 1, 3, vari.M)), vari)


def test_staged_src_equals_whole_cycles():
    """`resample_staged` on the staging equals `resample_auto` on the bucket
    with ``out_len = Q * L`` bit for bit, for a bank the kernel takes, a
    varispeed bank and a bank it does not take (L < 8, the plain form)."""
    x = torch.from_numpy(_batch(2, seed=4))
    for ri, ro, q in ((44100, 48000, "high"), (44100, 44056, "low"), (96000, 48000, "high")):
        bank = tbank(ri, ro, quality=q)
        Q = -(-bank.out_len(T) // bank.L)
        want = sk.resample_auto(x, bank, out_len=Q * bank.L)
        if bank.G is None:
            st = torch.from_numpy(_banded_staging(x.numpy(), bank))
        else:
            n_rows, pf = tres.rows_marshal_plan(bank, T)
            assert n_rows == Q + tres._overlap_rows(bank)
            st = torch.zeros((FILES, 2, n_rows * bank.M))
            st[..., pf:pf + T] = x
        assert torch.equal(sk.resample_staged(st, bank, Q), want), (ri, ro, q)
    assert sk.launches == 0


def test_rows_helpers_match_jax():
    """The port's copies of the JAX package's rows plans."""
    for ri, ro, q in BANKS + [(96000, 48000, "high"), (8000, 48000, "low")]:
        tb, jb = tbank(ri, ro, quality=q), jbank(ri, ro, quality=q)
        assert tres.rows_pre_applicable(tb) == j_rows_pre_applicable(jb)
        assert tres.banded_rows_applicable(tb) == jres.banded_rows_applicable(jb)
        assert tres.rows_marshal_plan(tb, 12345) == j_rows_marshal_plan(jb, 12345)
        if tb.G is None:
            assert tres.banded_rows_plan(tb, 12345) == jres.banded_rows_plan(jb, 12345)


def test_build_process_fn():
    """`build_process_fn` is `process_batch` for one config and rate."""
    from f9tpu_torch.pipeline import build_process_fn

    cfg = TConfig(output_dir="/tmp/x", target_rate=48000, quality="low")
    x = _batch(2, seed=2)
    fn = build_process_fn(cfg, 44100, device="cpu")
    got = fn(x, VALID, SEEDS)
    want = tgraph.process_batch(x, VALID, cfg, 44100, SEEDS, device="cpu")
    assert torch.equal(got.codes, want.codes)
    assert torch.equal(fn(x, VALID, SEEDS, latency_frames=3).codes,
                       tgraph.process_batch(x, VALID, cfg, 44100, SEEDS, latency_frames=3,
                                            device="cpu").codes)


# ---------------------------------------------------------------- the jobs

def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _write_inputs(d, bits: int, rate: int = 44100) -> list[str]:
    """Three stereo files of 0.2-0.5 s (and one mono) at ``bits`` (32 =
    float32 WAV)."""
    rng = np.random.default_rng(bits)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, (ch, sec) in enumerate(((2, 0.2), (2, 0.5), (2, 0.37), (1, 0.3))):
        x = (0.2 * rng.standard_normal((ch, int(sec * rate)))).astype(np.float32)
        p = os.path.join(d, f"in{i}.wav")
        twav.write_wav(p, x, rate, bits=bits)
        paths.append(p)
    return paths


def _run_job(paths, out, mesh=None, **kw):
    cfg = TConfig(output_dir=out, bucket_frames=(1 << 13, 1 << 15), batch_size=2, seed=4,
                  quality="low", **kw)
    bp = tsched.BatchProcessor(cfg, mesh=mesh, device=None if mesh else "cpu")
    res = bp.run(paths)
    assert res.completed == len(paths) and res.failed == 0, bp.log.lines()
    return {os.path.basename(p): _sha(os.path.join(out, p)) for p in os.listdir(out)
            if p.endswith(".wav")}


@pytest.mark.parametrize("bits,rate,mesh", [
    (32, 48000, 0), (24, 48000, 0), (32, 44056, 0), (24, 44056, 0), (32, 48000, 2),
    (24, 48000, 2), (32, 44056, 2)])
def test_batch_processor_rows_writes_the_packed_bytes(tmp_path, bits, rate, mesh):
    """`BatchProcessor(device_layout="rows")` on float32 WAVs (the
    host-marshalled rows: dense, or varispeed at 44,056) and on 24-bit WAVs
    (the raw wire) writes each file's packed-run bytes, on one device and on
    a files mesh of 2 CPU shards."""
    from f9tpu_torch.parallel import make_mesh

    paths = _write_inputs(str(tmp_path / "in"), bits)
    m = make_mesh(mesh, devices=["cpu"] * mesh) if mesh else None
    packed = _run_job(paths, str(tmp_path / "packed"), target_rate=rate)
    rows = _run_job(paths, str(tmp_path / "rows"), mesh=m, target_rate=rate,
                    device_layout="rows")
    assert len(rows) == 4 and rows == packed


def test_batch_processor_rows_with_reverb_runs_packed(tmp_path):
    """A rows config in reverb mode runs packed (the JAX package's rule)."""
    paths = _write_inputs(str(tmp_path / "in"), 32)[:2]
    kw = dict(target_rate=48000, reverb_mode=True, noise_floor_db=-90.0, latency_frames=0)
    assert (_run_job(paths, str(tmp_path / "rows"), device_layout="rows", **kw)
            == _run_job(paths, str(tmp_path / "packed"), **kw))


def test_cli_rows_config_file_and_flag(tmp_path, capsys):
    """A JSON config holding ``"device_layout": "rows"`` (as the JAX CLI
    saves it) loads and runs; ``--device-layout rows`` gives the packed
    run's bytes."""
    paths = _write_inputs(str(tmp_path / "in"), 32)[:2]
    conf = str(tmp_path / "rows.json")
    with open(conf, "w") as f:
        json.dump({"device_layout": "rows", "rate": 48000, "quality": "low"}, f)
    common = ["--device", "cpu", "--seed", "2"]
    assert cli.main(["process", *paths, "--out", str(tmp_path / "a"), "--config", conf,
                     *common]) == 0
    assert cli.main(["process", *paths, "--out", str(tmp_path / "b"), "--rate", "48000",
                     "--quality", "low", "--device-layout", "rows", *common]) == 0
    assert cli.main(["process", *paths, "--out", str(tmp_path / "c"), "--rate", "48000",
                     "--quality", "low", *common]) == 0
    capsys.readouterr()
    for p in paths:
        name = os.path.basename(p).replace(".wav", "_processed.wav")
        shas = {_sha(str(tmp_path / d / name)) for d in "abc"}
        assert len(shas) == 1, name
