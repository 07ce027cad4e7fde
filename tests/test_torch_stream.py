"""The port's streaming path against the JAX package's, and its own
contracts, on the CPU.

- `resample_presliced` on one haloed chunk, port against JAX: <= 2e-6 abs
  and <= -120 dB (the port sums in float64, JAX in float32); within the
  port, chunked == whole bitwise.
- `stream_resample_file`, port against JAX: the same frame count, <= 2 LSB
  at 24 bits without a chain, <= 16 LSB with an FFT chain (MKL against
  pocketfft).  The inputs sit near -20 dBFS: on -10 dBFS white noise the
  JAX stream's float32 convolution itself reads up to 5 LSB from the
  float64 oracle, the port's 1.
- Within the port, the bytes do not depend on the chunk size (three sizes)
  for routing, fan-out, latency either way, reverb tails, 16 and 24 bits,
  WAV, AIFF and FLAC, and the raw wire equals the float wire.
- The entry points run on CUDA unless asked for the CPU, and the options
  not ported yet raise, naming their ROADMAP item.

Every test here runs torch on one CPU thread (`_one_thread`): the suite
runs files in parallel processes, and an OpenMP pool that spin-waits after
each parallel op starves them (a 1200-cycle presliced fold took 19 s instead
of 0.07 s beside five busy processes).  Thread counts are the subject of
`tests/test_torch_chain.py::test_whole_vectors_is_position_invariant`."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu import cli as jcli  # noqa: E402
from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import wav  # noqa: E402
from f9tpu.io.aiff import read_aiff, write_aiff  # noqa: E402
from f9tpu.io.flac import read_flac  # noqa: E402
from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.ops.resample import resample_presliced as j_presliced  # noqa: E402
from f9tpu.pipeline import stream as jstream  # noqa: E402
from f9tpu_torch import cli  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io.aiff import AiffReader  # noqa: E402
from f9tpu_torch.io.wav import WavReader  # noqa: E402
from f9tpu_torch.models import design_cycle_bank, resample_oracle  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops.resample import resample_presliced as t_presliced  # noqa: E402
from f9tpu_torch.pipeline import calibration as tcal  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402
from f9tpu_torch.tools import hw_soak  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sig(ch, n, seed, rate=44100, level=0.1, dc=0.01):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    f = rng.uniform(100.0, 5000.0, size=(ch, 1))
    x = (level * np.sin(2 * np.pi * f * t) + 0.2 * level * rng.standard_normal((ch, n)) + dc)
    return x.astype(np.float32)


def _codes(path, bits=24):
    reader = {".aiff": read_aiff, ".flac": read_flac}.get(os.path.splitext(path)[1],
                                                          wav.read_wav)
    y, rate = reader(path)
    return np.round(np.asarray(y, np.float64) * (1 << (bits - 1))).astype(np.int64), rate


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


# ------------------------------------------------------- resample_presliced

_BANKS = [(44100, 48000, "high"), (48000, 44100, "high"), (176400, 48000, "high"),
          (44100, 88200, "high")]
_BANK_IDS = ["44k1-48k", "48k-44k1", "176k4-48k_R4", "2x_up_L2"]


def _haloed(x, bank, Q):
    """``x`` behind the bank's front pad, zero-filled to the span of Q
    cycles."""
    xp = np.zeros((x.shape[0], (Q - 1) * bank.M + bank.W), np.float32)
    keep = min(x.shape[-1], xp.shape[-1] - bank.pad_front)
    xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
    return xp


@pytest.mark.parametrize("ri,ro,q", _BANKS, ids=_BANK_IDS)
def test_resample_presliced_matches_jax(ri, ro, q):
    """<= 2e-6 abs and <= -120 dB on the same haloed chunk (measured
    <= 1.0e-6 and -130.7 ... -133.7 dB): JAX's float32 convolution against
    the port's float64 fold."""
    bank = design_cycle_bank(ri, ro, quality=q)
    Q = 700
    xp = _haloed(_sig(2, 800 * bank.M, seed=ri % 97, rate=ri, level=0.5), bank, Q)
    want = np.asarray(j_presliced(xp, bank, Q))
    got = t_presliced(torch.from_numpy(xp), bank, Q).numpy()
    assert got.shape == want.shape == (2, Q * bank.L)
    err = got.astype(np.float64) - want
    assert np.abs(err).max() <= 2e-6
    db = 20 * np.log10(np.sqrt(np.mean(err ** 2)) / np.sqrt(np.mean(want.astype(np.float64) ** 2)))
    assert db <= -120.0


@pytest.mark.parametrize("ri,ro,q", _BANKS, ids=_BANK_IDS)
def test_resample_presliced_chunked_equals_whole(ri, ro, q):
    """Bitwise: the whole padded signal in one call against haloed chunks
    of 1, 2, 3, 37 and 250 cycles (each output sums its window in a fixed
    order; the preview's last chunk of an item holds any count down to 1);
    and the whole form within half an ulp of the oracle's SRC."""
    bank = design_cycle_bank(ri, ro, quality=q)
    x = _sig(2, 300 * bank.M + 777, seed=5, rate=ri, level=0.5)
    out_len = bank.out_len(x.shape[-1])
    Q = -(-out_len // bank.L)
    whole = t_presliced(torch.from_numpy(_haloed(x, bank, Q)), bank, Q)
    for cycles in (1, 2, 3, 37, 250):
        outs = []
        for q0 in range(0, Q, cycles):
            n = min(cycles, Q - q0)
            lo = q0 * bank.M - bank.pad_front
            span = np.zeros((2, (n - 1) * bank.M + bank.W), np.float32)
            a, b = max(0, lo), min(x.shape[-1], lo + span.shape[-1])
            if b > a:
                span[:, a - lo:b - lo] = x[:, a:b]
            outs.append(t_presliced(torch.from_numpy(span), bank, n))
        assert torch.equal(torch.cat(outs, dim=-1), whole), cycles
    ref = resample_oracle(x, ri, ro, quality=q)
    assert np.abs(whole.numpy()[:, :out_len] - ref).max() <= 2e-6


def test_resample_presliced_refuses():
    bank = design_cycle_bank(44100, 48000)
    with pytest.raises(ValueError, match="too short"):
        t_presliced(torch.zeros(2, bank.W - 1), bank, 1)
    # a varispeed bank streams: two cycles of a haloed chunk, and the same
    # length check
    vari = design_cycle_bank(44100, 44056, quality="low")
    assert t_presliced(torch.zeros(2, 100000), vari, 2).shape == (2, 2 * vari.L)
    with pytest.raises(ValueError, match="too short"):
        t_presliced(torch.zeros(2, vari.M + vari.W - 1), vari, 2)


# -------------------------------------------------------- whole stream

def _ir(path, ch, n=7200, seed=8, gain=0.04):
    rng = np.random.default_rng(seed)
    ir = gain * rng.standard_normal((ch, n)) * np.exp(-np.arange(n) / (n / 8.0))
    ir[:, 0] = 0.5
    wav.write_wav(path, ir.astype(np.float32), 48000, bits=32)
    return path


def _chain_stages(m, ir):
    """Delay, EQ fold, compressor, UPOLS reverb and limiter: the insert
    loop's kinds, at test size, in either package."""
    return m.Chain(m.Delay(0.003), m.Biquad("peaking", 1000.0, 1.0, 3.0),
                   m.Compressor(-18.0, 3.0, 2.0, 400.0),
                   m.ConvolutionReverb(ir, 0.7, 0.5), m.Limiter(-1.0))


@pytest.mark.parametrize("with_chain", [False, True], ids=["plain", "chain"])
def test_stream_matches_jax(tmp_path, with_chain):
    """Same frame count; codes <= 2 LSB at 24 bits without a chain
    (measured 1), <= 16 with the insert chain (measured 1).  Latency 216
    (the chain's 3 ms delay plus the limiter's 1.5 ms lookahead at 48 kHz)
    is trimmed in both."""
    src = str(tmp_path / "s.wav")
    wav.write_wav(src, _sig(2, 44100 + 333, seed=1), 44100, bits=24)
    kw = dict(target_rate=48000, seed=7)
    lat = None
    if with_chain:
        ir = _sig(1, 7000, seed=2, rate=48000, level=0.05, dc=0.0)[0]
        ir *= np.exp(-np.arange(7000) / 900.0).astype(np.float32)
        kw_j = dict(kw, chain=_chain_stages(jchain, ir))
        kw_t = dict(kw, chain=_chain_stages(tchain, ir))
        lat = 144 + 72
    else:
        kw_j = kw_t = kw
    nj = jstream.stream_resample_file(src, str(tmp_path / "j.wav"),
                                      JConfig(output_dir=str(tmp_path), **kw_j),
                                      chunk_seconds=0.4, latency_frames=lat)
    nt = tstream.stream_resample_file(src, str(tmp_path / "t.wav"),
                                      TConfig(output_dir=str(tmp_path), **kw_t),
                                      chunk_seconds=0.4, latency_frames=lat, device="cpu")
    assert nj == nt == -(-(44100 + 333) * 160 // 147)
    cj, _ = _codes(str(tmp_path / "j.wav"))
    ct, _ = _codes(str(tmp_path / "t.wav"))
    assert ct.shape == cj.shape
    assert np.abs(ct - cj).max() <= (16 if with_chain else 2)


def _write_src(tmp_path, ch, n, bits=24, seed=3, fmt="wav"):
    x = _sig(ch, n, seed=seed)
    src = str(tmp_path / f"src.{'aiff' if fmt == 'aiff' else 'wav'}")
    (write_aiff if fmt == "aiff" else wav.write_wav)(src, x, 44100, bits=bits)
    return src


#: each case's config; "chain" adds a delay, a 0.2 s reverb IR and a fast
#: limiter, whose ring-out (~0.25 s) stays under every chunk size
_INVARIANT = {
    "routing_silent": dict(ch=3, cfg=dict(channel_routing=[2, -1, 0])),
    "mono_fanout": dict(ch=1, cfg=dict(output_channels=2)),
    "latency_pos": dict(ch=2, lat=517),
    "latency_neg": dict(ch=2, lat=-300),
    "reverb_24": dict(ch=2, cfg=dict(reverb_mode=True, max_tail_seconds=1.0), chain=True),
    "reverb_16": dict(ch=2, cfg=dict(reverb_mode=True, max_tail_seconds=1.0, bits=16),
                      chain=True),
    "aiff_out": dict(ch=2, cfg=dict(output_format="aiff")),
    "flac_out": dict(ch=2, cfg=dict(output_format="flac"), chain=True, lat=360),
}


@pytest.mark.parametrize("case", sorted(_INVARIANT))
def test_stream_bytes_do_not_depend_on_chunk_size(tmp_path, case):
    """Byte-identical files at three chunk sizes (0.1, 0.23 and 0.5 s; with
    a chain 0.3, 0.45 and 0.7 s), the exact frame count (the tail within
    its cap in reverb mode, past the source), and routed-silent channels
    digital zero."""
    spec = _INVARIANT[case]
    n_in = 44100 + 4321
    src = _write_src(tmp_path, spec["ch"], n_in)
    kw = dict(output_dir=str(tmp_path), target_rate=48000, seed=11, **spec.get("cfg", {}))
    sizes = (0.1, 0.23, 0.5)
    if spec.get("chain"):
        ir = np.exp(-np.arange(9600) / 1200.0).astype(np.float32) * 0.3
        ir[0] = 0.5
        kw["chain"] = tchain.Chain(tchain.Delay(0.003), tchain.ConvolutionReverb(ir),
                                   tchain.Limiter(-1.0, 1.5, 3000.0))
        assert kw["chain"].tail_frames(48000) < 0.3 * 48000
        sizes = (0.3, 0.45, 0.7)
    cfg = TConfig(**kw)
    ext = {"aiff": "aiff", "flac": "flac"}.get(cfg.output_format, "wav")
    outs, ns = [], []
    for cs in sizes:
        out = str(tmp_path / f"o{cs}.{ext}")
        ns.append(tstream.stream_resample_file(src, out, cfg, chunk_seconds=cs,
                                               latency_frames=spec.get("lat"),
                                               device="cpu"))
        outs.append(_bytes(out))
    assert ns[0] == ns[1] == ns[2]
    assert outs[0] == outs[1] == outs[2]
    expect = -(-n_in * 160 // 147)
    if cfg.reverb_mode:
        assert expect < ns[0] <= expect + 48000
    else:
        assert ns[0] == expect
    codes, rate = _codes(str(tmp_path / f"o{sizes[0]}.{ext}"), cfg.bits)
    assert rate == 48000 and codes.shape == (len(cfg.channel_routing or [0] * (
        cfg.output_channels or spec["ch"])), ns[0])
    if case == "routing_silent":
        assert not codes[1].any() and codes[0].any()


@pytest.mark.parametrize("bits,fmt,cfg", [
    (24, "wav", dict(channel_routing=[2, -1, 0], latency_frames=37)),
    (16, "wav", dict(output_channels=2)),
    (24, "aiff", dict(remove_dc=True)),
], ids=["wav24_routing_dc_latency", "wav16_fanout", "aiff24_big_endian"])
def test_raw_wire_equals_float_wire(tmp_path, monkeypatch, bits, fmt, cfg):
    """Bitwise: container bytes decoded, fanned out, routed and DC-corrected
    on the device against the host's float path."""
    ch = 1 if "output_channels" in cfg else 3
    src = _write_src(tmp_path, ch, 30011, bits=bits, fmt=fmt)
    c = TConfig(output_dir=str(tmp_path), target_rate=48000, seed=2, quality="low", **cfg)
    raw = str(tmp_path / "raw.wav")
    flt = str(tmp_path / "flt.wav")
    n1 = tstream.stream_resample_file(src, raw, c, chunk_seconds=0.23, device="cpu")
    monkeypatch.setattr(WavReader, "raw_wire", lambda self: None)
    monkeypatch.setattr(AiffReader, "raw_wire", lambda self: None)
    n2 = tstream.stream_resample_file(src, flt, c, chunk_seconds=0.23, device="cpu")
    assert n1 == n2 and _bytes(raw) == _bytes(flt)


def test_empty_input_writes_no_frames(tmp_path):
    src = str(tmp_path / "e.wav")
    wav.write_wav(src, np.zeros((2, 0), np.float32), 44100, bits=24)
    for reverb in (False, True):
        cfg = TConfig(output_dir=str(tmp_path), target_rate=48000, reverb_mode=reverb)
        assert tstream.stream_resample_file(src, str(tmp_path / "o.wav"), cfg,
                                            device="cpu") == 0


def test_tail_detector_matches_jax():
    """Exact: the same window verdicts on the same statistic stream."""
    rng = np.random.default_rng(4)
    env = np.abs(rng.standard_normal(48000 * 2)).astype(np.float32)
    env[30000:] *= np.exp(-np.arange(66000) / 2000.0).astype(np.float32)
    for mode in ("peak", "rms"):
        kw = dict(output_dir="unused", reverb_mode=True, tail_mode=mode)
        dets = [m._TailDetector(48000, 25000, c(**kw), -3.0, -70.0)
                for m, c in ((jstream, JConfig), (tstream, TConfig))]
        ends = [[d.feed(env[i:i + 997]) for i in range(0, env.size, 997)] for d in dets]
        assert ends[0] == ends[1] and any(e is not None for e in ends[1])


def test_failed_stream_removes_part_and_refuses_out_equals_in(tmp_path, monkeypatch):
    src = _write_src(tmp_path, 1, 30000)
    cfg = TConfig(output_dir=str(tmp_path), target_rate=48000, quality="low", seed=1)
    out = str(tmp_path / "o.wav")

    def boom(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tstream, "resample_presliced", boom)
    with pytest.raises(RuntimeError, match="injected"):
        tstream.stream_resample_file(src, out, cfg, chunk_seconds=0.1, device="cpu")
    assert not os.path.exists(out) and not os.path.exists(out + ".part")
    monkeypatch.undo()
    assert tstream.stream_resample_file(src, out, cfg, chunk_seconds=0.1, device="cpu") > 0
    before = _bytes(src)
    with pytest.raises(ValueError, match="refusing"):
        tstream.stream_resample_file(src, src, cfg, device="cpu")
    assert _bytes(src) == before


@pytest.mark.parametrize("what", ["mesh", "normalize_lufs", "varispeed"])
def test_unported_stream_options_raise(tmp_path, what):
    """A mesh, loudness normalization and a varispeed rate, which used to
    raise, now stream to the exact frame count; on a mesh of 2 frames
    shards the bytes are the one-device stream's."""
    src = _write_src(tmp_path, 2, 25000)
    kw = dict(output_dir=str(tmp_path), quality="low",
              target_rate=44056 if what == "varispeed" else 48000)
    if what == "normalize_lufs":
        kw["normalize_lufs"] = -14.0
    out = str(tmp_path / "o.wav")
    if what == "mesh":
        from f9tpu_torch.parallel import make_mesh

        one = str(tmp_path / "one.wav")
        n = tstream.stream_resample_file(src, out, TConfig(**kw), chunk_seconds=0.3,
                                         mesh=make_mesh(1, 2, devices=["cpu"] * 2))
        assert n == tstream.stream_resample_file(src, one, TConfig(**kw), chunk_seconds=0.3,
                                                 device="cpu")
        assert n == design_cycle_bank(44100, 48000, quality="low").out_len(25000)
        assert _bytes(out) == _bytes(one)
    else:
        norm = {}
        n = tstream.stream_resample_file(src, out, TConfig(**kw), chunk_seconds=0.3,
                                         device="cpu", norm_info=norm)
        assert n == design_cycle_bank(44100, kw["target_rate"], quality="low").out_len(25000)
        assert os.path.exists(out) and bool(norm) == (what == "normalize_lufs")
    assert not os.path.exists(out + ".part")


@pytest.mark.parametrize("flags,item", [(["--frames-shards", "2"], "Multi-device"),
                                        (["--normalize-lufs=-14"], "Loudness")],
                         ids=["frames_shards", "normalize_lufs"])
def test_cli_stream_unported_flags_exit_2(tmp_path, capsys, flags, item):
    """``--frames-shards 2`` and ``--normalize-lufs`` exited 2 and now run:
    the first on a CPU mesh of 2 frames shards, with the one-device run's
    bytes; the second reporting the measured loudness and the gain."""
    src = _write_src(tmp_path, 2, 25000)
    rc = cli.main(["stream", src, "--out", str(tmp_path / "o.wav"), "--device", "cpu",
                   "--json", *flags])
    cap = capsys.readouterr()
    if item == "Loudness":
        res = json.loads(cap.out)
        assert rc == 0 and abs(res["source_lufs"] + res["applied_gain_db"] + 14.0) <= 0.011
    else:
        assert rc == 0, cap.err
        assert cli.main(["stream", src, "--out", str(tmp_path / "one.wav"), "--device",
                         "cpu", "--json"]) == 0
        capsys.readouterr()
        assert _bytes(str(tmp_path / "o.wav")) == _bytes(str(tmp_path / "one.wav"))


def test_cli_stream_matches_jax(tmp_path, capsys):
    """`stream --json` on both CLIs: the same summary fields and frame
    count, codes <= 2 LSB (measured 1)."""
    src = _write_src(tmp_path, 2, 44100 + 1234)
    flags = ["--rate", "48000", "--chunk-seconds", "0.3", "--seed", "3", "--latency", "20",
             "--routing", "1,0", "--json"]
    out = {}
    for name, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        out[name] = str(tmp_path / f"{name}.wav")
        assert mod.main(["stream", src, "--out", out[name], *flags, *extra]) == 0
        out[name] = (out[name], json.loads(capsys.readouterr().out))
    (jp, js), (tp, ts) = out["jax"], out["torch"]
    for k in ("out_frames", "rate", "seconds", "bits", "format"):
        assert ts[k] == js[k], k
    assert ts["device"] == "cpu"
    cj, _ = _codes(jp)
    ct, _ = _codes(tp)
    assert ct.shape == cj.shape == (2, js["out_frames"])
    assert np.abs(ct - cj).max() <= 2, np.abs(ct - cj).max()


def test_cli_stream_chain_flags_and_formats(tmp_path, capsys):
    """The chain flags reach the stream (calibrated latency given by hand),
    the --out extension picks the container, and two chunk sizes above the
    chain's ring-out (fast releases keep it at ~0.36 s) write the same
    bytes."""
    src = _write_src(tmp_path, 2, 66150)
    ir = _ir(str(tmp_path / "ir.wav"), 2)
    outs = []
    for cs in ("0.4", "0.65"):
        out = str(tmp_path / f"o{cs}.flac")
        rc = cli.main(["stream", src, "--out", out, "--device", "cpu", "--rate", "48000",
                       "--chunk-seconds", cs, "--latency", "312", "--chain-delay-ms", "5",
                       "--chain-eq", "peaking:1000:1:3", "--chain-comp=-18:3:5:800",
                       "--chain-ir", ir, "--chain-limit=-0.3:1.5:3000", "--json"])
        assert rc == 0
        assert json.loads(capsys.readouterr().out)["format"] == "flac"
        outs.append(_bytes(out))
    assert outs[0] == outs[1]


# ------------------------------------------------- devices and the soak

def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["measure_latency", "get_or_measure", "impulse",
                                   "stream_resample_file", "stream_init", "sine",
                                   "log_sweep", "run_loop_test", "render_playlist",
                                   "stream_playlist"])
def test_entry_points_default_to_cuda(tmp_path, monkeypatch, entry):
    """With no device given each entry point asks for CUDA and, without a
    GPU, raises instead of running on the CPU."""
    from f9tpu_torch.ops.signal import impulse, log_sweep, sine
    from f9tpu_torch.pipeline.preview import render_playlist, stream_playlist
    from f9tpu_torch.pipeline.selftest import run_loop_test

    _no_cuda(monkeypatch)
    src = _write_src(tmp_path, 2, 3000)
    call = {
        "measure_latency": lambda: tcal.measure_latency(44100, 48000),
        "get_or_measure": lambda: tcal.CalibrationCache().get_or_measure(44100, 48000),
        "impulse": lambda: impulse(64),
        "stream_resample_file": lambda: tstream.stream_resample_file(
            src, str(tmp_path / "o.wav"), TConfig(output_dir=str(tmp_path))),
        "stream_init": lambda: tchain.Chain(tchain.Delay(0.01)).stream_init(48000, 2),
        "sine": lambda: sine(64, 48000),
        "log_sweep": lambda: log_sweep(64, 48000),
        "run_loop_test": lambda: run_loop_test(48000, 44100, seconds=0.01),
        "render_playlist": lambda: render_playlist([src], 48000),
        "stream_playlist": lambda: stream_playlist([src], 48000, str(tmp_path / "o.wav")),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        call()
    assert not os.path.exists(str(tmp_path / "o.wav.part"))


@pytest.mark.parametrize("part", ["pinned", "chain_fuzz", "stream_fuzz"])
def test_hw_soak_parts_on_cpu(tmp_path, part):
    """The soak's three parts at a fixed seed and few trials; each asserts
    0 ULP / identical bytes itself."""
    if part == "pinned":
        hw_soak.pinned_repro("cpu")
    elif part == "chain_fuzz":
        hw_soak.chain_fuzz(seed=99, trials=3, device="cpu")
    else:
        hw_soak.stream_fuzz(seed=7000, trials=3, work=str(tmp_path), device="cpu")
