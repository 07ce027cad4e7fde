"""The port's own copies of the JAX package's jax-free modules (config,
models, io, native) against the originals, bitwise.

The port keeps copies so that it imports nothing of the JAX package; these
tests hold each copy to its original on the same inputs: filter banks and
the float64 oracle, the processing config, every decoder whose input the
JAX package's own tests build (WAV 16/24/32-bit float, RF64, AIFF/AIFC,
FLAC, Sun .au), the encoders' bytes, and the g++ twins of the codecs."""

import dataclasses
import shutil
import struct

import numpy as np
import pytest

pytest.importorskip("torch")

from f9tpu import config as jconfig  # noqa: E402
from f9tpu import native as jnative  # noqa: E402
from f9tpu.io import aiff as jaiff  # noqa: E402
from f9tpu.io import codec as jcodec  # noqa: E402
from f9tpu.io import flac as jflac  # noqa: E402
from f9tpu.io import wav as jwav  # noqa: E402
from f9tpu.models import filters as jfilters  # noqa: E402
from f9tpu.models import oracle as joracle  # noqa: E402
from f9tpu_torch import config as tconfig  # noqa: E402
from f9tpu_torch import native as tnative  # noqa: E402
from f9tpu_torch.io import aiff as taiff  # noqa: E402
from f9tpu_torch.io import codec as tcodec  # noqa: E402
from f9tpu_torch.io import flac as tflac  # noqa: E402
from f9tpu_torch.io import wav as twav  # noqa: E402
from f9tpu_torch.models import filters as tfilters  # noqa: E402
from f9tpu_torch.models import oracle as toracle  # noqa: E402

#: the rate pairs of tests/test_torch_src.py, an integer ratio each way and
#: a varispeed pair (no dense matrix)
PAIRS = [(44100, 48000), (48000, 44100), (176400, 48000), (48000, 96000),
         (96000, 48000), (44100, 44056)]


def _sig(ch: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(0.4 * rng.standard_normal((ch, n)), -0.95, 0.95).astype(np.float32)


@pytest.mark.parametrize("quality", list(jfilters.QUALITY_PRESETS))
@pytest.mark.parametrize("ri,ro", PAIRS)
def test_bank_copy_is_bitwise(ri, ro, quality):
    j = jfilters.design_cycle_bank(ri, ro, quality=quality)
    t = tfilters.design_cycle_bank(ri, ro, quality=quality)
    assert (t.L, t.M, t.W, t.pad_front, t.taps_per_phase, t.dense_ok) == \
        (j.L, j.M, j.W, j.pad_front, j.taps_per_phase, j.dense_ok)
    for n in (0, 1, 12345, 1 << 20):
        assert t.out_len(n) == j.out_len(n)
    if j.G is None:
        assert t.G is None
    else:
        assert t.G.dtype == j.G.dtype and np.array_equal(t.G, j.G)
    assert tfilters.resolve_ratio(ri, ro) == jfilters.resolve_ratio(ri, ro)


def test_presets_and_kinds_are_the_same():
    assert tfilters.QUALITY_PRESETS == jfilters.QUALITY_PRESETS
    for kind in ("minphase", "lagrange"):
        j = jfilters.design_cycle_bank(44100, 48000, kind=kind)
        t = tfilters.design_cycle_bank(44100, 48000, kind=kind)
        assert t.pad_front == j.pad_front and np.array_equal(t.G, j.G)


@pytest.mark.parametrize("ri,ro,quality", [(44100, 48000, "high"), (48000, 44100, "medium"),
                                           (176400, 48000, "ultra"), (44100, 44056, "high")])
def test_oracle_copy_is_bitwise(ri, ro, quality):
    x = _sig(2, 3001, seed=ri % 101)
    j = joracle.resample_oracle(x, ri, ro, quality=quality)
    t = toracle.resample_oracle(x, ri, ro, quality=quality)
    assert t.dtype == j.dtype and np.array_equal(t, j)


def test_version_copy_is_the_same():
    from f9tpu import version as jversion
    from f9tpu_torch import version as tversion

    assert tversion.__version__ == jversion.__version__ == "0.3.0"


def test_config_copy_has_the_same_fields_and_defaults():
    j = jconfig.ProcessingConfig(output_dir="o")
    t = tconfig.ProcessingConfig(output_dir="o")
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.noise_floor_threshold_db == j.noise_floor_threshold_db
    assert tconfig.RECORDING_LENGTH_LATENCY_FACTOR == jconfig.RECORDING_LENGTH_LATENCY_FACTOR
    for src, lat in ((0, 0), (44100, 312), (10, -3)):
        assert tconfig.recording_length(src, lat) == jconfig.recording_length(src, lat)


@pytest.mark.parametrize("kw", [
    {"quality": "bogus"}, {"bits": 20}, {"kind": "cubic"}, {"output_dir": ""},
    {"noise_floor_margin_pct": 60}, {"channel_routing": [0, -2]},
    {"normalize_lufs": -80.0}, {"chain": object()}])
def test_config_copy_refuses_what_the_original_refuses(kw):
    args = {"output_dir": "o", **kw}
    with pytest.raises(ValueError) as je:
        jconfig.ProcessingConfig(**args).validate()
    with pytest.raises(ValueError) as te:
        tconfig.ProcessingConfig(**args).validate()
    # the chain message names each package's own Chain
    assert str(te.value).replace("f9tpu_torch.", "f9tpu.") == str(je.value)


def _same_decode(path):
    jx, jr = jcodec.read_audio(path)
    tx, tr = tcodec.read_audio(path)
    assert tr == jr and tx.dtype == jx.dtype and np.array_equal(tx, jx)
    ji, ti = jcodec.probe(path), tcodec.probe(path)
    assert dataclasses.asdict(ti) == dataclasses.asdict(ji)
    jp, tp = _raw(jcodec, path), _raw(tcodec, path)
    if isinstance(jp, str):          # the raw wire refuses float and odd widths
        assert tp == jp
    else:
        assert tp.dtype == jp.dtype and np.array_equal(tp, jp)


def _raw(codec, path):
    """The raw device-wire payload, or the refusal's message."""
    try:
        return codec.read_raw_pcm(path)[0]
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("bits,ch", [(16, 1), (24, 2), (32, 2)])
def test_wav_decode_is_bitwise(tmp_path, bits, ch):
    p = str(tmp_path / f"w{bits}.wav")
    jwav.write_wav(p, _sig(ch, 4097, seed=bits), 44100, bits=bits)
    _same_decode(p)


def test_rf64_header_and_reader_are_bitwise(tmp_path):
    for frames in (1000, 1 << 31):
        assert twav._wav_header(frames, 2, 48000, 24, is_float=False) == \
            jwav._wav_header(frames, 2, 48000, 24, is_float=False)
    # an RF64 file past 4 GiB of sparse zeros with real codes at its end
    p = str(tmp_path / "big.wav")
    frames = (0x1_0000_0000 // 6) + 64
    w = jwav.WavWriter(p, 2, 48000, bits=24)
    w._f.truncate(w._f.tell() + (frames - 8) * 6)
    w._f.seek(0, 2)
    w.frames_written = frames - 8
    w.append_codes(np.tile(np.array([[123456], [-654321]], np.int32), (1, 8)))
    w.close()
    ji, ti = jwav.probe_wav(p), twav.probe_wav(p)
    assert dataclasses.asdict(ti) == dataclasses.asdict(ji) and ti.num_frames == frames
    with jwav.WavReader(p) as jr, twav.WavReader(p) as tr:
        for start in (frames - 8, frames // 2):
            assert np.array_equal(tr.read(start, 8), jr.read(start, 8))


def _aifc(comp: bytes, payload: bytes, bits: int, frames: int) -> bytes:
    comm = (struct.pack(">hIh", 1, frames, bits)
            + jaiff._write_extended80(44100.0) + comp + b"\x00\x00")
    ssnd = struct.pack(">II", 0, 0) + payload
    body = b"AIFC" + b"FVER" + struct.pack(">II", 4, 0xA2805140)
    body += b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    return b"FORM" + struct.pack(">I", len(body)) + body


@pytest.mark.parametrize("form", ["aiff16", "aiff24", "sowt", "fl32"])
def test_aiff_decode_is_bitwise(tmp_path, form):
    p = str(tmp_path / f"{form}.aiff")
    x = _sig(2, 3001, seed=len(form))
    if form.startswith("aiff"):
        jaiff.write_aiff(p, x, 48000, bits=int(form[4:]))
    else:
        mono = x[0]
        if form == "sowt":
            payload = np.round(mono * 32768).clip(-32768, 32767).astype("<i2").tobytes()
            blob = _aifc(b"sowt", payload, 16, mono.size)
        else:
            blob = _aifc(b"fl32", mono.astype(">f4").tobytes(), 32, mono.size)
        with open(p, "wb") as f:
            f.write(blob)
    _same_decode(p)


@pytest.mark.parametrize("bits", [16, 24])
def test_flac_decode_is_bitwise(tmp_path, bits):
    p = str(tmp_path / f"f{bits}.flac")
    jflac.write_flac(p, _sig(2, 9000, seed=bits), 44100, bits=bits)
    _same_decode(p)
    jc = jflac.read_flac_codes(p)
    tc = tflac.read_flac_codes(p)
    assert np.array_equal(np.asarray(tc[0]), np.asarray(jc[0]))


def _au(enc: int, payload: bytes, ch: int) -> bytes:
    return b".snd" + struct.pack(">IIIII", 28, len(payload), enc, 44100, ch) + b"\0" * 4 + payload


@pytest.mark.parametrize("enc", [1, 2, 3, 4, 5, 6, 7, 27])
def test_au_decode_is_bitwise(tmp_path, enc):
    rng = np.random.default_rng(enc)
    n, ch = 2000, 2
    if enc in (1, 2, 27):
        payload = rng.integers(0, 256, n * ch, dtype=np.uint8).tobytes()
    elif enc in (3, 4, 5):
        nb = enc - 1
        payload = rng.integers(0, 256, n * ch * nb, dtype=np.uint8).tobytes()
    else:
        dt = ">f4" if enc == 6 else ">f8"
        payload = _sig(1, n * ch, seed=enc)[0].astype(dt).tobytes()
    p = str(tmp_path / f"e{enc}.au")
    with open(p, "wb") as f:
        f.write(_au(enc, payload, ch))
    _same_decode(p)


@pytest.mark.parametrize("bits", [16, 24])
def test_encoder_bytes_are_bitwise(tmp_path, bits):
    rng = np.random.default_rng(bits)
    ch, n = 2, 5003
    lim = 1 << (bits - 1)
    codes = rng.integers(-lim, lim, (ch, n)).astype(np.int32)
    nb = bits // 8
    inter = (np.ascontiguousarray(codes.T).reshape(-1).astype(np.int64) & ((1 << bits) - 1))
    payload = np.stack([(inter >> (8 * k)) & 0xFF for k in range(nb)], -1).astype(np.uint8)
    payload = payload.reshape(-1)
    for name, jw, tw, args in (
            ("wav", jwav.write_wav_payload, twav.write_wav_payload, (payload, ch, 48000)),
            ("aiff", jaiff.write_aiff_payload, taiff.write_aiff_payload, (payload, ch, 48000)),
            ("flac", jflac.write_flac_codes, tflac.write_flac_codes, (codes, 48000))):
        pj, pt = str(tmp_path / f"j.{name}"), str(tmp_path / f"t.{name}")
        jw(pj, *args, bits=bits)
        tw(pt, *args, bits=bits)
        with open(pj, "rb") as fj, open(pt, "rb") as ft:
            assert ft.read() == fj.read(), name


def test_native_twins_are_bitwise(tmp_path):
    """The port's g++ build of the same source, into its own build
    directory, against the JAX package's."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (the native twins are built from source)")
    assert tnative.available(), tnative.build_error()
    assert jnative.available(), jnative.build_error()
    assert "f9tpu_torch" in tnative._LIB and tnative._LIB != jnative._LIB
    rng = np.random.default_rng(11)
    raw = rng.integers(0, 256, 3 * 4096, dtype=np.uint8)
    assert np.array_equal(tnative.unpack24_to_f32(raw), jnative.unpack24_to_f32(raw))
    codes = rng.integers(-(1 << 23), 1 << 23, 4096).astype(np.int32)
    assert np.array_equal(tnative.pack24_from_i32(codes), jnative.pack24_from_i32(codes))
    planar = _sig(3, 1001, seed=2)
    inter = tnative.interleave_f32(planar)
    assert np.array_equal(inter, jnative.interleave_f32(planar))
    assert np.array_equal(tnative.deinterleave_f32(inter, 3), jnative.deinterleave_f32(inter, 3))
    blob = raw.tobytes()
    assert tnative.ogg_crc_native(blob) == jnative.ogg_crc_native(blob)
    c2 = rng.integers(-(1 << 15), 1 << 15, (2, 4096)).astype(np.int32)
    assert (tnative.flac_encode_frame(c2, 16, 3, 4096, 44100)
            == jnative.flac_encode_frame(c2, 16, 3, 4096, 44100))
    H = rng.standard_normal((160, 32))
    x = rng.standard_normal(3000)
    assert np.array_equal(tnative.resample_oracle_native(x, H, 160, 147, 16, 3200),
                          jnative.resample_oracle_native(x, H, 160, 147, 16, 3200))
    # the FLAC decoder's native frame loop through each package's reader
    p = str(tmp_path / "n.flac")
    jflac.write_flac(p, _sig(2, 9000, seed=9), 44100, bits=24)
    assert np.array_equal(tflac.read_flac(p)[0], jflac.read_flac(p)[0])
