"""Sub-file progress and the chunked codecs (`tests/test_progress.py`), through
the port and the JAX package.

- The chunked WAV and AIFF code writers and the payload writers give the
  bytes of the one-shot writers, and the port's bytes are JAX's; the
  callbacks are monotone and end at 1.0.
- `read_audio_progress` decodes what `read_audio` decodes, a truncated file
  too, in both packages, with the same callbacks.
- The chunked AIFF writer refuses a bad bit depth before it opens the file.
- The scheduler's sub-file progress (with `SUBFILE_PROGRESS_FRAMES` and
  `SUBFILE_PROGRESS_CHUNK` patched on each scheduler) and the short file's
  stage ticks: the port's manifest history equals JAX's tick for tick.
"""

import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import aiff as jaiff  # noqa: E402
from f9tpu.io import codec as jcodec  # noqa: E402
from f9tpu.io import wav as jwav  # noqa: E402
from f9tpu.pipeline import manifest as jmanifest  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io import aiff as taiff  # noqa: E402
from f9tpu_torch.io import codec as tcodec  # noqa: E402
from f9tpu_torch.io import wav as twav  # noqa: E402
from f9tpu_torch.pipeline import manifest as tmanifest  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

#: (wav, aiff, codec, manifest, scheduler, config class, BatchProcessor keywords)
PACKAGES = {"jax": (jwav, jaiff, jcodec, jmanifest, jsched, JConfig, {}),
            "torch": (twav, taiff, tcodec, tmanifest, tsched, TConfig, {"device": "cpu"})}


def _codes(channels, frames, seed=0, bits=24):
    rng = np.random.default_rng(seed)
    lim = 1 << (bits - 1)
    return rng.integers(-lim, lim, size=(channels, frames)).astype(np.int32)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _chunked_vs_whole(tmp_path, write, ext: str, args, kw, chunk_frames: int):
    """Each package's one-shot and chunked bytes and chunked callbacks."""
    out = {}
    for name in PACKAGES:
        a, b = str(tmp_path / f"{name}_one.{ext}"), str(tmp_path / f"{name}_chunk.{ext}")
        fn = write(name)
        fn(a, *args, **kw)
        seen = []
        fn(b, *args, **kw, progress_cb=seen.append, chunk_frames=chunk_frames)
        assert _read(a) == _read(b), name
        assert seen == sorted(seen) and seen[-1] == 1.0, (name, seen)
        out[name] = (_read(b), seen)
    assert out["torch"] == out["jax"]
    return out["torch"][1]


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_wav_codes_chunked_byte_identical(tmp_path, bits):
    seen = _chunked_vs_whole(tmp_path, lambda p: PACKAGES[p][0].write_wav_codes, "wav",
                             (_codes(2, 7001, seed=bits), 44100), dict(bits=bits), 1000)
    assert len(seen) == 8


@pytest.mark.parametrize("bits", [16, 24])
def test_aiff_codes_chunked_byte_identical(tmp_path, bits):
    seen = _chunked_vs_whole(tmp_path, lambda p: PACKAGES[p][1].write_aiff_codes, "aiff",
                             (_codes(2, 5003, seed=bits), 44100), dict(bits=bits), 700)
    assert len(seen) > 3


def test_payload_writers_chunked_byte_identical(tmp_path):
    rng = np.random.default_rng(7)
    frames, ch = 4096, 2
    payload = rng.integers(0, 256, size=(frames * ch * 3,)).astype(np.uint8)
    for fn, ext in (("write_wav_payload", "wav"), ("write_aiff_payload", "aiff")):
        mod = 0 if ext == "wav" else 1
        seen = _chunked_vs_whole(tmp_path, lambda p: getattr(PACKAGES[p][mod], fn), ext,
                                 (payload, ch, 48000), dict(bits=24), 500)
        assert len(seen) > 3


def _source(tmp_path, mk: str, x: np.ndarray) -> str:
    if mk == "wav8":
        # hand-built unsigned 8-bit PCM (no writer emits it)
        p = str(tmp_path / "a.wav")
        u8 = np.clip(np.round(x * 128.0) + 128.0, 0, 255).astype(np.uint8)
        payload = np.ascontiguousarray(u8.T).reshape(-1).tobytes()
        hdr = (b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
               + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 2, 32000, 32000 * 2, 2, 8)
               + b"data" + struct.pack("<I", len(payload)))
        with open(p, "wb") as f:
            f.write(hdr + payload)
        return p
    if mk == "aiff24":
        p = str(tmp_path / "a.aiff")
        jaiff.write_aiff(p, x, 32000, bits=24)
        return p
    p = str(tmp_path / "a.wav")
    jwav.write_wav(p, x, 32000, bits={"wav16": 16, "wav24": 24, "wav_f32": 32}[mk])
    return p


@pytest.mark.parametrize("mk", ["wav8", "wav16", "wav24", "wav_f32", "aiff24"])
def test_read_audio_progress_matches_read_audio(tmp_path, mk):
    rng = np.random.default_rng(11)
    x = (0.4 * rng.standard_normal((2, 6007))).astype(np.float32)
    p = _source(tmp_path, mk, x)
    got = {}
    for name, (_, _, codec, *_rest) in PACKAGES.items():
        ref, rate_ref = codec.read_audio(p)
        seen = []
        y, rate = codec.read_audio_progress(p, seen.append, chunk_frames=1111)
        assert rate == rate_ref
        np.testing.assert_array_equal(y, ref)
        assert seen == sorted(seen) and seen[-1] == 1.0 and len(seen) == 6
        got[name] = (y, rate, seen)
    np.testing.assert_array_equal(got["torch"][0], got["jax"][0])
    assert got["torch"][1:] == got["jax"][1:]


def test_read_audio_progress_truncated_file(tmp_path):
    """Mid-frame truncation clips to whole frames, like read_audio."""
    x = (0.2 * np.random.default_rng(3).standard_normal((2, 4000))).astype(np.float32)
    p = str(tmp_path / "t.wav")
    jwav.write_wav(p, x, 16000, bits=24)
    raw = _read(p)
    with open(p, "wb") as f:
        f.write(raw[: len(raw) - 7])           # chop mid-frame
    got = {}
    for name, (_, _, codec, *_rest) in PACKAGES.items():
        ref, _ = codec.read_audio(p)
        got[name], _ = codec.read_audio_progress(p, lambda fr: None, chunk_frames=999)
        np.testing.assert_array_equal(got[name], ref)
    np.testing.assert_array_equal(got["torch"], got["jax"])


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_aiff_bad_bits_raises_before_writing(tmp_path, pkg):
    """The chunked AIFF writer validates the bit depth before it opens the
    file, so a deliverable already at that path survives."""
    aiff = PACKAGES[pkg][1]
    p = str(tmp_path / "keep.aiff")
    with open(p, "wb") as f:
        f.write(b"PRECIOUS")
    with pytest.raises(ValueError, match="bit depth"):
        aiff.write_aiff_codes(p, _codes(1, 100), 44100, bits=8,
                              progress_cb=lambda fr: None, chunk_frames=10)
    assert _read(p) == b"PRECIOUS"


def _history(monkeypatch, manifest_mod, updates: bool):
    """Record every progress value the manifest is given, per path."""
    history: dict[str, list] = {}
    cls = manifest_mod.JobManifest
    orig_set, orig_update = cls.set_progress, cls.update

    def rec_set(self, path, progress):
        history.setdefault(path, []).append(round(progress, 4))
        orig_set(self, path, progress)

    def rec_update(self, path, status, progress=None, **kw):
        if progress is not None:
            history.setdefault(path, []).append(round(progress, 4))
        return orig_update(self, path, status, progress=progress, **kw)

    monkeypatch.setattr(cls, "set_progress", rec_set)
    if updates:
        monkeypatch.setattr(cls, "update", rec_update)
    return history


def _float_wav(tmp_path, name, frames, seed):
    x = (0.1 * np.random.default_rng(seed).standard_normal((1, frames))).astype(np.float32)
    src = str(tmp_path / name)
    jwav.write_wav(src, x, 8000, bits=32)      # float WAV: the host decode path
    return src


def test_scheduler_subfile_progress(tmp_path, monkeypatch):
    """A long file's manifest progress moves through decode (0 -> 0.3),
    staged (0.4), device (0.7) and encode (0.7 -> 1.0), in both packages,
    and the port's ticks are JAX's."""
    frames = 20000
    src = _float_wav(tmp_path, "long.wav", frames, seed=21)
    hist = {}
    for name, (wav, _, _, manifest, sched, conf, extra) in PACKAGES.items():
        monkeypatch.setattr(sched, "SUBFILE_PROGRESS_FRAMES", 4096)
        monkeypatch.setattr(sched, "SUBFILE_PROGRESS_CHUNK", 4096)
        history = _history(monkeypatch, manifest, updates=True)
        cfg = conf(output_dir=str(tmp_path / name), target_rate=8000, quality="low",
                   bucket_frames=(1 << 15,), dither=False)
        assert sched.BatchProcessor(cfg, **extra).run([src]).completed == 1
        h = hist[name] = history[src]
        assert h == sorted(h) and h[-1] == 1.0, (name, h)
        assert len([v for v in h if 0.0 < v < 0.3]) >= 3, h   # 20000 / 4096: 4 ticks
        assert 0.4 in h and 0.7 in h, h
        assert len([v for v in h if 0.7 < v < 1.0]) >= 3, h
        y, r = wav.read_wav(sched.build_output_path(src, cfg.output_dir, cfg.postfix))
        assert r == 8000 and y.shape[-1] == frames
        monkeypatch.undo()
    assert hist["torch"] == hist["jax"]


def test_scheduler_short_file_progress_unchanged(tmp_path, monkeypatch):
    """Short files keep the cheap stage ticks (no chunked decode or encode),
    the same in both packages."""
    src = _float_wav(tmp_path, "short.wav", 4000, seed=5)
    hist = {}
    for name, (_, _, _, manifest, sched, conf, extra) in PACKAGES.items():
        history = _history(monkeypatch, manifest, updates=False)
        cfg = conf(output_dir=str(tmp_path / name), target_rate=8000, quality="low",
                   bucket_frames=(4096,), dither=False)
        assert sched.BatchProcessor(cfg, **extra).run([src]).completed == 1
        hist[name] = history.get(src, [])
        assert hist[name] and all(v in (0.4, 0.7) for v in hist[name]), hist[name]
        monkeypatch.undo()
    assert hist["torch"] == hist["jax"]
