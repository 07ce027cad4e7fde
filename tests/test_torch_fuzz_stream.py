"""The streaming config fuzz (`tests/test_fuzz_configs.py`'s stream and
sharded-stream trials), through the port and the JAX package on the CPU.

The draws are the JAX tests' draw for draw, so a seed makes the same source
and config in both.  Seeds 7000-7007 draw every container (WAV, AIFF, FLAC,
MP3 through the test-only `avref` encoder, FLAC where it is missing), the
routing and mono fan-out cases, normalization, reverb, latency, both filter
kinds and every output format; seeds 9000-9004 draw, for the sharded stream,
both containers, routing and fan-out, normalization, the chain, latency and
reverb (`test_stream_draws_cover_every_feature`).

Held to the port's own contract, which is tighter than JAX's:
- the port's bytes at 0.11 s and 0.34 s chunks are identical (JAX's test
  allows 2 codes there);
- on a mesh of 4 frames shards of the CPU the port's stream equals its
  one-device stream byte for byte, length included, reverb too (JAX allows a
  hop of length and 4 codes).

Against JAX: the same frame count, and codes within 2 LSB, the port-vs-JAX
bound of `tests/test_torch_stream.py` (set there at -20 dBFS; these sources
are white noise at 0.3, peaks past full scale, where JAX's float32 streamed
convolution is known to read up to 3 LSB from the float64 oracle, ROADMAP
Queue 3; on these draws it stays within 2 of the port).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import write_wav  # noqa: E402
from f9tpu.io.aiff import write_aiff  # noqa: E402
from f9tpu.io.flac import write_flac_codes  # noqa: E402
from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.pipeline import stream as jstream  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io import codec  # noqa: E402
from f9tpu_torch.models import design_cycle_bank  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.parallel import make_mesh  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402

STREAM_SEEDS = tuple(range(7000, 7008))
SHARDED_SEEDS = tuple(range(9000, 9005))


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread (see `tests/test_torch_stream.py`)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _avref():
    try:
        import avref
    except ImportError:
        return None
    return avref if avref.available() else None


def _routing(rng, ch: int, kw: dict) -> None:
    if ch == 1 and rng.integers(2):
        kw["output_channels"] = 2
    elif ch == 4 and rng.integers(2):
        kw["channel_routing"] = [3, 0, -1, 1]


def _draw_stream(seed: int):
    """`test_random_streaming_config_end_to_end`'s draws: ``(x, container,
    kw, latency)``; an MP3 the test cannot encode becomes FLAC, as there."""
    rng = np.random.default_rng(seed)
    ch = int(rng.choice([1, 2, 4]))
    frames = int(rng.integers(3000, 30_000))
    x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
    container = str(rng.choice(["wav", "aiff", "flac", "mp3"]))
    if container == "mp3" and (_avref() is None or ch > 2):
        container = "flac"
    kw = dict(quality="low",
              target_rate=int(rng.choice([48000, 32000, 44056])),
              kind=str(rng.choice(["sinc", "minphase"])),
              bits=int(rng.choice([16, 24])),
              dither=bool(rng.integers(2)),
              remove_dc=bool(rng.integers(2)),
              seed=int(rng.integers(100)),
              gain_db=float(rng.choice([0.0, -3.0])),
              output_format=str(rng.choice(["wav", "aiff", "flac"])))
    lat = int(rng.integers(1, 300)) if rng.integers(2) else 0
    _routing(rng, ch, kw)
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = -18.0
    if rng.integers(3) == 0:
        kw.update(reverb_mode=True, noise_floor_db=-85.0, max_tail_seconds=0.3)
    return x, container, kw, lat


def _draw_sharded(seed: int):
    """`test_random_sharded_streaming_matches_single_chip`'s draws: ``(x,
    container, kw, latency)``, the chain as the flag ``"chain"``."""
    rng = np.random.default_rng(seed)
    ch = int(rng.choice([1, 2, 4]))
    frames = int(rng.integers(20_000, 50_000))
    x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
    container = str(rng.choice(["wav", "aiff"]))
    kw = dict(quality="low",
              target_rate=int(rng.choice([48000, 32000, 44056])),
              bits=int(rng.choice([16, 24])),
              dither=bool(rng.integers(2)),
              remove_dc=bool(rng.integers(2)),
              seed=int(rng.integers(100)),
              gain_db=float(rng.choice([0.0, -3.0])))
    lat = int(rng.integers(1, 300)) if rng.integers(2) else 0
    _routing(rng, ch, kw)
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = -18.0
    kw["chain"] = bool(rng.integers(2))
    if rng.integers(3) == 0:
        kw.update(reverb_mode=True, noise_floor_db=-85.0, max_tail_seconds=0.3)
    return x, container, kw, lat


def _write_source(path_stem: str, x: np.ndarray, container: str) -> str:
    src = f"{path_stem}.{container}"
    codes24 = np.clip(np.round(x.astype(np.float64) * (1 << 23)),
                      -(1 << 23), (1 << 23) - 1)
    if container == "flac":
        write_flac_codes(src, codes24.astype(np.int64), 44100, bits=24)
    elif container == "mp3":
        _avref().encode_file_opts("libmp3lame", src, "mp3", codes24.astype(np.int32),
                                  44100, 24, bit_rate=192000)
    else:
        (write_wav if container == "wav" else write_aiff)(src, x, 44100, bits=24)
    return src


def _configs(kw: dict, out_dir: str):
    """(JAX config, port config) for the drawn keywords."""
    kw = dict(kw, output_dir=out_dir)
    chain = kw.pop("chain", False)
    return (JConfig(**kw, chain=jchain.Chain(jchain.Gain(-1.5), jchain.Delay(0.002))
                    if chain else None),
            TConfig(**kw, chain=tchain.Chain(tchain.Gain(-1.5), tchain.Delay(0.002))
                    if chain else None))


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _codes(path: str, bits: int) -> np.ndarray:
    y, _ = codec.read_audio(path)
    return np.round(np.asarray(y, np.float64) * (1 << (bits - 1))).astype(np.int64)


def _assert_near_jax(t_path: str, j_path: str, bits: int) -> None:
    tc, jc = _codes(t_path, bits), _codes(j_path, bits)
    assert tc.shape == jc.shape
    assert np.abs(tc - jc).max() <= 2, int(np.abs(tc - jc).max())


def _expected_frames(frames: int, cfg, n: int) -> None:
    expect = design_cycle_bank(44100, cfg.target_rate, quality="low",
                               kind=cfg.kind).out_len(frames)
    if cfg.reverb_mode:
        assert expect <= n <= expect + int(0.3 * cfg.target_rate)
    else:
        assert n == expect


@pytest.mark.parametrize("seed", STREAM_SEEDS)
def test_random_stream_matches_jax(tmp_path, seed):
    x, container, kw, lat = _draw_stream(seed)
    src = _write_source(str(tmp_path / "s"), x, container)
    jcfg, tcfg = _configs(kw, str(tmp_path))
    ext = {"aiff": "aiff", "flac": "flac"}.get(tcfg.output_format, "wav")
    outs = {c: str(tmp_path / f"t{c}.{ext}") for c in (0.11, 0.34)}
    ns = [tstream.stream_resample_file(src, out, tcfg, chunk_seconds=c, latency_frames=lat,
                                       device="cpu") for c, out in outs.items()]
    assert ns[0] == ns[1] and _bytes(outs[0.11]) == _bytes(outs[0.34]), (seed, kw, lat)
    j_out = str(tmp_path / f"j.{ext}")
    nj = jstream.stream_resample_file(src, j_out, jcfg, chunk_seconds=0.11, latency_frames=lat)
    assert ns[0] == nj, (seed, ns, nj)
    _expected_frames(x.shape[1], tcfg, ns[0])
    y, rate = codec.read_audio(outs[0.11])
    assert rate == tcfg.target_rate and np.isfinite(y).all() and y.shape[1] == ns[0]
    if "channel_routing" in kw:
        assert np.all(y[2] == 0.0)
    _assert_near_jax(outs[0.11], j_out, tcfg.bits)


@pytest.mark.parametrize("seed", SHARDED_SEEDS)
def test_random_sharded_stream_equals_one_device(tmp_path, seed):
    x, container, kw, lat = _draw_sharded(seed)
    src = _write_source(str(tmp_path / "s"), x, container)
    jcfg, tcfg = _configs(kw, str(tmp_path))
    one, sharded, j_out = (str(tmp_path / f"{n}.wav") for n in ("one", "sharded", "jax"))
    n1 = tstream.stream_resample_file(src, one, tcfg, chunk_seconds=0.4, latency_frames=lat,
                                      device="cpu")
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    n2 = tstream.stream_resample_file(src, sharded, tcfg, chunk_seconds=0.1, mesh=mesh,
                                      latency_frames=lat)
    assert n1 == n2 and _bytes(one) == _bytes(sharded), (seed, kw, lat, n1, n2)
    nj = jstream.stream_resample_file(src, j_out, jcfg, chunk_seconds=0.4, latency_frames=lat)
    assert n1 == nj, (seed, n1, nj)
    _expected_frames(x.shape[1], tcfg, n1)
    if "channel_routing" in kw:
        assert np.all(codec.read_audio(sharded)[0][2] == 0.0)
    _assert_near_jax(one, j_out, tcfg.bits)


def test_stream_draws_cover_every_feature():
    stream = [_draw_stream(s) for s in STREAM_SEEDS]
    sharded = [_draw_sharded(s) for s in SHARDED_SEEDS]

    def features(draws):
        seen: dict[str, set] = {}
        for x, container, kw, lat in draws:
            route = ("fan-out" if "output_channels" in kw
                     else "routing" if "channel_routing" in kw else "none")
            for key, v in (("container", container), ("route", route), ("latency", lat > 0),
                           ("normalize", "normalize_lufs" in kw),
                           ("reverb", kw.get("reverb_mode", False)),
                           ("kind", kw.get("kind")), ("format", kw.get("output_format")),
                           ("rate", kw["target_rate"]), ("bits", kw["bits"]),
                           ("dither", kw["dither"]), ("chain", kw.get("chain"))):
                seen.setdefault(key, set()).add(v)
        return seen

    both, flags = {True, False}, {"route": {"none", "fan-out", "routing"},
                                  "rate": {48000, 32000, 44056}, "bits": {16, 24}}
    want = dict(flags, container={"wav", "aiff", "flac", "mp3"} if _avref() else
                {"wav", "aiff", "flac"}, latency=both, normalize=both, reverb=both,
                kind={"sinc", "minphase"}, format={"wav", "aiff", "flac"}, dither=both,
                chain={None})
    assert features(stream) == want
    want = dict(flags, container={"wav", "aiff"}, latency=both, normalize=both, reverb=both,
                kind={None}, format={None}, dither=both, chain=both)
    assert features(sharded) == want
