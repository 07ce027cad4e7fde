"""The port's playlist preview against the JAX package's, and its own byte
contract, on the CPU.

Port against JAX (`render_playlist` on the same files): item start frames
and frame counts exact; samples within 2 LSB at 24 bits on -20 dBFS input
(the JAX preview's SRC is a float32 convolution, the port's CPU path a
float64 fold or gather).  Within the port: `stream_playlist`'s samples
equal `render_playlist` + `write_wav`'s byte for byte (the data chunk; the
streamed file's header carries the RF64-ready JUNK chunk of `WavWriter`),
and its memory does not grow with the programme.  The placement rules and
errors are the JAX package's."""

import importlib
import os
import tracemalloc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu.io import wav  # noqa: E402
from f9tpu_torch.io import codec  # noqa: E402
from f9tpu_torch.ops import routing as trouting  # noqa: E402
from f9tpu_torch.pipeline import preview as tpv  # noqa: E402

jpv = importlib.import_module("f9tpu.pipeline.preview")


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite runs files in parallel processes; see tests/test_torch_stream.py
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_lib(tmp_path, n=3, rate=44100, channels=2, seconds=0.25, seed=0):
    """`tests/test_pipeline.py`'s library: ragged lengths, a tone per item."""
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        frames = int(seconds * rate) + 37 * i
        t = np.arange(frames) / rate
        x = np.stack([(0.4 * np.sin(2 * np.pi * (220 + 110 * i) * t)).astype(np.float32)
                      for _ in range(channels)])
        p = str(tmp_path / f"src_{i}.wav")
        wav.write_wav(p, x, rate, bits=24)
        paths.append(p)
    return paths


def _quiet(path, rate, channels, seconds, seed):
    """Two tones and noise at about -20 dBFS RMS, 24-bit."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    f = rng.uniform(150.0, 4000.0, size=(channels, 2))
    x = (0.1 * np.sin(2 * np.pi * f[:, :1] * t) + 0.05 * np.sin(2 * np.pi * f[:, 1:] * t)
         + 0.01 * rng.standard_normal((channels, n)))
    wav.write_wav(path, x.astype(np.float32), rate, bits=24)
    return path


def _mixed_rate_lib(tmp_path):
    """Items at 44.1 k (stereo), 96 k (dense bank), 48 k (rate-matched,
    mono) and 44,056 Hz (a varispeed bank), for a 48 k session."""
    return [_quiet(str(tmp_path / f"q{i}.wav"), r, ch, s, 40 + i)
            for i, (r, ch, s) in enumerate([(44100, 2, 0.3), (96000, 2, 0.2),
                                            (48000, 1, 0.25), (44056, 2, 0.3)])]


def _codes(x):
    return np.clip(np.round(np.asarray(x, np.float64) * (1 << 23)), -(1 << 23),
                   (1 << 23) - 1).astype(np.int64)


def _items(items):
    return [(os.path.basename(i.path), i.start_frame, i.num_frames) for i in items]


def _data_chunk(path):
    with open(path, "rb") as f:
        blob = f.read()
    return blob[blob.index(b"data"):]


@pytest.mark.parametrize("kw", [
    dict(output_channels=2, monitor=True),
    dict(output_channels=8, monitor=True, target_channels=[2, 3]),
    dict(output_channels=4, monitor=True, loops=2, target_channels=[0, 1],
         monitor_channels=(0, 1), silence_ms=70),
], ids=["plain_monitor", "bus8_targets", "loops2_overlap"])
def test_render_playlist_matches_jax(tmp_path, kw):
    files = _mixed_rate_lib(tmp_path)
    tm, tmon, titems = tpv.render_playlist(files, 48000, device="cpu", **kw)
    jm, jmon, jitems = jpv.render_playlist(files, 48000, **kw)
    assert _items(titems) == _items(jitems)
    assert tm.shape == jm.shape and tm.dtype == np.float32
    assert np.abs(_codes(tm) - _codes(jm)).max() <= 2
    assert tmon.shape == jmon.shape
    assert np.abs(_codes(tmon) - _codes(jmon)).max() <= 2
    assert tpv.projected_frames(files, 48000, silence_ms=kw.get("silence_ms", 150),
                                loops=kw.get("loops", 1)) == tm.shape[1]
    assert tpv.projected_frames(files, 48000) == jpv.projected_frames(files, 48000)


def test_render_playlist(tmp_path):
    files = make_lib(tmp_path, n=2, rate=44100, channels=1, seconds=0.1)
    main, mon, items = tpv.render_playlist(files, 44100, silence_ms=100,
                                           output_channels=2, monitor=True, device="cpu")
    silence = 4410
    n0 = items[0].num_frames
    assert items[1].start_frame == n0 + silence
    assert np.all(main[:, n0:n0 + silence] == 0)
    assert mon.shape[0] == 2 and main.shape[0] == 2


def test_render_playlist_channel_targeting(tmp_path):
    files = make_lib(tmp_path, n=2, rate=44100, channels=1, seconds=0.1)
    main, mon, items = tpv.render_playlist(files, 44100, silence_ms=50, output_channels=8,
                                           monitor=False, target_channels=[4, 5],
                                           device="cpu")
    assert main.shape[0] == 8 and mon is None
    assert np.any(main[4] != 0) and np.any(main[5] != 0)
    for c in (0, 1, 2, 3, 6, 7):
        assert np.all(main[c] == 0)
    np.testing.assert_array_equal(main[4], main[5])


def test_render_playlist_dual_render_monitoring(tmp_path):
    files = make_lib(tmp_path, n=1, rate=44100, channels=1, seconds=0.1)
    main, mon, _ = tpv.render_playlist(files, 44100, output_channels=8, monitor=True,
                                       target_channels=[6, 7], monitor_channels=(2, 3),
                                       device="cpu")
    assert mon is not None and mon.shape[0] == 2
    np.testing.assert_array_equal(main[2], mon[0])
    np.testing.assert_array_equal(main[3], mon[1])
    np.testing.assert_array_equal(main[6], main[7])
    assert np.all(main[0] == 0) and np.all(main[5] == 0)
    main2, mon2, _ = tpv.render_playlist(files, 44100, output_channels=4, monitor=True,
                                         target_channels=[0, 1], monitor_channels=(0, 1),
                                         device="cpu")
    np.testing.assert_allclose(main2[0], mon2[0] * 2, atol=1e-7)


@pytest.mark.parametrize("kw, match", [
    (dict(output_channels=2, target_channels=[5]), "outside"),
    (dict(output_channels=4, target_channels=[1, 1]), "duplicate"),
    (dict(output_channels=2, monitor=True, monitor_channels=(0, 9)), "outside"),
    (dict(output_channels=4, monitor=True, monitor_channels=(1, 1),
          target_channels=[2, 3]), "DISTINCT"),
    (dict(output_channels=4, monitor=True, monitor_channels=(2, 3)), "requires"),
    (dict(output_channels=4, target_channels=[]), "empty"),
])
def test_render_playlist_target_validation(tmp_path, kw, match):
    files = make_lib(tmp_path, n=1, rate=44100, channels=1, seconds=0.05)
    with pytest.raises(ValueError, match=match):
        tpv.render_playlist(files, 44100, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jpv.render_playlist(files, 44100, **kw)
    with pytest.raises(ValueError, match=match):
        tpv.stream_playlist(files, 44100, str(tmp_path / "x.wav"), device="cpu", **kw)


def test_render_playlist_looping(tmp_path):
    files = make_lib(tmp_path, n=2, channels=1, seconds=0.05)
    main1, _, _ = tpv.render_playlist(files, 44100, silence_ms=50, output_channels=1,
                                      device="cpu")
    main2, _, items2 = tpv.render_playlist(files, 44100, silence_ms=50, output_channels=1,
                                           loops=2, device="cpu")
    assert len(items2) == 4
    gap = 44100 * 50 // 1000
    assert items2[2].start_frame == main1.shape[1] + gap
    assert main2.shape[1] == 2 * main1.shape[1] + gap


@pytest.mark.parametrize("case", ["bus8_monitor", "loops2", "varispeed_item"])
def test_stream_playlist_bytes_equal_render(tmp_path, case):
    """The data chunk of `stream_playlist`'s main and monitor files equals
    `render_playlist` + `write_wav`'s, item table and frame count too:
    8 channels with the mixdown of 6 added onto the bus, a looped playlist,
    and a 44,056 Hz item (the varispeed bank's gather) beside a 96 k one."""
    from f9tpu_torch.io import wav as twav

    if case == "varispeed_item":
        files = [_quiet(str(tmp_path / "v.wav"), 44056, 2, 0.4, 7),
                 _quiet(str(tmp_path / "h.wav"), 96000, 1, 0.1, 8)]
        kw = dict(output_channels=2, monitor=True, rate=48000)
    else:
        files = make_lib(tmp_path, n=2, rate=44100, channels=1, seconds=0.1)
        files.append(_quiet(str(tmp_path / "hi48.wav"), 48000, 2, 0.1, 9))
        kw = (dict(output_channels=8, monitor=True, target_channels=[0, 1, 2, 3, 4, 5],
                   monitor_channels=(6, 7), rate=44100) if case == "bus8_monitor" else
              dict(output_channels=6, monitor=True, loops=2, target_channels=[4, 5],
                   monitor_channels=(0, 1), silence_ms=70, quality="low", rate=44100))
    rate = kw.pop("rate")
    main, mon, items_r = tpv.render_playlist(files, rate, device="cpu", **kw)
    ref_main, ref_mon = str(tmp_path / "ref_main.wav"), str(tmp_path / "ref_mon.wav")
    twav.write_wav(ref_main, main, rate, bits=24)
    twav.write_wav(ref_mon, mon, rate, bits=24)
    got_main, got_mon = str(tmp_path / "s_main.wav"), str(tmp_path / "s_mon.wav")
    items_s, frames = tpv.stream_playlist(files, rate, got_main, monitor_out=got_mon,
                                          device="cpu", chunk_seconds=0.05, **kw)
    assert frames == main.shape[1]
    assert _items(items_s) == _items(items_r)
    assert _data_chunk(got_main) == _data_chunk(ref_main)
    assert _data_chunk(got_mon) == _data_chunk(ref_mon)
    assert codec.probe(got_main).num_channels == kw["output_channels"]
    assert tpv.projected_frames(files, rate, silence_ms=kw.get("silence_ms", 150),
                                loops=kw.get("loops", 1)) == frames


def test_mixdown_is_the_same_per_block():
    """Each frame of the mixdown of 3-8 channels takes the same adds
    whatever the block: blocks of any size equal the whole, bit for bit."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((8, 50001))
                         .astype(np.float32))
    for c in (3, 6, 8):
        whole = trouting.mixdown_monitor(x[:c])
        for a, b in ((0, 1), (7, 4100), (33333, 50001)):
            assert torch.equal(trouting.mixdown_monitor(x[:c, a:b].contiguous()),
                               whole[:, a:b])


def test_stream_playlist_constant_memory(tmp_path):
    """A tiny item looped into a multi-minute 8-channel programme: the
    streamed form's traced host memory stays under 16 MB (the render form
    would hold ~74 MB)."""
    rng = np.random.default_rng(8)
    p = str(tmp_path / "tiny.wav")
    wav.write_wav(p, (0.3 * rng.standard_normal((1, 12000))).astype(np.float32),
                  48000, bits=24)
    loops = 120
    tracemalloc.start()
    items, frames = tpv.stream_playlist([p], 48000, str(tmp_path / "long.wav"),
                                        silence_ms=150, output_channels=8, loops=loops,
                                        device="cpu")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert len(items) == loops
    assert frames == loops * 12000 + (loops - 1) * 7200
    assert frames * 8 * 4 > 70_000_000
    assert peak < 16_000_000, peak
    assert codec.probe(str(tmp_path / "long.wav")).num_frames == frames


def test_stream_playlist_blockwise_single_long_item(tmp_path):
    """One long item stays O(chunk): quadrupling its length does not move
    the peak traced memory, which stays under half the decoded item."""
    rng = np.random.default_rng(9)

    def peak_for(seconds):
        T = seconds * 44100
        p = str(tmp_path / f"item_{seconds}.wav")
        wav.write_wav(p, (0.25 * rng.standard_normal((1, T))).astype(np.float32),
                      44100, bits=24)
        out = str(tmp_path / f"out_{seconds}.wav")
        tracemalloc.start()
        items, frames = tpv.stream_playlist([p], 48000, out, quality="low",
                                            output_channels=2, chunk_seconds=2.0,
                                            device="cpu")
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        assert len(items) == 1 and items[0].num_frames == frames
        assert codec.probe(out).num_frames == frames == -(-T * 160 // 147)
        return peak, T * 4

    peak_short, _ = peak_for(20)
    peak_long, item_long = peak_for(80)
    assert peak_long < 1.25 * peak_short, (peak_short, peak_long)
    assert peak_long < item_long // 2, (peak_long, item_long)


def test_single_chunk_items_equal_whole(tmp_path):
    """Items shorter than a chunk are one chunk of exactly their cycles
    (down to one); their samples equal `resample_presliced` of the whole
    padded item in one call."""
    from f9tpu_torch.models import design_cycle_bank
    from f9tpu_torch.ops.resample import resample_presliced

    bank = design_cycle_bank(44100, 48000)
    for frames in (1, 147, 2 * 147 + 5, 3 * 147):
        p = _quiet(str(tmp_path / f"s{frames}.wav"), 44100, 2, frames / 44100, frames)
        blocks = list(tpv._iter_item_blocks(p, 48000, "high", "sinc", device="cpu"))
        assert len(blocks) == 1
        x, _ = codec.read_audio(p)
        Q = -(-frames // bank.M)
        xp = np.zeros((2, (Q - 1) * bank.M + bank.W), np.float32)
        xp[:, bank.pad_front:bank.pad_front + frames] = x
        want = resample_presliced(torch.from_numpy(xp), bank, Q).numpy()[:, :bank.out_len(frames)]
        np.testing.assert_array_equal(blocks[0], want)
