"""The batch graph's epilogue (`f9tpu_torch.ops.epilogue`), on the CPU.

- The port's graph, whose epilogue is the twin here, against the JAX
  graph's two fusions on the same numpy input: dither on and off, DC on and
  off, a static gain, per-file gains, 16 / 24 / 32 bits, int32 codes and
  the raw wire's payload, a routed-silent channel, mono fan-out and C = 1,
  2, 8: identical ``out_frames``, dB within 1e-3, codes within 2 LSB of
  24-bit resolution (`tests/test_torch_graph.py`'s bounds).
- The twin's DC mean is the exact mean (``math.fsum`` in float64) within one
  float32 ulp; its tile tree is the kernel's thread order, replayed here.
- A file's codes, mean, sum of squares and peak are bitwise the same when
  its bucket grows by whole or partial tiles, when it moves rows and when
  the batch width changes.
- The payload is `pack_interleaved` of the int32 codes; the tail floor
  equals the full-size formula it replaced on the same ``z``; the stream's
  chunk finish equals its eager form.
- A `cuda`-marked test holds the kernel pair to the twin on the card; it
  skips here.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.pipeline import graph as jgraph  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.ops import analysis, dither  # noqa: E402
from f9tpu_torch.ops import epilogue as ep  # noqa: E402
from f9tpu_torch.ops.devcodec import pack_interleaved  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402

FILES, T = 3, 5000
VALID = np.array([5000, 3000, 17], np.int32)
SEEDS = np.arange(1, FILES + 1, dtype=np.int32)


def _batch(channels: int, seed: int) -> np.ndarray:
    """A sine at -12 dBFS plus noise and 0.01 of DC, zero past each file's
    valid length."""
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    x = (0.25 * np.sin(2 * np.pi * 997.0 * t)
         + 0.05 * rng.standard_normal((FILES, channels, T)) + 0.01).astype(np.float32)
    for i, n in enumerate(VALID):
        x[i, :, n:] = 0.0
    return x


def _check(got, want, codes_got, codes_want, bits):
    assert np.array_equal(got.out_frames.numpy(), np.asarray(want.out_frames))
    assert np.array_equal(got.tail_terminated.numpy(), np.asarray(want.tail_terminated))
    for name in ("peak_db", "rms_db", "noise_floor_db"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert np.abs(g - w).max() <= 1e-3, (name, g, w)
    assert codes_got.shape == codes_want.shape
    diff = np.abs(codes_got.astype(np.int64) - codes_want.astype(np.int64))
    assert diff.max() <= 2 << max(0, bits - 24), int(diff.max())


#: (config keywords, input channels, per-file gains in dB)
GRAPH_CASES = {
    "dither_dc": ({}, 2, None),
    "no_dither": ({"dither": False}, 2, None),
    "no_dc": ({"remove_dc": False}, 2, None),
    "no_dither_no_dc": ({"dither": False, "remove_dc": False}, 2, None),
    "gain_db": ({"gain_db": -6.0}, 2, None),
    "per_file_gain": ({"gain_db": 1.5}, 2, [-3.0, 2.0, 0.5]),
    "bits16": ({"bits": 16}, 2, None),
    "bits32": ({"bits": 32}, 2, None),
    "silent_routed_channel": ({"channel_routing": [1, -1, 0]}, 2, None),
    # a bus of 72 outputs whose channel 70 is silent
    "silent_channel_70_of_72": ({"channel_routing": [-1 if c == 70 else c % 2
                                                     for c in range(72)]}, 2, None),
    "mono_fanout": ({"output_channels": 2}, 1, None),
    "mono": ({}, 1, None),
    "eight_channels": ({"gain_db": -2.0}, 8, [0.0, -1.0, 4.0]),
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_epilogue_matches_jax(case):
    extra, channels, gains = GRAPH_CASES[case]
    kw = dict(output_dir="/tmp/x", target_rate=48000, **extra)
    x = _batch(channels, seed=len(case))
    want = jgraph.process_batch(jnp.asarray(x), VALID, ProcessingConfig(**kw), 44100,
                                jnp.asarray(SEEDS), per_file_gain_db=gains)
    got = tgraph.process_batch(torch.from_numpy(x), VALID, TConfig(**kw), 44100, SEEDS,
                               per_file_gain_db=gains)
    bits = kw.get("bits", 24)
    _check(got, want, got.codes.numpy(), np.asarray(want.codes), bits)
    for c, r in enumerate(extra.get("channel_routing", ())):
        if r < 0:
            assert not got.codes[:, c].any()


def _payload_codes(payload: np.ndarray, bits: int) -> np.ndarray:
    nb = bits // 8
    b = payload.reshape(payload.shape[0], -1, nb).astype(np.int64)
    v = sum(b[..., k] << (8 * k) for k in range(nb))
    return v - ((v >> (bits - 1)) << bits)


def _raw(x: np.ndarray) -> np.ndarray:
    """24-bit interleaved little-endian bytes of ``x (files, C, T)``."""
    codes = np.round(x * (1 << 23)).astype(np.int64)
    inter = np.swapaxes(codes, 1, 2) & 0xFFFFFF
    return np.stack([(inter >> (8 * k)) & 0xFF for k in range(3)],
                    axis=-1).astype(np.uint8).reshape(x.shape[0], -1)


@pytest.mark.parametrize("case", ["payload24_silent", "payload16_gain", "payload24_mono_fanout"])
def test_raw_payload_matches_jax(case):
    kw = dict(output_dir="/tmp/x", target_rate=48000)
    channels = 2
    if case == "payload24_silent":
        kw["channel_routing"] = [-1, 0]
    elif case == "payload16_gain":
        kw.update(bits=16, gain_db=-4.0, remove_dc=False)
    else:
        channels, kw["output_channels"] = 1, 2
    raw = _raw(_batch(channels, seed=7))
    want = jgraph.process_batch_raw(jnp.asarray(raw), VALID, ProcessingConfig(**kw), 44100,
                                    jnp.asarray(SEEDS), in_channels=channels, in_bits=24)
    got = tgraph.process_batch_raw(raw, VALID, TConfig(**kw), 44100, SEEDS,
                                   in_channels=channels, in_bits=24, device="cpu")
    bits = kw.get("bits", 24)
    assert got.codes.dtype == torch.uint8
    _check(got, want, _payload_codes(got.codes.numpy(), bits),
           _payload_codes(np.asarray(want.codes), bits), bits)


def _noise(shape, seed, dc=0.013):
    rng = np.random.default_rng(seed)
    return (0.2 * rng.standard_normal(shape) + dc).astype(np.float32)


@pytest.mark.parametrize("n", [0, 1, 4095, 4096, 4097, 10000, 3 * 4096 + 5])
def test_dc_mean_is_the_exact_mean_within_an_ulp(n):
    y = _noise((2, 3, 3 * 4096 + 9), seed=n)
    of = np.array([n, max(0, n - 3)], np.int32)
    _, _, _, mean = ep.epilogue(torch.from_numpy(y), torch.from_numpy(of), None, bits=24,
                                remove_dc=True, gain=1.0)
    for f in range(2):
        for c in range(3):
            exact = math.fsum(map(float, y[f, c, :of[f]])) / max(int(of[f]), 1)
            got = float(mean[f, c])
            assert abs(got - exact) <= np.spacing(np.float32(abs(exact))), (f, c, got, exact)


def _kernel_tree(tile: np.ndarray) -> np.float64:
    """The kernel's order over one tile of 4096 float64 values: thread t
    holds element t + 256k, halves its 16 registers (k + 8, 4, 2, 1), then
    shared memory over thread index (128, 64, then 32 by warp 0), then warp
    shuffles down 16 ... 1."""
    v = tile.reshape(16, 256)                  # v[k, t] = tile[t + 256 k]
    for h in (8, 4, 2, 1):
        v = v[:h] + v[h:2 * h]
    red = v[0]
    for h in (128, 64, 32):
        red = red[:h] + red[h:2 * h]
    for off in (16, 8, 4, 2, 1):
        red = red[:off] + red[off:2 * off]
    return red[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tile_tree_is_the_kernel_s_thread_order(seed):
    rng = np.random.default_rng(seed)
    # values whose sum depends on the association: widely spread magnitudes
    x = (rng.standard_normal((3, 2 * ep.TILE + 77))
         * np.exp2(rng.integers(-30, 30, size=(3, 2 * ep.TILE + 77))))
    got = ep._tile_sums(torch.from_numpy(x)).numpy()
    xp = np.pad(x, ((0, 0), (0, 3 * ep.TILE - x.shape[1])))
    want = np.array([[_kernel_tree(xp[r, j * ep.TILE:(j + 1) * ep.TILE]) for j in range(3)]
                     for r in range(3)])
    assert np.array_equal(got, want)
    # and it is not the sequential sum
    assert not np.array_equal(got[:, 0], np.array([sum(r[:ep.TILE]) for r in xp]))


def _file_results(res, f, n_codes):
    codes, sumsq, peak, mean = res
    return (codes[f, :, :n_codes], sumsq[f], peak[f], mean[f])


def _run(y, of, seeds, **kw):
    cs = dither.channel_seeds(torch.from_numpy(seeds).to(torch.int64), y.shape[1])
    return ep.epilogue(torch.from_numpy(np.ascontiguousarray(y)), torch.from_numpy(of), cs,
                       bits=24, remove_dc=True, gain=10 ** (-1 / 20), **kw)


@pytest.mark.parametrize("variant", ["bucket_whole_tile", "bucket_partial_tile", "rows",
                                     "batch_width"])
def test_a_file_s_results_do_not_depend_on_bucket_row_or_width(variant):
    blen = 2 * ep.TILE + 1000
    y = _noise((4, 2, blen), seed=5)
    of = np.array([blen, 9001, 4096, 17], np.int32)
    for i, n in enumerate(of):
        y[i, :, n:] = 0.25         # what lies past the end never counts
    seeds = np.array([7, 8, 9, 10], np.int32)
    base = _run(y, of, seeds)
    if variant.startswith("bucket"):
        grow = ep.TILE if variant == "bucket_whole_tile" else 1234
        y2 = np.pad(y, ((0, 0), (0, 0), (0, grow)), constant_values=0.5)
        other, order = _run(y2, of, seeds), np.arange(4)
    elif variant == "rows":
        order = np.array([2, 0, 3, 1])
        other = _run(y[order], of[order], seeds[order])
    else:
        order = np.array([1])
        other = _run(y[1:2], of[1:2], seeds[1:2])
    for j, f in enumerate(order):
        for a, b in zip(_file_results(base, f, blen), _file_results(other, j, blen)):
            assert torch.equal(a, b), (variant, f)


def test_graph_results_do_not_depend_on_the_bucket_length():
    """The whole slice: one file in a bucket one tile and a bit longer gives
    the same codes and metrics, bit for bit."""
    rng = np.random.default_rng(3)
    x = (0.2 * rng.standard_normal((2, 2, 9000)) + 0.01).astype(np.float32)
    valid = np.array([9000, 6000], np.int32)
    x[1, :, 6000:] = 0.0
    cfg = TConfig(output_dir="unused", target_rate=48000)
    n0 = ep.launches
    a = tgraph.process_batch(x, valid, cfg, 44100, [4, 5], device="cpu")
    b = tgraph.process_batch(np.pad(x, ((0, 0), (0, 0), (0, 5000))), valid, cfg, 44100,
                             [4, 5], device="cpu")
    for f in range(2):
        n = int(a.out_frames[f])
        assert torch.equal(a.codes[f, :, :n], b.codes[f, :, :n])
        assert not b.codes[f, :, n:].any()
    for k in ("out_frames", "peak_db", "rms_db", "noise_floor_db"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert ep.launches == n0          # the CPU path ran the twin


@pytest.mark.parametrize("bits,channels", [(24, 2), (24, 1), (16, 2), (16, 5)])
def test_payload_is_pack_interleaved_of_the_codes(bits, channels):
    y = _noise((3, channels, 7001), seed=bits + channels)
    of = torch.tensor([7001, 5000, 0], dtype=torch.int32)
    cs = dither.channel_seeds(torch.tensor([1, 2, 3]), channels)
    kw = dict(bits=bits, remove_dc=True, gain=0.7, keep=6999,
              silent=(channels - 1,) if channels > 1 else ())
    codes = ep.epilogue(torch.from_numpy(y), of, cs, **kw)[0]
    payload = ep.epilogue(torch.from_numpy(y), of, cs, packed=bits, **kw)[0]
    assert payload.dtype == torch.uint8
    assert torch.equal(payload, pack_interleaved(codes, bits))


def _old_tail_floor(z, out_frames, win):
    """The full-size formula the graph used before: the loudest channel's
    |z| over the whole output, then the last ``win`` valid positions."""
    out_total = z.shape[-1]
    mono = torch.amax(torch.abs(z), dim=1)
    raw_pos = (out_frames[:, None].to(torch.int64) - win
               + torch.arange(win, dtype=torch.int64)[None, :])
    in_range = raw_pos >= 0
    gathered = torch.gather(mono, -1, raw_pos.clamp(0, out_total - 1))
    n_tail = torch.clamp(torch.clamp(out_frames, max=win).to(torch.float32), min=1.0)
    tail_rms = torch.sqrt(torch.sum(torch.square(gathered) * in_range, dim=-1) / n_tail)
    return analysis._amp_to_db(tail_rms)


@pytest.mark.parametrize("case", ["dc", "no_dc", "per_file_gain", "short_files"])
def test_tail_floor_equals_the_full_size_formula(case):
    win = 480
    y = torch.from_numpy(_noise((4, 3, 6000), seed=len(case)))
    of = torch.tensor([6000, 5000, 300, 0] if case == "short_files" else [6000, 5999, 481, 480],
                      dtype=torch.int32)
    gain_lin = torch.tensor([0.5, 1.0, 2.0, 1.5]) if case == "per_file_gain" else None
    remove_dc = case != "no_dc"
    _, _, _, mean = ep.epilogue(y, of, None, bits=24, remove_dc=remove_dc, gain=0.9,
                                gain_lin=gain_lin)
    g = ep.gain_factor(0.9, gain_lin)
    vmask = torch.arange(6000, dtype=torch.int32)[None, None, :] < of[:, None, None]
    ym = y - mean[..., None] if remove_dc else y
    z = torch.where(vmask, ym * g, torch.zeros(()))
    want = _old_tail_floor(z, of, win)
    got = tgraph._tail_floor(y, of, mean, g, win)
    assert torch.equal(got, want)


def _eager_finish(y, seeds_c, pos0, gain, bits, do_dither, silent, wire):
    """The stream's chunk finish as it was written eagerly."""
    y = y * gain
    if do_dither:
        pos = pos0 + torch.arange(y.shape[-1], dtype=torch.int64)
        codes = dither.quantize_noise(y, bits, seeds_c[:, None], pos[None, :])
    else:
        codes = dither.quantize_noise(y, bits)
    if silent:
        mask = torch.zeros(y.shape[0], dtype=torch.bool)
        mask[list(silent)] = True
        codes = codes.masked_fill(mask[:, None], 0)
    if wire == "pack24":
        return pack_interleaved(codes, 24)
    return codes.to(torch.int16) if wire == "i16" else codes


@pytest.mark.parametrize("bits,wire,pos0,silent,do_dither", [
    (24, "pack24", -312, (), True), (16, "i16", 10**10 + 3, (1,), True),
    (32, None, 2**31 - 5, (0,), True), (24, "pack24", 0, (1,), False)])
def test_stream_finish_equals_its_eager_form(bits, wire, pos0, silent, do_dither):
    y = torch.from_numpy(_noise((2, 9001), seed=bits))
    seeds_c = dither.channel_seeds(torch.tensor(dither.file_seed(9, "a.wav")), 2)
    gain = float(np.float32(10 ** (-2 / 20)))
    codes, env, _ = tstream._finish_chunk(y, None, seeds_c, pos0, gain, rate_out=48000,
                                          bits=bits, do_dither=do_dither, silent=silent,
                                          want_env=True, wire=wire)
    want = _eager_finish(y, seeds_c, pos0, gain, bits, do_dither, silent, wire)
    assert codes.dtype == want.dtype and torch.equal(codes, want)
    assert torch.equal(env, torch.amax(torch.abs(y * gain), dim=0))


@pytest.mark.parametrize("bad", ["dtype", "out_frames_dtype", "keep", "packed_bits",
                                 "dc_without_lengths", "silent_channel"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(bad):
    y = torch.zeros((2, 3, 100))
    of = torch.tensor([100, 50], dtype=torch.int32)
    kw = dict(bits=24, remove_dc=True, gain=1.0)
    if bad == "dtype":
        y = y.double()
    elif bad == "out_frames_dtype":
        of = of.long()
    elif bad == "keep":
        kw["keep"] = 101
    elif bad == "packed_bits":
        kw["packed"] = 16
    elif bad == "dc_without_lengths":
        of = None
    else:
        kw["silent"] = (3,)
    n0 = ep.launches
    with pytest.raises(ValueError):
        ep.epilogue(y, of, None, **kw)
    assert ep.launches == n0


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    """On an NVIDIA GPU: the kernel pair against the twin, bit for bit, over
    a flag grid (`chip_smoke.py` phase 11 does the same at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    # C = 4 and 16 stage a payload past 48 KB of shared memory, C = 24 and
    # 72 past the 192 KB a block stages (written in place); channel 70 of 72
    # is silent; 65,600 one-channel files make more rows and files than a
    # grid's second axis holds
    for files, C, total in ((3, 2, 3 * ep.TILE + 11), (3, 4, 3 * ep.TILE + 11),
                            (3, 16, 3 * ep.TILE + 11), (3, 24, 3 * ep.TILE + 11),
                            (3, 72, ep.TILE + 11), (65600, 1, 300)):
        y = torch.from_numpy(_noise((files, C, total), seed=C)).to(dev)
        of = torch.tensor(np.random.default_rng(C).integers(0, total + 1, files),
                          dtype=torch.int32, device=dev)
        of[0] = total
        cs = dither.channel_seeds(torch.arange(1, files + 1, device=dev), C)
        silent = tuple(c for c in (1, 70) if c < C)
        keep = min(total, 5001)
        for kw in (dict(bits=24, remove_dc=True), dict(bits=24, remove_dc=True, packed=24),
                   dict(bits=16, remove_dc=False, packed=16, silent=silent, keep=keep),
                   dict(bits=32, remove_dc=True, keep=keep - 1, silent=silent)):
            n0 = ep.launches
            got = ep.epilogue(y, of, cs, gain=0.8, **kw)
            torch.cuda.synchronize()
            assert ep.launches == n0 + 1
            want = ep.epilogue_reference(y, of, cs, gain=0.8, **kw)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w), (C, kw)
