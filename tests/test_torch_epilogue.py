"""The batch graph's epilogue (`f9tpu_torch.ops.epilogue`), on the CPU.

- The port's graph, whose epilogue is the twin here, against the JAX
  graph's two fusions on the same numpy input: dither on and off, DC on and
  off, a static gain, per-file gains, 16 / 24 / 32 bits, int32 codes and
  the raw wire's payload, a routed-silent channel, mono fan-out and C = 1,
  2, 8: identical ``out_frames``, dB within 1e-3, codes within 2 LSB of
  24-bit resolution (`tests/test_torch_graph.py`'s bounds).
- The twin's DC mean is the exact mean (``math.fsum`` in float64) within one
  float32 ulp; its tile tree is the kernel's thread order, replayed here,
  with warp 0's one-barrier form.  The kernel's persistent walk is replayed
  for any grid (tickets at the end of each block's walk, the last taker
  folding in ascending order) and gives the twin's mean, sum of squares and
  peak bitwise; its one-conversion rounding and its int-to-float of the
  noise's halves equal the forms they replaced on every edge.
- A file's codes, mean, sum of squares and peak are bitwise the same when
  its bucket grows by whole or partial tiles, when it moves rows and when
  the batch width changes.
- The payload is `pack_interleaved` of the int32 codes; the tail floor
  equals the full-size formula it replaced on the same ``z``; the stream's
  chunk finish equals its eager form.
- Off the CPU the wrapper launches or raises, never the twin; 11c's trace
  check (`chip_smoke.py`) fails a trace that lost a launch and counts busy
  time as a union of intervals.
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


def _warp0_tree(w: np.ndarray) -> np.float64:
    """The kernel's tree after its one barrier: ``w[t]`` is thread t's
    register sum; lane l adds (l, l + 128), (l + 32, l + 160), (l + 64,
    l + 192), (l + 96, l + 224), then (r0 + r2) + (r1 + r3), then shuffles
    down 16 ... 1."""
    r0, r1 = w[:32] + w[128:160], w[32:64] + w[160:192]
    r2, r3 = w[64:96] + w[192:224], w[96:128] + w[224:256]
    s = (r0 + r2) + (r1 + r3)
    for off in (16, 8, 4, 2, 1):
        s = s[:off] + s[off:2 * off]
    return s[0]


def _kernel_tile(seg: np.ndarray) -> np.float64:
    """One tile's sum as the kernel takes it: a float64 segment of at most
    TILE values, zero-padded; registers halved, then `_warp0_tree`."""
    v = np.pad(seg, (0, ep.TILE - len(seg))).reshape(16, 256)
    for h in (8, 4, 2, 1):
        v = v[:h] + v[h:2 * h]
    return _warp0_tree(v[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_one_barrier_tree_is_the_halving_tree(seed):
    """Warp 0's tree after one barrier adds in the order of the halving over
    thread index (128, 64, 32), so it is bitwise the twin's tile sum."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((4, ep.TILE)) * np.exp2(rng.integers(-30, 30, size=(4, ep.TILE)))
    want = ep._tile_sums(torch.from_numpy(x)).numpy()[:, 0]
    for r in range(4):
        assert _kernel_tile(x[r]) == _kernel_tree(x[r]) == want[r]


def _walk(units: int, grid: int, reverse: bool):
    """Block b's units in the kernel's order: steps b, b + G, ...; step i
    is unit i, or units - 1 - i walking in reverse."""
    return [[units - 1 - i if reverse else i for i in range(b, units, grid)]
            for b in range(grid)]


#: (files, C, frames, out_frames): tile counts that no grid below divides,
#: rows shorter than a tile, a file with no valid sample
WALK_SHAPES = {"ragged": (3, 2, 5 * 4096 + 77, [5 * 4096 + 77, 9000, 17]),
               "silent_file": (2, 3, 2 * 4096 + 1, [2 * 4096 + 1, 0])}


@pytest.mark.parametrize("grid", [1, 7, 64, 1000])
@pytest.mark.parametrize("shape", sorted(WALK_SHAPES))
def test_persistent_walk_folds_to_the_twin(shape, grid):
    """The kernel's persistent walk replayed: G blocks walk units b, b + G,
    ... (pass 2 from the last), write each tile's partial, take the tickets
    of all their units once the walk ends, in any order of the blocks, and
    the block that takes a row's (file's) last ticket folds its tiles in
    ascending order, a file's channels in ascending order.  Whatever the
    grid, including one no tile count divides and one with more blocks than
    units, the mean, the sum of squares and the peak are the twin's bits."""
    files, C, T, lengths = WALK_SHAPES[shape]
    rng = np.random.default_rng(grid)
    y = _noise((files, C, T), seed=grid)
    of = np.array(lengths, np.int32)
    gain = np.float32(0.8)
    _, sumsq, peak, mean = ep.epilogue_reference(torch.from_numpy(y), torch.from_numpy(of),
                                                 None, bits=24, remove_dc=True, gain=0.8)
    rows, n_tiles = files * C, -(-T // ep.TILE)

    def fold_by_tickets(walks, per_counter, n_counters):
        """The block that takes each counter's last ticket, blocks ending
        in a random order."""
        tickets, folder = np.zeros(n_counters, np.int64), {}
        for b in rng.permutation(len(walks)):
            for u in walks[b]:
                tickets[u // per_counter] += 1
                if tickets[u // per_counter] == per_counter:
                    folder[u // per_counter] = b
        return folder

    # pass 1: a tile of a row per unit
    units = rows * n_tiles
    walks = _walk(units, min(grid, units), reverse=False)
    assert sorted(u for w in walks for u in w) == list(range(units))
    part = np.zeros((rows, n_tiles))
    for w in walks:
        for u in w:
            row, tile = divmod(u, n_tiles)
            n, t0 = min(int(of[row // C]), T), tile * ep.TILE
            if t0 < n:
                part[row, tile] = _kernel_tile(y[row // C, row % C, t0:min(t0 + ep.TILE, n)]
                                               .astype(np.float64))
    assert len(fold_by_tickets(walks, n_tiles, rows)) == rows
    got_mean = np.zeros(rows, np.float32)
    for row in range(rows):
        n = min(int(of[row // C]), T)
        acc = 0.0
        for j in range(-(-n // ep.TILE)):
            acc += part[row, j]
        got_mean[row] = np.float32(acc / max(int(of[row // C]), 1))
    assert np.array_equal(got_mean.reshape(files, C), mean.numpy())

    # pass 2: a frame tile of a file across its channels per unit, reversed
    units = files * n_tiles
    walks = _walk(units, min(grid, units), reverse=True)
    assert sorted(u for w in walks for u in w) == list(range(units))
    sq, pk = np.zeros((rows, n_tiles)), np.zeros((rows, n_tiles), np.float32)
    for w in walks:
        for u in w:
            f, tile = divmod(u, n_tiles)
            n, t0 = min(int(of[f]), T), tile * ep.TILE
            for c in range(C):
                seg = y[f, c, t0:t0 + ep.TILE]
                z = np.where(np.arange(t0, t0 + len(seg)) < n,
                             (seg - got_mean[f * C + c]) * gain, np.float32(0))
                if t0 < n:
                    z64 = z.astype(np.float64)
                    sq[f * C + c, tile] = _kernel_tile(z64 * z64)
                    pk[f * C + c, tile] = np.abs(z).max()
    assert len(fold_by_tickets(walks, n_tiles, files)) == files
    for f in range(files):
        nvt = -(-min(int(of[f]), T) // ep.TILE)
        acc = 0.0
        for c in range(C):
            ch = 0.0
            for j in range(nvt):
                ch += sq[f * C + c, j]
            acc += ch
        assert acc == float(sumsq[f]), (f, acc, float(sumsq[f]))
        assert np.float32(pk[f * C:(f + 1) * C, :nvt].max(initial=0)) == float(peak[f])


@pytest.mark.parametrize("bits", [16, 24, 32])
def test_round_clip_in_one_conversion_equals_the_float_clamp(bits):
    """The kernel rounds to an int (half to even, saturating) and clamps as
    ints; its first form rounded, clamped and truncated as floats
    (``fminf(fmaxf(rintf(v), -s), clip_hi)``, NaN giving -s).  Replayed on
    the edges of every width, the codes are the same."""
    s = np.float32(2.0 ** (bits - 1))
    hi = dither._clip_hi(float(s))
    rng = np.random.default_rng(bits)
    edges = [s, -s, s - 1, -s + 1, s - 0.5, -s - 0.5, hi, np.nextafter(hi, np.float32(np.inf)),
             0.5, 1.5, 2.5, -0.5, -1.5, -0.0, 2.0 ** 31, -2.0 ** 31, 3e38, -3e38,
             np.inf, -np.inf, np.nan]
    v = np.concatenate([np.array(edges, np.float32),
                        (rng.standard_normal(4096) * s * 1.2).astype(np.float32)])
    with np.errstate(invalid="ignore"):
        first = np.fmin(np.fmax(np.rint(v), -s), hi).astype(np.int64)
        r = np.rint(v.astype(np.float64))
        sat = np.clip(np.nan_to_num(r, nan=0.0), -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)
    lo_i, hi_i = int(-s), int(hi)
    now = np.where(np.isnan(v), lo_i, np.clip(sat, lo_i, hi_i))
    assert np.array_equal(first, now)


def test_sixteen_bit_halves_become_floats_by_their_bits():
    """The noise's halves (0 ... 65535) as floats without a conversion:
    the bits of 2^23 + x, less 2^23, are float(x) exactly."""
    x = np.arange(1 << 16, dtype=np.uint32)
    by_bits = (np.uint32(0x4B000000) | x).view(np.float32) - np.float32(8388608.0)
    assert np.array_equal(by_bits, x.astype(np.float32))


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


@pytest.mark.parametrize("case", ["units_past_int32", "build_fails"])
def test_a_tensor_off_the_cpu_never_runs_the_twin(case, monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises: more (row,
    tile) units than the kernel indexes, or a kernel library that does not
    build, raise, and neither runs the twin nor counts a launch."""
    def twin(*a, **k):
        raise AssertionError("the wrapper ran the twin on a tensor off the CPU")

    def no_build():
        raise RuntimeError("nvcc not found")

    from f9tpu_torch.ops import _build

    monkeypatch.setattr(ep, "epilogue_reference", twin)
    monkeypatch.setattr(_build, "load_library", no_build)
    files, C, total = (1 << 16, 1 << 10, 32 * ep.TILE + 1) if case == "units_past_int32" \
        else (2, 3, 100)
    y = torch.empty((files, C, total), device="meta")
    of = torch.empty((files,), dtype=torch.int32, device="meta")
    n0 = ep.launches
    with pytest.raises(ValueError if case == "units_past_int32" else RuntimeError):
        ep.epilogue(y, of, None, bits=24, remove_dc=True, gain=1.0, silent=(1,))
    assert ep.launches == n0


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_11c", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_graph_profile_counts_busy_time_as_a_union():
    """11c's busy time: overlapping intervals (a copy on the side stream
    under a kernel) count once."""
    busy = _chip_smoke()._busy_union_us
    assert busy([]) == 0
    assert busy([(0, 10), (5, 15), (20, 30)]) == 25
    assert busy([(0, 100), (10, 20), (30, 40)]) == 100
    assert busy([(5, 6), (0, 1), (0, 1)]) == 2


def test_graph_profile_refuses_a_trace_with_missing_launches():
    """11c's trace check: every name a multiple of the graphs traced, and
    the SRC kernel and the pair as many times as their counters read per
    graph; a trace that lost a launch fails."""
    faults = _chip_smoke()._trace_faults
    expect = {"cycle_src": 1, "finish_pass": 1, "dc_pass": 1}
    good = {"cycle_src_tc<5>(...)": 5, "finish_pass<0>(...)": 5, "dc_pass(...)": 5,
            "elementwise_kernel": 10, "Memcpy DtoH": 30}
    assert faults(good, 5, expect) == []
    lost = dict(good, **{"cycle_src_tc<5>(...)": 4})
    assert faults(lost, 5, expect)
    odd = dict(good, elementwise_kernel=9)
    assert faults(odd, 5, expect)
    assert faults(good, 5, dict(expect, dc_pass=0))


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    """On an NVIDIA GPU: the kernel pair against the twin, bit for bit, over
    a flag grid (`chip_smoke.py` phase 11 does the same at full size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    dev = torch.device("cuda")
    # C = 4 and 16 stage a payload beside the ring (16 at 16 bits only), C =
    # 16 at 24 bits, 24 and 72 write it in place; channel 70 of 72 is
    # silent; 65,600 one-channel files make more rows and files than a
    # grid's second axis holds; 3 * TILE + 11 is a row stride 3 mod 4
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
