"""The dynamics stages' kernels (`f9tpu_torch/csrc/dynamics.cu`: the release
envelope ``f9_slanted_cummax`` and the windowed maximum ``f9_window_max``),
on the CPU.

- Each kernel's order and indexing, replayed in numpy float32, equal the
  plain twin bit for bit: the envelope's one pass (tiles on the absolute
  grid from a ticket, their quads on the 16-byte grid, the warps' scans,
  the decoupled look-back inside an envelope block with the flags published
  in random interleavings, each block's carry folded from the earlier
  blocks' maxima, the state out), with `Compressor._ENV_BLOCK` patched to
  256, at 2^17 and 2^20, chunks from mid-block, shorter than a tile, across
  several blocks, ending on the grid, from a carried state, at both tiles;
  the windowed maximum's register tree (lanes, shuffles, remainder shifts,
  segments and their warm-up, the row's start, NaN payloads), its staged
  levels and its level launches past the staged width.  The CUDA sources
  compute in these orders, each rounding an `_rn` intrinsic.
- The twins equal the JAX package's functions bit for bit on the same
  numpy inputs: `Compressor._slanted_cummax_stream` (`f9tpu/ops/chain.py:733`)
  over the same chunks, and `_window_max_past` (`:902`) on signed input.
- The kernels themselves run only on the card (`chip_smoke.py
  --chain-kernels`, and the `cuda`-marked tests in
  `tests/test_torch_chain_kernels.py`)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops import chain_kernels as ck  # noqa: E402

ENV_THREADS = 256
WMAX_TILE = 2048


def _mx(a, b):
    """torch.maximum on the card, as the kernels write it: a NaN operand
    wins (the first if both), else the larger."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.where(np.isnan(a), a, np.where(np.isnan(b), b, np.fmax(a, b))).astype(np.float32)


def _level(shape, seed):
    """dB levels with the features the kernels must keep: exact zeros of
    both signs at the start and a plateau of equal values."""
    rng = np.random.default_rng(seed)
    lv = rng.uniform(-90.0, 6.0, size=shape).astype(np.float32)
    T = shape[-1]
    lv[..., :40] = 0.0
    lv[..., 1:40:3] = -0.0
    lv[..., T // 2:T // 2 + 300] = -12.5
    return lv


# ------------------------------------------------------ the envelope's pass

ENV_AGGREGATE, ENV_INCLUSIVE = 1, 2


def _warp_inclusive(x):
    """A warp's shuffle-up scan of (..., 256) values, lanes in groups of 32:
    ``inc = mx(y, inc)`` for lanes >= o, o = 1, 2, 4, 8, 16; and each lane's
    value shuffled up by one (lane 0 keeps its own)."""
    lanes = np.arange(ENV_THREADS) % 32
    inc = x.copy()
    for o in (1, 2, 4, 8, 16):
        y = np.roll(inc, o, axis=-1)
        inc = np.where(lanes >= o, _mx(y, inc), inc)
    ex = np.where(lanes >= 1, np.roll(inc, 1, axis=-1), inc)
    return inc, ex


def _warp_max(x):
    """A warp's xor tree over 32 lanes."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = _mx(x, x[..., lanes ^ o])
    return x[..., 0]


class _EnvTile:
    """One tile of `env_scan` as a thread block computes it: its quads on the
    row's 16-byte grid (thread t quads t + 256h, thread 0 the spill quad),
    each quad row's warp scans, warp 0's scan of the parts (4 a lane in
    order, then across the lanes) for the aggregate and each part's prefix,
    and env from the exclusive prefix and the carry."""

    def __init__(self, row, k, lv, a, n, j0, s, cf, Q):
        self.row, self.k, self.n, self.s, self.Q = row, k, n, s, Q
        qx = ENV_THREADS * Q                             # the spill quad, thread 0's
        e = 4 * np.arange(qx + 1)[:, None] - s + np.arange(4)[None, :]   # (quad, u)
        ok = (e >= 0) & (e < n)
        raw = np.where(ok, lv[a + np.clip(e, 0, n - 1)], np.float32(0))
        self.j = (j0 + e).astype(np.float32)
        self.r = self.j * cf
        self.v = np.where(ok, raw + self.r, np.float32(-np.inf)).astype(np.float32)
        self.e, self.ok, self.cf = e, ok, cf
        run = np.full(qx + 1, -np.inf, np.float32)
        for u in range(4):
            run = _mx(run, self.v[:, u])
        self.extra = 4 * qx - s < n
        self.xmax = run[qx] if self.extra else np.float32(-np.inf)
        self.inc, self.ex = [], []
        for h in range(Q):
            inc, ex = _warp_inclusive(run[ENV_THREADS * h:ENV_THREADS * (h + 1)])
            self.inc.append(inc)
            self.ex.append(ex)
        parts = np.array([self.inc[h][32 * w + 31] for h in range(Q)
                          for w in range(ENV_THREADS // 32)], np.float32)
        per = -(-parts.size // 32)
        parts = np.concatenate([parts, np.full(32 * per - parts.size, -np.inf, np.float32)])
        parts = parts.reshape(32, per)
        self.pv = np.empty_like(parts)                   # a lane's parts before each
        run = np.full(32, -np.inf, np.float32)
        for i in range(parts.shape[1]):
            self.pv[:, i], run = run, _mx(run, parts[:, i])
        inc, _ = _warp_inclusive(np.tile(run, ENV_THREADS // 32))
        self.exc = np.concatenate([[np.float32(-np.inf)], inc[:31]]).astype(np.float32)
        self.main = inc[31]
        self.agg = _mx(self.main, self.xmax)

    def env(self, P, carry):
        """env of the tile's frames from P, the exclusive prefix, and carry:
        each (quad row, warp) from the prefix entering it, each lane from its
        warp's and the lane's before it, a thread's 4 frames in order."""
        out = np.empty(self.n, np.float32)
        lanes = np.arange(ENV_THREADS) % 32
        pre = _mx(_mx(np.float32(P), self.exc)[:, None], self.pv).reshape(-1)
        pre = pre[:self.Q * ENV_THREADS // 32].reshape(self.Q, -1)
        for h in range(self.Q):
            sp = np.repeat(pre[h], 32)
            sp = np.where(lanes > 0, _mx(sp, self.ex[h]), sp)
            self._quads(np.arange(ENV_THREADS) + ENV_THREADS * h, sp, carry, out)
        if self.extra:
            self._quads(np.array([ENV_THREADS * self.Q]),
                        np.array([_mx(np.float32(P), self.main)], np.float32), carry, out)
        return out

    def _quads(self, q, sp, carry, out):
        for u in range(4):
            sp = _mx(sp, self.v[q, u])
            decay = self.cf * (self.j[q, u] + np.float32(1.0))
            e = _mx(sp - self.r[q, u], carry - decay)
            ok = self.ok[q, u]
            out[self.e[q, u][ok]] = e[ok]


def _env_kernel_order(level, c, pos, m, env_carry, B, order=0, offset=0, events=None):
    """`f9_slanted_cummax` replayed: tiles on the absolute grid
    (`chain_kernels.env_tile_frames`: 16,384 frames where the call has at
    least 528 of them, else 2,048; never more than B), claimed row-major
    from the ticket, each one block (`_EnvTile`: 16 or 2 quads a thread on
    the row's 16-byte grid, ``offset`` floats off it at the first row,
    thread 0's spill quad); then the
    published flags in an interleaving drawn from ``order`` (0: each tile
    to its end before the next): a tile publishes its aggregate (the
    block's first tile in the chunk its inclusive prefix from the seed: m
    in the chunk's first block, -1e9 after), warp 0 looks back 32 flags at
    a time (a flag of status 0 is not ready: the warp reads the window
    again later; it stops at the first inclusive prefix), publishes its
    inclusive prefix; warp 1 folds the carry from the state's and the
    blocks' maxima S_0 .. S_{blk-1} (each the inclusive prefix of its
    block's last tile, waited for); then env, and the row's last tile the
    state out.  ``events`` counts what the look-back found ("aggregate",
    "inclusive", "not ready")."""
    level = np.asarray(level, np.float32)
    lead, T = level.shape[:-1], level.shape[-1]
    rows = level.reshape(-1, T)
    R = rows.shape[0]
    mr = np.asarray(m, np.float32).reshape(R)
    cr = np.asarray(env_carry, np.float32).reshape(R)
    cf = np.float32(c)
    p0 = pos % B
    tile = ck.env_tile_frames(R, T, p0, B)
    Q = (ck.ENV_TILE if tile > ck.ENV_TILE_NARROW else ck.ENV_TILE_NARROW) // (4 * ENV_THREADS)
    t0, tpb = p0 // tile, B // tile
    ntiles = -(-(p0 + T) // tile) - t0
    r_last, decay_b = np.float32(B - 1) * cf, cf * np.float32(B)
    ends = (p0 + T) % B == 0
    flags = {}                                   # (row, k) -> (status, value)
    env = np.empty_like(rows)
    m_out, c_out = np.empty(R, np.float32), np.empty(R, np.float32)
    events = {} if events is None else events
    rng = np.random.default_rng(order)

    def tile_task(row, k):
        t = t0 + k
        a, b = max(0, t * tile - p0), min(T, (t + 1) * tile - p0)
        blk = t // tpb
        k0 = max(0, blk * tpb - t0)
        yield
        tl = _EnvTile(row, k, rows[row], a, b - a, (p0 + a) % B, (offset + row * T + a) % 4, cf, Q)
        if k == k0:
            P = mr[row] if blk == 0 else np.float32(-1e9)
        else:
            flags[(row, k)] = (ENV_AGGREGATE, tl.agg)
            yield
            P, hi = np.float32(-np.inf), k - 1
            while True:                                  # warp 0's look-back
                idx = [hi - lane for lane in range(32) if hi - lane >= k0]
                seen = [flags.get((row, i), (0, 0.0)) for i in idx]
                if any(st == 0 for st, _ in seen):
                    events["not ready"] = events.get("not ready", 0) + 1
                    yield
                    continue
                vals = np.full(32, -np.inf, np.float32)
                first = next((n for n, (st, _) in enumerate(seen) if st == ENV_INCLUSIVE), None)
                for n, (st, v) in enumerate(seen[:None if first is None else first + 1]):
                    vals[n] = v
                    key = "inclusive" if st == ENV_INCLUSIVE else "aggregate"
                    events[key] = events.get(key, 0) + 1
                P = _mx(P, _warp_max(vals))
                if first is not None:
                    break
                hi -= 32
                yield
        flags[(row, k)] = (ENV_INCLUSIVE, _mx(P, tl.agg))
        carry = cr[row]                                  # warp 1's fold
        for bb in range(blk):
            kl = min(ntiles, (bb + 1) * tpb - t0) - 1
            while flags.get((row, kl), (0, 0.0))[0] != ENV_INCLUSIVE:
                yield
            carry = _mx(flags[(row, kl)][1] - r_last, carry - decay_b)
        yield
        env[row, a:b] = tl.env(P, carry)
        if k == ntiles - 1:
            incl = flags[(row, k)][1]
            c_out[row] = _mx(incl - r_last, carry - decay_b) if ends else carry
            m_out[row] = np.float32(-1e9) if ends else incl

    tickets = [(row, k) for row in range(R) for k in range(ntiles)]
    live, nxt = [], 0
    while nxt < len(tickets) or live:
        if order == 0:                                   # in ticket order, each to its end
            for _ in tile_task(*tickets[nxt]):
                pass
            nxt += 1
            continue
        # start the next ticket or advance a running tile, at random
        if nxt < len(tickets) and (not live or rng.random() < 0.4):
            live.append(tile_task(*tickets[nxt]))
            nxt += 1
        i = int(rng.integers(len(live)))
        try:
            next(live[i])
        except StopIteration:
            live.pop(i)
    return env.reshape(*lead, T), m_out.reshape(lead), c_out.reshape(lead)


def _chunks(B):
    """(pos, T): from the grid's start and mid-block, shorter than a tile,
    across one boundary, ending on the grid after half a block and after two
    and a half, on the grid at both ends."""
    return [(0, 1500), (B // 2 + 13, 2100), (5, 7), (B - 3, 5), (3 * B + B // 2, B // 2),
            (3 * B + B // 2, 2 * B + B // 2), (7 * B, 3 * B)]


def _state(lead, carried, seed):
    if not carried:
        return np.full(lead, -1e9, np.float32), np.full(lead, -1e9, np.float32)
    rng = np.random.default_rng(seed)
    return (np.asarray(rng.uniform(-40.0, 0.0, size=lead), np.float32),
            np.asarray(rng.uniform(-40.0, 0.0, size=lead), np.float32))


def _twin(level, c, pos, m, ec):
    got = tchain.Compressor._slanted_cummax_stream_reference(
        torch.from_numpy(level), c, pos, torch.from_numpy(m), torch.from_numpy(ec))
    return tuple(t.numpy() for t in got)


def _same(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return a.shape == b.shape and np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("carried", [False, True])
def test_envelope_kernel_order_is_the_twin_s_on_a_small_grid(case, carried, monkeypatch):
    """`_ENV_BLOCK` patched to 256 (tiles of 256 frames, one a block): the
    three passes equal the twin bit for bit, env and both halves of the
    state, on 3 x 1 rows and a 1-D row."""
    monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", 256)
    pos, T = _chunks(256)[case]
    for lead in ((3, 1), ()):
        level = _level((*lead, T), 10 + case)
        m, ec = _state(lead, carried, 20 + case)
        got = _env_kernel_order(level, 300.0 / 48000, pos, m, ec, 256)
        want = _twin(level, 300.0 / 48000, pos, m, ec)
        for g, w in zip(got, want):
            assert _same(g, w), (pos, T, lead)


@pytest.mark.parametrize("pos,T", [(0, 5000), (65549, 4100), (5, 7), (131072 - 2100, 2100),
                                   (131072 - 700, 1900), (1, 70 * 2048 + 5),
                                   (16383, 16386)])
def test_envelope_kernel_order_is_the_twin_s_at_2_17(pos, T):
    """At the shipped block (2^17 frames, tiles of 2,048 here): from the grid's
    start, from mid-block, shorter than a tile, ending exactly on the grid,
    across one block boundary, over a block's 8 tiles into the next, and
    from a tile's last frame past the next tile's first, from a carried
    state."""
    level = _level((2, 1, T), pos % 97)
    m, ec = _state((2, 1), True, 5)
    got = _env_kernel_order(level, 80.0 / 48000, pos, m, ec, 1 << 17)
    want = _twin(level, 80.0 / 48000, pos, m, ec)
    for g, w in zip(got, want):
        assert _same(g, w)


def test_envelope_state_at_the_grid_and_when_empty(monkeypatch):
    """A chunk that ends exactly on the grid leaves m' = -1e9 and env_carry'
    = the env at the block's last frame; a chunk of 0 frames hands its
    state back unchanged; chunks carried one into the next equal the whole
    signal."""
    monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", 256)
    level = _level((2, 1, 512 + 256 - 100), 3)
    m, ec = _state((2, 1), True, 4)
    env, m1, c1 = _env_kernel_order(level, 0.01, 100, m, ec, 256)
    assert np.all(m1 == np.float32(-1e9)) and _same(c1, env[..., -1])
    tm, tec = torch.from_numpy(m), torch.from_numpy(ec)
    got = tchain.Compressor._slanted_cummax_stream_reference(
        torch.empty((2, 1, 0)), 0.01, 77, tm, tec)
    assert got[1] is tm and got[2] is tec and got[0].shape == (2, 1, 0)
    whole = _env_kernel_order(level, 0.01, 100, m, ec, 256)[0]
    parts, state, a = [], (m, ec), 0
    for n in (3, 250, 1, 300, 114):
        e, mm, cc = _env_kernel_order(level[..., a:a + n], 0.01, 100 + a, *state, 256)
        parts.append(e)
        state, a = (mm, cc), a + n
    assert a == level.shape[-1] and _same(np.concatenate(parts, -1), whole)


@pytest.mark.parametrize("order", range(1, 7))
def test_envelope_look_back_in_random_orders(order, monkeypatch):
    """The tiles' flags published in an interleaving drawn at random (a tile
    starts in ticket order; any running tile may advance): `_ENV_BLOCK` at
    2^20 over 40 tiles of one block and the next's first (look-back windows
    of 32, a block's carry waiting on the last tile of the one before), at
    2^17 over two blocks of 8 tiles, and at 256 over nine blocks of one
    tile, 2 rows, carried state: bitwise the twin's."""
    for B, pos, T in ((1 << 20, (1 << 20) - 40 * 16384 + 1, 40 * 16384 + 5),
                      (1 << 17, 1, 70 * 2048 + 5), (256, 128 + 13, 2100)):
        monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", B)
        level = _level((2, 1, T), 70 + order)
        m, ec = _state((2, 1), True, 80 + order)
        got = _env_kernel_order(level, 300.0 / 48000, pos, m, ec, B, order=order)
        for g, w in zip(got, _twin(level, 300.0 / 48000, pos, m, ec)):
            assert _same(g, w), (B, order)


def test_look_back_meets_every_kind_of_flag():
    """Over six random interleavings the look-back finds predecessors not
    yet ready, published as aggregates and as inclusive prefixes."""
    events = {}
    level = _level((2, 1, 20 * 16384), 90)
    m, ec = _state((2, 1), True, 91)
    for order in range(1, 7):
        _env_kernel_order(level, 0.01, 0, m, ec, 1 << 20, order=order, events=events)
    assert all(events.get(k, 0) > 0 for k in ("not ready", "aggregate", "inclusive")), events


@pytest.mark.parametrize("offset", range(4))
def test_envelope_quads_off_the_16_byte_grid(offset):
    """The level ``offset`` floats off the 16-byte grid (rows of an odd
    length, so each row sits elsewhere on it): a tile's first quad masked
    before it, thread 0's spill quad after it, at a tile's length +- 1,
    from a tile's last frame, 3 rows: bitwise the twin's."""
    for pos, T in ((0, 16385), (16383, 16386), (131072 - 16385, 32771)):
        level = _level((3, 1, T), 100 + offset)
        m, ec = _state((3, 1), True, 101 + offset)
        got = _env_kernel_order(level, 80.0 / 48000, pos, m, ec, 1 << 17, offset=offset)
        for g, w in zip(got, _twin(level, 80.0 / 48000, pos, m, ec)):
            assert _same(g, w), (pos, T)


W8 = 16384                                 # `chain_kernels.ENV_TILE`


@pytest.mark.parametrize("pos,T,B", [(0, W8 + 1, 1 << 17), (W8 - 1, W8 + 2, 1 << 17),
                                     ((1 << 17) - W8 - 1, 2 * W8 + 3, 1 << 17),
                                     (1, 70 * 2048 + 5, 1 << 17),
                                     ((1 << 20) - 34 * W8 + 7, 34 * W8, 1 << 20)])
def test_envelope_wide_tiles(pos, T, B, monkeypatch):
    """The wide tile (16 quads a thread, 16,384 frames), which the kernel
    takes from `ENV_WIDE_MIN_TILES` tiles a call on (patched to 1 here): at
    a tile's edges, across a block boundary, and at 2^20 over 34 tiles of a
    block (two look-back windows), 2 rows one float off the 16-byte grid,
    in a random interleaving: bitwise the twin's."""
    assert ck.ENV_TILE == W8
    monkeypatch.setattr(ck, "ENV_WIDE_MIN_TILES", 1)
    monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", B)
    assert ck.env_tile_frames(2, T, pos % B, B) == ck.ENV_TILE
    level = _level((2, 1, T), 120 + T % 7)
    m, ec = _state((2, 1), True, 121)
    got = _env_kernel_order(level, 80.0 / 48000, pos, m, ec, B, order=3, offset=1)
    for g, w in zip(got, _twin(level, 80.0 / 48000, pos, m, ec)):
        assert _same(g, w)


def test_envelope_tile_choice():
    """The insert loop's 8 linked rows of 2,903,040 frames take the wide
    tile (1,424 of them); a 20 s stream chunk's one row of 962,560 the
    narrow one (59 wide tiles would leave most SMs idle); a tile is never
    longer than the envelope block."""
    assert ck.env_tile_frames(8, 2_903_040, 0, 1 << 17) == ck.ENV_TILE
    assert ck.env_tile_frames(1, 962_560, 4096, 1 << 17) == ck.ENV_TILE_NARROW
    assert ck.env_tile_frames(600, 100, 0, 1 << 17) == ck.ENV_TILE
    assert ck.env_tile_frames(8, 2_903_040, 0, 256) == 256
    assert ck.ENV_TILE % ck.ENV_TILE_NARROW == 0 and (1 << 17) % ck.ENV_TILE == 0


def test_envelope_carries_come_from_the_block_maxima(monkeypatch):
    """Warp 1's fold: from the state's carry and each block's maximum S_b
    of fl(level + fl(j * c)) (the seed included), carry_{b+1} =
    max(fl(S_b - r_last), fl(carry_b - fl(c * B))) is the twin's env at
    block b's last frame, over nine blocks from mid-block."""
    B, pos, T = 256, 128 + 13, 2100
    monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", B)
    level = _level((2, 1, T), 110)
    m, ec = _state((2, 1), True, 111)
    cf = np.float32(0.01)
    env = _twin(level, 0.01, pos, m, ec)[0]
    j = ((pos + np.arange(T)) % B).astype(np.float32)
    v = level + j * cf
    carry, seed, a = ec.copy(), m.copy(), 0
    while a < T:
        n = min(T - a, B - (pos + a) % B)
        S = np.maximum(seed, v[..., a:a + n].max(axis=-1))
        if (pos + a + n) % B == 0:
            carry = _mx(S - np.float32(B - 1) * cf, carry - cf * np.float32(B))
            assert _same(carry, env[..., a + n - 1]), a
        seed, a = np.full_like(seed, -1e9), a + n


# ------------------------------------------------------ against the JAX package

def _jax_stream(level, c, pos, m, ec):
    got = jchain.Compressor._slanted_cummax_stream(
        jnp.asarray(level), c, jnp.int32(pos), jnp.asarray(m), jnp.asarray(ec))
    return tuple(np.asarray(t) for t in got)


@pytest.mark.parametrize("case", range(7))
@pytest.mark.parametrize("carried", [False, True])
def test_envelope_twin_is_jax_s_on_a_small_grid(case, carried, monkeypatch):
    """The twin against `f9tpu/ops/chain.py:733` with both packages'
    `_ENV_BLOCK` patched to 256, over the same chunks and states: bitwise."""
    monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", 256)
    monkeypatch.setattr(jchain.Compressor, "_ENV_BLOCK", 256)
    pos, T = _chunks(256)[case]
    level = _level((3, 1, T), 30 + case)
    m, ec = _state((3, 1), carried, 40 + case)
    for g, w in zip(_twin(level, 300.0 / 48000, pos, m, ec),
                    _jax_stream(level, 300.0 / 48000, pos, m, ec)):
        assert _same(g, w)


@pytest.mark.parametrize("pos,T", [(0, 5000), (65549, 70000), (131072 - 2100, 2100),
                                   (131072 - 700, 1900)])
def test_envelope_twin_is_jax_s_at_2_17(pos, T):
    """At 2^17: from the grid's start, mid-block, ending on the grid and
    across a boundary, from a carried state: bitwise."""
    level = _level((2, 1, T), 50 + pos % 89)
    m, ec = _state((2, 1), True, 6)
    for g, w in zip(_twin(level, 80.0 / 48000, pos, m, ec),
                    _jax_stream(level, 80.0 / 48000, pos, m, ec)):
        assert _same(g, w)


# ------------------------------------------------------ the windowed maximum

def _shifts(W):
    """The twin's tree: 1, 2, 4, ... while 2s <= W, then W - s."""
    shifts, s = [], 1
    while 2 * s <= W:
        shifts.append(s)
        s *= 2
    if W - s:
        shifts.append(W - s)
    return shifts


def _wmax_register_order(a, W, seg=None, offset=0):
    """`wmax_reg` replayed: a warp of 32 lanes streams a segment of ``seg``
    steps of a row (default `chain_kernels.wmax_segment_steps`), step k the
    positions 256k - off .. 256k - off + 255, lane l the 8 from 256k - off +
    8l, off the row's offset on the 16-byte grid (``offset`` floats at the
    first row); the segment starts ceil((W - 1) / 256) steps early with
    every level's carried values +0.0, and +0.0 is read outside the row.  A
    level of shift 8a + b: position u of a lane takes the level's input from
    lane - a (u >= b, position u - b) or lane - a - 1 (u - b + 8), a lane
    before 0 from the step before (the sending lane sends its step-before
    value when lane + r passes 31); r = 0 reads its own.  A step whose
    outputs' windows (it and the `warm` steps before) hold no NaN takes
    fmaxf alone."""
    a = np.asarray(a, np.float32)
    lead, T = a.shape[:-1], a.shape[-1]
    rows = a.reshape(-1, T)
    R = rows.shape[0]
    shifts = _shifts(W)
    steps = -(-(T + 3) // ck.WMAX_STEP)
    seg = seg or ck.wmax_segment_steps(R, T)
    warm = -(-(W - 1) // ck.WMAX_STEP)
    lane = np.arange(32)[:, None]
    out = np.full_like(rows, np.nan)
    for r in range(R):
        off = (offset + r * T) % 4
        for k0 in range(0, steps, seg):
            k1 = min(k0 + seg, steps)
            pv = np.zeros((len(shifts), 32, 8), np.float32)
            nans = 0
            for k in range(max(0, k0 - warm), k1):
                p = ck.WMAX_STEP * k - off + 8 * lane + np.arange(8)[None, :]     # (32, 8)
                inside = (p >= 0) & (p < T)
                f = np.where(inside, rows[r, np.clip(p, 0, T - 1)], np.float32(0))
                nans = (nans << 1) | int(np.isnan(f).any())
                mxf = _mx if nans & ((2 << warm) - 1) else np.fmax
                for lvl, sh in enumerate(shifts):
                    A, Bm = divmod(sh, 8)
                    g = np.empty_like(f)
                    for u in range(8):
                        j, rr = (u - Bm, A) if u >= Bm else (u - Bm + 8, A + 1)
                        if rr == 0:
                            src = f[:, j]
                        else:
                            send = np.where(np.arange(32) + rr < 32, f[:, j], pv[lvl][:, j])
                            src = send[(np.arange(32) - rr) % 32]
                        g[:, u] = mxf(f[:, u], src)
                    pv[lvl], f = f, g
                if k >= k0:
                    out[r, p[inside]] = f[inside]
    return out.reshape(*lead, T)


def _wmax_kernel_order(a, W, seg=None, offset=0):
    """`f9_window_max` replayed, dispatched by W as the kernel is: up to
    `WMAX_REG_MAX_W` the register form (`_wmax_register_order`); up to
    `WMAX_STAGED_MAX_W`, per tile of 2048 outputs the span of the outputs
    and the W - 1 positions before them (+0.0 before the row and past its
    end) through the twin's levels, each from one buffer into the other, a
    position below the level's shift keeping its value, the outputs at W -
    1 on; past it, each level over the whole row, +0.0 read before its
    start."""
    if W <= ck.WMAX_REG_MAX_W:
        return _wmax_register_order(a, W, seg, offset)
    a = np.asarray(a, np.float32)
    lead, T = a.shape[:-1], a.shape[-1]
    rows = a.reshape(-1, T)
    shifts = _shifts(W)
    if W <= ck.WMAX_STAGED_MAX_W:
        tiles = -(-T // WMAX_TILE)
        span = WMAX_TILE + W - 1
        padded = np.zeros((rows.shape[0], W - 1 + tiles * WMAX_TILE), np.float32)
        padded[:, W - 1:W - 1 + T] = rows
        f = padded[:, np.arange(tiles)[:, None] * WMAX_TILE + np.arange(span)[None, :]]
        for sh in shifts:
            h = f.copy()
            h[..., sh:] = _mx(f[..., sh:], f[..., :span - sh])
            f = h
        out = f[..., W - 1:].reshape(rows.shape[0], tiles * WMAX_TILE)[:, :T]
    else:
        out = rows
        for sh in shifts:
            prev = np.zeros_like(out)
            if sh < T:
                prev[:, sh:] = out[:, :T - sh]
            out = _mx(out, prev)
    return out.reshape(*lead, T)


def _signed(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[..., 500:600] = 0.25                       # a plateau
    return x


def _signed_zeros(shape, seed):
    """`_signed` with, where the row is long enough, runs and ties of both
    zeros (what the kernels' order must resolve as the port's twin does)."""
    x = _signed(shape, seed)
    x[..., 1000:1200:2] = -0.0
    x[..., 1001:1200:2] = 0.0
    x[..., 1400:1500] = -0.0
    return x


@pytest.mark.parametrize("W", [2, 3, 8, 9, 72, 73, 74, 289, 512, 513, 1025, 27009, 30000])
def test_window_max_kernel_order_is_the_twin_s(W):
    """Bitwise on signed input with ties of both zeros (negative outputs
    where the window lies past the start, +0.0 where it reaches before it),
    rows of 5000 frames, of 300 and a 1-D row: the register form up to
    `WMAX_REG_MAX_W` (512: W = 9 and 73 take a remainder of 1 lane and 1
    position, 289 one of 4 lanes and 1, 512 a last doubling of a whole
    step), the staged form from 513 to 27,009, the level launches at
    30,000."""
    for shape in ((3, 1, 5000), (2, 300), (4100,)):
        x = _signed_zeros(shape, W + len(shape))
        want = tchain._window_max_past_reference(torch.from_numpy(x), W).numpy()
        assert _same(_wmax_kernel_order(x, W), want), shape


@pytest.mark.parametrize("W", [2, 9, 73, 289, 511, 512])
@pytest.mark.parametrize("seg", [1, 2, 3, 7])
def test_window_max_register_segments_warm_up(W, seg):
    """Segments of 1-7 steps, each warmed from ceil((W - 1) / 256) steps
    before it (from the row's start with the carried values +0.0 where that
    reaches before it), on rows of 3000 frames four floats apart on the
    16-byte grid: bitwise the twin's."""
    x = _signed_zeros((4, 1, 3001), W + seg)
    want = tchain._window_max_past_reference(torch.from_numpy(x), W).numpy()
    assert _same(_wmax_kernel_order(x, W, seg=seg), want)


@pytest.mark.parametrize("offset", range(1, 4))
def test_window_max_register_rows_off_the_16_byte_grid(offset):
    """The row ``offset`` floats off the 16-byte grid: the first step starts
    1-3 positions before the row (read as +0.0): bitwise the twin's at W =
    3, 73 and 512."""
    x = _signed_zeros((3, 1001), 20 + offset)
    for W in (3, 73, 512):
        want = tchain._window_max_past_reference(torch.from_numpy(x), W).numpy()
        assert _same(_wmax_kernel_order(x, W, offset=offset), want), W


@pytest.mark.parametrize("W", [2, 73, 289, 512, 513])
def test_window_max_keeps_the_newest_nan(W):
    """NaNs of two payloads a few positions apart, one at a row's start and
    one in a segment's warm-up.  With torch's rule on the card (a NaN
    operand wins, the first if both) the twin's tree keeps the newest NaN in
    the window: the kernel's order (the register form's steps with a NaN in
    their windows taking that rule, the others fmaxf) keeps the same bits as
    the tree in numpy with that rule.  Torch's CPU maximum returns a NaN of
    its own, so against the CPU twin the NaNs fall on the same outputs and
    every other output is bitwise."""
    x = _signed_zeros((2, 1, 2600), 30 + W)
    na, nb = (np.array([w], np.uint32).view(np.float32)[0] for w in (0x7FC00001, 0xFFC00123))
    x[0, 0, 700], x[0, 0, 703] = na, nb
    x[1, 0, 0], x[1, 0, 1800] = nb, na
    tree = x
    for sh in _shifts(W):
        shifted = np.zeros_like(tree)
        shifted[..., sh:] = tree[..., :-sh]
        tree = _mx(tree, shifted)
    assert tree[0, 0, 704].view(np.uint32) == np.float32(nb).view(np.uint32)
    twin = tchain._window_max_past_reference(torch.from_numpy(x), W).numpy()
    for seg in (None, 2):
        got = _wmax_kernel_order(x, W, seg=seg)
        assert _same(got, tree), seg
        nan = np.isnan(twin)
        assert np.array_equal(np.isnan(got), nan) and _same(got[~nan], twin[~nan])


def test_window_max_register_limit_and_segments():
    """`WMAX_REG_MAX_W` is two steps (every shift of its tree at most one
    step, so a lane before lane 0 is in the step before); the segments aim
    at `WMAX_REG_WARPS` warps and take at least 2 steps."""
    assert ck.WMAX_REG_MAX_W == 2 * ck.WMAX_STEP
    assert max(_shifts(ck.WMAX_REG_MAX_W)) == ck.WMAX_STEP
    assert all(max(_shifts(W)) <= ck.WMAX_STEP for W in range(2, ck.WMAX_REG_MAX_W + 1))
    assert max(_shifts(ck.WMAX_REG_MAX_W + 1)) <= ck.WMAX_STEP    # the staged form takes it
    assert ck.wmax_segment_steps(8, 2_903_112) == 43
    assert ck.wmax_segment_steps(1, 962_632) == 2
    assert ck.wmax_segment_steps(1, 100) == 2
    rows, T = 8, 2_903_112
    steps = -(-(T + 3) // ck.WMAX_STEP)
    assert rows * -(-steps // ck.wmax_segment_steps(rows, T)) <= ck.WMAX_REG_WARPS


def test_window_max_staged_limit_is_the_kernel_s():
    """`chain_kernels.WMAX_STAGED_MAX_W` is the widest window whose two
    staged buffers (the levels run from one into the other) fit a block's
    227 KB (`csrc/dynamics.cu`), the limit the wrapper allocates the level
    launches' scratch row past."""
    assert 2 * 4 * (WMAX_TILE + ck.WMAX_STAGED_MAX_W - 1) <= 227 * 1024
    assert 2 * 4 * (WMAX_TILE + ck.WMAX_STAGED_MAX_W) > 227 * 1024


@pytest.mark.parametrize("W", [2, 3, 73, 1025])
def test_window_max_twin_is_jax_s_on_signed_input(W):
    """`_window_max_past_reference` against `f9tpu/ops/chain.py:902` on
    signed input: bitwise, the zero padding's +0.0 included."""
    x = _signed((2, 1, 3000), 60 + W)
    want = np.asarray(jchain._window_max_past(jnp.asarray(x), W))
    got = tchain._window_max_past_reference(torch.from_numpy(x), W).numpy()
    assert _same(got, want)
    assert np.all(got[..., :W - 1] >= 0.0)


def test_dispatch_keeps_the_eager_dynamics_on_the_cpu():
    """On the CPU the envelope and the windowed maximum are their twins, bit
    for bit; a window of 1 is the input."""
    level = torch.from_numpy(_level((2, 1, 3000), 7))
    m = torch.full((2, 1), -1e9)
    for g, w in zip(tchain.Compressor._slanted_cummax_stream(level, 0.01, 123, m, m),
                    tchain.Compressor._slanted_cummax_stream_reference(level, 0.01, 123, m, m)):
        assert _same(g.numpy(), w.numpy())
    x = torch.from_numpy(_signed((2, 3000), 8))
    assert _same(tchain._window_max_past(x, 73).numpy(),
                 tchain._window_max_past_reference(x, 73).numpy())
    assert tchain._window_max_past(x, 1) is x
