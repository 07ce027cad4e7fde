"""The dynamics stages' kernels (`f9tpu_torch/csrc/dynamics.cu`: the release
envelope ``f9_slanted_cummax`` and the windowed maximum ``f9_window_max``),
on the CPU.

- Each kernel's passes and indexing, replayed in numpy float32, equal the
  plain twin bit for bit: the envelope's tile maxima on the absolute grid,
  the walk per row (each tile's prefix, each block's maximum and incoming
  carry, the state out) and the rescan (a thread's 8 frames, the threads
  before it, the decayed carry), with `Compressor._ENV_BLOCK` patched to 256
  and at 2^17, chunks from mid-block, shorter than a tile, across several
  blocks, ending on the grid, from a carried state; the windowed maximum's
  staged levels (the twin's doubling tree from one buffer into the other)
  and its level launches past the staged width.  The CUDA sources compute
  in these orders, each rounding an `_rn` intrinsic.
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

ENV_THREADS, ENV_R = 256, 8
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


# ------------------------------------------------------ the envelope's passes

def _env_kernel_order(level, c, pos, m, env_carry, B):
    """`f9_slanted_cummax` replayed: (a) each tile's maximum of fl(level +
    fl(j * c)), 256 threads striding the tile, a warp's xor tree, warps in
    order; (b) per row, a thread per envelope block walking its tiles (each
    tile's exclusive prefix from the block's seed: m in the chunk's first
    block, -1e9 after), then the blocks' carries in order and the state
    out; (c) per tile, a thread's 8 consecutive frames, the prefix of the
    threads before it, then env = max(fl(s - r), fl(carry - fl(c * (j +
    1))))."""
    level = np.asarray(level, np.float32)
    lead, T = level.shape[:-1], level.shape[-1]
    rows = level.reshape(-1, T)
    R = rows.shape[0]
    mr = np.asarray(m, np.float32).reshape(R)
    cr = np.asarray(env_carry, np.float32).reshape(R)
    cf = np.float32(c)
    p0 = pos % B
    tile = min(ENV_R * ENV_THREADS, B)
    t0, tpb = p0 // tile, B // tile
    ntiles = -(-(p0 + T) // tile) - t0
    nblocks = -(-(p0 + T) // B)
    j = ((p0 + np.arange(T)) % B).astype(np.float32)
    r = j * cf
    v = rows + r
    spans = [(max(0, (t0 + k) * tile - p0), min(T, (t0 + k + 1) * tile - p0))
             for k in range(ntiles)]
    # (a)
    tmax = np.empty((R, ntiles), np.float32)
    for k, (a, b) in enumerate(spans):
        best = np.full((R, ENV_THREADS), -np.inf, np.float32)
        for i in range(a, b):
            t = (i - a) % ENV_THREADS
            best[:, t] = _mx(best[:, t], v[:, i])
        for o in (16, 8, 4, 2, 1):        # a warp's xor tree
            lanes = np.arange(ENV_THREADS)
            best = _mx(best, best[:, lanes ^ o])
        out = best[:, 0]
        for w in range(1, ENV_THREADS // 32):
            out = _mx(out, best[:, 32 * w])
        tmax[:, k] = out
    # (b)
    tpre = np.empty((R, ntiles), np.float32)
    sb = np.empty((R, nblocks), np.float32)
    for blk in range(nblocks):
        k0, k1 = max(0, blk * tpb - t0), min(ntiles, (blk + 1) * tpb - t0)
        s = mr.copy() if blk == 0 else np.full(R, -1e9, np.float32)
        for k in range(k0, k1):
            tpre[:, k] = s
            s = _mx(s, tmax[:, k])
        sb[:, blk] = s
    r_last = np.float32(B - 1) * cf
    decay_b = cf * np.float32(B)
    ends = (p0 + T) % B == 0
    cin = np.empty((R, nblocks), np.float32)
    carry = cr.copy()
    for blk in range(nblocks):
        cin[:, blk] = carry
        if blk + 1 < nblocks or ends:
            carry = _mx(sb[:, blk] - r_last, carry - decay_b)
    c_out = carry if ends else cin[:, -1]
    m_out = np.full(R, -1e9, np.float32) if ends else sb[:, -1]
    # (c)
    env = np.empty_like(rows)
    for k, (a, b) in enumerate(spans):
        n = b - a
        blk = (t0 + k) // tpb
        run = np.full((R, ENV_THREADS), -np.inf, np.float32)
        for i in range(n):
            t = i // ENV_R
            run[:, t] = _mx(run[:, t], v[:, a + i])
        s_thread = np.empty((R, ENV_THREADS), np.float32)
        s = tpre[:, k].copy()
        for t in range(ENV_THREADS):      # the threads before t, then t's frames
            s_thread[:, t] = s
            s = _mx(s, run[:, t])
        for i in range(n):
            t, u = divmod(i, ENV_R)
            if u == 0:
                s = s_thread[:, t]
            s = _mx(s, v[:, a + i])
            decay = cf * (j[a + i] + np.float32(1.0))
            env[:, a + i] = _mx(s - r[a + i], cin[:, blk] - decay)
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
                                   (131072 - 700, 1900)])
def test_envelope_kernel_order_is_the_twin_s_at_2_17(pos, T):
    """At the shipped block (2^17 frames, tiles of 2048): from the grid's
    start, from mid-block across tiles, shorter than a tile, ending exactly
    on the grid, and across one block boundary, from a carried state."""
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

def _wmax_kernel_order(a, W):
    """`f9_window_max` replayed: up to `WMAX_STAGED_MAX_W`, per tile of 2048
    outputs the span of the outputs and the W - 1 positions before them
    (+0.0 before the row and past its end) through the twin's levels, each
    from one buffer into the other, a position below the level's shift
    keeping its value, the outputs at W - 1 on; past it, each level over the
    whole row, +0.0 read before its start."""
    a = np.asarray(a, np.float32)
    lead, T = a.shape[:-1], a.shape[-1]
    rows = a.reshape(-1, T)
    shifts, s = [], 1
    while 2 * s <= W:
        shifts.append(s)
        s *= 2
    if W - s:
        shifts.append(W - s)
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


@pytest.mark.parametrize("W", [2, 3, 8, 73, 1025, 27009, 30000])
def test_window_max_kernel_order_is_the_twin_s(W):
    """Bitwise on signed input (negative outputs where the window lies past
    the start, +0.0 where it reaches before it), rows of 5000 frames (three
    tiles), of 300 (less than one) and a 1-D row; 27,009 is the widest
    staged window and 30,000 runs the level launches."""
    for shape in ((3, 1, 5000), (2, 300), (4100,)):
        x = _signed(shape, W + len(shape))
        want = tchain._window_max_past_reference(torch.from_numpy(x), W).numpy()
        assert _same(_wmax_kernel_order(x, W), want), shape


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
