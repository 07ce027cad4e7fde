"""The insert chain's kernels (`f9tpu_torch/ops/chain_kernels.py`,
`csrc/upols.cu`, `csrc/fold.cu`) and UPOLS's group form, on the CPU.

- The group form (`chain._upols_core`: a group of blocks through one
  batched rFFT, one multiply-sum, one batched irFFT) equals the per-block
  loop it replaced, kept here as `_parent_upols`, bit for bit: every K,
  row count, form (mono IR, one IR per channel) and group boundary, with
  `UPOLS_GROUP` patched small.  Streamed chunks equal the whole signal bit
  for bit however they cut the groups.
- `upols_mac_reference` is `_delay_line_sum(X * H)` per block, bitwise.
- The kernels' orders and indexing, replayed in numpy (the MAC's staged
  blocks and two-output lanes walking the halving tree in float64, its
  column form above 32 taps, the fold's eight-output windows, eights,
  16s and counter, the moving average's newest-first sum and its
  eight-output register windows), equal the
  plain twins bit for bit: the CUDA sources compute in these orders with
  one rounding per `_rn` intrinsic, and the MAC's FMA product is the
  twin's (`test_fma_product_is_the_twin_s`).
- Port against the JAX package: `_upols` / `_upols_stream` against
  `f9tpu/ops/chain.py:128,160` and `k_weight` against JAX's, <= -130 dB RMS,
  the bound of `tests/test_torch_chain.py::test_fft_convolve_matches_jax`
  (torch's CPU FFT is MKL's, JAX's pocketfft).
- The wrapper rule: a CPU tensor never loads the kernel library and counts
  no launch; a tensor off the CPU launches or raises, never the twin; each
  wrapper refuses what its kernel does not take (the envelope a block length
  that is not a power of two, a state of another shape, a level that is not
  contiguous; the windowed maximum W < 2) before the library is asked for.
  The envelope's and the windowed maximum's orders are replayed in
  `tests/test_torch_dynamics_kernels.py`.
- `cuda`-marked tests hold each kernel to its twin on the card; they skip
  without one (`chip_smoke.py --chain-kernels` runs them at full size)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.ops import loudness as jloud  # noqa: E402
from f9tpu_torch.ops import _build  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops import chain_kernels as ck  # noqa: E402
from f9tpu_torch.ops import loudness as tloud  # noqa: E402

B = 64


def _sig(shape, seed, level=0.5):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 48000.0
    return (level * np.sin(2 * np.pi * 441.0 * t)
            + 0.3 * level * rng.standard_normal(shape)).astype(np.float32)


def _irs(n_ir: int, channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    decay = np.exp(-np.arange(n_ir) / max(1.0, n_ir / 4))
    return (0.3 * rng.standard_normal((channels, n_ir)) * decay).astype(np.float32)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# ------------------------------------------- the parent's per-block loop

def _parent_step(fdl, win, H, B):
    Xi = torch.fft.rfft(win.contiguous(), n=2 * B, dim=-1)
    fdl = torch.cat([Xi[None], fdl[:-1]], dim=0)
    Y = tchain._delay_line_sum(fdl * H).to(torch.complex64)
    return fdl, torch.fft.irfft(Y, n=2 * B, dim=-1)[..., B:]


def _parent_upols(x, H, B):
    T = x.shape[-1]
    nb = max(1, -(-T // B))
    xp = F.pad(x, (B, nb * B - T))
    lead = torch.broadcast_shapes(x.shape[:-1], H.shape[1:-1])
    fdl = torch.zeros((H.shape[0], *lead, B + 1), dtype=torch.complex64)
    y = x.new_empty((*lead, nb * B))
    for i in range(nb):
        fdl, y[..., i * B:(i + 1) * B] = _parent_step(fdl, xp[..., i * B:i * B + 2 * B], H, B)
    return y[..., :T]


def _case(form: str, K: int, rows: int, nb: int, seed: int = 0):
    """(x, H, the group form, the parent) for a K-deep IR: `rows` mono
    signals through `_upols_rows`, or `rows` stereo files with one IR per
    channel through `_upols_channels`; T = nb * B - 5 frames."""
    T = nb * B - 5
    if form == "mono":
        ir = _irs(K * B - 7 if K > 1 else B - 7, 1, seed + K)
        H = tchain._spectrum([tchain._partition_ir(ir[0], B)], "cpu")[:, 0]
        x = torch.from_numpy(_sig((rows, T), seed + 1))
        return x, H, (lambda v: tchain._upols_rows(v, H, B)), (lambda v: _parent_upols(v, H, B))
    irs = _irs(K * B - 7 if K > 1 else B - 7, 2, seed + K)
    H = tchain._spectrum([tchain._partition_ir(r, B) for r in irs], "cpu")
    x = torch.from_numpy(_sig((rows, 2, T), seed + 1))

    def parent(v):
        y = _parent_upols(torch.movedim(v, -2, 0).reshape(2, -1, T), H, B)
        return torch.movedim(y.reshape(2, *v.shape[:-2], T), 0, -2)

    return x, H, (lambda v: tchain._upols_channels(v, H, B)), parent


@pytest.mark.parametrize("form", ["mono", "true_stereo"])
@pytest.mark.parametrize("K", [1, 2, 7, 30])
@pytest.mark.parametrize("rows", [1, 3, 16])
def test_group_form_is_the_per_block_loop(form, K, rows, monkeypatch):
    """Bitwise, with groups of 3: 2 blocks (one short group), 3 (one whole
    group), 4 (a group and one block) and 10 (many) blocks."""
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 3)
    assert tchain._partition_ir(np.zeros(K * B - 7 if K > 1 else B - 7, np.float32),
                                B)[0].shape[0] == K
    for nb in (2, 3, 4, 10):
        x, _H, group, parent = _case(form, K, rows, nb)
        assert _same(group(x), parent(x)), (form, K, rows, nb)


@pytest.mark.parametrize("form", ["mono", "true_stereo"])
@pytest.mark.parametrize("K", [1, 7, 30])
@pytest.mark.parametrize("rows", [1, 3, 16])
def test_row_tiles_are_the_per_block_loop(form, K, rows, monkeypatch):
    """The card's form, FFT calls of a fixed number of rows (here 2: a short
    last tile for 1, 3 and 3 x 2 rows), bitwise the per-block loop, with
    groups of 3 over 2, 4 and 10 blocks; streamed chunks of 1 and 4 blocks
    equal the whole."""
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 3)
    monkeypatch.setattr(tchain, "_fft_rows", lambda n, device: 2)
    for nb in (2, 4, 10):
        x, H, group, parent = _case(form, K, rows, nb)
        whole = group(x)
        assert _same(whole, parent(x)), (form, K, rows, nb)
    x, H, _group, _parent = _case(form, K, rows, 11)
    x = x[..., :10 * B].contiguous()
    if form == "true_stereo":            # the reverb's streamed layout, one row per IR
        x = x[0][:, None, :]
    whole = tchain._upols(x, H, B)
    for blocks in (1, 4):
        state = tchain._upols_state(tuple(whole.shape[:-1]), K, B, "cpu")
        out = []
        for a in range(0, 10 * B, blocks * B):
            y, state = tchain._upols_stream(x[..., a:a + blocks * B], state, H, B)
            out.append(y)
        assert _same(torch.cat(out, dim=-1), whole), (form, K, rows, blocks)


def test_group_form_at_the_insert_loop_s_block(monkeypatch):
    """Bitwise at B = 1024 (n = 2048 FFTs), K = 7, 16 rows, groups of 5
    over 12 blocks, on 8 threads: the FFT gives each row the same bits in a
    batch of 16 rows and of 80."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 5)
    try:
        b = 1024
        ir = _irs(7 * b - 37, 1, 3)[0]
        H = tchain._spectrum([tchain._partition_ir(ir, b)], "cpu")[:, 0]
        x = torch.from_numpy(_sig((16, 12 * b + 100), 4))
        assert _same(tchain._upols_rows(x, H, b), _parent_upols(x, H, b))
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("form", ["mono", "true_stereo"])
@pytest.mark.parametrize("K", [1, 7, 30])
def test_streamed_chunks_equal_the_whole(form, K, monkeypatch):
    """Bitwise: chunks of 1, G - 1, G, G + 1 and 2G + 1 blocks (G = 3),
    each from the state the last left, equal the whole signal's `_upols`;
    the state keeps the last K - 1 spectra."""
    G = 3
    monkeypatch.setattr(tchain, "UPOLS_GROUP", G)
    nb = 23
    x, H, _group, _parent = _case(form, K, 3, nb + 1)
    x = x[..., :nb * B].contiguous()
    if form == "true_stereo":            # the reverb's streamed layout, one row per IR
        x = x[0][:, None, :]
    whole = tchain._upols(x, H, B)
    for blocks in (1, G - 1, G, G + 1, 2 * G + 1):
        state = tchain._upols_state(tuple(whole.shape[:-1]), H.shape[0], B, "cpu")
        out, a = [], 0
        while a < nb * B:
            b = min(nb * B, a + blocks * B)
            y, state = tchain._upols_stream(x[..., a:b], state, H, B)
            out.append(y)
            a = b
        assert state[0].shape[0] == K - 1
        assert _same(torch.cat(out, dim=-1), whole), (form, K, blocks)


def test_stage_streams_across_group_boundaries(monkeypatch):
    """A stereo reverb and a long FIR streamed at 1, 2 and 5 blocks a chunk
    equal their `apply` bit for bit, with groups of 2."""
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 2)
    rate = 48000
    stages = [tchain.ConvolutionReverb(_irs(9000, 2, 5), wet=0.7),
              tchain.ConvolutionReverb(_irs(9000, 1, 6)[0], wet=0.7, dry=0.5),
              tchain.FIRInsert(_irs(5000, 1, 7)[0])]
    x = torch.from_numpy(_sig((2, 11 * 4096), 8))
    for st in stages:
        grid = st.stream_grid(rate)
        assert grid == 4096
        whole = st.apply(x, rate)
        for blocks in (1, 2, 5):
            state = st.stream_state(rate, 2, "cpu")
            out = []
            for a in range(0, x.shape[-1], blocks * grid):
                y, state = st.apply_stream(x[:, a:a + blocks * grid], state, rate, a)
                out.append(y)
            assert _same(torch.cat(out, dim=-1), whole), (type(st).__name__, blocks)


@pytest.mark.parametrize("n", [8192, 16384, 32768, 6000])
def test_fft_row_bits_do_not_depend_on_the_rows_beside_it(n):
    """The group form's premise on the CPU, on 8 threads: the first ``rows``
    rows of each block take the same bits in a batch of ``UPOLS_GROUP x
    rows`` as in one of ``UPOLS_GROUP x 8``, rFFT and irFFT, at the
    insert loop's n, the two next blocks `_fft_block_size` picks and one n
    that is not a power of two."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        G = tchain.UPOLS_GROUP
        x = torch.from_numpy(_sig((G, 8, n), n))
        X = torch.fft.rfft(x, n=n, dim=-1)
        wide_r, wide_i = _bits(X), _bits(torch.fft.irfft(X, n=n, dim=-1))
        for rows in (1, 2, 3):
            r = _bits(torch.fft.rfft(x[:, :rows].contiguous(), n=n, dim=-1))
            i = _bits(torch.fft.irfft(X[:, :rows].contiguous(), n=n, dim=-1))
            assert torch.equal(r, wide_r[:, :rows]), (n, rows)
            assert torch.equal(i, wide_i[:, :rows]), (n, rows)
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("b", [8192, 4099])
def test_streamed_equals_whole_where_one_row_transforms_apart(b, monkeypatch):
    """Bitwise, one mono row on 8 threads, at blocks where MKL rounds a
    batch of one row apart from a batch of several (n = 16384 on several
    threads, n = 8198 = 2 x 4099 on any): chunks of 1 and 2 blocks equal
    the whole signal, groups of 3, because every transform is of a whole
    group."""
    before = torch.get_num_threads()
    torch.set_num_threads(8)
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 3)
    try:
        ir = _irs(2 * b - 11, 1, b)[0]
        H = tchain._spectrum([tchain._partition_ir(ir, b)], "cpu")[:, 0]
        nb = 7
        x = torch.from_numpy(_sig((1, nb * b), b + 1))
        whole = tchain._upols(x, H, b)
        for blocks in (1, 2):
            state = tchain._upols_state((1,), H.shape[0], b, "cpu")
            out = []
            for a in range(0, nb * b, blocks * b):
                y, state = tchain._upols_stream(x[..., a:a + blocks * b], state, H, b)
                out.append(y)
            assert _same(torch.cat(out, dim=-1), whole), (b, blocks)
    finally:
        torch.set_num_threads(before)


def test_a_float64_signal_is_the_per_block_loop_s(monkeypatch):
    """A float64 signal goes through complex128 spectra as the per-block
    loop took it, bitwise, and `fft_convolve` returns float64."""
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 3)
    ir = _irs(7 * B - 7, 1, 9)[0]
    H = tchain._spectrum([tchain._partition_ir(ir, B)], "cpu")[:, 0]
    x = torch.from_numpy(_sig((3, 10 * B - 5), 10).astype(np.float64))
    assert _same(tchain._upols_rows(x, H, B), _parent_upols(x, H, B))
    y = tchain.fft_convolve(x, ir, block=B)
    assert y.dtype == torch.float64 and _same(y, _parent_upols(x, H, B))


@pytest.mark.parametrize("K,G", [(1, 1), (2, 3), (7, 4), (30, 2)])
def test_mac_reference_is_the_delay_line_sum_per_block(K, G):
    """`upols_mac_reference` equals ``_delay_line_sum(X * H)`` over each
    block's newest-first delay line, bit for bit, mono and two-row H."""
    rng = np.random.default_rng(K)
    rows, Nf = 4, 33
    parts = rng.standard_normal((2, K - 1 + G, rows, Nf)).astype(np.float32)
    buf = torch.complex(torch.from_numpy(parts[0]), torch.from_numpy(parts[1]))
    for hrows in (1, 2):
        shape = (K, 1, Nf) if hrows == 1 else (K, 2, 1, Nf)
        H = torch.complex(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)),
                          torch.from_numpy(rng.standard_normal(shape).astype(np.float32)))
        b = buf if hrows == 1 else buf.reshape(K - 1 + G, 2, 2, Nf)
        got = ck.upols_mac_reference(b, H, G)
        for g in range(G):
            X = torch.stack([b[K - 1 + g - k] for k in range(K)])
            want = tchain._delay_line_sum(X * H.to(torch.complex128)).to(torch.complex64)
            assert _same(got[g], want), (K, G, hrows, g)


# ------------------------------------------- the kernels' orders in numpy

#: `csrc/upols.cu`'s geometry: bins a block, outputs a block, outputs a lane,
#: rows a block, and the deepest delay line of the register-tree kernel
MAC_TB, MAC_GB, MAC_GN, MAC_RB, MAC_REG_MAX_K = 32, 32, 2, 2, 32
#: `csrc/fold.cu`'s geometry: outputs a thread, threads a block
FOLD_R, FOLD_THREADS = 8, 128


def _complex(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """complex64 from its parts, signed zeros kept (``re + 1j * im`` turns
    an imaginary -0.0 into +0.0)."""
    z = np.empty(np.shape(re), np.complex64)
    z.real, z.imag = re, im
    return z


def _fma(a: float, b: float, c: float) -> float:
    """``a * b + c`` rounded once to float64, as the card's FMA does: the
    exact value from `fractions.Fraction`, rounded by ``float()``; an exact
    zero takes IEEE's sign (``-0`` only when the exact product and ``c`` are
    both zeros of negative sign)."""
    from fractions import Fraction

    exact = Fraction(a) * Fraction(b) + Fraction(c)
    if exact != 0:
        return float(exact)
    p = a * b                           # exact; a zero carries the product's sign
    return -0.0 if (p == 0 and c == 0 and np.signbit(p) and np.signbit(c)) else 0.0


def test_fma_product_is_the_twin_s():
    """The kernel's product ``(fma(a, c, -b*d), fma(a, d, b*c))`` of float32
    parts equals the twin's complex128 product bit for bit: every quadruple
    of ±0.0, ±subnormals, ±1, ±3.4e38 and random values, and random
    quadruples."""
    f32 = np.finfo(np.float32)
    special = [0.0, -0.0, float(f32.smallest_subnormal), -float(f32.smallest_subnormal),
               float(np.float32(3e-39)), 1.0, -1.0, float(f32.max), -float(f32.max),
               float(np.float32(1.5)), float(np.float32(-0.3))]
    rng = np.random.default_rng(15)
    quads = [(a, b, c, d) for a in special for b in special for c in special[::2]
             for d in special[1::2]]
    quads += [tuple(float(v) for v in q)
              for q in (rng.standard_normal((3000, 4)) * 10.0 ** rng.integers(-30, 30, (3000, 1)))
              .astype(np.float32)]
    q = np.array(quads, np.float32)
    x = torch.complex(torch.from_numpy(q[:, 0]), torch.from_numpy(q[:, 1]))
    h = torch.complex(torch.from_numpy(q[:, 2]), torch.from_numpy(q[:, 3])).to(torch.complex128)
    twin = _bits(x.to(torch.complex128) * h).numpy().reshape(-1, 2)
    got = np.array([(_fma(a, c, -(b * d)), _fma(a, d, b * c)) for a, b, c, d in quads])
    assert np.array_equal(got.view(np.int64), twin)


def _mac_kernel_order(buf: np.ndarray, H: np.ndarray, G: int) -> np.ndarray:
    """`csrc/upols.cu` for ``buf (K - 1 + G, rows, Nf)`` and ``H (K, Hrows,
    Nf)`` complex64, in numpy float64, block by block as the card runs it.

    K <= 32 (`upols_mac_reg`): a block stages 32 bins of H and of up to two
    rows' ``K - 1 + 32`` spectra as float64 (+0.0 past the row and past its
    outputs); a lane walks the halving tree depth first for 2 consecutive
    outputs at once, reading output j's spectrum for tap k at ``K - 1 + g +
    j - k``.  K > 32 (`upols_mac_col`): the tree's first level as the
    products are formed, then the halving levels over the ceil(K/2)
    partials.  A product ``ac - bd``, ``ad + bc`` of float64 copies of
    float32 parts is exact before its one rounding, so numpy's form is the
    kernel's FMA form (`test_fma_product_is_the_twin_s`)."""
    K, rows, Nf = H.shape[0], buf.shape[1], buf.shape[2]
    Hrows = H.shape[1]
    rph = rows // Hrows
    Y = np.full((G, rows, Nf), np.nan, np.complex64)

    def prod(xr, xi, hr, hi):
        return xr * hr - xi * hi, xr * hi + xi * hr

    def add(p, q):
        return p[0] + q[0], p[1] + q[1]

    if K > MAC_REG_MAX_K:
        X = buf.astype(np.complex128)
        Hc = H.astype(np.complex128)[:, np.repeat(np.arange(Hrows), rph)]   # (K, rows, Nf)
        for g in range(G):
            def p_k(k, g=g):
                x, h = X[K - 1 + g - k], Hc[k]
                return prod(x.real, x.imag, h.real, h.imag)
            n = (K + 1) // 2
            p = [add(p_k(i), p_k(i + n)) if i + n < K else p_k(i) for i in range(n)]
            while n > 1:
                hh = (n + 1) // 2
                for i in range(n - hh):
                    p[i] = add(p[i], p[i + hh])
                n = hh
            Y[g] = _complex(p[0][0].astype(np.float32), p[0][1].astype(np.float32))
        return Y

    def width(L):
        n = K
        for _ in range(L):
            n = (n + 1) // 2
        return n

    levels = 0
    while width(levels) > 1:
        levels += 1
    XR = K - 1 + MAC_GB
    tiles, chunks = -(-Nf // MAC_TB), -(-rph // MAC_RB)
    for gb in range(-(-G // MAC_GB)):
        for hr in range(Hrows):
            for c in range(chunks):
                for t in range(tiles):
                    r0, g0, f0 = hr * rph + c * MAC_RB, gb * MAC_GB, t * MAC_TB
                    rbv, gbv = min(MAC_RB, rph - c * MAC_RB), min(MAC_GB, G - g0)
                    nf = min(MAC_TB, Nf - f0)
                    hs = np.zeros((2, K, MAC_TB))
                    hs[0, :, :nf] = H[:, hr, f0:f0 + nf].real
                    hs[1, :, :nf] = H[:, hr, f0:f0 + nf].imag
                    xs = np.zeros((2, rbv, XR, MAC_TB))
                    part = buf[g0:g0 + K - 1 + gbv, r0:r0 + rbv, f0:f0 + nf].transpose(1, 0, 2)
                    xs[0, :, :K - 1 + gbv, :nf] = part.real
                    xs[1, :, :K - 1 + gbv, :nf] = part.imag
                    per_row = -(-gbv // MAC_GN)
                    for it in range(rbv * per_row):
                        rr, g = divmod(it, per_row)
                        g *= MAC_GN

                        def node(L, i, rr=rr, g=g):
                            if L == 0:          # (MAC_GN, lanes): output j's tap i
                                a = K - 1 + g - i
                                return prod(xs[0, rr, a:a + MAC_GN], xs[1, rr, a:a + MAC_GN],
                                            hs[0, i], hs[1, i])
                            left = node(L - 1, i)
                            if i + width(L) < width(L - 1):
                                return add(left, node(L - 1, i + width(L)))
                            return left

                        re, im = node(levels, 0)
                        for j in range(min(MAC_GN, gbv - g)):
                            Y[g0 + g + j, r0 + rr, f0:f0 + nf] = _complex(
                                re[j, :nf].astype(np.float32), im[j, :nf].astype(np.float32))
    return Y


@pytest.mark.parametrize("K", [1, 2, 3, 5, 7, 8, 16, 17, 30, 31, 32, 33, 64])
def test_mac_kernel_order_is_the_twin_s(K):
    """The MAC kernels' arithmetic replayed in numpy float64 (the register
    tree's staged blocks and 2-output lanes for K <= 32, the column form
    above) equals `upols_mac_reference` bit for bit, with an H row shared by
    3 signal rows (a row chunk of 2 and one of 1), groups of 3 and of 37 (two
    output blocks, the last short), 17 and 40 bins (a short bin tile), and
    exact zeros of both signs among the spectra."""
    rng = np.random.default_rng(100 + K)
    for G, Nf in ((3, 17), (37, 40)):
        shape = (K - 1 + G, 6, Nf)
        re = rng.standard_normal(shape).astype(np.float32)
        im = rng.standard_normal(shape).astype(np.float32)
        re[0, :, :4], im[0, :, 2:6] = 0.0, -0.0
        hre = (rng.standard_normal((K, 2, Nf)) * 3).astype(np.float32)
        him = (rng.standard_normal((K, 2, Nf)) * 3).astype(np.float32)
        him[0, 0, :3] = -0.0
        buf, H = _complex(re, im), _complex(hre, him)
        want = ck.upols_mac_reference(torch.from_numpy(buf).view(K - 1 + G, 2, 3, Nf),
                                      torch.from_numpy(H).view(K, 2, 1, Nf), G)
        got = _mac_kernel_order(buf, H, G)
        assert _same(torch.from_numpy(got), want.view(G, 6, Nf)), (K, G)


def _fold_kernel_order(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """`csrc/fold.cu` fir_fold_kernel for ``x (rows, T)`` in numpy float32,
    every thread of every block at once, as the card indexes it: a block
    stages ``8q + 7`` samples before its 1024 outputs (+0.0 outside the row)
    and the taps (+0.0 past W, ``8q + 8`` of them, q = W // 8); thread t
    owns outputs ``8t .. 8t + 7`` and walks the taps in eights, the window
    ``w[7 + i - u]`` of output i and tap 8j + u made of the eight samples
    new in step j and the seven newest of step j - 1; two eights make a 16,
    the 16s enter a binary counter (levels 0-2 in registers, 3-8 in shared
    memory on the card: the same values), and the last eight
    (odd q), the last W mod 8 taps and the counter's levels are merged from
    the smallest up."""
    W, (rows, T) = taps.shape[0], x.shape
    q, r = W >> 3, W & 7
    qp = q >> 1
    tile = FOLD_R * FOLD_THREADS
    tiles = -(-T // tile)
    pre = 8 * q + 7
    tp = np.zeros(8 * q + 8, np.float32)
    tp[:W] = taps
    # the staged span of every block, (rows * tiles, pre + tile + 1)
    xp = np.zeros((rows, pre + tiles * tile + 1), np.float32)
    xp[:, pre:pre + T] = x
    span = (np.arange(tiles)[:, None] * tile + np.arange(pre + tile + 1)[None, :])
    xs = xp[:, span].reshape(rows * tiles, -1)
    lanes = 8 * q + FOLD_R * np.arange(FOLD_THREADS)       # xw: step 0's window start

    def load8(off):                                           # (blocks, threads, 8)
        return xs[:, (lanes + off)[:, None] + np.arange(8)[None, :]]

    def eight(now, last, j):
        tk = tp[8 * j:8 * j + 8]
        t = []
        for i in range(FOLD_R):
            a = [(now[..., 7 + i - u] if 7 + i - u < 8 else last[..., i - u - 1]) * tk[u]
                 for u in range(8)]
            t.append(((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7])))
        return t

    C = load8(8)
    hp = {}
    for ip in range(qp):
        j = 2 * ip
        A = load8(-8 * j)
        te = eight(A, C, j)
        C = load8(-8 * (j + 1))
        t = [e + o for e, o in zip(te, eight(C, A, j + 1))]
        lv = 0
        while (ip >> lv) & 1:
            t = [h + v for h, v in zip(hp[lv], t)]
            lv += 1
        hp[lv] = t
    if q & 1:
        A = load8(-8 * (q - 1))
        lone = eight(A, C, q - 1)
    w0, w1, tk = load8(-8 * q), load8(-8 * q + 8), tp[8 * q:8 * q + 8]
    out = []
    for i in range(FOLD_R):
        def p(u, i=i):
            m = 7 + i - u
            return (w0[..., m] if m < 8 else w1[..., m - 8]) * tk[u]
        s = {}
        if r > 0:
            s[0] = p(0)
        if r > 1:
            s[1] = s[0] + p(1)
        if r > 2:
            s[0] = p(2)
        if r > 3:
            s[2] = s[1] + (s[0] + p(3))
        if r > 4:
            s[0] = p(4)
        if r > 5:
            s[1] = s[0] + p(5)
        if r > 6:
            s[0] = p(6)
        acc = None
        for lv in range(3):
            if (r >> lv) & 1:
                acc = s[lv] if acc is None else s[lv] + acc
        if q & 1:
            acc = lone[i] if acc is None else lone[i] + acc
        for lv in range(10):
            if (qp >> lv) & 1:
                acc = hp[lv][i] if acc is None else hp[lv][i] + acc
        out.append(acc)
    y = np.stack(out, axis=-1).reshape(rows, tiles * tile)
    return y[:, :T]


@pytest.mark.parametrize("W", [2, 3, 7, 8, 9, 15, 16, 17, 24, 63, 64, 65, 127, 351, 1024, 5631,
                               5632])
def test_fold_kernel_order_is_the_twin_s(W):
    """The fold kernel's order and indexing replayed in numpy float32 equal
    `_fir_fold_reference` bit for bit, on rows of 1500 frames (a whole tile
    and a short one) and of 300 (less than a tile) that start with exact
    zeros (+0.0 and -0.0), with taps of both signs: even a zero's sign.  W
    covers the eights' edges, 16 (two eights), R * 8 +- 1 (R = 8 outputs a
    thread) and `FOLD_MAX_W`."""
    taps = _sig((W,), W, level=1.0 / np.sqrt(W))
    taps[::3] *= -1.0
    for T in (1500, 300):
        x = _sig((2, T), W + 1)
        x[0, :40] = 0.0
        x[1, :40] = -0.0
        want = tchain._fir_fold_reference(torch.from_numpy(x), taps).numpy()
        got = _fold_kernel_order(x, taps)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), T


@pytest.mark.parametrize("win", [2, 48, 73, 240, 4801])
def test_ma_kernel_order_is_the_twin_s(win):
    """The moving-average kernel's order (x[n] first, then x[n-1] back to
    x[n-win+1], +0.0 before the start, times f32(1/win)) equals
    `_uniform_ma_past_reference` bit for bit, zeros of both signs at the
    start included."""
    x = np.square(_sig((2, 6000), win))
    x[1, :100] = -0.0
    T = x.shape[-1]
    xp = np.concatenate([np.zeros((2, win - 1), np.float32), x], axis=-1)
    acc = xp[:, win - 1:].copy()
    for k in range(1, win):
        acc = acc + xp[:, win - 1 - k:win - 1 - k + T]
    got = acc * np.float32(1.0 / win)
    want = tchain._uniform_ma_past_reference(torch.from_numpy(x), win).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


MA_R, MA_THREADS = 8, 256
MA_TILE = MA_R * MA_THREADS


def _ma_kernel_order(x: np.ndarray, win: int) -> np.ndarray:
    """The moving-average kernel (`csrc/fold.cu` ma_past_tiles) replayed in
    numpy float32: per tile of `MA_TILE` outputs the staged span of pre =
    8 * ((win - 1) // 8 + 1) samples before it (+0.0 outside the row; the
    unstaged form, ma_past_rows, reads the same values from the row), thread t
    owning outputs nt + i, nt = n0 + 8t, i < 8: acc_i = x[nt + i], then eights
    of steps k = 1 + 8j + u adding x[nt + i - k] = now[7 + i - u] or
    last[i - u - 1], the two windows A and C taking the roles in turns, the
    last (win - 1) % 8 steps from a window loaded whole, times f32(1 /
    win)."""
    x = np.asarray(x, np.float32)
    lead, T = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, T)
    q, r = (win - 1) // 8, (win - 1) % 8
    pre = 8 * (q + 1)
    tiles = -(-T // MA_TILE)
    padded = np.zeros((rows.shape[0], pre + tiles * MA_TILE), np.float32)
    padded[:, pre:pre + T] = rows
    xs = padded[:, np.arange(tiles)[:, None] * MA_TILE + np.arange(pre + MA_TILE)[None, :]]
    base = pre + MA_R * np.arange(MA_THREADS)            # nt's index in the span

    def load(off):                                        # (rows, tiles, threads, 8)
        return xs[:, :, off[:, None] + np.arange(8)[None, :]]

    def eight(now, last, steps):
        for u in range(steps):
            for i in range(MA_R):
                m = MA_R - 1 + i - u
                acc[i] = acc[i] + (now[..., m] if m < MA_R else last[..., m - MA_R])

    C = load(base)
    acc = [C[..., i].copy() for i in range(MA_R)]
    j = 0
    while j + 1 < q:
        A = load(base - MA_R * (j + 1))
        eight(A, C, MA_R)
        C = load(base - MA_R * (j + 2))
        eight(C, A, MA_R)
        j += 2
    if j < q:
        A = load(base - MA_R * (j + 1))
        eight(A, C, MA_R)
        C = A
    if r:
        eight(load(base - MA_R * (q + 1)), C, r)
    out = np.stack([a * np.float32(1.0 / win) for a in acc], axis=-1)
    return out.reshape(rows.shape[0], tiles * MA_TILE)[:, :T].reshape(*lead, T)


@pytest.mark.parametrize("win", [2, 3, 9, 16, 17, 48, 73, 240, 4801, 12000, 60000])
def test_ma_register_order_is_the_twin_s(win):
    """The redesigned kernel's order (8 outputs a thread, their window slid
    through registers by eights, two windows in turns) equals
    `_uniform_ma_past_reference` bit for bit on rows of 5000 frames (three
    tiles) that start with zeros of both signs, on rows of 300 (less than a
    tile) and a 1-D row; win covers an odd and an even number of eights,
    eights with and without a remainder, a span past 48 KB (12,000) and one
    past a block's 227 KB (60,000, read from the row)."""
    for shape in ((2, 5000), (3, 1, 300), (2500,)):
        x = np.square(_sig(shape, win + len(shape)))
        x[..., :60] = 0.0
        x[..., 1:60:2] = -0.0
        want = tchain._uniform_ma_past_reference(torch.from_numpy(x), win).numpy()
        got = _ma_kernel_order(x, win)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), shape


def test_dispatch_keeps_the_eager_forms_on_the_cpu():
    """On the CPU `_fir_fold` is the reference and `_uniform_ma_past` too,
    bit for bit; one tap is one multiply and a window of 1 the input."""
    x = torch.from_numpy(_sig((2, 3, 900), 1))
    taps = _sig((51,), 2, level=0.1)
    assert _same(tchain._fir_fold(x, taps), tchain._fir_fold_reference(x, taps))
    assert _same(tchain._fir_fold(x, taps[:1]), x * float(taps[0]))
    assert _same(tchain._uniform_ma_past(x, 37), tchain._uniform_ma_past_reference(x, 37))
    assert tchain._uniform_ma_past(x, 1) is x


# ------------------------------------------------------ against the JAX package

def _db(got, want):
    e = np.sqrt(np.mean(np.square(got.astype(np.float64) - want)))
    r = np.sqrt(np.mean(np.square(want.astype(np.float64))))
    return 20.0 * np.log10(max(e, 1e-300) / r)


@pytest.mark.parametrize("K", [1, 7, 30])
def test_upols_matches_jax(K, monkeypatch):
    """`_upols` (groups of 4) against `f9tpu/ops/chain.py:128 _upols` on 3
    rows: <= -130 dB RMS."""
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 4)
    ir = _irs(K * B - 3, 1, 20 + K)[0]
    h_re, h_im = tchain._partition_ir(ir, B)
    x = _sig((3, 11 * B + 17), 21)
    want = np.asarray(jchain._upols(jnp.asarray(x), jnp.asarray(h_re), jnp.asarray(h_im), B))
    H = tchain._spectrum([(h_re, h_im)], "cpu")[:, 0]
    got = tchain._upols(torch.from_numpy(x), H, B).numpy()
    assert got.shape == want.shape
    assert _db(got, want) <= -130.0


@pytest.mark.parametrize("K", [1, 7, 30])
def test_upols_stream_matches_jax(K, monkeypatch):
    """`_upols_stream` chunk by chunk (2, 5 and 3 blocks, groups of 2)
    against `f9tpu/ops/chain.py:160 _upols_stream` from the same zero
    state: <= -130 dB RMS, and the port's carried spectra are JAX's delay
    line without its oldest entry, newest last, to the same bound."""
    monkeypatch.setattr(tchain, "UPOLS_GROUP", 2)
    ir = _irs(K * B - 3, 1, 30 + K)[0]
    h_re, h_im = tchain._partition_ir(ir, B)
    x = _sig((2, 10 * B), 31)
    H = tchain._spectrum([(h_re, h_im)], "cpu")[:, 0]
    state = tchain._upols_state((2,), K, B, "cpu")
    prev = jnp.zeros((2, B), jnp.float32)
    fre = fim = jnp.zeros((K, 2, B + 1), jnp.float32)
    got, want, a = [], [], 0
    for blocks in (2, 5, 3):
        seg = x[:, a:a + blocks * B]
        y, state = tchain._upols_stream(torch.from_numpy(seg), state, H, B)
        got.append(y.numpy())
        yj, prev, fre, fim = jchain._upols_stream(jnp.asarray(seg), prev, fre, fim,
                                                  jnp.asarray(h_re), jnp.asarray(h_im), B)
        want.append(np.asarray(yj))
        a += blocks * B
    assert _db(np.concatenate(got, -1), np.concatenate(want, -1)) <= -130.0
    assert np.array_equal(state[1].numpy(), np.asarray(prev))
    if K > 1:
        jd = np.asarray(fre)[:K - 1][::-1] + 1j * np.asarray(fim)[:K - 1][::-1]
        err = np.sqrt(np.mean(np.abs(state[0].numpy() - jd) ** 2))
        assert 20.0 * np.log10(err / np.sqrt(np.mean(np.abs(jd) ** 2))) <= -130.0


def test_k_weight_matches_jax():
    """The meter's K-weighting (~5k taps, B = 4096, K = 2) on 2 x 70,000
    frames, past JAX's direct-form threshold: <= -130 dB RMS."""
    x = _sig((2, 70000), 40, level=0.3)
    want = np.asarray(jloud.k_weight(jnp.asarray(x)))
    got = tloud.k_weight(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert _db(got, want) <= -130.0


# ------------------------------------------------------ the wrapper rule

def _counts():
    return ck.launches_mac, ck.launches_fold, ck.launches_ma, ck.launches_env, ck.launches_wmax


def test_a_cpu_tensor_never_loads_the_library(monkeypatch):
    """The UPOLS convolvers, the fold, the moving average, the envelope and
    the windowed maximum on CPU tensors run their twins: the library is
    never loaded and no launch counts."""
    def no_build():
        raise AssertionError("a CPU tensor loaded the kernel library")

    monkeypatch.setattr(_build, "load_library", no_build)
    n0 = _counts()
    x = torch.from_numpy(_sig((2, 2, 5000), 50))
    tchain.fft_convolve(x, _irs(900, 1, 51)[0], block=128)
    tchain._fft_convolve_multi(x, _irs(700, 2, 52), block=128)
    tchain._fir_fold(x, _sig((33,), 53, level=0.1))
    tchain._uniform_ma_past(x, 48)
    tchain._window_max_past(x, 73)
    init = torch.full((2, 2), -1e9)
    tchain.Compressor._slanted_cummax_stream(x, 0.01, 100, init, init)
    tchain.Compressor(-24.0, 4.0).apply(x, 48000)
    tchain.Limiter(-0.3).apply(x, 48000)
    tloud.k_weight(x[0])
    assert _counts() == n0


@pytest.mark.parametrize("which", ["mac", "fold", "ma", "env", "wmax"])
def test_a_tensor_off_the_cpu_never_runs_the_twin(which, monkeypatch):
    """Off the CPU each wrapper launches or raises: with a library that does
    not build, the call raises nvcc's error, runs no twin and counts no
    launch."""
    def twin(*a, **k):
        raise AssertionError("the wrapper ran the twin on a tensor off the CPU")

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ck, "upols_mac_reference", twin)
    monkeypatch.setattr(tchain, "_fir_fold_reference", twin)
    monkeypatch.setattr(tchain, "_uniform_ma_past_reference", twin)
    monkeypatch.setattr(tchain, "_window_max_past_reference", twin)
    monkeypatch.setattr(tchain.Compressor, "_slanted_cummax_stream_reference",
                        staticmethod(twin))
    monkeypatch.setattr(_build, "load_library", no_build)
    n0 = _counts()
    x = torch.empty((2, 2, 5000), device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        if which == "mac":
            K, G = 7, 4
            ck.upols_mac(torch.empty((K - 1 + G, 2, 2, 65), dtype=torch.complex64, device="meta"),
                         torch.empty((K, 2, 1, 65), dtype=torch.complex64, device="meta"), G)
        elif which == "fold":
            tchain._fir_fold(x, np.ones(351, np.float32))
        elif which == "ma":
            tchain._uniform_ma_past(x, 240)
        elif which == "env":
            m = torch.empty((2, 1), device="meta")
            tchain.Compressor._slanted_cummax_stream(x[:, :1], 0.01, 77, m, m)
        else:
            tchain._window_max_past(x, 73)
    assert _counts() == n0


@pytest.mark.parametrize("bad", ["K", "spectra", "dtype", "bins", "rows", "taps", "win",
                                 "block", "state", "level", "W"])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(bad, monkeypatch):
    """Shapes, types and sizes a kernel does not take raise ValueError
    before the library is asked for."""
    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "load_library", no_build)
    c64 = dict(dtype=torch.complex64, device="meta")
    K, G = 7, 3
    buf, H = torch.empty((K - 1 + G, 4, 65), **c64), torch.empty((K, 1, 65), **c64)
    n0 = _counts()
    with pytest.raises(ValueError):
        if bad == "K":
            ck.upols_mac(torch.empty((65 - 1 + G, 4, 65), **c64),
                         torch.empty((65, 1, 65), **c64), G)
        elif bad == "spectra":
            ck.upols_mac(buf[1:], H, G)
        elif bad == "dtype":
            ck.upols_mac(buf, H.to(torch.complex128), G)
        elif bad == "bins":
            ck.upols_mac(buf, H[..., :64], G)
        elif bad == "rows":
            ck.upols_mac(torch.empty((K - 1 + G, 4, 2, 65), **c64),
                         torch.empty((K, 1, 2, 65), **c64), G)
        elif bad == "taps":
            ck.fir_fold(torch.empty((2, 100), device="meta"),
                        torch.ones(ck.FOLD_MAX_W + 1, device="meta"))
        elif bad == "win":
            ck.ma_past(torch.empty((2, 100), dtype=torch.float64, device="meta"), 8)
        elif bad == "block":                      # not a power of two
            m = torch.empty((2,), device="meta")
            ck.slanted_cummax(torch.empty((2, 100), device="meta"), 0.01, 0, m, m, 3 << 10)
        elif bad == "state":                      # m not of the level's leading shape
            m = torch.empty((2,), device="meta")
            ck.slanted_cummax(torch.empty((2, 100), device="meta"), 0.01, 0,
                              torch.empty((2, 1), device="meta"), m, 256)
        elif bad == "level":                      # not contiguous
            m = torch.empty((2,), device="meta")
            ck.slanted_cummax(torch.empty((100, 2), device="meta").t(), 0.01, 0, m, m, 256)
        else:
            ck.window_max(torch.empty((2, 100), device="meta"), 1)
    assert _counts() == n0


def test_h_rows_maps_signal_rows_onto_h():
    """Row r takes H's row r // (rows / Hrows): a mono IR over every row,
    one IR per channel over the channel-first rows and the streamed
    layout."""
    assert ck._h_rows((16,), (1,)) == 1
    assert ck._h_rows((2, 8), (2, 1)) == 2
    assert ck._h_rows((2, 1), (2, 1)) == 2
    assert ck._h_rows((3, 2, 5), (1,)) == 1
    with pytest.raises(ValueError):
        ck._h_rows((4, 2), (1, 2))


def test_chain_kernel_ablation_changes_apply():
    """`tools/chain_kernel_ablation.py`'s copies of `csrc/upols.cu` and
    `csrc/fold.cu` each change what they name (the tool raises if a kernel's
    source moved away from a change), and without a card it exits 1."""
    from f9tpu_torch.tools import chain_kernel_ablation as abl

    src = abl.variant_sources()
    assert set(src) == {(k, c) for k, (_name, copies) in abl.VARIANTS.items() for c in copies}
    for (kernel, copy), text in src.items():
        assert (text == src[(kernel, "whole")]) == (copy == "whole"), (kernel, copy)
    if not torch.cuda.is_available():
        assert abl.main([]) == 1


def test_ptxas_report_reads_each_kernel():
    """`_build.ptxas_report` reads ptxas's ``-v`` lines per kernel, as
    `chip_smoke.py` 14c and the ablation tool print them."""
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_113upols_mac_regILi30EEEvNS_7MacArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_113upols_mac_regILi30EEEvNS_7MacArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_115fir_fold_kernelEPKfS1_Pfxxi' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_115fir_fold_kernelEPKfS1_Pfxxi
    288 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers, 288 bytes cumulative stack size
"""
    rep = _build.ptxas_report(log)
    assert rep == {
        "_ZN4_GLOBAL__N_113upols_mac_regILi30EEEvNS_7MacArgsE":
            dict(stack=0, spill_stores=0, spill_loads=0, registers=128),
        "_ZN4_GLOBAL__N_115fir_fold_kernelEPKfS1_Pfxxi":
            dict(stack=288, spill_stores=4, spill_loads=8, registers=56)}
    assert _build.ptxas_report("") == {}


def test_upols_ablation_tool_on_the_cpu(capsys):
    """`tools/upols_sum_ablation.py` on the CPU: the group form, groups of
    one block and the twin give the same bits, and a signal's output does
    not depend on the rows beside it."""
    from f9tpu_torch.tools import upols_sum_ablation

    assert upols_sum_ablation.main(["--device", "cpu", "--rows", "3", "--seconds", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "block vs group: bitwise equal True" in out
    assert "twin vs group: bitwise equal True" in out
    assert "alone: 0 of 48000 samples differ" in out      # 2 channels x 0.5 s


# ------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_mac_kernel_matches_twin_on_card(card):
    """Bitwise: every K the kernel takes at the edges, mono and two-channel
    H, 1 and 16 rows, groups of 1 and 5."""
    rng = np.random.default_rng(1)
    for K in (1, 2, 7, 30, 64):
        for hrows, rows in ((1, 1), (1, 16), (2, 16)):
            for G in (1, 5):
                shape = (K - 1 + G, hrows, rows // hrows, 129)
                buf = torch.complex(*(torch.from_numpy(rng.standard_normal(shape)
                                                       .astype(np.float32)) for _ in "ri")).to(card)
                H = torch.complex(*(torch.from_numpy(rng.standard_normal((K, hrows, 1, 129))
                                                     .astype(np.float32)) for _ in "ri")).to(card)
                n0 = ck.launches_mac
                got = ck.upols_mac(buf, H, G)
                torch.cuda.synchronize()
                assert ck.launches_mac == n0 + 1
                assert _same(got, ck.upols_mac_reference(buf, H, G)), (K, hrows, rows, G)


@pytest.mark.cuda
def test_fold_and_ma_kernels_match_twins_on_card(card):
    """Bitwise: the fold at W = 2, 3, 7, 351, 1024 and the moving average at
    2, 48, 73, 240, 4801, on rows not a multiple of the tile that start with
    exact zeros."""
    x = _sig((3, 2, 5000 + 37), 7)
    x[..., :50] = 0.0
    xd = torch.from_numpy(x).to(card)
    for W in (2, 3, 7, 351, 1024):
        taps = _sig((W,), W, level=1.0 / np.sqrt(W))
        got = tchain._fir_fold(xd, taps)
        assert _same(got, tchain._fir_fold_reference(xd, taps)), W
    for win in (2, 48, 73, 240, 4801):
        got = tchain._uniform_ma_past(xd, win)
        assert _same(got, tchain._uniform_ma_past_reference(xd, win)), win


@pytest.mark.cuda
def test_envelope_kernel_matches_twin_on_card(card, monkeypatch):
    """Bitwise, env and the state out, with `_ENV_BLOCK` at 256 and 2^17:
    chunks from mid-block, ending on the grid and shorter than a tile, from
    the virgin and a carried state; each call launches the kernel once."""
    rng = np.random.default_rng(2)
    for B in (256, 1 << 17):
        monkeypatch.setattr(tchain.Compressor, "_ENV_BLOCK", B)
        for pos, T in ((B // 2 + 13, 3 * B + 5000), (3 * B + B // 2, B // 2), (5, 7)):
            lv = torch.from_numpy(rng.uniform(-90.0, 6.0, (3, 1, T)).astype(np.float32)).to(card)
            for m in (torch.full((3, 1), -1e9, device=card),
                      torch.from_numpy(rng.uniform(-40.0, 0.0, (3, 1)).astype(np.float32)).to(card)):
                n0 = ck.launches_env
                got = tchain.Compressor._slanted_cummax_stream(lv, 0.005, pos, m, m)
                torch.cuda.synchronize()
                assert ck.launches_env == n0 + 1
                want = tchain.Compressor._slanted_cummax_stream_reference(lv, 0.005, pos, m, m)
                for g, w in zip(got, want):
                    assert _same(g, w.contiguous()), (B, pos, T)


@pytest.mark.cuda
def test_window_max_kernel_matches_twin_on_card(card):
    """Bitwise on signed input at W = 2, 3, 73, 1025 and 30,000 (the level
    launches), on rows not a multiple of the tile and on rows shorter than
    one."""
    x = _sig((3, 1, 40000 + 37), 9)
    xd = torch.from_numpy(x).to(card)
    for W in (2, 3, 73, 1025, 30000):
        for v in (xd, xd[..., :300].contiguous()):
            n0 = ck.launches_wmax
            got = tchain._window_max_past(v, W)
            torch.cuda.synchronize()
            assert ck.launches_wmax == n0 + 1
            assert _same(got, tchain._window_max_past_reference(v, W)), (W, v.shape)


@pytest.mark.cuda
def test_upols_chunked_equals_whole_on_card(card, monkeypatch):
    """On the card the streamed `_upols` at 1, G - 1, G and G + 1 blocks a
    chunk equals the whole signal, bitwise (groups of 4)."""
    G = 4
    monkeypatch.setattr(tchain, "UPOLS_GROUP", G)
    x, H, _g, _p = _case("mono", 30, 4, 18)
    x, H = x[..., :17 * B].contiguous().to(card), H.to(card, torch.complex64)
    whole = tchain._upols(x, H, B)
    for blocks in (1, G - 1, G, G + 1):
        state = tchain._upols_state((4,), 30, B, card)
        out = []
        for a in range(0, 17 * B, blocks * B):
            y, state = tchain._upols_stream(x[..., a:a + blocks * B], state, H, B)
            out.append(y)
        assert _same(torch.cat(out, -1), whole), blocks
