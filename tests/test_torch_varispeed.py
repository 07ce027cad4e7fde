"""The port's varispeed SRC (banks with no dense cycle matrix) against the
JAX package's, on the CPU.

Tolerances, each with its reason:

- `_banded_plan`, `_h_rev_f32_cached` and the banks' geometry: bitwise (the
  port's copies of host-side numpy code).
- `resample_gather` and `resample_banded` against
  `f9tpu.ops.resample.resample_banded`: <= 2e-6 abs (the port sums each
  output in float64 and rounds once, JAX in float32 per 128-output segment;
  measured 2.4e-7), and <= -120 dB against the float64 oracle on the five
  pairs of `tests/test_varispeed.py` (measured -148 dB).
- presliced chunks == whole: bitwise (every output sums its own taps in one
  fixed order).
- The batch job and the stream at 44056 Hz against the JAX package: equal
  frame counts, <= 2 LSB at 24 bits (inputs near -20 dBFS, dither off: the
  JAX forms' own float32 error is the larger part).
- The kernel's windowed 3xTF32 k8 order, replayed in numpy from
  `kernel_plan` / `packed_bank_f32`: <= 0.2 LSB RMS, <= 1.5 max at 24 bits
  against the exact sum on a -12 dBFS signal (the dense form's gate).

On the CPU the wrappers run the plain twin and `src_kernel.launches` stays
0.  Every test runs torch on one CPU thread, as `tests/test_torch_stream.py`
explains."""

import hashlib
import importlib
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu import cli as jcli  # noqa: E402
from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import wav  # noqa: E402
from f9tpu.models.filters import design_cycle_bank as jbank  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu.pipeline import stream as jstream  # noqa: E402
from f9tpu_torch import cli  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.models import design_cycle_bank, resample_oracle  # noqa: E402
from f9tpu_torch.ops import resample as tres  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402
from f9tpu_torch.pipeline import calibration as tcal  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402
from f9tpu_torch.tools import hw_soak  # noqa: E402

# `f9tpu.ops` exports the function `resample` over the module's name
jres = importlib.import_module("f9tpu.ops.resample")

#: the five pairs of tests/test_varispeed.py
PAIRS = [(44100, 44056, "low"), (44056, 44100, "low"), (44100, 44056, "medium"),
         (192000, 44056, "low"), (44100, 44056, "ultra")]
ABS_TOL = 2e-6
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _noise(ch, n, seed, level=0.25):
    return (level * np.random.default_rng(seed).standard_normal((ch, n))).astype(np.float32)


def _db(err, ref):
    return 20 * np.log10(max(np.sqrt(np.mean(err ** 2)), 1e-300) / np.sqrt(np.mean(ref ** 2)))


@pytest.mark.parametrize("ri,ro,q", PAIRS)
def test_plan_and_tables_are_the_jax_package_s(ri, ro, q):
    bank, jb = design_cycle_bank(ri, ro, quality=q), jbank(ri, ro, quality=q)
    assert bank.G is None and jb.G is None
    assert np.array_equal(tres._h_rev_f32_cached(bank), jres._h_rev_f32_cached(jb))
    tp, jp = tres._banded_plan(bank), jres._banded_plan(jb)
    assert tp[:4] == jp[:4] and np.array_equal(tp[4], jp[4])


@pytest.mark.parametrize("ri,ro,q", PAIRS)
def test_varispeed_forms_match_jax_and_oracle(ri, ro, q):
    x = _noise(2, 30000, 3)
    bank, jb = design_cycle_bank(ri, ro, quality=q), jbank(ri, ro, quality=q)
    want = np.asarray(jres.resample_banded(jnp.asarray(x), jb))
    ref = resample_oracle(x.astype(np.float64), ri, ro, quality=q)
    xt = torch.from_numpy(x)
    flat = tres.resample_banded(xt, bank)
    for name, got in (("gather", tres.resample_gather(xt, bank)), ("banded", flat),
                      ("resample", tres.resample(xt, bank)),
                      ("auto", sk.resample_auto(xt, bank)),
                      ("rates", tres.resample_rates(xt, ri, ro, quality=q))):
        got = got.numpy()
        assert got.shape == want.shape == ref.shape, name
        assert np.abs(got - want).max() <= ABS_TOL, (name, np.abs(got - want).max())
        assert _db(got - ref, ref) <= -120.0, (name, _db(got - ref, ref))
        assert np.array_equal(got, flat.numpy()), name          # one twin behind all
    assert sk.launches == 0


@pytest.mark.parametrize("ri,ro,q", [(44100, 44056, "low"), (192000, 44056, "low")])
def test_presliced_chunks_equal_whole_bitwise(ri, ro, q):
    bank, jb = design_cycle_bank(ri, ro, quality=q), jbank(ri, ro, quality=q)
    x = _noise(2, 6 * bank.M + 123, 4)
    out_len = bank.out_len(x.shape[-1])
    Q = -(-out_len // bank.L)
    xp = np.zeros((2, (Q - 1) * bank.M + bank.W), np.float32)
    keep = min(x.shape[-1], xp.shape[-1] - bank.pad_front)
    xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
    whole = tres.resample_presliced(torch.from_numpy(xp), bank, Q)
    assert torch.equal(whole[:, :out_len], tres.resample(torch.from_numpy(x), bank))
    for cycles in (1, 3):
        outs = []
        for q0 in range(0, Q, cycles):
            n = min(cycles, Q - q0)
            span = xp[:, q0 * bank.M:q0 * bank.M + (n - 1) * bank.M + bank.W]
            outs.append(tres.resample_presliced(torch.from_numpy(span.copy()), bank, n))
        assert torch.equal(torch.cat(outs, dim=-1), whole), cycles
    want = np.asarray(jres.resample_presliced(jnp.asarray(xp), jb, Q))
    assert np.abs(whole.numpy() - want).max() <= ABS_TOL
    with pytest.raises(ValueError, match="too short"):
        tres.resample_presliced(torch.zeros(2, bank.W - 1), bank, 1)


@pytest.mark.parametrize("ri,ro", [(44100, 48000), (48000, 44100), (96000, 44100)])
def test_gather_twin_matches_the_dense_twin_on_standard_ratios(ri, ro):
    """Three executions of one design: the gather form, the dense kernel
    twin and JAX's gather, within 2e-6 of each other."""
    x = _noise(2, 4000, 4)
    bank, jb = design_cycle_bank(ri, ro, quality="medium"), jbank(ri, ro, quality="medium")
    assert bank.dense_ok
    g = tres.resample_gather(torch.from_numpy(x), bank).numpy()
    d = sk.resample_kernel_reference(torch.from_numpy(x), bank).numpy()
    j = np.asarray(jres.resample_gather(jnp.asarray(x), jb))
    assert g.shape == d.shape == j.shape
    assert np.abs(g - d).max() <= ABS_TOL and np.abs(g - j).max() <= ABS_TOL


def test_bank_to_torch_returns_the_phase_bank_of_a_varispeed_bank():
    bank, jb = design_cycle_bank(44100, 44056), jbank(44100, 44056)
    hrev, off, ph = tres.bank_to_torch(bank, CPU)
    assert hrev.dtype == torch.float32 and tuple(hrev.shape) == (bank.L, bank.taps_per_phase)
    assert np.array_equal(hrev.numpy(), jres._h_rev_f32_cached(jb))
    from f9tpu.models.filters import _cycle_tables

    joff, jph = _cycle_tables(jb.L, jb.M, jb.delay_upsamples % jb.L)
    assert np.array_equal(off.numpy(), joff) and np.array_equal(ph.numpy(), jph)
    assert tres.bank_to_torch(bank, CPU)[0] is hrev                 # cached
    with pytest.raises(RuntimeError, match="dense cycle matrix disabled"):
        tres.cycle_matrix_f32(bank)


def test_empty_and_short_inputs():
    bank = design_cycle_bank(44100, 44056, quality="low")
    assert tres.resample(torch.zeros((2, 0)), bank).shape == (2, 0)
    assert sk.resample_rows_reference(torch.zeros((2, 0)), bank)[0].shape == (2, 0, bank.L)
    y = tres.resample(torch.ones((1, 7)), bank, out_len=5)
    assert y.shape == (1, 5) and torch.isfinite(y).all()
    rows, out_len = sk.resample_rows_reference(torch.from_numpy(_noise(1, 500, 2)), bank)
    assert out_len == bank.out_len(500) and rows.shape == (1, 1, bank.L)


def test_non_cpu_varispeed_tensor_launches_or_raises():
    """No fallback: off the CPU every varispeed entry point goes to the
    kernel wrapper, which refuses anything but a CUDA tensor; the plain twin
    serves CPU tensors only."""
    bank = design_cycle_bank(44100, 44056)
    x = torch.empty((2, 30000), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.resample_kernel(x, bank)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.resample_presliced_kernel(x, bank, 2)
    for fn in (tres.resample, tres.resample_banded, sk.resample_auto):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(x, bank)
    assert sk.launches == 0 and sk.launches_windowed == 0


# ----------------------------------------------------- the kernel's plan


@pytest.mark.parametrize("ri,ro,q", PAIRS + [(44100, 44056, "high"), (192000, 44056, "high")])
def test_windowed_plan_and_packed_bank(ri, ro, q):
    """The windowed form's launch plan and packed bank: every tap of every
    phase inside its tile's band, hi + lo within 2^-21 of it, zeros
    elsewhere, windows within the pitch, the pitch 4 mod 32 (an A load's 8
    rows x 4 taps in 32 banks), shared memory within a block's limit."""
    bank = design_cycle_bank(ri, ro, quality=q)
    plan = sk.kernel_plan(bank)
    assert sk.kernel_applicable(bank) and plan.pitch % 32 == 4
    packed, tiles = sk.packed_bank_f32(bank)
    L, K, nt = bank.L, bank.taps_per_phase, plan.nt
    assert len(plan.bands) == len(tiles) == -(-L // (8 * nt))
    assert max(8 * nk for _, nk in plan.bands) <= plan.pitch
    assert plan.smem_bytes <= 232448 and plan.ring_off >= 16 * plan.warps * plan.pitch
    assert np.array_equal(sk.tf32_rna(packed), packed)
    lane = np.arange(32)
    banks_hit = ((lane >> 2) * plan.pitch + (lane & 3)) % 32
    assert len(set(banks_hit.tolist())) == 32
    hrev = tres._h_rev_f32_cached(bank).astype(np.float64)
    off, ph = tres._phase_tables(bank)
    for c in (0, len(tiles) // 2, len(tiles) - 1):
        w_lo, nk, o = (int(v) for v in tiles[c])
        assert nk % sk.KC8 == 0
        quad = packed[o:o + nk * nt * 32].reshape(nk, nt, 8, 4, 4).astype(np.float64)
        # (s, n, g, t, part) -> value at row w_lo + 8s + 4*part + t, column 8n + g
        val = (quad[..., :2] + quad[..., 2:]).transpose(0, 4, 3, 1, 2).reshape(nk * 8, nt * 8)
        want = np.zeros_like(val)
        for j in range(8 * nt):
            p = 8 * nt * c + j
            if p < L:
                r0 = int(off[p]) - w_lo
                assert 0 <= r0 and r0 + K <= 8 * nk
                want[r0:r0 + K, j] = hrev[ph[p]]
        assert np.abs(val - want).max() <= 2.0 ** -21 * np.abs(hrev).max()
        assert np.array_equal(val != 0, want != 0)


WINDOWED_BANKS = PAIRS + [(44100, 44056, "high"), (44056, 44100, "high"), (192000, 44056, "high")]


def _launch_groups(plan):
    """(group, pitch) of every group a launch can take: the plan's, then
    each halving `_win_launch` may make for a launch of few rows."""
    out, g = [], plan.group
    while g >= 1:
        out.append((g, plan.pitch if g == plan.group else sk._win_pitch(plan.bands, g)))
        g //= 2
    return out


@pytest.mark.parametrize("ri,ro,q", WINDOWED_BANKS)
def test_windowed_tile_groups_cover_every_tile_once(ri, ro, q):
    """Each column tile belongs to exactly one group of ``group``
    neighbours, at the plan's group and at every smaller one a launch can
    take; the group's union window, from its first tile's band start, holds
    every band of the group, and a slot of ``pitch`` floats holds the union
    behind a shift of up to 3 in whole float4s."""
    bank = design_cycle_bank(ri, ro, quality=q)
    plan = sk.kernel_plan(bank)
    n = len(plan.bands)
    assert plan.group in (1, 2, 4) and bank.G is None
    for group, pitch in _launch_groups(plan):
        owner = [c // group for c in range(n)]
        groups = [list(range(i, min(n, i + group))) for i in range(0, n, group)]
        assert sorted(c for g in groups for c in g) == list(range(n))
        assert all(owner[c] == gi for gi, g in enumerate(groups) for c in g)
        for g in groups:
            u_lo = plan.bands[g[0]][0]
            u_hi = max(lo + 8 * nk for lo, nk in (plan.bands[c] for c in g))
            assert all(u_lo <= plan.bands[c][0]
                       and plan.bands[c][0] + 8 * plan.bands[c][1] <= u_hi for c in g)
            assert 4 * -(-(3 + u_hi - u_lo) // 4) <= pitch
        assert pitch % 32 == 4 and pitch <= plan.pitch


@pytest.mark.parametrize("ri,ro,q", WINDOWED_BANKS)
def test_windowed_a_loads_take_one_wavefront(ri, ro, q):
    """With the rows of a slot group 4 cycles apart (rowmap 1) every row of
    an A load has the same shift into its window, so a pitch of 4 mod 32
    keeps each load in 32 banks: one wavefront, counted over every warp,
    shift, tile offset in the union and k8 step, at the flat signal's cycle
    stride.  Rows in order (one-warp launches) would conflict."""
    bank = design_cycle_bank(ri, ro, quality=q)
    plan = sk.kernel_plan(bank)
    for group, pitch in _launch_groups(plan):
        offsets = {(lo - plan.bands[c - c % group][0]) % 32 for c, (lo, _) in enumerate(plan.bands)}
        for warps in (2, 4, 8):
            assert sk._win_a_load_wavefronts(bank.M, warps, pitch, 1, offsets) == 1.0
        if bank.M % 4:
            assert sk._win_a_load_wavefronts(bank.M, 2, pitch, 0, offsets) > 1.0


@pytest.mark.parametrize("ri,ro,q", WINDOWED_BANKS)
@pytest.mark.parametrize("signals,cycles", [(1, 1), (2, 80), (1, 17), (32, 96), (64, 3000)])
@pytest.mark.parametrize("sms", [132, 114], ids=["h100_sxm", "h100_pcie"])
def test_windowed_launch_fits_shared_memory_at_every_size(ri, ro, q, signals, cycles, sms):
    """A launch of 1 signal x 1 cycle, the stream's 2-signal chunk of 80
    cycles, the kernel phase's 32 x 96 and a large one, on cards of 132 and
    114 SMs: warps shrink to the rows; the group halves only into a grid
    that fits on the card at once, and as far as that goes; the pitch holds
    the group's union window; shared memory stays within the plan's and a
    block's 232,448 bytes; a one-warp launch takes rows in order."""
    bank = design_cycle_bank(ri, ro, quality=q)
    plan = sk.kernel_plan(bank)
    n_rows = signals * cycles
    warps, rowmap, group, pitch, smem = sk._win_launch(plan, n_rows, sms)
    assert smem <= plan.smem_bytes <= 232448 and 1 <= warps <= plan.warps
    assert (group, pitch) in _launch_groups(plan) and smem == sk._window_smem(plan.nt, warps, pitch)[1]
    assert rowmap == int(warps > 1)
    assert warps == 1 or 16 * (warps // 2) < n_rows
    row_blocks = -(-n_rows // (16 * warps))

    pitches = dict(_launch_groups(plan))

    def fits(g):
        slots = sms * sk._win_blocks_per_sm(sk._window_smem(plan.nt, warps, pitches[g])[1])
        return row_blocks * -(-len(plan.bands) // g) <= slots
    assert group == plan.group or fits(group)
    assert group == 1 or not fits(group // 2)


#: kernel_plan and packed_bank_f32 of the dense banks the card's kernel phase
#: runs, as they were before the windowed form was added: (nt, warps, skew,
#: rowmap, ring_off, smem_bytes), sha256[:16] of repr(bands), of the packed
#: bank's bytes and of the tile table's
DENSE_RECORDED = {
    (44100, 48000, "high"): ((5, 8, 0, 1, 18856, 95904), "bb9effd0f44f5065",
                             "674b2b2e0417fba1", "43fc1c19d9f5eb34"),
    (48000, 44100, "high"): ((5, 8, 4, 0, 23088, 112832), "911af51c4a9f9eb7",
                             "31a025d23479f573", "b50e95f158dd5414"),
    (44100, 48000, "ultra"): ((5, 8, 0, 1, 18920, 96160), "ac6cce276dc872e8",
                              "06761b0bcf8b2b20", "15dccc3e847c08d0"),
    (176400, 48000, "high"): ((5, 8, 0, 1, 19304, 97696), "5c95c750fc9cae14",
                              "b7fe76de8dec67f0", "59b6173609d18705"),
}


@pytest.mark.parametrize("key", sorted(DENSE_RECORDED))
def test_dense_plans_and_packed_banks_are_unchanged(key):
    bank = design_cycle_bank(key[0], key[1], quality=key[2])
    p = sk.kernel_plan(bank)
    packed, tiles = sk.packed_bank_f32(bank)

    def h(b):
        return hashlib.sha256(b).hexdigest()[:16]

    got = ((p.nt, p.warps, p.skew, p.rowmap, p.ring_off, p.smem_bytes),
           h(repr(p.bands).encode()), h(packed.tobytes()), h(tiles.tobytes()))
    assert got == DENSE_RECORDED[key] and p.pitch == 0


def _kernel_order(x, bank, Q, group=None):
    """The windowed form's arithmetic in numpy float32, ``(Q, L)`` outputs of
    ``x`` from `kernel_plan` and `packed_bank_f32` as the kernel reads them:
    per group of ``group`` column tiles (the plan's by default), each row's
    union window from
    ``q*M`` plus the group's first band start; per tile, its band at its
    offset inside that window; per 8-row step x split into TF32 high and
    low parts (round to nearest, ties away), a fresh fragment that starts
    from the negated compensation and adds xh*gl, xl*gh, then xh*gh (8
    products each, in order), joined to the running sum by Fast2Sum."""
    plan = sk.kernel_plan(bank)
    group = group or plan.group
    pitch = dict(_launch_groups(plan))[group]
    packed, tiles = sk.packed_bank_f32(bank)
    L, M, nt = bank.L, bank.M, plan.nt
    xp = np.zeros((Q - 1) * M + int(tiles[:, 0].max()) + pitch + 8, np.float32)
    n = min(x.size, xp.size - bank.pad_front)
    xp[bank.pad_front:bank.pad_front + n] = x[:n]
    xh = sk.tf32_rna(xp)
    xl = sk.tf32_rna(xp - xh)
    y = np.zeros((Q, L), np.float32)
    for c, (w_lo, nk, o) in enumerate(tiles[:, :3]):
        u_lo = int(tiles[c - c % group, 0])
        win = np.arange(Q)[:, None] * M + u_lo + np.arange(pitch - 3)[None, :]
        wh, wl = xh[win], xl[win]                     # the rows' union windows
        a_off = int(w_lo) - u_lo
        cols = np.arange(8 * nt * c, min(L, 8 * nt * (c + 1)))
        quad = packed[o:o + nk * nt * 32].reshape(nk, nt, 8, 4, 4)
        gh, gl = (np.concatenate([quad[..., i], quad[..., i + 1]], axis=3)
                  .transpose(0, 3, 1, 2).reshape(nk, 8, 8 * nt)[:, :, :cols.size]
                  for i in (0, 2))
        total = np.zeros((Q, cols.size), np.float32)
        nc = np.zeros_like(total)
        for s in range(nk):
            k8 = a_off + 8 * s + np.arange(8)
            ah, al = wh[:, k8], wl[:, k8]
            d = nc
            for a, b in ((ah, gl[s]), (al, gh[s]), (ah, gh[s])):
                for k in range(8):
                    d = d + a[:, k:k + 1] * b[k][None, :]
            tk = total + d
            nc = d - (tk - total)
            total = tk
        y[:, cols] = total + nc
    return y


@pytest.mark.parametrize("ri,ro,q", [(44100, 44056, "high"), (44056, 44100, "high")])
def test_windowed_kernel_order_meets_the_accuracy_gate(ri, ro, q):
    bank = design_cycle_bank(ri, ro, quality=q)
    Q = 12
    rng = np.random.default_rng(ri % 977)
    t = np.arange(Q * bank.M + bank.W) / ri
    f = rng.uniform(80.0, 6000.0, size=2)
    x = (0.3 * np.sin(2 * np.pi * f[0] * t) + 0.15 * np.sin(2 * np.pi * f[1] * t + 0.7)
         + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    y = _kernel_order(x, bank, Q)
    # a launch of few rows takes a smaller group: only addresses move
    assert np.array_equal(_kernel_order(x, bank, Q, group=1), y)
    # the exact sum: float64 over the float32 taps
    hrev = tres._h_rev_f32_cached(bank).astype(np.float64)
    off, ph = tres._phase_tables(bank)
    xpad = np.concatenate([np.zeros(bank.pad_front), x.astype(np.float64), np.zeros(bank.W)])
    idx = (np.arange(Q)[:, None, None] * bank.M + off[None, :, None]
           + np.arange(bank.taps_per_phase)[None, None, :])
    exact = np.einsum("qlk,lk->ql", xpad[idx], hrev[ph])
    err = (y - exact) * 2.0 ** 23
    rms, mx = float(np.sqrt(np.mean(err ** 2))), float(np.abs(err).max())
    assert rms <= 0.2 and mx <= 1.5, (rms, mx)
    yt, _ = sk.resample_rows_reference(torch.from_numpy(x), bank)
    assert np.abs(yt.numpy()[:Q] - exact).max() <= 2.0 ** -24


# ------------------------------------------------------- graph, job, stream


def test_exact_out_valid_stays_in_int64_for_varispeed_banks():
    """ceil(n*L/M) per file for L = 11014: n*L passes 2^31 from 195k frames
    and float32 is exact only to 2^24."""
    bank = design_cycle_bank(44100, 44056)
    n = np.array([0, 1, 11025, 194_999, 5_000_000, 190_000_000], np.int64)
    got = tgraph._exact_out_valid(torch.from_numpy(n).to(torch.int32), bank, 1 << 30)
    want = [-(-int(v) * bank.L // bank.M) for v in n]
    assert got.tolist() == want and bank.out_len(190_000_000) == want[-1]


def test_calibration_through_a_varispeed_bank(tmp_path):
    got = tcal.measure_latency(44100, 44056, quality="low", device="cpu")
    from f9tpu.pipeline import calibration as jcal

    want = jcal.measure_latency(44100, 44056, quality="low")
    assert got.detected and got.latency_frames == want.latency_frames == 0
    assert abs(got.peak_amplitude - want.peak_amplitude) <= 1e-5
    cache = tcal.CalibrationCache(str(tmp_path / "c.json"))
    assert cache.get_or_measure(44100, 44056, quality="low", device="cpu") == got
    with open(tmp_path / "c.json") as f:
        assert list(json.load(f)) == ["44100->44056:sinc:low:"]


def _write_src(d, ch, n, seed=9, name="v.wav"):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    x = (0.08 * np.sin(2 * np.pi * 523.0 * t) + 0.02 * rng.standard_normal((ch, n))
         + 0.01).astype(np.float32)
    path = os.path.join(str(d), name)
    wav.write_wav(path, x, 44100, bits=24)
    return path


def _codes(path):
    x, rate = wav.read_wav(path)
    return np.round(np.asarray(x, np.float64) * (1 << 23)).astype(np.int64), rate


def test_batch_job_at_44056_matches_jax(tmp_path):
    src = [_write_src(tmp_path, 2, 30000, 9, "a.wav"), _write_src(tmp_path, 1, 23001, 10, "b.wav")]
    outs = {}
    for name, mod, conf, extra in (("jax", jsched, JConfig, {}),
                                   ("torch", tsched, TConfig, {"device": "cpu"})):
        out = str(tmp_path / f"out_{name}")
        cfg = conf(output_dir=out, target_rate=44056, quality="low", dither=False,
                   batch_size=2, bucket_frames=(1 << 15,))
        res = mod.BatchProcessor(cfg, **extra).run(src)
        assert res.completed == 2 and res.failed == 0, (name, res)
        outs[name] = (out, res)
    for p in src:
        assert (outs["torch"][1].per_file[p]["out_frames"]
                == outs["jax"][1].per_file[p]["out_frames"])
        stem = os.path.splitext(os.path.basename(p))[0]
        tc, tr = _codes(os.path.join(outs["torch"][0], f"{stem}_processed.wav"))
        jc, jr = _codes(os.path.join(outs["jax"][0], f"{stem}_processed.wav"))
        assert tr == jr == 44056 and tc.shape == jc.shape
        assert np.abs(tc - jc).max() <= 2, np.abs(tc - jc).max()
    assert sk.launches == 0


def test_stream_at_44056_matches_jax_and_ignores_the_chunk_size(tmp_path):
    src = _write_src(tmp_path, 2, 50000)
    kw = dict(output_dir=str(tmp_path), target_rate=44056, quality="low", dither=False)
    jout = str(tmp_path / "j.wav")
    n_j = jstream.stream_resample_file(src, jout, JConfig(**kw), chunk_seconds=0.5)
    blobs = []
    for cs in (0.26, 0.6, 5.0):
        out = str(tmp_path / f"t_{cs}.wav")
        n_t = tstream.stream_resample_file(src, out, TConfig(**kw), chunk_seconds=cs,
                                           device="cpu")
        assert n_t == n_j == design_cycle_bank(44100, 44056, quality="low").out_len(50000)
        with open(out, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1] == blobs[2]
    tc, _ = _codes(str(tmp_path / "t_0.6.wav"))
    jc, _ = _codes(jout)
    assert tc.shape == jc.shape and np.abs(tc - jc).max() <= 2, np.abs(tc - jc).max()
    # dithered bytes are chunk-size invariant too
    kw["dither"], kw["seed"] = True, 3
    shas = set()
    for cs in (0.26, 0.6):
        out = str(tmp_path / f"d_{cs}.wav")
        tstream.stream_resample_file(src, out, TConfig(**kw), chunk_seconds=cs, device="cpu")
        with open(out, "rb") as f:
            shas.add(hashlib.sha256(f.read()).hexdigest())
    assert len(shas) == 1


def test_cli_process_and_stream_at_44056_match_the_jax_cli(tmp_path, capsys):
    src = _write_src(tmp_path, 2, 26000)
    runs = {}
    for name, mod, extra in (("jax", jcli, []), ("torch", cli, ["--device", "cpu"])):
        out = str(tmp_path / f"o_{name}")
        rc = mod.main(["process", src, "--out", out, "--rate", "44056", "--quality", "low",
                       "--no-dither", "--batch-size", "1", "--json", *extra])
        assert rc == 0
        runs[name] = (out, json.loads(capsys.readouterr().out))
        s_out = str(tmp_path / f"s_{name}.wav")
        assert mod.main(["stream", src, "--out", s_out, "--rate", "44056", "--quality", "low",
                         "--no-dither", "--chunk-seconds", "0.3", "--json", *extra]) == 0
        runs[name] += (s_out, json.loads(capsys.readouterr().out))
    (jo, js, jso, jss), (to, ts, tso, tss) = runs["jax"], runs["torch"]
    assert ts["completed"] == js["completed"] == 1
    assert ts["per_file"][src]["out_frames"] == js["per_file"][src]["out_frames"]
    assert tss["out_frames"] == jss["out_frames"] == ts["per_file"][src]["out_frames"]
    for a, b in ((os.path.join(to, "v_processed.wav"), os.path.join(jo, "v_processed.wav")),
                 (tso, jso)):
        tc, _ = _codes(a)
        jc, _ = _codes(b)
        assert tc.shape == jc.shape and np.abs(tc - jc).max() <= 2


def test_soak_streams_a_varispeed_and_a_normalized_trial(tmp_path, capsys):
    hw_soak.stream_fuzz(5, 3, str(tmp_path), "cpu")
    out = capsys.readouterr().out
    assert "rate 44056" in out and "normalize -" in out and out.count("invariant") == 3


@pytest.mark.cuda
def test_windowed_kernel_matches_twin_on_card():
    """On an NVIDIA GPU: the windowed form against the float64 gather."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for ri, ro, q in PAIRS:
        bank = design_cycle_bank(ri, ro, quality=q)
        x = torch.from_numpy(_noise(2, 3 * bank.M + 77, 1)).cuda()
        n0 = sk.launches_windowed
        y = sk.resample_kernel(x, bank)
        torch.cuda.synchronize()
        assert sk.launches_windowed == n0 + 1
        assert (y - tres.resample_gather(x, bank)).abs().max().item() <= 5e-7
