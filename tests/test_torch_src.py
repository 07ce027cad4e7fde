"""The port's SRC (kernel dispatch, plain twin, unfold + matmul form)
against the JAX package's Pallas and conv forms and the float64 oracle, and
the CUDA kernel's arithmetic replayed in numpy.

On the CPU the kernel wrappers run the plain twin; the JAX Pallas kernel
runs in interpret mode, as the JAX package's own tests run it.  Tolerance:
max abs <= 2e-6 between forms (the JAX package's own bound between its SRC
forms, tests/test_resample_parity.py) and <= -120 dB against the oracle.
The JAX side takes the JAX package's banks, the port side the port's own.

The kernel itself runs only on the card.  `_kernel_order` replays its
summation order on the CPU from the same launch plan and packed bank the
kernel reads (split TF32, fresh k8 fragments, Kahan join), held to the
design gate: <= 0.2 LSB RMS and <= 1.5 LSB max at 24 bits against the exact
sum on a -12 dBFS signal."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.models import design_cycle_bank as jbank  # noqa: E402
from f9tpu.models import resample_oracle  # noqa: E402
from f9tpu.ops import pallas_src  # noqa: E402
from f9tpu_torch.models import design_cycle_bank  # noqa: E402
from f9tpu_torch.models.filters import QUALITY_PRESETS, STANDARD_RATES, resolve_ratio  # noqa: E402
from f9tpu_torch.ops import resample as tres  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402

# the module, not the function `f9tpu.ops` re-exports under the same name
jres = importlib.import_module("f9tpu.ops.resample")

BANKS = [(44100, 48000, "high"), (44100, 48000, "ultra"),
         (48000, 44100, "low"), (176400, 48000, "high")]


def _db(err, ref) -> float:
    e = np.sqrt(np.mean(np.square(np.asarray(err, np.float64))))
    r = np.sqrt(np.mean(np.square(np.asarray(ref, np.float64))))
    return 20.0 * np.log10(max(e, 1e-300) / r)


def _signal(rate_in: int, seed: int) -> np.ndarray:
    T = rate_in // 5 + 13                       # deliberately unaligned
    rng = np.random.default_rng(seed)
    t = np.arange(T) / rate_in
    x = (0.3 * np.sin(2 * np.pi * 440.0 * t)[None]
         + 0.1 * rng.standard_normal((2, T)))
    return x.astype(np.float32)


@pytest.mark.parametrize("ri,ro,q", BANKS)
def test_src_forms_match_jax_and_oracle(ri, ro, q):
    bank, jb = design_cycle_bank(ri, ro, quality=q), jbank(ri, ro, quality=q)
    x = _signal(ri, seed=ri + len(q))
    xt = torch.from_numpy(x)
    want_pallas = np.asarray(pallas_src.resample_pallas(jnp.asarray(x), jb))
    want_conv = np.asarray(jres.resample(jnp.asarray(x), jb))
    ref = resample_oracle(x, ri, ro, quality=q)
    rows, out_len = sk.resample_rows_reference(xt, bank)
    assert rows.shape == (2, -(-out_len // bank.L), bank.L)
    got = {
        "auto": sk.resample_auto(xt, bank).numpy(),
        "twin": sk.resample_kernel_reference(xt, bank).numpy(),
        "rows": rows.reshape(2, -1)[:, :out_len].numpy(),
        "unfold": tres.resample(xt, bank).numpy(),
        "rates": tres.resample_rates(xt, ri, ro, quality=q).numpy(),
    }
    for name, y in got.items():
        assert y.shape == want_pallas.shape == ref.shape, name
        assert y.dtype == np.float32, name
        for jname, want in (("pallas", want_pallas), ("conv", want_conv)):
            err = np.abs(y - want).max()
            assert err <= 2e-6, f"{name} vs JAX {jname}: {err:.3e}"
        assert _db(y - ref, ref) <= -120.0, f"{name}: {_db(y - ref, ref):.1f} dB"


@pytest.mark.parametrize("out_len", [1, 159, 160, 161, 4000])
def test_explicit_out_len_matches_jax(out_len):
    bank = design_cycle_bank(44100, 48000, quality="medium")
    x = _signal(44100, seed=3)[:, :3700]
    want = np.asarray(pallas_src.resample_pallas(
        jnp.asarray(x), jbank(44100, 48000, quality="medium"), out_len=out_len))
    got = sk.resample_kernel_reference(torch.from_numpy(x), bank, out_len=out_len).numpy()
    got_conv = tres.resample(torch.from_numpy(x), bank, out_len=out_len).numpy()
    assert got.shape == got_conv.shape == want.shape == (2, out_len)
    assert np.abs(got - want).max() <= 2e-6
    assert np.abs(got_conv - want).max() <= 2e-6


def test_empty_and_tiny_inputs():
    bank = design_cycle_bank(44100, 48000)
    for T in (0, 1, 5):
        x = np.full((3, T), 0.25, np.float32)
        want = np.asarray(pallas_src.resample_pallas(jnp.asarray(x), jbank(44100, 48000)))
        got = sk.resample_auto(torch.from_numpy(x), bank).numpy()
        assert got.shape == want.shape == (3, bank.out_len(T))
        assert np.abs(got - want).max(initial=0.0) <= 2e-6


def test_unfold_form_serves_integer_ratios():
    """Banks the kernel does not take (L < 8) go to the unfold + matmul form,
    matching the JAX package's conv there."""
    for ri, ro in [(48000, 96000), (96000, 48000)]:
        bank = design_cycle_bank(ri, ro, quality="medium")
        assert not sk.kernel_applicable(bank)
        x = _signal(ri, seed=5)[:, :4000]
        want = np.asarray(jres.resample(jnp.asarray(x), jbank(ri, ro, quality="medium")))
        got = sk.resample_auto(torch.from_numpy(x), bank).numpy()
        assert np.abs(got - want).max() <= 2e-6
        ref = resample_oracle(x, ri, ro, quality="medium")
        assert _db(got - ref, ref) <= -120.0


def test_kernel_gate_covers_pallas_gate_and_cpu_never_launches():
    rates = [8000, 16000, 22050, 32000, 44100, 48000, 88200, 96000, 176400, 192000]
    sk.launches = 0
    n_pallas = 0
    for ri in rates:
        for ro in rates:
            for q in QUALITY_PRESETS:
                if pallas_src.pallas_applicable(jbank(ri, ro, quality=q)):
                    n_pallas += 1
                    assert sk.kernel_applicable(design_cycle_bank(ri, ro, quality=q)), \
                        (ri, ro, q)
    assert n_pallas > 100
    bank = design_cycle_bank(44100, 48000)
    sk.resample_auto(torch.zeros((2, 1000)), bank)
    tres.resample_presliced(torch.zeros((2, 9 * bank.M + bank.W)), bank, 10)
    assert sk.launches == 0


def test_non_cpu_tensor_launches_or_raises():
    """No fallback: a tensor that is not on the CPU goes to the kernel
    wrapper, which refuses anything but a CUDA tensor."""
    bank = design_cycle_bank(44100, 48000)
    x = torch.empty((2, 1000), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.resample_kernel(x, bank)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sk.resample_rows(x, bank)
    assert sk.launches == 0


def test_varispeed_bank_names_its_roadmap_item():
    """A varispeed bank waited for its ROADMAP item; now `resample_auto`
    takes it: on the CPU through the float64 gather twin, with no launch,
    and a dense-only helper says which forms serve the bank."""
    bank = design_cycle_bank(44100, 44056)
    assert bank.G is None and sk.kernel_applicable(bank)
    x = torch.from_numpy(_signal(44100, seed=2)[:, :500])
    y = sk.resample_auto(x, bank)
    assert y.shape == (2, bank.out_len(500)) and sk.launches == 0
    ref = resample_oracle(x.numpy().astype(np.float64), 44100, 44056)
    assert np.abs(y.numpy() - ref).max() <= 2e-6
    with pytest.raises(RuntimeError, match="resample_banded"):
        sk.stacked_bank_f32(bank)


def test_bank_to_torch_is_the_jax_cycle_matrix():
    bank, jb = design_cycle_bank(48000, 44100, quality="high"), jbank(48000, 44100, quality="high")
    g = tres.bank_to_torch(bank, torch.device("cpu"))
    assert g.dtype == torch.float32 and tuple(g.shape) == (bank.W, bank.L)
    assert np.array_equal(g.numpy(), jres.cycle_matrix_f32(jb))
    assert tres.bank_to_torch(bank, torch.device("cpu")) is g     # cached
    assert np.array_equal(sk.stacked_bank_f32(bank), pallas_src.stacked_bank_f32(jb))
    assert sk.rows_marshal_plan(bank, 12345) == pallas_src.rows_marshal_plan(jb, 12345)


@pytest.mark.cuda
def test_kernel_matches_twin_on_card():
    """On an NVIDIA GPU: the CUDA kernel against its float64 plain twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    for ri, ro, q in BANKS:
        bank = design_cycle_bank(ri, ro, quality=q)
        x = torch.from_numpy(_signal(ri, seed=1)).cuda()
        n0 = sk.launches
        y = sk.resample_kernel(x, bank)
        torch.cuda.synchronize()
        assert sk.launches == n0 + 1
        yt, out_len = sk.resample_rows_reference(x, bank)
        assert (y - yt.reshape(2, -1)[:, :out_len]).abs().max().item() <= 5e-7


#: the four banks of the kernel phase on the card (R = 1, 1, 2, 4)
CARD_BANKS = [(44100, 48000, "high"), (48000, 44100, "high"), (44100, 48000, "ultra"),
              (176400, 48000, "high")]


def _tone(rate: int, n: int, seed: int) -> np.ndarray:
    """Two tones plus white noise at about -12 dBFS RMS (the card's kernel
    phase signal)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    f = rng.uniform(80.0, 6000.0, size=2)
    return (0.3 * np.sin(2 * np.pi * f[0] * t) + 0.15 * np.sin(2 * np.pi * f[1] * t + 0.7)
            + 0.02 * rng.standard_normal(n)).astype(np.float32)


def _kernel_order(x: np.ndarray, bank, Q: int) -> np.ndarray:
    """The CUDA kernel's arithmetic in numpy float32: ``(Q, L)`` outputs of
    the signal ``x``, from `kernel_plan` and `packed_bank_f32` as the kernel
    reads them.  Per column tile and 8-row step: x split into TF32 high and
    low parts (round to nearest, ties away); a fresh fragment that starts
    from the negated compensation and adds xh*gl, xl*gh, then xh*gh, each an
    8-product sum in order (the products are exact in float32); the fragment
    joins the running sum by Fast2Sum; the output is sum + the negated
    compensation."""
    plan = sk.kernel_plan(bank)
    packed, tiles = sk.packed_bank_f32(bank)
    L, M, nt = bank.L, bank.M, plan.nt
    rows = 8 * int(tiles[:, 1].max())
    xp = np.zeros((Q - 1) * M + max(rows, bank.W) + int(tiles[:, 0].max()) + 8, np.float32)
    n = min(x.size, xp.size - bank.pad_front)
    xp[bank.pad_front:bank.pad_front + n] = x[:n]
    xh = sk.tf32_rna(xp)
    xl = sk.tf32_rna(xp - xh)
    y = np.zeros((Q, L), np.float32)
    for c, (w_lo, nk, off) in enumerate(tiles[:, :3]):
        cols = np.arange(8 * nt * c, min(L, 8 * nt * (c + 1)))
        quad = packed[off:off + nk * nt * 32].reshape(nk, nt, 8, 4, 4)   # s, n, g, t, part
        # hi / lo of G[w_lo + 8s + k, 8*nt*c + 8n + g] as (s, k, column)
        gh, gl = (np.concatenate([quad[..., i], quad[..., i + 1]], axis=3)
                  .transpose(0, 3, 1, 2).reshape(nk, 8, 8 * nt)[:, :, :cols.size]
                  for i in (0, 2))
        total = np.zeros((Q, cols.size), np.float32)
        nc = np.zeros_like(total)
        for s in range(nk):
            idx = np.arange(Q)[:, None] * M + w_lo + 8 * s + np.arange(8)[None, :]
            ah, al = xh[idx], xl[idx]
            d = nc
            for a, b in ((ah, gl[s]), (al, gh[s]), (ah, gh[s])):
                for k in range(8):
                    d = d + a[:, k:k + 1] * b[k][None, :]
            tk = total + d
            nc = d - (tk - total)
            total = tk
        y[:, cols] = total + nc
    return y


def _case(ri, ro, q, kind="sinc"):
    """A bank as a test case; a sinc bank keeps the id of the (ri, ro, q)
    cases this file had before it took the filter kind."""
    return pytest.param(ri, ro, q, kind, id=f"{ri}-{ro}-{q}" + ("" if kind == "sinc" else f"-{kind}"))


#: one bank of each plan variant the card's four banks do not cover: 2 and 4
#: warps, R = 3 and 5, L = 640 (16 column tiles), lagrange's short W
PLAN_VARIANTS = [(192000, 44100, "high"), (96000, 44100, "high"), (48000, 88200, "ultra"),
                 (48000, 176400, "ultra"), (44100, 192000, "high"),
                 (44100, 48000, "high", "lagrange")]


@pytest.mark.parametrize("ri,ro,q,kind", [_case(*b) for b in CARD_BANKS + PLAN_VARIANTS])
def test_kernel_order_meets_the_accuracy_gate(ri, ro, q, kind):
    """The kernel's summation order against the exact sum, in LSB at 24 bits
    on a -12 dBFS signal: RMS <= 0.2, max <= 1.5 (the design gate; a plain
    float32 running sum reads ~0.4 RMS, one TF32 pass ~500)."""
    bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
    Q = 1500 if bank.L < 100 else 300
    x = _tone(ri, Q * bank.M + bank.W, seed=ri % 977)
    y = _kernel_order(x, bank, Q)
    idx = np.arange(Q)[:, None] * bank.M + np.arange(bank.W)[None, :] - bank.pad_front
    xpad = np.where((idx >= 0) & (idx < x.size), x[np.clip(idx, 0, x.size - 1)], 0)
    exact = xpad.astype(np.float64) @ bank.G.astype(np.float32).astype(np.float64)
    err = (y - exact) * 2.0 ** 23
    rms, mx = float(np.sqrt(np.mean(err ** 2))), float(np.abs(err).max())
    assert rms <= 0.2 and mx <= 1.5, (rms, mx)
    # the twin the card is held to is the exact sum rounded once
    yt, out_len = sk.resample_rows_reference(torch.from_numpy(x), bank)
    assert np.abs(yt.numpy()[:Q] - exact).max() <= 2.0 ** -24


#: every bank the kernel takes in `chip_smoke.py` phase 12a: the 30 studio
#: pairs at the four sinc presets, at minphase high and at lagrange, and the
#: varispeed pairs at the four presets, where L >= 8
_STUDIO = [(a, b) for a in STANDARD_RATES for b in STANDARD_RATES if a != b]
SWEEP_KERNEL_BANKS = [
    (a, b, q, kind)
    for a, b, q, kind in ([(a, b, q, "sinc") for a, b in _STUDIO for q in QUALITY_PRESETS]
                          + [(a, b, "high", k) for k in ("minphase", "lagrange")
                             for a, b in _STUDIO]
                          + [(a, b, q, "sinc") for a, b in ((44100, 44056), (44056, 44100),
                                                            (192000, 44056), (44100, 42735))
                             for q in QUALITY_PRESETS])
    if resolve_ratio(a, b)[0] >= 8]
PACKED_CASES = ([(*b, "sinc") for b in CARD_BANKS + [(48000, 44100, "low"), (8000, 44100, "ultra"),
                                                     (44100, 8000, "ultra")]]
                + [b for b in SWEEP_KERNEL_BANKS
                   if b[3] != "sinc" or b[:3] not in CARD_BANKS + [(48000, 44100, "low")]])


def _packed_entries(packed: np.ndarray, tiles: np.ndarray, nt: int):
    """``(w, col, value)`` of every packed entry, flat: the bank row and
    output phase each fragment value stands for, and its hi + lo (float64)."""
    ws, cols, vals = [], [], []
    s, n, g, t, k = np.ix_(np.arange(int(tiles[:, 1].max())), np.arange(nt), np.arange(8),
                           np.arange(4), np.arange(2))
    for c, (w_lo, nk, off) in enumerate(tiles[:, :3]):
        quad = packed[off:off + nk * nt * 32].reshape(nk, nt, 8, 4, 4).astype(np.float64)
        w, col = np.broadcast_arrays(w_lo + 8 * s[:nk] + t + 4 * k, 8 * nt * c + 8 * n + g)
        ws.append(w.ravel())
        cols.append(col[:nk].ravel())
        vals.append((quad[..., 0:2] + quad[..., 2:4]).ravel())
    return np.concatenate(ws), np.concatenate(cols), np.concatenate(vals)


@pytest.mark.parametrize("ri,ro,q,kind", [_case(*b) for b in PACKED_CASES])
def test_packed_bank_and_plan(ri, ro, q, kind):
    """The launch plan and packed bank the kernel reads, for every bank the
    card's phase 12a launches: the plan fits a block's shared memory, every
    non-zero of G lies inside its tile's band with hi + lo within 2^-21 of
    its value (the split keeps 22 bits) and zeros outside G; a varispeed
    bank (no dense G) holds each phase's K taps of the phase bank exactly
    once, in a window pitch of 4 mod 32 floats.  A loads are free of bank
    conflicts for the card's four banks."""
    bank = design_cycle_bank(ri, ro, quality=q, kind=kind)
    plan = sk.kernel_plan(bank)
    assert plan is not None and sk.kernel_applicable(bank)
    packed, tiles = sk.packed_bank_f32(bank)
    L, nt = bank.L, plan.nt
    assert len(plan.bands) == len(tiles) == -(-L // (8 * nt))
    assert plan.smem_bytes <= 232448 and plan.ring_off % 4 == 0
    assert np.all(tiles[:, 1] % sk.KC8 == 0)
    assert np.array_equal(sk.tf32_rna(packed), packed)              # all TF32 values
    w, col, v = _packed_entries(packed, tiles, nt)
    assert not v[col >= L].any()
    if bank.G is None:
        assert plan.pitch % 32 == 4 and plan.pitch >= 3 + sk._union_floats(plan.bands, plan.group)
        assert plan.smem_bytes == sk._window_smem(nt, plan.warps, plan.pitch)[1]
        off, ph = tres._phase_tables(bank)
        hrev, K = tres._h_rev_f32_cached(bank), bank.taps_per_phase
        c = np.minimum(col, L - 1)
        tap = w - off[c]
        inside = (col < L) & (tap >= 0) & (tap < K)
        assert not v[~inside].any()
        want = hrev[ph[c[inside]], tap[inside]]
        assert np.abs(v[inside] - want).max() <= 2.0 ** -21 * np.abs(hrev).max()
        assert np.array_equal(np.bincount(col[inside], minlength=L), np.full(L, K))
        return
    G = bank.G.astype(np.float32)
    inside = (col < L) & (w < G.shape[0])
    assert not v[~inside].any()
    rebuilt = np.zeros(G.shape)
    np.add.at(rebuilt, (w[inside], col[inside]), v[inside])
    assert np.abs(rebuilt - G).max() <= 2.0 ** -21 * np.abs(G).max()
    assert np.array_equal(rebuilt != 0, G != 0)
    if kind == "sinc" and (ri, ro, q) in CARD_BANKS:
        assert sk._a_load_wavefronts(bank.M, plan.warps, plan.skew, plan.rowmap) == 1.0
        assert plan.warps == 8


def test_tf32_split_matches_ptx_rounding():
    """Round to nearest, ties away from zero, at the 13th bit: exact ties go
    up in magnitude, sign kept, and hi + lo keeps 22 significant bits."""
    one = np.float32(1.0)
    tie = np.frombuffer(np.uint32(0x3F801000).tobytes(), np.float32)[0]   # 1 + 2^-11
    below = np.frombuffer(np.uint32(0x3F800FFF).tobytes(), np.float32)[0]
    got = sk.tf32_rna(np.array([tie, -tie, below, one], np.float32))
    want = np.array([1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0, 1.0], np.float32)
    assert np.array_equal(got, want)
    v = np.random.default_rng(3).standard_normal(10000).astype(np.float32)
    hi = sk.tf32_rna(v)
    lo = sk.tf32_rna(v - hi)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - v) <= np.abs(v) * 2.0 ** -21)
