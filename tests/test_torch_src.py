"""The port's SRC (kernel dispatch, plain twin, unfold + matmul form)
against the JAX package's Pallas and conv forms and the float64 oracle.

On the CPU the kernel wrappers run the plain twin; the JAX Pallas kernel
runs in interpret mode, as the JAX package's own tests run it.  Tolerance:
max abs <= 2e-6 between forms (the JAX package's own bound between its SRC
forms, tests/test_resample_parity.py) and <= -120 dB against the oracle."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.models import design_cycle_bank, resample_oracle  # noqa: E402
from f9tpu.models.filters import QUALITY_PRESETS  # noqa: E402
from f9tpu.ops import pallas_src  # noqa: E402
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
    bank = design_cycle_bank(ri, ro, quality=q)
    x = _signal(ri, seed=ri + len(q))
    xt = torch.from_numpy(x)
    want_pallas = np.asarray(pallas_src.resample_pallas(jnp.asarray(x), bank))
    want_conv = np.asarray(jres.resample(jnp.asarray(x), bank))
    ref = resample_oracle(x, ri, ro, quality=q)
    rows, out_len = sk.resample_rows(xt, bank)
    assert rows.shape == (2, -(-out_len // bank.L), bank.L)
    got = {
        "auto": sk.resample_auto(xt, bank).numpy(),
        "kernel": sk.resample_kernel(xt, bank).numpy(),
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
    want = np.asarray(pallas_src.resample_pallas(jnp.asarray(x), bank, out_len=out_len))
    got = sk.resample_kernel(torch.from_numpy(x), bank, out_len=out_len).numpy()
    got_conv = tres.resample(torch.from_numpy(x), bank, out_len=out_len).numpy()
    assert got.shape == got_conv.shape == want.shape == (2, out_len)
    assert np.abs(got - want).max() <= 2e-6
    assert np.abs(got_conv - want).max() <= 2e-6


def test_empty_and_tiny_inputs():
    bank = design_cycle_bank(44100, 48000)
    for T in (0, 1, 5):
        x = np.full((3, T), 0.25, np.float32)
        want = np.asarray(pallas_src.resample_pallas(jnp.asarray(x), bank))
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
        want = np.asarray(jres.resample(jnp.asarray(x), bank))
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
                bank = design_cycle_bank(ri, ro, quality=q)
                if pallas_src.pallas_applicable(bank):
                    n_pallas += 1
                    assert sk.kernel_applicable(bank), (ri, ro, q)
    assert n_pallas > 100
    bank = design_cycle_bank(44100, 48000)
    sk.resample_auto(torch.zeros((2, 1000)), bank)
    sk.resample_rows(torch.zeros((2, 1000)), bank)
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
    bank = design_cycle_bank(44100, 44056)
    assert bank.G is None
    with pytest.raises(NotImplementedError, match="Varispeed"):
        sk.resample_auto(torch.zeros((1, 500)), bank)


def test_bank_to_torch_is_the_jax_cycle_matrix():
    bank = design_cycle_bank(48000, 44100, quality="high")
    g = tres.bank_to_torch(bank, torch.device("cpu"))
    assert g.dtype == torch.float32 and tuple(g.shape) == (bank.W, bank.L)
    assert np.array_equal(g.numpy(), jres.cycle_matrix_f32(bank))
    assert tres.bank_to_torch(bank, torch.device("cpu")) is g     # cached
    assert np.array_equal(sk.stacked_bank_f32(bank), pallas_src.stacked_bank_f32(bank))
    assert sk.rows_marshal_plan(bank, 12345) == pallas_src.rows_marshal_plan(bank, 12345)


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
