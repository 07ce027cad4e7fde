"""`src_kernel.src_route`, the one rule that picks the SRC implementation,
and the tables of the forms that ask it.

The route table is recorded from the commit before the rule existed, when
each entry point chose for itself (`kernel_applicable` for `cycle_src`,
the dense L < 8 gate for the `cycle_fold` kernel, else the plain form):
every (pair, preset) bank of fourteen common rates, 8 kHz to 384 kHz, and
the varispeed banks the tests run.  The rule reads a device's type alone,
so both device types are asked here without a GPU."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu_torch.models import design_cycle_bank  # noqa: E402
from f9tpu_torch.models.filters import QUALITY_PRESETS  # noqa: E402
from f9tpu_torch.ops import cycle_fold as cf  # noqa: E402
from f9tpu_torch.ops import loudness as tloud  # noqa: E402
from f9tpu_torch.ops import resample as tres  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402
from f9tpu_torch.ops import src_plain as sp  # noqa: E402

RATES = (8000, 11025, 16000, 22050, 24000, 32000, 44100, 48000, 88200, 96000, 176400,
         192000, 352800, 384000)
VARISPEED = [(44100, 44056, "low"), (44056, 44100, "low"), (44100, 44056, "medium"),
             (192000, 44056, "low"), (44100, 44056, "ultra"), (44100, 44056, "high"),
             (44056, 44100, "high"), (192000, 44056, "high")]
KEYS = [(ri, ro, q) for ri in RATES for ro in RATES if ri != ro
        for q in QUALITY_PRESETS] + VARISPEED
#: the earlier commit's choices over `KEYS`: counts among the 728 dense
#: banks, the varispeed banks', and the sha256 of ``"ri>ro:q=impl"`` lines
DENSE_COUNTS = {"cycle_src": 440, "cycle_fold": 284, "plain": 4}
VARISPEED_COUNTS = {"cycle_src": 8}
ROUTES_SHA256 = "fd0d29ac339d0e23"
PLAIN = [(384000, 11025, q) for q in QUALITY_PRESETS]


@pytest.fixture(scope="module")
def banks():
    return {key: design_cycle_bank(key[0], key[1], quality=key[2]) for key in KEYS}


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_route_table_is_the_earlier_dispatch(banks, device):
    dev = torch.device(device)
    routes = {key: sk.src_route(bank, dev) for key, bank in banks.items()}
    assert {r.card for r in routes.values()} == {device == "cuda"}
    dense = [r.impl for key, r in routes.items() if banks[key].G is not None]
    vari = [r.impl for key, r in routes.items() if banks[key].G is None]
    assert len(dense) == 728 and len(vari) == len(VARISPEED)
    assert {k: dense.count(k) for k in set(dense)} == DENSE_COUNTS
    assert {k: vari.count(k) for k in set(vari)} == VARISPEED_COUNTS
    assert sorted(k for k, r in routes.items() if r.impl == "plain") == sorted(PLAIN)
    text = "\n".join(f"{ri}>{ro}:{q}={routes[ri, ro, q].impl}" for ri, ro, q in KEYS)
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == ROUTES_SHA256


def test_route_reads_the_kernels_own_gates(banks):
    """``cycle_src`` exactly where `kernel_applicable`, ``cycle_fold``
    exactly where `fold_kernel_applicable` and the former does not."""
    for key, bank in banks.items():
        impl = sk.src_route(bank, torch.device("cpu")).impl
        assert (impl == "cycle_src") == sk.kernel_applicable(bank), key
        assert (impl == "cycle_fold") == (cf.fold_kernel_applicable(bank)
                                          and not sk.kernel_applicable(bank)), key


def _noise(rows: int, T: int, seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).uniform(-0.9, 0.9, (rows, T)).astype(np.float32)
    return torch.from_numpy(x)


#: one bank of each answer, and a varispeed bank
TABLE_BANKS = [(44100, 48000, "high", "cycle_src"), (96000, 48000, "high", "cycle_fold"),
               (48000, 192000, "high", "cycle_fold"), (384000, 11025, "low", "plain"),
               (44100, 44056, "low", "cycle_src")]


@pytest.mark.parametrize("ri,ro,q,impl", TABLE_BANKS)
def test_cpu_tables_run_the_twins(ri, ro, q, impl):
    """On the CPU each form runs the implementation its table names for the
    rule's answer, bit for bit, and no kernel launches."""
    bank = design_cycle_bank(ri, ro, quality=q)
    assert sk.src_route(bank, torch.device("cpu")) == (impl, False)
    sk.launches = cf.launches = 0
    x = _noise(2, 3 * bank.M + bank.W + 77, ri % 101)
    T = x.shape[-1]
    batch = {"cycle_src": sk.resample_kernel_reference, "cycle_fold": sp._unfold_matmul,
             "plain": sp._plain_batch}[impl]
    assert torch.equal(sk.resample_auto(x, bank), batch(x, bank, None))
    assert torch.equal(tres.resample_rates(x, ri, ro, quality=q), batch(x, bank, None))
    Q = -(-bank.out_len(T) // bank.L)
    xp = torch.zeros((2, (Q - 1) * bank.M + bank.W))
    keep = min(T, xp.shape[-1] - bank.pad_front)
    xp[:, bank.pad_front:bank.pad_front + keep] = x[:, :keep]
    assert torch.equal(tres.resample_presliced(xp, bank, Q), sp._plain_presliced(xp, bank, Q))
    whole = batch(x, bank, Q * bank.L)
    xs = torch.cat([torch.zeros((2, bank.pad_front)), x, torch.zeros((2, 2 * bank.W))], -1)
    assert torch.equal(sk.resample_staged(xs, bank, Q), whole)
    if bank.G is None:
        assert torch.equal(tres.resample(x, bank), sp.resample_gather(x, bank))
    else:
        assert torch.equal(tres.resample(x, bank), sp._unfold_matmul(x, bank, None))
    assert sk.launches == cf.launches == 0


def test_meter_peak_table():
    """The true-peak oversampler (L = 4, M = 1) is a `cycle_fold` bank at
    the meter's rates; on the CPU `_tp_step` is the fused kernel's twin."""
    for rate in (8000, 44100, 48000, 96000, 192000):
        bank = design_cycle_bank(rate, 4 * rate, quality="high")
        assert sk.src_route(bank, torch.device("cuda")) == ("cycle_fold", True)
    bank = design_cycle_bank(48000, 192000, quality="high")
    xp = _noise(2, 600 + bank.W, 7)
    want = cf.presliced_absmax_reference(xp, bank, 600)
    assert torch.equal(tloud._tp_step(xp, cycles=600, rate_in=48000, oversample=4), want)
