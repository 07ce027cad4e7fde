"""The batch job at the benchmark's ``studio96`` settings, held to the
benchmark's plain reference (`bench_h100.reference`: float64, its own banks,
calibration and dither hash).

48 kHz files go up x2 to a 96 kHz session (the dense L = 2 bank) and x4 to
192 kHz (L = 4).  On the CPU both run the unfold and float32 matmul, JAX's
conv bit for bit; on the card the `cycle_fold` kernel's flat form, bit for
bit its plain twin `cycle_fold.resample_fold_reference`, which the card-form
cases put in the batch table's CPU entry (`src_kernel._BATCH`).  `process_batch_raw` and the reference take the same 24-bit
wire, lengths and dither seeds, and `bench_h100.judge.compare` reads the
same numbers the benchmark's ``correct`` reads.  The plain reference with
its SRC in TF32 (10 mantissa bits) stands in for a program of a lower
precision and must fail the same limits."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench_h100 import judge  # noqa: E402
from bench_h100.reference.pipeline import Reference  # noqa: E402
from f9tpu_torch.config import ProcessingConfig  # noqa: E402
from f9tpu_torch.ops import cycle_fold as cf  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402
from f9tpu_torch.pipeline import graph  # noqa: E402
from f9tpu_torch.pipeline.calibration import CalibrationCache  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RATE_IN, C, BITS, BUCKET = 48000, 2, 24, 1 << 16
VALID = np.array([65536, 50021, 40000, 23001], np.int32)
SEEDS = np.array([1234567, 99, 2**31 - 1, 0], np.int32)

#: Limits, each with its reason.  The float32 matmul reads up to 8.3 LSB
#: from the float64 oracle at x2 and x4 near full scale (ROADMAP.md, the
#: table of Queue 2's parked half); each side rounds its value plus the same
#: dither, which adds at most one code.
CODE_LSB = 9
#: The card's form, the float64 fold, reads at most 0.53 LSB from the oracle
#: there (`tests/test_torch_cycle_fold.py`); the reference's own float64 SRC
#: and each side's rounding of its value plus the same dither add a code
#: each.
FOLD_CODE_LSB = 3
#: A file's peak, RMS and noise floor in dB: float32 samples against float64
#: ones move them by ~1e-6 dB at these levels; TF32 operands by ~1e-3.
PEAK_DB, RMS_DB, FLOOR_DB = 1e-4, 1e-5, 1e-4
#: |1 - slope| of the program's codes less the reference's undithered value
#: on the reference's dither: ~0.01 with the file's own dither at these
#: lengths, 1 with none or another seed's.
DITHER_GAP = 0.06


def _studio96(target_rate: int) -> dict:
    with open(os.path.join(ROOT, "bench_h100", "configs", "studio96.json")) as f:
        cfg = json.load(f)
    return {**cfg, "target_rate": target_rate, "bucket_frames": [BUCKET]}


def _wire() -> np.ndarray:
    """Two tones and noise a channel at the cells' levels (0.3, 0.15, 0.02),
    24-bit interleaved, zero past each file."""
    rng = np.random.default_rng(96)
    s = float(1 << (BITS - 1))
    raw = np.zeros((len(VALID), BUCKET * C * BITS // 8), np.uint8)
    for i, n in enumerate(VALID):
        f = rng.uniform(80.0, 6000.0, (C, 2))
        t = np.arange(n) / RATE_IN
        x = (0.3 * np.sin(2 * np.pi * f[:, :1] * t) + 0.15 * np.sin(2 * np.pi * f[:, 1:] * t + 0.7)
             + 0.02 * rng.standard_normal((C, n)))
        codes = np.clip(np.round(x * s), -s, s - 1).astype("<i4")
        raw[i, :n * C * 3] = codes.T.reshape(-1).view(np.uint8).reshape(-1, 4)[:, :3].reshape(-1)
    return raw


def _program(cfg: dict) -> tuple[int, list[dict]]:
    pc = ProcessingConfig(
        target_rate=cfg["target_rate"], quality=cfg["quality"], kind=cfg["kind"], bits=cfg["bits"],
        dither=cfg["dither"], remove_dc=cfg["remove_dc"], gain_db=cfg["gain_db"],
        trim_enabled=cfg["trim_enabled"], batch_size=len(VALID),
        bucket_frames=tuple(cfg["bucket_frames"]), output_dir="unused")
    cal = CalibrationCache().get_or_measure(RATE_IN, pc.target_rate, quality=pc.quality,
                                            kind=pc.kind, device="cpu")
    res = graph.process_batch_raw(_wire(), VALID, pc, RATE_IN, SEEDS, in_channels=C,
                                  in_bits=BITS, latency_frames=cal.latency_frames,
                                  noise_floor_db=None, device="cpu")
    host = [t.numpy() for t in (res.codes, res.out_frames, res.peak_db, res.rms_db,
                                res.noise_floor_db, res.tail_terminated)]
    return cal.latency_frames, judge.from_program(host, cfg["bits"], C)


def _readings(got: list[dict], ref: Reference) -> dict:
    want = ref.batch(torch.from_numpy(_wire()), VALID, SEEDS, C, BITS,
                     verdicts=[(g["out_frames"], g["terminated"]) for g in got])
    return judge.compare(got, want)


def _within(r: dict, code_lsb: int = CODE_LSB) -> bool:
    return (r["code_lsb"] <= code_lsb and r["peak_db"] <= PEAK_DB and r["rms_db"] <= RMS_DB
            and r["floor_db"] <= FLOOR_DB and r["dither_gap"] <= DITHER_GAP
            and r["frames_bad"] == 0)


@pytest.mark.parametrize("target_rate", [96000, 192000], ids=["x2", "x4"])
def test_upsampling_batch_within_limits_of_the_reference(target_rate):
    cfg = _studio96(target_rate)
    latency, got = _program(cfg)
    ref = Reference(cfg, RATE_IN, {}, torch.device("cpu"))
    assert latency == ref.latency
    assert [g["out_frames"] for g in got] == [-(-int(n) * target_rate // RATE_IN) for n in VALID]
    r = _readings(got, ref)
    assert _within(r), r


@pytest.mark.parametrize("target_rate", [96000, 192000], ids=["x2", "x4"])
def test_card_form_batch_within_limits_of_the_reference(target_rate, monkeypatch):
    """The batch with its SRC in the card's form: the CPU's unfold and
    matmul replaced by the flat form's plain twin, held to the reference
    at `FOLD_CODE_LSB`."""
    calls = []

    def twin(x, bank, out_len):
        calls.append(bank.L)
        return cf.resample_fold_reference(x, bank, out_len)

    monkeypatch.setitem(sk._BATCH, ("cycle_fold", False), sk._on_signal(twin))
    cfg = _studio96(target_rate)
    latency, got = _program(cfg)
    assert calls and set(calls) == {target_rate // RATE_IN}
    ref = Reference(cfg, RATE_IN, {}, torch.device("cpu"))
    assert latency == ref.latency
    assert [g["out_frames"] for g in got] == [-(-int(n) * target_rate // RATE_IN) for n in VALID]
    r = _readings(got, ref)
    assert _within(r, FOLD_CODE_LSB), r


@pytest.mark.parametrize("target_rate", [96000, 192000], ids=["x2", "x4"])
def test_tf32_stand_in_fails_the_limits(target_rate):
    cfg = _studio96(target_rate)
    ref = Reference(cfg, RATE_IN, {}, torch.device("cpu"))
    stand_in = Reference(cfg, RATE_IN, {}, torch.device("cpu"), tf32=True)
    got = stand_in.batch(torch.from_numpy(_wire()), VALID, SEEDS, C, BITS)["files"]
    r = _readings(got, ref)
    assert not _within(r), r
    # it fails by the codes and by every dB figure, each by far
    assert r["code_lsb"] > 10 * CODE_LSB, r
    assert r["peak_db"] > 5 * PEAK_DB and r["rms_db"] > 5 * RMS_DB and r["floor_db"] > 5 * FLOOR_DB, r
