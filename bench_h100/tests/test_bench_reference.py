"""The plain reference against the port's CPU path (its plain twins) at
small sizes, for both configurations: the reference's own design, SRC,
chain, tail detector and whole batch."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import _small
from bench_h100 import cell as cells
from bench_h100 import harness, judge
from bench_h100.reference import chain as plain_chain
from bench_h100.reference import design, src, tail
from bench_h100.reference.pipeline import Reference


@pytest.mark.parametrize("pair,L,M,W,nnz", [((44100, 48000), 160, 147, 274, 20480),
                                           ((96000, 48000), 1, 2, 256, 256)])
def test_design_matches_the_published_banks(pair, L, M, W, nnz):
    l, m, K, H, delay = design.design(*pair)
    C, _ = design.cycle_form(l, m, K, H, delay)
    assert (l, m, C.shape[0], np.count_nonzero(C)) == (L, M, W, nnz)
    assert design.taps_per_output(l, m, K, H, delay).sum() == nnz


@pytest.mark.parametrize("pair", [(44100, 48000), (96000, 48000), (48000, 44100)])
def test_src_against_the_port(pair):
    from f9tpu_torch.models.filters import design_cycle_bank
    from f9tpu_torch.ops.src_kernel import resample_auto

    x = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, (3, 9000))
                         .astype(np.float32))
    bank = design_cycle_bank(*pair)
    n = bank.out_len(x.shape[-1])
    got = resample_auto(x, bank).to(torch.float64)[:, :n]
    want = src.resample(x, *pair, n)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) < 2e-6


def test_tf32_control_rounds_to_ten_bits():
    t = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -(1.0 + 2.0 ** -10)])
    assert src.to_tf32(t).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10)]


def test_chain_against_the_port():
    c = cells.load("reverb48.stems_reverb")
    stages = [dict(s) for s in c.config["chain"]]
    stages[3] = dict(stages[3], ir=dict(stages[3]["ir"], seconds=0.05))
    cc = cells.Cell(c.workload, dict(c.config, chain=stages), c.traffic, c.limits, [], [])
    irs = cc.impulse_responses()
    prog = harness.Program._chain(stages, irs)
    rng = np.random.default_rng(2)
    y = (0.5 * np.sin(np.arange(20000) / 7.0) * np.linspace(1, 0, 20000)
         + 0.05 * rng.standard_normal((2, 2, 20000))).astype(np.float32)
    got = prog.apply(torch.from_numpy(y), 48000).to(torch.float64)
    want = plain_chain.apply(torch.from_numpy(y).to(torch.float64), stages, 48000, irs)
    assert float((got - want).abs().max()) < 2e-5
    assert prog.tail_frames(48000) == plain_chain.tail_frames(stages, 48000, irs)


def test_tail_verdict_against_the_port():
    from f9tpu_torch.ops.trim import detect_tail_end

    rng = np.random.default_rng(3)
    T = 48000 * 3
    decay = 10.0 ** (-np.arange(T) / 48000 * 40 / 20)
    x = torch.from_numpy((rng.standard_normal((4, 2, T)) * 0.3 * decay).astype(np.float32))
    min_f = torch.tensor([0, 24000, 72000, 140000], dtype=torch.int32)
    end, hit = detect_tail_end(torch.amax(x.abs(), dim=1), 1.0, 10.0, rate=48000,
                               min_frames=min_f)
    for f in range(4):
        lv, win, hop = tail.levels(x[f].abs().amax(dim=0).to(torch.float64), 48000, 100, 50)
        args = (lv, win, hop, T, -80.0, int(min_f[f]), 3)
        assert tail.verdict(*args) == (int(end[f]), bool(hit[f]))
        assert tail.consistent(*args, 0.0, int(end[f]), bool(hit[f]))
        if hit[f]:
            assert not tail.consistent(*args, 0.0, int(end[f]) + hop, True)


@pytest.mark.parametrize("workload", _small.CELLS)
def test_batch_against_the_port(workload):
    c = cells.load(workload, overrides=_small.overrides(workload))
    irs = c.impulse_responses()
    prog = harness.Program(c, 9, torch.device("cpu"), irs)
    ref = Reference(c.config, c.traffic["rate_in"], irs, torch.device("cpu"))
    assert (ref.latency, ref.floor_db) == (prog.latency, prog.noise_floor)
    out_ch = len(c.config.get("channel_routing") or ()) or c.traffic["channels"]
    for k in range(2):
        host = prog.dispatch(k).get()
        got = judge.from_program(host, c.config["bits"], out_ch)
        want = ref.batch(prog.wire[k], prog.valid[k], c.dither_seeds(9, k),
                         c.traffic["channels"], c.traffic["bits"],
                         verdicts=[(g["out_frames"], g["terminated"]) for g in got])
        r = judge.compare(got, want)
        assert r["frames_bad"] == 0
        assert r["code_lsb"] <= 2
        assert max(r["peak_db"], r["rms_db"], r["floor_db"]) < 1e-4


@pytest.mark.parametrize("other,gap", [(None, 0.0), (8, 1.0), ("none", 1.0)])
def test_dither_slope_tells_the_seed(other, gap):
    from bench_h100.reference import finish

    y = torch.from_numpy(np.random.default_rng(3).uniform(-0.3, 0.3, (2, 60000)))
    codes, *_, exact, noise = finish.finish(y, 60000, 7, bits=24, dither=True, remove_dc=True,
                                            gain_db=0.0, floor_frames=4800)
    if other is not None:
        codes = finish.finish(y, 60000, other if other != "none" else 7, bits=24,
                              dither=other != "none", remove_dc=True, gain_db=0.0,
                              floor_frames=4800)[0]
    slope = judge.dither_slope(codes.numpy(), exact.numpy(), noise.numpy())
    assert abs(abs(1.0 - slope) - gap) < 0.02
