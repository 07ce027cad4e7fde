"""The output check separates: a sound run of each cell is correct, the
control (the plain reference in TF32 in the program's place) is not, and
neither is a run whose timed path is broken underneath in any of the ways
a batch job can be (``faults.py``): a batch answered with the previous
batch's results or with those of the same wire's last dispatch, the
dither left out or drawn from another seed, half of a batch left out, an
answer altered where it is produced."""

from __future__ import annotations

import pytest
import torch

import _small
import faults


@pytest.mark.parametrize("workload", _small.CELLS)
def test_sound_run_is_correct(workload):
    rc, res = _small.run(workload)
    assert rc == 0 and res["correct"], res.get("checks")
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("workload", _small.CELLS)
def test_control_is_not_correct(workload):
    rc, res = _small.run(workload, extra=("--control",))
    assert rc == 0 and not res["correct"], res["checks"]
    assert res["checks"]["code_lsb"]["value"] > res["checks"]["code_lsb"]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", _small.CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    faults.plant(fault, monkeypatch.setattr)
    # the small library is two batches: with two warm-up dispatches every
    # batch of the window answers with its wire's last dispatch
    rc, res = _small.run(workload, traffic={"warmup_batches": 2} if fault == "stale_lib" else None)
    assert rc == 0 and not res["correct"], res["checks"]
    if fault in ("stale_lib", "seed", "undithered"):
        # only the dither tells these apart: each is within a few LSB
        assert res["checks"]["dither_gap"]["value"] > res["checks"]["dither_gap"]["limit"]


def test_traced_run_reads_and_judges():
    rc, res = _small.run("studio48.cd_masters", trace=1)
    assert rc == 0 and res["correct"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["metrics"]["graph_enqueue_ms"]["value"] > 0


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from bench_h100 import harness

    rc = harness.main(["--workload", "studio48.cd_masters", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import subprocess
    import sys

    out = subprocess.run([sys.executable, "bench_h100/run.py", "--workload", "studio48.cd_masters",
                          "--seed", "5", "--seconds", "2", "--trace", "0"], cwd=_small.harness.cells.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
