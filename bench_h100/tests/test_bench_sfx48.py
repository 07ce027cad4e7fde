"""The cell ``studio96.sfx48`` (48 kHz libraries up x2 through the dense
L = 2 batch SRC) at a CPU size.

A sound run is correct and prints the end-to-end metrics the cell lists,
the control is not correct, and neither is a run whose timed path is broken
underneath (``faults.py``).  A traced run judges and prints only the
per-layer metrics that list the cell."""

from __future__ import annotations

import pytest

from bench_h100 import cell as cells

import _small
import faults

CELL = "studio96.sfx48"


def _run(traffic=None, **kw):
    # the 48 kHz files stay in one small bucket (16,384 frames)
    return _small.run(CELL, traffic={"seconds": [0.1, 0.3], **(traffic or {})}, **kw)


def test_sound_run_is_correct():
    rc, res = _run()
    assert rc == 0 and res["correct"], res.get("checks")
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cells.load(CELL).end_to_end}
    assert {"xrt", "batch_p95_ms", "setup_s"} <= set(res["metrics"])


def test_control_is_not_correct():
    rc, res = _run(extra=("--control",))
    assert rc == 0 and not res["correct"], res["checks"]
    assert res["checks"]["code_lsb"]["value"] > res["checks"]["code_lsb"]["limit"]


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    faults.plant(fault, monkeypatch.setattr)
    rc, res = _run(traffic={"warmup_batches": 2} if fault == "stale_lib" else None)
    assert rc == 0 and not res["correct"], res["checks"]
    if fault in ("stale_lib", "seed", "undithered"):
        assert res["checks"]["dither_gap"]["value"] > res["checks"]["dither_gap"]["limit"]


def test_traced_run_reads_and_judges():
    rc, res = _run(trace=1)
    assert rc == 0 and res["correct"]
    listed = {m["name"] for m in cells.load(CELL).per_layer}
    assert "graph_enqueue_ms" in listed and set(res["metrics"]) <= listed
    assert res["metrics"]["graph_enqueue_ms"]["value"] > 0
