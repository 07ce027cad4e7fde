"""The port's twin of `tests/test_quality_characteristics.py`: the design
characteristics `docs/QUALITY.md` publishes, measured through the port's
tool (`f9tpu_torch.tools.gen_quality`) on the CPU and held to the JAX
package's tool (`tools/gen_quality.py`) on the same bank within the
tolerances the card's phase 12d applies (`gen_quality.figure_ok`: ripple
0.01 dB, edge 0.002 of Nyquist, levels 3 dB or both past 130 dB), besides
each JAX test's own bound.

The JAX file's two `*_hbm_traffic_budget` tests read XLA's cost model of a
jitted graph; the port runs eagerly and has no such model, so they stay
out.  A last test runs the port's tool on a two-pair subset and checks its
tables' layout against `docs/QUALITY.md`'s."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu_torch.models.filters import design_cycle_bank  # noqa: E402
from f9tpu_torch.tools import gen_quality as gq  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_gen_quality",
                                               os.path.join(REPO, "tools", "gen_quality.py"))
jgq = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jgq)

RIPPLE, EDGE, ALIAS, IMAGE, THDN = gq.COLUMNS[1:6]


def _held(column, got, want):
    assert gq.figure_ok(column, got, want), (column, got, want)


@pytest.mark.parametrize("rate_in,rate_out", [(44100, 48000), (96000, 44100)])
def test_passband_ripple_high(rate_in, rate_out):
    """quality=high: gain error < 0.05 dB for tones up to 0.8x the shared
    Nyquist, and the JAX tool's ripple within 0.01 dB."""
    got = gq.passband_ripple_db(rate_in, rate_out, "high", device="cpu")
    assert got < 0.05, got
    _held(RIPPLE, got, jgq.passband_ripple_db(rate_in, rate_out, "high"))


def test_minus1db_edge_ordering():
    """The crossing count buys transition width: the -1 dB edge marches
    toward Nyquist with the preset, each edge within 0.002 of JAX's."""
    edges = {}
    for quality in ("low", "high"):
        edges[quality] = gq.edge_frac(48000, 44100, quality, device="cpu")
        _held(EDGE, edges[quality], jgq.edge_frac(48000, 44100, quality))
    assert edges["high"] > edges["low"] + 0.05, edges
    assert edges["high"] > 0.88, edges


def test_alias_rejection_high():
    """96k -> 44.1k high: a tone above the output Nyquist rejected > 120 dB."""
    got = gq.alias_rejection_db(96000, 44100, "high", device="cpu")
    assert got > 120.0, got
    _held(ALIAS, got, jgq.alias_rejection_db(96000, 44100, "high"))


def test_image_suppression_high():
    """44.1k -> 96k high: images above the input Nyquist suppressed > 130 dB."""
    got = gq.image_suppression_db(44100, 96000, "high", device="cpu")
    assert got > 130.0, got
    _held(IMAGE, got, jgq.image_suppression_db(44100, 96000, "high"))


def test_thdn_coherent_high():
    """Coherent THD+N of a ~1 kHz tone, 44.1k -> 48k high: below -125 dB.
    The port's CPU twin sums in float64, so its floor lies deeper than
    JAX's float32 one; both are past 130 dB."""
    got = gq.thdn_db(44100, 48000, "high", device="cpu")
    assert got < -125.0, got
    _held(THDN, got, jgq.thdn_db(44100, 48000, "high"))


def test_varispeed_banded_characteristics():
    """44.1k -> 44056 (L/M = 11014/11025) has no dense cycle matrix: its
    passband (tones at 0.25 and 0.8 of Nyquist within 0.05 dB) and alias
    rejection (> 120 dB), held to JAX's banded path."""
    bank = design_cycle_bank(44100, 44056, quality="high")
    assert bank.G is None   # certifying the varispeed forms, not the dense one
    ny = 0.5 * 44056
    for frac in (0.25, 0.8):
        got = gq._tone_gain_db(frac * ny, 44100, 44056, "high", "sinc", "cpu")
        assert abs(got) < 0.05, (frac, got)
        want = jgq._tone_gain_db(frac * ny, 44100, 44056, "high")
        assert abs(got - want) <= gq.RIPPLE_TOL_DB, (frac, got, want)
    got = gq.alias_rejection_db(44100, 44056, "high", device="cpu")
    assert got > 120.0, got
    _held(ALIAS, got, jgq.alias_rejection_db(44100, 44056, "high"))


def test_figure_tolerances_refuse_what_they_should():
    """The card's 12d gate (`figure_ok` via `compare`): each tolerance
    passes a figure just inside it and refuses one just outside, levels
    past 130 dB pass whatever their gap, and vs oracle is held to -120 dB."""
    ORACLE = gq.COLUMNS[6]
    assert gq.figure_ok(RIPPLE, 0.0147, 0.0047) and not gq.figure_ok(RIPPLE, 0.0148, 0.0047)
    assert gq.figure_ok(EDGE, 0.907, 0.905) and not gq.figure_ok(EDGE, 0.908, 0.905)
    assert gq.figure_ok(IMAGE, 92.5, 95.4) and not gq.figure_ok(IMAGE, 92.3, 95.4)
    assert gq.figure_ok(ALIAS, 146.0, 137.0) and not gq.figure_ok(ALIAS, 126.0, 137.0)
    assert gq.figure_ok(THDN, -141.3, -132.0) and not gq.figure_ok(THDN, -128.0, -132.0)
    assert gq.figure_ok(ALIAS, None, None) and not gq.figure_ok(ALIAS, None, 139.3)
    assert gq.figure_ok(ORACLE, -120.0, -141.7) and not gq.figure_ok(ORACLE, -119.9, -141.7)
    row = {c: 0.0 for c in gq.COLUMNS[1:]}
    faults = gq.compare({"## t": [("a", dict(row, **{ORACLE: -119.0})),
                                  ("b", dict(row, **{ORACLE: -130.0}))]},
                        {"## t": [("a", dict(row))]})
    assert len(faults) == 2 and "a: vs oracle" in faults[0] and "b: no such row" in faults[1], \
        faults


def test_quality_table_layout(tmp_path):
    """The port's tool on two pairs into ``tmp_path``: the JAX document's
    headings and columns, its row order restricted to the two pairs, every
    figure within the tolerances of its row there; and it refuses to write
    `docs/QUALITY.md`."""
    pairs = [(96000, 44100), (44100, 48000)]
    out = tmp_path / "q.md"
    assert gq.main(["--device", "cpu", "--out", str(out),
                    "--pairs", ",".join(f"{a}:{b}" for a, b in pairs)]) == 0
    text = out.read_text()
    with open(os.path.join(REPO, "docs", "QUALITY.md")) as fh:
        ref_text = fh.read()

    def headings(t):
        return [line for line in t.splitlines() if line.startswith("## ")]
    assert headings(text) == headings(ref_text)
    assert text.splitlines()[2].endswith("on **CPU**")
    got, want = gq.read_tables(text), gq.read_tables(ref_text)
    assert list(got) == list(want) and len(got) == len(gq.SECTIONS)
    labels = {gq.pair_label(a, b) for a, b in pairs}
    for heading, rows in got.items():
        assert [p for p, _ in rows] == [p for p, _ in want[heading] if p in labels], heading
    assert sum(line == gq._HEADER for line in text.splitlines()) == len(gq.SECTIONS)
    assert gq.compare(got, want) == []
    assert np.isfinite([v for rows in got.values() for _, r in rows
                        for v in r.values() if v is not None]).all()
    with pytest.raises(SystemExit):
        gq.main(["--device", "cpu", "--out", os.path.join(REPO, "docs", "QUALITY.md")])
