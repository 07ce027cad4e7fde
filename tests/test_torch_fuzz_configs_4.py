"""Seeds 1018-1023 of the batch config fuzz, with the helpers and bounds of
`tests/test_torch_fuzz_configs.py` (a file of their own so that no file's
trials outrun one worker), and the case that shows whose the top-octave gap
between the two packages is."""

import numpy as np
import pytest

pytest.importorskip("torch")

from test_torch_fuzz_configs import (BATCH_SEEDS, PACKAGES, _codes, _inputs, _one_thread,  # noqa: E402, F401
                                     _run, check_trial, draw_trial)


@pytest.mark.parametrize("seed", BATCH_SEEDS[18:24])
def test_random_config_matches_jax(tmp_path, seed):
    check_trial(tmp_path, seed)


def test_top_octave_gap_is_the_reference_s(tmp_path):
    """Seed 1020 (+3 dB, no dither, DC removal or chain; 32 kHz, reverb mode)
    puts codes 3 apart in the top octave.  Against the float64 oracle the
    port reads at most 1 LSB on every file, and wherever the two packages are
    more than 2 apart JAX is at least 2 from the oracle: the gap is JAX's."""
    from f9tpu_torch.io import wav
    from f9tpu_torch.models import resample_oracle

    files, kw = draw_trial(1020)
    assert kw["gain_db"] == 3.0 and not (kw["dither"] or kw["remove_dc"] or kw["chain"])
    paths = _inputs(tmp_path, files)
    runs = {pkg: _run(pkg, kw, paths, str(tmp_path / pkg)) for pkg in PACKAGES}
    cfg, _, outs = runs["torch"]
    s = 1 << (cfg.bits - 1)
    gaps = 0
    for p, f in zip(paths, outs):
        x, _ = wav.read_wav(p)
        ref = resample_oracle(x, 44100, cfg.target_rate, quality="low") * 10 ** (3.0 / 20)
        rc = np.clip(np.round(ref * s), -s, s - 1)
        tc, _ = _codes(str(tmp_path / "torch" / f), cfg.bits)
        jc, _ = _codes(str(tmp_path / "jax" / f), cfg.bits)
        n = rc.shape[1]                          # reverb mode's tail runs past it
        assert np.abs(tc[:, :n] - rc).max() <= 1, f
        far = np.abs(tc[:, :n] - jc[:, :n]) > 2
        assert (np.abs(jc[:, :n] - rc)[far] >= 2).all(), f
        gaps += int(far.sum())
    assert gaps > 0
