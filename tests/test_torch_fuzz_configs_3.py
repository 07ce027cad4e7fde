"""Seeds 1012-1017 of the batch config fuzz, with the helpers and bounds of
`tests/test_torch_fuzz_configs.py` (a file of their own so that no file's
trials outrun one worker)."""

import pytest

pytest.importorskip("torch")

from test_torch_fuzz_configs import BATCH_SEEDS, _one_thread, check_trial  # noqa: E402, F401


@pytest.mark.parametrize("seed", BATCH_SEEDS[12:18])
def test_random_config_matches_jax(tmp_path, seed):
    check_trial(tmp_path, seed)
