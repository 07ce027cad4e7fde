"""`examples/demo_torch.py`, the port's twin of `examples/demo.py`, on the
CPU: its configurations 1-5 (mono parity against the oracle, a 96k batch
with dither, an 8-channel routing map with a silent bus, reverb mode with
calibration, the mixed-rate folder), each with the demo's own asserts.  All
13 run on the card (`chip_smoke.py` phase 10e); on the CPU the other eight
take over a minute (the insert loop's reverb, the normalizer's true-peak
fold, the stream).  Torch runs on one thread, as in
`tests/test_torch_stream.py`."""

import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

_spec = importlib.util.spec_from_file_location(
    "demo_torch", os.path.join(os.path.dirname(__file__), "..", "examples", "demo_torch.py"))
demo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(demo)


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_demo_configuration_on_the_cpu(tmp_path, capsys, config):
    demo.run(str(tmp_path), "cpu", {config})
    assert f"[{config}] " in capsys.readouterr().out


def test_demo_config_spec():
    assert demo._configs("all") == set(range(1, 14))
    assert demo._configs("1-5") == {1, 2, 3, 4, 5}
    assert demo._configs("1,3,8-9") == {1, 3, 8, 9}
