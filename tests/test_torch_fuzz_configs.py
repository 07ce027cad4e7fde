"""The config-interaction fuzz (`tests/test_fuzz_configs.py`), through the
port and the JAX package on the same inputs.

Each trial draws random small WAVs and a random valid `ProcessingConfig`
exactly as the JAX test's ``_random_cfg`` does (the same draws in the same
order, so seeds 1000-1007 are the JAX test's trials), and runs both
`BatchProcessor`s over the same files, the port on the CPU.  Seeds 1000-1023:
the JAX test's 8 never draw dither, 32 kHz or the oversized file that the
scheduler streams; the 24 draw every value of every feature
(`test_batch_draws_cover_every_feature`).

Per trial both packages complete every file, with the same output names,
containers, rates, streamed flags and frame counts, and the port's codes sit
within 2 LSB of JAX's at 24-bit resolution (`tests/test_torch_graph.py`'s
bound; 2 << 8 codes at 32 bits, where float32 carries 24 significant bits)
below -12 dBFS.  Above it the bound is `tests/test_torch_loudness.py`'s
full-scale one, 2 LSB plus 2^-21 of the 24-bit code's magnitude: there a
float32 ulp is up to half an LSB, and JAX's float32 batch SRC reads up to 3
LSB from the float64 oracle where the port's reads 1
(ROADMAP Queue 3).

Seeds 1000-1005 run here, 1006-1023 six at a time in
`tests/test_torch_fuzz_configs_2.py`, `_3.py` and `_4.py` (a trial with a
true-peak cap spends 15-45 s in the port's float64 oversampler on the CPU,
and a file runs on one worker), which import this file's helpers; `_4.py`
also holds `test_top_octave_gap_is_the_reference_s`.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import write_wav  # noqa: E402
from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.pipeline import scheduler as jsched  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.io import codec  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops import src_kernel as sk  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

#: the JAX test's 8 seeds and 16 more, which bring dither, 32 kHz and the
#: oversized file
BATCH_SEEDS = tuple(range(1000, 1024))
#: (scheduler, config class, chain module, BatchProcessor keywords)
PACKAGES = {"jax": (jsched, JConfig, jchain, {}),
            "torch": (tsched, TConfig, tchain, {"device": "cpu"})}


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread: the suite runs files in parallel processes, and an
    idle OpenMP pool spin-waits beside them (`tests/test_torch_stream.py`)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_cfg(rng) -> dict:
    """`tests/test_fuzz_configs.py::_random_cfg`, draw for draw, as keywords
    (the chain as the flag ``"chain"``, built per package)."""
    kw = dict(quality="low", batch_size=4, bucket_frames=(2048, 8192))
    kw["target_rate"] = int(rng.choice([44100, 48000, 32000, 44056]))
    kw["bits"] = int(rng.choice([16, 24, 32]))
    kw["dither"] = bool(rng.integers(2))
    kw["remove_dc"] = bool(rng.integers(2))
    kw["gain_db"] = float(rng.choice([0.0, -6.0, 3.0]))
    kw["seed"] = int(rng.integers(100))
    kw["output_format"] = str(rng.choice(["wav", "aiff"]))
    if kw["output_format"] == "aiff" and kw["bits"] == 32:
        kw["bits"] = 24
    kw["device_layout"] = str(rng.choice(["packed", "rows"]))
    if rng.integers(2):
        kw["reverb_mode"] = True
        kw["noise_floor_db"] = -90.0
        kw["tail_mode"] = str(rng.choice(["peak", "rms"]))
    kw["chain"] = bool(rng.integers(3) == 0)
    if rng.integers(3) == 0:
        kw["output_channels"] = 2
    if rng.integers(3) == 0:
        kw["normalize_lufs"] = float(rng.choice([-14.0, -20.0, -24.0]))
        if rng.integers(2):
            kw["normalize_tp_db"] = -1.0
        kw["surround_weights"] = bool(rng.integers(2))
    return kw


def draw_trial(seed: int):
    """The JAX trial's draws: ``(files, kw)``, each file ``(name, x, bits)``,
    the oversized one last when drawn (``kw["oversized"]``)."""
    rng = np.random.default_rng(seed)
    files = []
    for i in range(int(rng.integers(2, 5))):
        ch = int(rng.choice([1, 2]))
        frames = int(rng.integers(500, 6000))
        x = (0.3 * rng.standard_normal((ch, frames))).astype(np.float32)
        if rng.integers(2):
            x += 0.05
        files.append((f"f{i}.wav", x, int(rng.choice([16, 24, 32]))))
    kw = _random_cfg(rng)
    kw["oversized"] = bool(rng.integers(3) == 0 and not kw.get("reverb_mode", False))
    if kw["oversized"]:
        x = (0.2 * rng.standard_normal((2, 12_000))).astype(np.float32)
        files.append(("big.wav", x, 24))
    return files, kw


def _config(pkg: str, kw: dict, out_dir: str):
    _, conf, chain_mod, _ = PACKAGES[pkg]
    kw = {k: v for k, v in kw.items() if k != "oversized"}
    kw["chain"] = (chain_mod.Chain(chain_mod.Gain(-1.5), chain_mod.Saturator("soft", 3.0, 0.7))
                   if kw["chain"] else None)
    return conf(output_dir=out_dir, **kw)


def _codes(path: str, bits: int) -> tuple[np.ndarray, int]:
    """(channels, frames) integer codes and the rate of an output file: 32-bit
    WAV data read as int32 (a float32 decode would round them)."""
    y, rate = codec.read_audio(path)
    if bits == 32:
        with open(path, "rb") as f:
            blob = f.read()
        start = blob.index(b"data") + 8
        c = np.frombuffer(blob[start:start + 4 * y.size], "<i4").reshape(-1, y.shape[0]).T
        return c.astype(np.int64), rate
    return np.round(np.asarray(y, np.float64) * (1 << (bits - 1))).astype(np.int64), rate


def _inputs(tmp_path, files) -> list[str]:
    (tmp_path / "in").mkdir()
    paths = []
    for name, x, bits in files:
        p = str(tmp_path / "in" / name)
        write_wav(p, x, 44100, bits=bits)
        paths.append(p)
    return paths


def _run(pkg: str, kw: dict, paths: list[str], out_dir: str):
    sched, _, _, extra = PACKAGES[pkg]
    cfg = _config(pkg, kw, out_dir)
    res = sched.BatchProcessor(cfg, **extra).run(paths)
    outs = sorted(f for f in os.listdir(out_dir) if f.endswith((".wav", ".aiff")))
    return cfg, res, outs


def _bound(jc: np.ndarray, bits: int) -> np.ndarray:
    """Per code: (2 + 4|y|) LSB at 24-bit resolution, |y| the level (1 at
    full scale), i.e. 2 LSB plus 2^-21 of the 24-bit code."""
    unit = 1 << max(0, bits - 24)
    return unit * (2 + 4 * np.abs(jc) / float(1 << (bits - 1)))


def check_trial(tmp_path, seed: int) -> None:
    """One trial through both packages, held as the module says."""
    files, kw = draw_trial(seed)
    paths = _inputs(tmp_path, files)
    sk.launches = 0
    runs = {pkg: _run(pkg, kw, paths, str(tmp_path / pkg)) for pkg in PACKAGES}
    (_, jres, jouts), (cfg, tres, touts) = runs["jax"], runs["torch"]
    for res in (jres, tres):
        assert res.failed == 0 and res.completed == len(paths), (seed, kw, res.failed)
    assert touts == jouts and len(touts) == len(paths), (touts, jouts)
    assert sk.launches == 0          # the CPU path runs the kernel's twin
    for p in paths:
        streamed = kw["oversized"] and p.endswith("big.wav")
        assert (tres.per_file[p].get("streamed") is True) == streamed, p
        assert (jres.per_file[p].get("streamed") is True) == streamed, p
    unit = 1 << max(0, cfg.bits - 24)
    for f in touts:
        tc, t_rate = _codes(str(tmp_path / "torch" / f), cfg.bits)
        jc, j_rate = _codes(str(tmp_path / "jax" / f), cfg.bits)
        assert t_rate == j_rate == cfg.target_rate
        assert tc.shape == jc.shape and tc.shape[1] > 0, (f, tc.shape, jc.shape)
        diff = np.abs(tc - jc)
        assert (diff <= _bound(jc, cfg.bits)).all(), (seed, f, int(diff.max()), kw)
        quiet = np.abs(jc) < (1 << (cfg.bits - 3))         # below -12 dBFS
        assert not quiet.any() or diff[quiet].max() <= 2 * unit, (seed, f, kw)


@pytest.mark.parametrize("seed", BATCH_SEEDS[:6])
def test_random_config_matches_jax(tmp_path, seed):
    check_trial(tmp_path, seed)


def test_batch_draws_cover_every_feature():
    """The 24 seeds draw every value of each feature, both ways where it is a
    flag, and the oversized file (the scheduler's streaming route)."""
    seen: dict[str, set] = {}
    for seed in BATCH_SEEDS:
        _, kw = draw_trial(seed)
        for key in ("dither", "remove_dc", "target_rate", "bits", "output_format",
                    "device_layout", "chain", "oversized"):
            seen.setdefault(key, set()).add(kw.get(key))
        seen.setdefault("reverb", set()).add(kw.get("tail_mode"))
        seen.setdefault("fan-out", set()).add(kw.get("output_channels"))
        seen.setdefault("normalize", set()).add(
            None if kw.get("normalize_lufs") is None else kw.get("normalize_tp_db", "no tp"))
    want = {"dither": {True, False}, "remove_dc": {True, False},
            "target_rate": {44100, 48000, 32000, 44056}, "bits": {16, 24, 32},
            "output_format": {"wav", "aiff"}, "device_layout": {"packed", "rows"},
            "chain": {True, False}, "oversized": {True, False},
            "reverb": {None, "peak", "rms"}, "fan-out": {None, 2},
            "normalize": {None, -1.0, "no tp"}}
    assert seen == want, {k: (seen[k], want[k]) for k in want if seen[k] != want[k]}
    jax_seeds = [draw_trial(s)[1] for s in BATCH_SEEDS[:8]]
    assert not any(kw["dither"] or kw["target_rate"] == 32000 or kw["oversized"]
                   for kw in jax_seeds)
