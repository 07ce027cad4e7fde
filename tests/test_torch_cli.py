"""The port's CLI subcommands beside `process` and `stream` against the JAX
CLI, on the CPU (``--device cpu``): `preview`, `measure`, `selftest`,
`devices`, `watch`, `verify`, the config file, `--log-jsonl`,
`--keep-metadata`, `--require-rate`, `--profile`, `--version`, and the
options that still exit 2.

Each case runs both CLIs on the same files and compares exit codes and
what they print (item tables, latencies, verdicts, audit counts); outputs
within 2 LSB at 24 bits where both write audio.  Watch runs take an
``--interval`` of at most 0.2 s and a finite ``--sweeps`` or
``--exit-after-idle``."""

import json
import os
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu import cli as jcli  # noqa: E402
from f9tpu.io import read_wav, write_wav  # noqa: E402
from f9tpu_torch import cli  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    # the suite runs files in parallel processes; see tests/test_torch_stream.py
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def make_files(tmp_path, n=2, rate=44100):
    """`tests/test_cli.py`'s inputs: 0.1 s stereo 300 Hz tones."""
    paths = []
    for i in range(n):
        t = np.arange(int(rate * 0.1)) / rate
        x = (0.3 * np.sin(2 * np.pi * 300 * t)).astype(np.float32)
        p = str(tmp_path / f"f{i}.wav")
        write_wav(p, np.stack([x, x]), rate, bits=24)
        paths.append(p)
    return paths


def _noise(path, ch, n, rate=44100, seed=0, level=0.2):
    x = (level * np.random.default_rng(seed).standard_normal((ch, n))).astype(np.float32)
    write_wav(path, x, rate, bits=24)
    return path


def _run(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def _both(tmp_path, capsys, argv, port_extra=CPU, sub=None):
    """(JAX rc/out/err, port rc/out/err) of one subcommand, each writing
    under its own ``sub`` folder of ``tmp_path`` where ``{out}`` appears."""
    res = {}
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, port_extra)):
        d = str(tmp_path / f"{name}{sub or ''}")
        os.makedirs(d, exist_ok=True)
        res[name] = _run(main, [a.replace("{out}", d) for a in argv] + extra, capsys)
    return res["jax"], res["port"]


def _codes(path):
    y, rate = read_wav(path)
    return np.round(np.asarray(y, np.float64) * (1 << 23)).astype(np.int64), rate


# ----------------------------------------------------------------- preview

@pytest.mark.parametrize("flags", [
    ["--rate", "44100", "--silence-ms", "100"],
    ["--rate", "48000", "--channels", "6", "--target-channels", "4,5", "--monitor",
     "--monitor-channels", "0,1"],
    ["--rate", "48000", "--channels", "2", "--monitor", "--monitor-out", "{out}/mon.wav"],
], ids=["plain", "bus_monitor", "monitor_out"])
def test_cli_preview_matches_jax(tmp_path, capsys, flags):
    paths = make_files(tmp_path, 2)
    j, t = _both(tmp_path, capsys, ["preview", *paths, "--out", "{out}/p.wav", *flags])
    assert j[0] == t[0] == 0
    # the same item table (start frames and counts), the port's paths aside
    assert t[1].replace(str(tmp_path / "port"), "") == j[1].replace(str(tmp_path / "jax"), "")
    for f in ("p.wav",) + (("mon.wav",) if "--monitor-out" in flags else ()):
        jc, jr = _codes(str(tmp_path / "jax" / f))
        tc, tr = _codes(str(tmp_path / "port" / f))
        assert jr == tr and jc.shape == tc.shape and np.abs(jc - tc).max() <= 2, f
    if "--target-channels" in flags:
        y, _ = read_wav(str(tmp_path / "port" / "p.wav"))
        assert np.abs(y[0]).max() > 0 and np.abs(y[4]).max() > 0
        assert np.abs(y[2]).max() == 0 and np.abs(y[3]).max() == 0


def test_cli_preview_stream_flag_gives_the_same_file(tmp_path, capsys):
    """`preview --stream` writes the in-memory form's file byte for byte,
    main and monitor, on a mixed-rate list with the mixdown on the bus."""
    paths = make_files(tmp_path, 2)
    paths.append(_noise(str(tmp_path / "hi.wav"), 1, 9600, rate=96000, seed=3, level=0.1))
    common = ["--rate", "48000", "--channels", "8", "--target-channels", "2,3",
              "--monitor", "--silence-ms", "30", *CPU]
    assert cli.main(["preview", *paths, "--out", str(tmp_path / "m.wav"),
                     "--monitor-out", str(tmp_path / "mm.wav"), *common]) == 0
    assert cli.main(["preview", *paths, "--out", str(tmp_path / "s.wav"),
                     "--monitor-out", str(tmp_path / "sm.wav"), *common, "--stream"]) == 0
    assert "(streamed)" in capsys.readouterr().out
    for a, b in (("m.wav", "s.wav"), ("mm.wav", "sm.wav")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()


def test_cli_preview_auto_routes_to_the_streaming_renderer(tmp_path, capsys, monkeypatch):
    """Past the in-memory budget the CLI streams and says so (the budget is
    the JAX CLI's 512 MB; here one looped item is made to project past it)."""
    from f9tpu_torch.pipeline import preview as tpv

    paths = make_files(tmp_path, 1)
    monkeypatch.setattr(tpv, "projected_frames", lambda *a, **k: 1 << 27)
    rc, out, err = _run(cli.main, ["preview", *paths, "--out", str(tmp_path / "a.wav"),
                                   "--loops", "3", *CPU], capsys)
    assert rc == 0 and "(streamed)" in out and "in-memory budget" in err


@pytest.mark.parametrize("flags", [["--target-channels", "4,x"],
                                   ["--channels", "2", "--target-channels", "0,0"],
                                   ["--monitor", "--monitor-channels", "0"]])
def test_cli_preview_bad_channels_exit_2_as_jax(tmp_path, capsys, flags):
    src = _noise(str(tmp_path / "q.wav"), 1, 2000, rate=48000)
    j, t = _both(tmp_path, capsys, ["preview", src, "--out", "{out}/o.wav", "--rate",
                                    "48000", *flags])
    assert j[0] == t[0] == 2 and "error" in t[2]


# ------------------------------------------------- measure, selftest, devices

@pytest.mark.parametrize("flags, latency", [
    (["--quality", "low"], 0),
    (["--quality", "low", "--chain-delay-ms", "10"], 480),
    (["--chain-eq", "lowpass:4000", "--chain-limit=-0.3"], None),
])
def test_cli_measure_matches_jax(tmp_path, capsys, flags, latency):
    j, t = _both(tmp_path, capsys, ["measure", "--rate-in", "44100", "--rate", "48000",
                                    *flags])
    assert j[0] == t[0] == 0

    def lat(out):
        return int(out.split("latency ")[1].split(" frames")[0])

    assert lat(t[1]) == lat(j[1])
    if latency is not None:
        assert f"latency {latency} frames" in t[1]
    assert ("SRC+chain" in t[1]) == ("SRC+chain" in j[1]) == ("--chain" in " ".join(flags))


@pytest.mark.parametrize("flags", [
    ["--rate-in", "48000", "--rate", "44100", "--quality", "low"],
    ["--rate-in", "44100", "--rate", "48000", "--quality", "low", "--parity"],
    ["--rate-in", "44100", "--rate", "48000", "--parity"],
])
def test_cli_selftest_matches_jax(tmp_path, capsys, flags):
    j, t = _both(tmp_path, capsys, ["selftest", *flags])
    assert j[0] == t[0] == 0
    assert t[1].split(":")[0] == j[1].split(":")[0] == "loop_detected"
    if "--parity" in flags:
        assert "parity:" in t[1] and "[OK]" in t[1]
        db = float(t[1].split("parity: ")[1].split(" dB")[0])
        assert db <= -120.0


def test_cli_selftest_parity_fails_when_the_src_is_wrong(capsys, monkeypatch):
    """The exit code follows the verdict: a resampler 1e-4 off fails."""
    from f9tpu_torch.ops import resample as tres

    real = tres.resample_rates
    monkeypatch.setattr(tres, "resample_rates", lambda *a, **k: real(*a, **k) * 1.0001)
    rc, out, _ = _run(cli.main, ["selftest", "--rate-in", "44100", "--rate", "48000",
                                 "--quality", "low", "--parity", *CPU], capsys)
    assert rc == 1 and "FAIL" in out


def test_cli_devices(capsys):
    """`--device cpu` lists the CPU and exits 0, as the JAX CLI does on a
    machine without an accelerator; with no GPU the default exits 1 with one
    line on stderr, never a traceback and never the CPU's listing."""
    j = _run(jcli.main, ["devices"], capsys)
    t = _run(cli.main, ["devices", *CPU], capsys)
    assert j[0] == t[0] == 0
    assert "device(s)" in t[1] and "device(s)" in j[1] and t[1].startswith("[0] cpu")
    if torch.cuda.is_available():
        rc, out, _ = _run(cli.main, ["devices"], capsys)
        assert rc == 0 and f"{torch.cuda.device_count()} device(s)" in out
    else:
        rc, out, err = _run(cli.main, ["devices"], capsys)
        assert rc == 1 and out == "" and "no CUDA GPU" in err


@pytest.mark.parametrize("argv", [["selftest"], ["measure"], ["preview", "X", "--out", "o.wav"],
                                  ["watch", "D", "--out", "O", "--sweeps", "1"]])
def test_cli_without_a_gpu_exits_1_without_the_cpu(tmp_path, capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    if argv[0] == "preview":
        argv = ["preview", make_files(tmp_path, 1)[0], "--out", str(tmp_path / "o.wav")]
    if argv[0] == "watch":
        (tmp_path / "d").mkdir()
        argv = ["watch", str(tmp_path / "d"), "--out", str(tmp_path / "o"), "--sweeps", "1"]
    rc, out, err = _run(cli.main, argv, capsys)
    assert rc == 1 and "no CUDA GPU" in err and "Traceback" not in err
    assert not (tmp_path / "o.wav").exists()


# ------------------------------------------------------------- config file

def test_cli_config_roundtrip(tmp_path, capsys):
    make_files(tmp_path, 1)
    cfgp = str(tmp_path / "settings.json")
    assert cli.main(["process", str(tmp_path), "--out", str(tmp_path / "out"), "--rate",
                     "48000", "--quality", "low", "--save-config", cfgp, *CPU]) == 0
    saved = json.load(open(cfgp))
    assert saved["rate"] == 48000 and saved["quality"] == "low"
    assert set(saved) == set(jcli._CONFIG_KEYS) == set(cli._CONFIG_KEYS)
    with open(cfgp, "w") as f:
        json.dump({"quality": "medium"}, f)
    resolved = str(tmp_path / "resolved.json")
    assert cli.main(["process", str(tmp_path), "--out", str(tmp_path / "o2"), "--rate",
                     "48000", "--config", cfgp, "--save-config", resolved, *CPU]) == 0
    assert json.load(open(resolved))["quality"] == "medium"


def test_cli_config_files_are_shared_with_jax(tmp_path, capsys):
    """A file either CLI saves, the other loads to the same resolved
    settings; the flag on the command line wins over the file."""
    make_files(tmp_path, 1)
    flags = ["--rate", "48000", "--quality", "low", "--chain-eq", "lowpass:4000",
             "--chain-comp=-18:3", "--bits", "16", "--seed", "7"]
    cj, ct = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    assert jcli.main(["process", str(tmp_path), "--out", str(tmp_path / "oj"), *flags,
                      "--save-config", cj]) == 0
    assert cli.main(["process", str(tmp_path), "--out", str(tmp_path / "ot"), *flags,
                     "--save-config", ct, *CPU]) == 0
    assert open(cj).read() == open(ct).read()
    rj, rt = str(tmp_path / "rj.json"), str(tmp_path / "rt.json")
    assert cli.main(["process", str(tmp_path), "--out", str(tmp_path / "o3"), "--config",
                     cj, "--rate", "44100", "--save-config", rt, *CPU]) == 0
    assert jcli.main(["process", str(tmp_path), "--out", str(tmp_path / "o4"), "--config",
                      ct, "--rate", "44100", "--save-config", rj]) == 0
    assert json.load(open(rt)) == json.load(open(rj))
    assert json.load(open(rt))["rate"] == 44100 and json.load(open(rt))["bits"] == 16


def test_cli_save_then_config_gives_the_same_bytes(tmp_path, capsys):
    paths = make_files(tmp_path, 2)
    cfgp = str(tmp_path / "c.json")
    assert cli.main(["process", *paths, "--out", str(tmp_path / "a"), "--rate", "48000",
                     "--quality", "medium", "--gain", "-3", "--seed", "9",
                     "--save-config", cfgp, *CPU]) == 0
    assert cli.main(["process", *paths, "--out", str(tmp_path / "b"), "--config", cfgp,
                     *CPU]) == 0
    for i in range(2):
        assert ((tmp_path / "a" / f"f{i}_processed.wav").read_bytes()
                == (tmp_path / "b" / f"f{i}_processed.wav").read_bytes())


def test_cli_missing_config_file_clean(tmp_path, capsys):
    src = _noise(str(tmp_path / "c.wav"), 1, 1000)
    for main in (jcli.main, cli.main):
        with pytest.raises(SystemExit) as ei:
            main(["process", src, "--out", str(tmp_path / "o"), "--config",
                  str(tmp_path / "missing.json")])
        assert ei.value.code == 2
        assert "cannot load --config" in capsys.readouterr().err


# --------------------------------------------------- process's other options

def test_cli_process_log_jsonl(tmp_path, capsys):
    paths = make_files(tmp_path, n=1)
    jl = str(tmp_path / "events.jsonl")
    assert cli.main(["process", *paths, "--out", str(tmp_path / "out"), "--rate", "48000",
                     "--quality", "low", "--seed", "1", "--log-jsonl", jl, "--json",
                     *CPU]) == 0
    assert json.loads(capsys.readouterr().out)["completed"] == 1
    events = [json.loads(ln) for ln in open(jl)]
    assert any("Batch start" in e["msg"] for e in events)
    assert any("Completed" in e["msg"] for e in events)
    assert all("ts" in e for e in events)


def test_cli_process_require_rate_and_keep_metadata_match_jax(tmp_path, capsys):
    """Strict rate: the 48 k file is refused with the JAX CLI's status and
    exit code; --keep-metadata carries a WAV's LIST chunk as JAX does."""
    from f9tpu_torch.io import wav as twav

    good = _noise(str(tmp_path / "good.wav"), 2, 4000, seed=1)
    bad = _noise(str(tmp_path / "bad.wav"), 1, 4000, rate=48000, seed=2)
    j, t = _both(tmp_path, capsys, ["process", good, bad, "--out", "{out}", "--rate",
                                    "48000", "--quality", "low", "--require-rate", "44100",
                                    "--keep-metadata", "--resume", "--json"])
    assert j[0] == t[0] == 1
    js, ts = json.loads(j[1]), json.loads(t[1])
    assert ts["invalid_sample_rate"] == js["invalid_sample_rate"] == 1
    assert ts["completed"] == js["completed"] == 1
    for name in ("jax", "port"):
        rows = {r["path"]: r["status"] for r in
                json.load(open(tmp_path / name / ".manifest.json"))["files"]}
        assert rows == {good: "completed", bad: "invalid_sample_rate"}
    assert hasattr(twav, "read_wav")


def test_cli_process_profile_writes_a_trace(tmp_path, capsys):
    paths = make_files(tmp_path, 1)
    prof = str(tmp_path / "prof")
    rc, out, _ = _run(cli.main, ["process", *paths, "--out", str(tmp_path / "o"), "--rate",
                                 "48000", "--quality", "low", "--profile", prof, *CPU], capsys)
    assert rc == 0 and "profiler trace" in out
    trace = json.load(open(os.path.join(prof, "trace.json")))
    assert trace["traceEvents"]
    # the batch path's named spans (f9tpu_torch/spans.py) are in it
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"f9.graph", "f9.link.upload", "f9.front_end", "f9.src", "f9.epilogue",
            "f9.tail_floor", "f9.link.download"} <= names


@pytest.mark.parametrize("flags, item", [
    (["--device-layout", "rows"], "rows layout"),
    (["--files-shards", "2"], "Multi-device"),
    (["--channel-shards", "4"], "Multi-device"),
])
def test_cli_unported_process_options_exit_2(tmp_path, capsys, flags, item):
    """``--device-layout rows`` and the multi-device options exited 2
    naming their ROADMAP items; they now run (the multi-device options on a
    CPU mesh of that many shards), each file's bytes those of the packed,
    one-device run."""
    paths = make_files(tmp_path, 2)
    for sub in (["process", *paths], ["watch", str(tmp_path)]):
        # a watched file is taken once its size held over two sweeps
        extra = ["--sweeps", "2", "--interval", "0.05"] if sub[0] == "watch" else []
        out = str(tmp_path / f"o_{sub[0]}")
        rc, _, err = _run(cli.main, [*sub, "--out", out, "--quality", "low", *flags, *extra,
                                     *CPU], capsys)
        one = str(tmp_path / f"one_{sub[0]}")
        assert rc == 0, (sub[0], err)
        assert _run(cli.main, [*sub, "--out", one, "--quality", "low", *extra, *CPU],
                    capsys)[0] == 0
        for p in paths:
            stem = os.path.splitext(os.path.basename(p))[0]
            with open(os.path.join(out, f"{stem}_processed.wav"), "rb") as a, \
                    open(os.path.join(one, f"{stem}_processed.wav"), "rb") as b:
                assert a.read() == b.read(), (sub[0], p)


def test_cli_device_layout_packed_and_version(tmp_path, capsys):
    paths = make_files(tmp_path, 1)
    assert cli.main(["process", *paths, "--out", str(tmp_path / "o"), "--quality", "low",
                     "--device-layout", "packed", *CPU]) == 0
    capsys.readouterr()
    for main, prog in ((cli.main, "f9tpu-torch"), (jcli.main, "f9tpu")):
        with pytest.raises(SystemExit) as ei:
            main(["--version"])
        assert ei.value.code == 0
        assert capsys.readouterr().out.strip() == f"{prog} 0.3.0"


# ------------------------------------------------------------------- verify

def test_cli_verify_matches_jax_and_reads_its_manifests(tmp_path, capsys):
    """Each CLI verifies the other's `process --resume` manifest: all ok,
    exit 0; after one output byte flips, exit 1 and crc_mismatch; a
    deleted output is missing."""
    paths = make_files(tmp_path, 2)
    for name, main, extra in (("jax", jcli.main, []), ("port", cli.main, CPU)):
        assert main(["process", *paths, "--out", str(tmp_path / name), "--rate", "48000",
                     "--quality", "low", "--resume", *extra]) == 0
    capsys.readouterr()
    for maker in ("jax", "port"):
        man = str(tmp_path / maker / ".manifest.json")
        j, t = _run(jcli.main, ["verify", man, "--json"], capsys), \
            _run(cli.main, ["verify", man, "--json"], capsys)
        assert j[0] == t[0] == 0 and json.loads(j[1]) == json.loads(t[1])
        assert json.loads(t[1])["counts"]["ok"] == 2
    out0 = tmp_path / "port" / "f0_processed.wav"
    blob = bytearray(out0.read_bytes())
    blob[-10] ^= 0x01
    out0.write_bytes(bytes(blob))
    (tmp_path / "port" / "f1_processed.wav").unlink()
    man = str(tmp_path / "port" / ".manifest.json")
    j, t = _run(jcli.main, ["verify", man], capsys), _run(cli.main, ["verify", man], capsys)
    assert j[0] == t[0] == 1 and j[1] == t[1]
    assert "CRC_MISMATCH" in t[1] and "MISSING" in t[1]
    rc, out, _ = _run(cli.main, ["verify", man, "--json"], capsys)
    assert {r["status"] for r in json.loads(out)["files"]} == {"crc_mismatch", "missing"}


def test_cli_verify_missing_manifest_clean(tmp_path, capsys):
    rc, _, err = _run(cli.main, ["verify", str(tmp_path / "nope.json")], capsys)
    assert rc == 2 and "cannot load manifest" in err


# -------------------------------------------------------------------- watch

WATCH = ["--rate", "48000", "--quality", "low", "--seed", "1"]


def test_cli_watch_processes_landing_files(tmp_path, capsys):
    """Files landing in the folder are taken once stable, processed once,
    recorded in the manifest with hashes; the outputs are within 2 LSB of
    the JAX daemon's on the same drop."""
    indir = tmp_path / "drop"
    indir.mkdir()
    _noise(str(indir / "first.wav"), 2, 4000, seed=0)

    def land_later():
        time.sleep(0.25)
        _noise(str(indir / "second.wav"), 1, 3000, seed=1)

    t = threading.Thread(target=land_later, daemon=True)
    t.start()
    rc, out, _ = _run(cli.main, ["watch", str(indir), "--out", str(tmp_path / "out"), *WATCH,
                                 "--interval", "0.1", "--sweeps", "30", *CPU], capsys)
    t.join()
    assert rc == 0 and out.count("Completed") == 2
    assert jcli.main(["watch", str(indir), "--out", str(tmp_path / "jout"), *WATCH,
                      "--interval", "0.05", "--sweeps", "3"]) == 0
    for n in ("first", "second"):
        tc, tr = _codes(str(tmp_path / "out" / f"{n}_processed.wav"))
        jc, jr = _codes(str(tmp_path / "jout" / f"{n}_processed.wav"))
        assert tr == jr == 48000 and tc.shape == jc.shape and np.abs(tc - jc).max() <= 2
    saved = json.load(open(tmp_path / "out" / ".manifest.json"))
    assert all(r["status"] == "completed" and r["output_crc32"] for r in saved["files"])
    assert cli.main(["verify", str(tmp_path / "out" / ".manifest.json")]) == 0


def test_cli_watch_exits_after_idle(tmp_path):
    (tmp_path / "empty").mkdir()
    assert cli.main(["watch", str(tmp_path / "empty"), "--out", str(tmp_path / "out"),
                     *WATCH, "--interval", "0.05", "--exit-after-idle", "0.15", *CPU]) == 0


def test_cli_watch_reprocesses_replaced_file(tmp_path):
    indir = tmp_path / "drop"
    indir.mkdir()
    p = _noise(str(indir / "take.wav"), 1, 3000, seed=1)

    def replace_later():
        time.sleep(0.4)
        write_wav(p, np.zeros((1, 3000), np.float32), 44100, bits=24)

    t = threading.Thread(target=replace_later, daemon=True)
    t.start()
    rc = cli.main(["watch", str(indir), "--out", str(tmp_path / "out"), *WATCH, "--no-dither",
                   "--interval", "0.1", "--sweeps", "30", *CPU])
    t.join()
    assert rc == 0
    y, _ = read_wav(str(tmp_path / "out" / "take_processed.wav"))
    assert np.all(y == 0.0)


def test_cli_watch_restart_reprocesses_replaced_and_skips_unchanged(tmp_path):
    indir = tmp_path / "drop"
    indir.mkdir()
    _noise(str(indir / "keep.wav"), 1, 3000, seed=3)
    swap = _noise(str(indir / "swap.wav"), 1, 3000, seed=4)
    argv = ["watch", str(indir), "--out", str(tmp_path / "out"), *WATCH, "--no-dither",
            "--interval", "0.05", "--sweeps", "4", *CPU]
    assert cli.main(argv) == 0
    out_keep = str(tmp_path / "out" / "keep_processed.wav")
    keep_mtime = os.stat(out_keep).st_mtime_ns
    assert not np.all(read_wav(str(tmp_path / "out" / "swap_processed.wav"))[0] == 0.0)
    write_wav(swap, np.zeros((1, 3000), np.float32), 44100, bits=24)
    assert cli.main(argv) == 0
    assert np.all(read_wav(str(tmp_path / "out" / "swap_processed.wav"))[0] == 0.0)
    assert os.stat(out_keep).st_mtime_ns == keep_mtime


def test_cli_watch_picks_up_aiff(tmp_path):
    from f9tpu.io.aiff import write_aiff

    indir = tmp_path / "drop"
    indir.mkdir()
    write_aiff(str(indir / "take.aiff"),
               (0.2 * np.random.default_rng(2).standard_normal((2, 3000))).astype(np.float32),
               44100, bits=24)
    assert cli.main(["watch", str(indir), "--out", str(tmp_path / "out"), *WATCH,
                     "--interval", "0.05", "--sweeps", "4", *CPU]) == 0
    y, r = read_wav(str(tmp_path / "out" / "take_processed.wav"))
    assert r == 48000 and y.shape[0] == 2


def test_cli_watch_full_batch_surface(tmp_path):
    """The chain, --require-rate and --keep-metadata reach the daemon's
    batches: the 48 k drop is refused, the good one differs from a
    chainless render."""
    indir = tmp_path / "drop"
    indir.mkdir()
    good = _noise(str(indir / "good.wav"), 1, 4000, seed=4)
    bad = _noise(str(indir / "bad.wav"), 1, 4000, rate=48000, seed=5)
    assert cli.main(["watch", str(indir), "--out", str(tmp_path / "out"), *WATCH,
                     "--require-rate", "44100", "--chain-eq", "lowpass:4000",
                     "--keep-metadata", "--interval", "0.05", "--sweeps", "4", *CPU]) == 0
    outs = sorted(os.listdir(tmp_path / "out"))
    assert "good_processed.wav" in outs and "bad_processed.wav" not in outs
    by_path = {r["path"]: r for r in json.load(open(tmp_path / "out" / ".manifest.json"))["files"]}
    assert by_path[bad]["status"] == "invalid_sample_rate"
    assert by_path[good]["status"] == "completed"
    assert cli.main(["process", good, "--out", str(tmp_path / "plain"), *WATCH, *CPU]) == 0
    y_chain, _ = read_wav(str(tmp_path / "out" / "good_processed.wav"))
    y_plain, _ = read_wav(str(tmp_path / "plain" / "good_processed.wav"))
    assert y_chain.shape == y_plain.shape and not np.array_equal(y_chain, y_plain)


@pytest.mark.parametrize("case", ["out_is_dir", "invalid_config", "bad_interval"])
def test_cli_watch_startup_errors_match_jax(tmp_path, capsys, case):
    d = tmp_path / "drop"
    d.mkdir()
    out = {"out_is_dir": str(d)}.get(case, str(tmp_path / "out"))
    extra = {"invalid_config": ["--normalize-tp", "-1"],
             "bad_interval": ["--interval", "0"]}.get(case, ["--interval", "0.05"])
    argv = ["watch", str(d), "--out", out, *WATCH, "--sweeps", "1", *extra]
    j, t = _run(jcli.main, argv, capsys), _run(cli.main, argv + CPU, capsys)
    assert j[0] == t[0] == 2 and j[2] == t[2]


def test_cli_watch_survives_run_exception(tmp_path, capsys, monkeypatch):
    """A run that raises is logged with its error each sweep, and the
    daemon keeps sweeping."""
    d = tmp_path / "drop"
    d.mkdir()
    _noise(str(d / "x.wav"), 1, 3000, level=0.1)

    class Boom:
        def __init__(self, *a, **k):
            pass

        def run(self, *a, **k):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(cli, "BatchProcessor", Boom)
    rc, out, _ = _run(cli.main, ["watch", str(d), "--out", str(tmp_path / "out"), *WATCH,
                                 "--interval", "0.05", "--sweeps", "4", *CPU], capsys)
    assert rc == 0
    assert "FAILED: CUDA error: an illegal memory access" in out
    assert out.count("FAILED") >= 2


def test_cli_watch_growing_file_is_not_idle(tmp_path, capsys):
    d = tmp_path / "drop"
    d.mkdir()
    p = str(d / "grow.wav")
    x = (0.1 * np.random.default_rng(1).standard_normal((1, 3000))).astype(np.float32)
    calls = {"n": 0}
    real_sleep = time.sleep

    def mutating_sleep(s):
        calls["n"] += 1
        if calls["n"] <= 4:
            write_wav(p, x[:, :1000 + 400 * calls["n"]], 44100, bits=24)
        real_sleep(min(s, 0.01))

    write_wav(p, x[:, :1000], 44100, bits=24)
    orig = time.sleep
    time.sleep = mutating_sleep
    try:
        rc = cli.main(["watch", str(d), "--out", str(tmp_path / "out"), *WATCH,
                       "--interval", "0.2", "--exit-after-idle", "0.5", "--sweeps", "40", *CPU])
    finally:
        time.sleep = orig
    assert rc == 0
    assert "grow_processed.wav" in os.listdir(tmp_path / "out")
    assert "1 completed" in capsys.readouterr().out


def test_cli_watch_aborted_sweep_retries_files(tmp_path, capsys, monkeypatch):
    """A batch that fails on the device twice (the step and its one retry)
    aborts the run; the file is not remembered as done, and the next sweep
    completes it."""
    d = tmp_path / "drop"
    d.mkdir()
    _noise(str(d / "x.wav"), 2, 4000, level=0.1)
    real = tsched.process_batch_raw
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("CUDA error: unspecified launch failure")
        return real(*a, **k)

    monkeypatch.setattr(tsched, "process_batch_raw", flaky)
    rc, out, _ = _run(cli.main, ["watch", str(d), "--out", str(tmp_path / "out"), *WATCH,
                                 "--interval", "0.05", "--sweeps", "8", *CPU], capsys)
    assert rc == 0 and "ABORTED" in out and "unspecified launch failure" in out
    y, r = read_wav(str(tmp_path / "out" / "x_processed.wav"))
    assert r == 48000 and y.shape[1] > 0


def test_watch_log_jsonl(tmp_path):
    d = tmp_path / "inbox"
    d.mkdir()
    _noise(str(d / "w.wav"), 2, 3000, seed=7, level=0.3)
    jl = str(tmp_path / "watch_events.jsonl")
    common = [*WATCH, "--interval", "0.05", "--sweeps", "3", "--log-jsonl", jl, *CPU]
    assert cli.main(["watch", str(d), "--out", str(tmp_path / "o"), *common]) == 0
    events = [json.loads(ln) for ln in open(jl)]
    assert any("watch:" in e["msg"] for e in events)
    assert any("Completed" in e["msg"] for e in events)
    n_first = len(events)
    assert cli.main(["watch", str(d), "--out", str(tmp_path / "o"), *common]) == 0
    assert len([json.loads(ln) for ln in open(jl)]) > n_first


def test_watch_log_is_capped(tmp_path, monkeypatch):
    """The daemon's in-memory log keeps its last 1000 lines."""
    from f9tpu_torch.pipeline import logbook

    made = []
    real = logbook.StatusLog.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(logbook.StatusLog, "__init__", spy)
    (tmp_path / "e").mkdir()
    assert cli.main(["watch", str(tmp_path / "e"), "--out", str(tmp_path / "o"), *WATCH,
                     "--interval", "0.01", "--sweeps", "2", *CPU]) == 0
    assert made[0]._max_lines == 1000
