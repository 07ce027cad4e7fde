"""The port's multi-device path (`f9tpu_torch.parallel`) against its own
one-device path and against the JAX package's sharded path, on the CPU.

Each test is the counterpart of one in `tests/test_parallel.py` (named
after it), or covers what only the port has (`run_sharded`'s threads,
streams and collectives).  The JAX side runs on its 8-device virtual CPU
mesh (`tests/conftest.py`); the port runs on ``make_mesh(...,
devices=["cpu"] * 8)``: one process, one thread per shard, the collectives
reduced in shard order.  The same numpy inputs, made from a seed, go to
both.  Tolerances:

- port sharded against port unsharded: codes, ``out_frames``,
  ``tail_terminated``, ``peak_db`` and ``noise_floor_db`` bitwise (only
  ``pmax``, which is exact, feeds them); ``rms_db`` <= 1e-5 relative (a
  ``psum`` of shard partials adds in another order, JAX's own bound);
  stream and batch outputs sha256-equal; SRC floats bitwise (each output of
  the presliced form sums in one order wherever its chunk starts).
- port against JAX: SRC floats <= 2e-6 abs (the port sums in float64, JAX in
  float32, `tests/test_torch_stream.py`); codes <= 2 LSB at 24 bits (the
  JAX package's own bound between two SRC forms); at 16 bits with dither,
  where the SRC floats almost never move a code and a wrongly keyed noise
  would move about half of them, <= 0.1 % of samples differ and by at most
  1 LSB.  Stream inputs sit near -20 dBFS (`tests/test_torch_stream.py`).

Torch runs on one CPU thread per shard (`_one_thread`): the suite runs
files in parallel processes.
"""

import dataclasses
import hashlib
import os
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from f9tpu import cli as jcli  # noqa: E402
from f9tpu import parallel as jpar  # noqa: E402
from f9tpu.config import ProcessingConfig as JConfig  # noqa: E402
from f9tpu.io import wav  # noqa: E402
from f9tpu.ops import chain as jchain  # noqa: E402
from f9tpu.ops.resample import resample_rates as jresample_rates  # noqa: E402
from f9tpu.pipeline import BatchProcessor as JBatchProcessor  # noqa: E402
from f9tpu.pipeline import process_batch as jprocess_batch  # noqa: E402
from f9tpu.pipeline.stream import stream_resample_file as jstream_file  # noqa: E402
from f9tpu_torch import cli  # noqa: E402
from f9tpu_torch import parallel as tpar  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.device import NoDeviceError  # noqa: E402
from f9tpu_torch.models import design_cycle_bank, resample_oracle  # noqa: E402
from f9tpu_torch.ops import chain as tchain  # noqa: E402
from f9tpu_torch.ops.resample import resample_presliced, resample_rates  # noqa: E402
from f9tpu_torch.parallel import P, shard as tshard  # noqa: E402
from f9tpu_torch.pipeline import BatchProcessor, build_output_path  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402
from f9tpu_torch.pipeline.stream import stream_resample_file  # noqa: E402

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True)
def _one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tmesh(files=None, frames=1, channels=1):
    return tpar.make_mesh(files, frames, channels, devices=CPU8)


def _jmesh(files=None, frames=1, channels=1):
    return jpar.make_mesh(num_files_shards=files, num_frames_shards=frames,
                          num_channel_shards=channels)


def _max_lsb(a, b) -> int:
    """The largest difference of two code arrays of one shape."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a - b).max()) if a.size else 0


def _codes(path):
    y, rate = wav.read_wav(path)
    return np.round(np.asarray(y, np.float64) * (1 << 23)).astype(np.int64), rate


def _sha(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _cat(parts):
    """The per-shard results of `process_files_sharded` (graph results,
    files on dimension 0) as one, in file order."""
    return dataclasses.replace(parts[0], **{
        f.name: torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(parts[0])
        if isinstance(getattr(parts[0], f.name), torch.Tensor)})


def _check_metrics(got, ref, rms_rtol=1e-5):
    """Port sharded against port unsharded: all bitwise but the RMS."""
    for name in ("codes", "out_frames", "tail_terminated", "peak_db", "noise_floor_db"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    np.testing.assert_allclose(got.rms_db.numpy(), ref.rms_db.numpy(), rtol=rms_rtol)


# --------------------------------------------------------------- the mesh


def test_virtual_devices_present():
    """Eight CPU shards make the port's mesh of the JAX tests' eight virtual
    devices; with no device list the mesh is every CUDA card, once each,
    and without a card it raises instead of taking the CPU."""
    assert len(jax.devices()) == 8
    m = _tmesh()
    assert m.shape == {"files": 8, "frames": 1, "channels": 1}
    assert all(d.type == "cpu" for d in m.devices.flat)
    if torch.cuda.is_available():
        d = tpar.make_mesh().devices.ravel()
        assert len(set(d)) == len(d) == torch.cuda.device_count()
    else:
        with pytest.raises(NoDeviceError):
            tpar.make_mesh()


def test_make_mesh_shapes():
    for args in ((), (4, 2), (2, 2, 2), (1, 8), (2, 1, 4)):
        assert _tmesh(*args).shape == dict(_jmesh(*args).shape)
    with pytest.raises(ValueError) as te:
        _tmesh(3)
    with pytest.raises(ValueError) as je:
        _jmesh(3)
    assert str(te.value) == str(je.value) == "mesh 3x1x1 != 8 devices"
    # one device named several times: one card rehearsing a 4-card mesh
    assert tpar.make_mesh(4, devices=["cpu"] * 4).shape["files"] == 4
    assert tpar.files_sharding(_tmesh()).spec == P("files", None, None)
    assert tuple(tpar.files_sharding(_tmesh()).spec) == tuple(jpar.files_sharding(_jmesh()).spec)


def test_multislice_mesh_keeps_collectives_on_ici():
    """frames x channels blocks never straddle a slice (on cards: a node);
    the same grid as JAX's, the same refusal, and the mesh runs."""
    slice_ids = [0, 0, 0, 0, 1, 1, 1, 1]
    devs = [torch.device("cpu")] * 8
    m = tpar.make_multislice_mesh(num_frames_shards=2, devices=devs, slice_ids=slice_ids)
    jm = jpar.make_multislice_mesh(num_frames_shards=2, devices=jax.devices(),
                                   slice_ids=slice_ids)
    assert m.shape == dict(jm.shape) == {"files": 4, "frames": 2, "channels": 1}
    # the device ids of JAX's grid, mapped to their slices, are the port's
    # blocks: blocks 0-1 in slice 0, 2-3 in slice 1
    sid = {d.id: s for d, s in zip(jax.devices(), slice_ids)}
    assert [sid[d.id] for d in np.asarray(jm.devices)[:, :, 0].ravel()] == [0, 0, 0, 0, 1, 1, 1, 1]
    for mk, kw in ((tpar.make_multislice_mesh, dict(devices=devs)),
                   (jpar.make_multislice_mesh, dict(devices=jax.devices()))):
        with pytest.raises(ValueError, match="DCN"):
            mk(num_frames_shards=3, slice_ids=slice_ids, **kw)
    bank = design_cycle_bank(44100, 48000, quality="low")
    T = 2 * bank.M * 16
    y = tpar.resample_frames_sharded(np.zeros(T, np.float32), 44100, 48000, m, quality="low")
    jy = jpar.resample_frames_sharded(jnp.zeros(T, jnp.float32), 44100, 48000, jm,
                                      quality="low")
    assert tuple(y.shape) == np.asarray(jy).shape == (T * bank.L // bank.M,)


# ------------------------------------------------------ run_sharded itself


def test_collectives_reduce_in_shard_order():
    """psum adds in shard order 0..n-1 whatever the threads' timing (a
    float32 sum whose value depends on the order), pmax is exact and
    ppermute shifts; 16 shards (more than the cores) with a shortened
    switch interval, 20 runs."""
    n = 16
    vals = np.float32([1e8, 1.0, -1e8, 3.0] * 4) * np.float32(1.0 + np.arange(n) / 7)
    want = np.float32(0)
    for v in vals:
        want = np.float32(want + v)
    mesh = tpar.make_mesh(1, 1, n, devices=["cpu"] * n)

    def fn(ctx, x):
        i = ctx.axis_index("channels")
        right = ctx.ppermute(x, "channels", [(j, j + 1) for j in range(n - 1)])
        return (ctx.psum(x, "channels").reshape(1), ctx.pmax(x, "channels").reshape(1),
                right.reshape(1), torch.tensor([i]))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(20):
            outs = tshard.run_sharded(mesh, fn, (torch.from_numpy(vals),), (P("channels"),),
                                      None, timeout=30.0)
            for i, (s, m, r, idx) in enumerate(outs):
                assert s.item() == want and m.item() == vals.max()
                assert r.item() == (vals[i - 1] if i else 0.0) and idx.item() == i
    finally:
        sys.setswitchinterval(old)


@pytest.mark.parametrize("op", ["ppermute", "psum"])
def test_a_shard_may_write_what_it_gave(monkeypatch, op):
    """Shard 0 writes in place, once the collective has returned, the
    tensor it gave to a ``ppermute`` (or the ``psum`` result it holds as
    the group's first shard) before shard 1 has taken its copy: shard 1
    still gets the values as they were given."""
    import threading

    written = threading.Event()
    take = tshard.ShardContext._take

    def late_take(self, item):
        if self.axis_index("frames") == 1:
            assert written.wait(5.0)
        return take(self, item)

    monkeypatch.setattr(tshard.ShardContext, "_take", late_take)
    mesh = tpar.make_mesh(1, 2, 1, devices=["cpu"] * 2)

    def fn(ctx, x):
        x = x.clone()
        if op == "ppermute":
            y = ctx.ppermute(x, "frames", [(0, 1)])
            held = x
        else:
            y = held = ctx.psum(x, "frames")
        if ctx.axis_index("frames") == 0:
            held.zero_()
            written.set()
        return y

    x = torch.arange(1.0, 5.0)
    y = tshard.run_sharded(mesh, fn, (x,), (P("frames"),), None, timeout=10.0)[1]
    assert torch.equal(y, x[:2] if op == "ppermute" else x[:2] + x[2:])


@pytest.mark.parametrize("fault", ["raises", "stalls"])
def test_run_sharded_fails_and_never_hangs(fault):
    """A shard that raises before a psum aborts the others at once, and the
    call raises its error; a shard that stalls past the timeout makes the
    others raise TimeoutError.  Every shard thread has ended."""
    mesh = tpar.make_mesh(1, 1, 4, devices=["cpu"] * 4)

    def fn(ctx, x):
        if ctx.axis_index("channels") == 2:
            if fault == "raises":
                raise KeyError("shard 2 failed")
            time.sleep(1.5)
        return ctx.psum(x, "channels")

    t0 = time.monotonic()
    with pytest.raises(KeyError if fault == "raises" else TimeoutError):
        tshard.run_sharded(mesh, fn, (torch.ones(4),), (P("channels"),), P(), timeout=0.3)
    took = time.monotonic() - t0
    assert took < (1.0 if fault == "raises" else 5.0), took
    # every shard has stopped and the mesh's threads are free: the next run
    # on it completes
    ok = tshard.run_sharded(mesh, lambda ctx, x: ctx.psum(x, "channels"), (torch.ones(4),),
                            (P("channels"),), P(), timeout=5.0)
    assert torch.equal(ok, torch.full((1,), 4.0))


# ------------------------------------------------------------ files axis


def test_files_dp_matches_single_device():
    """The graph under files sharding: bitwise the one-device graph (no
    cross-file math), and within 2 LSB of JAX's sharded graph."""
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal((8, 2, 4410))).astype(np.float32)
    valid = np.full(8, 4410, np.int32)
    seeds = np.zeros(8, np.int32)
    kw = dict(output_dir="/tmp/x", quality="low", dither=False, remove_dc=False)
    tcfg = TConfig(**kw)
    ref = tgraph.process_batch(x, valid, tcfg, 44100, seeds, device="cpu")
    got = _cat(tpar.process_files_sharded(
        _tmesh(), lambda a, v, s: tgraph.process_batch(a, v, tcfg, 44100, s, device=a.device),
        x, valid, seeds))
    _check_metrics(got, ref, rms_rtol=0)
    xs = jax.device_put(jnp.asarray(x), jpar.files_sharding(_jmesh()))
    jres = jprocess_batch(xs, valid, JConfig(**kw), 44100, jax.random.PRNGKey(0))
    assert np.array_equal(got.out_frames.numpy(), np.asarray(jres.out_frames))
    assert _max_lsb(got.codes.numpy(), np.asarray(jres.codes)) <= 2


def test_process_files_sharded_helper():
    x = np.ones((8, 1, 147 * 4), np.float32)
    y = torch.cat(tpar.process_files_sharded(
        _tmesh(), lambda a: resample_rates(a, 44100, 48000, quality="low"), x))
    jy = jpar.process_files_sharded(
        _jmesh(), lambda a: jresample_rates(a, 44100, 48000, quality="low"), x)
    assert tuple(y.shape) == np.asarray(jy).shape == (8, 1, 160 * 4)
    assert np.abs(y.numpy() - np.asarray(jy)).max() <= 2e-6
    parts = tpar.process_files_sharded(_tmesh(4, 2), lambda a: a * 2, x)
    assert len(parts) == 4 and all(tuple(p.shape) == (2, 1, 588) for p in parts)


def _write_takes(d, n, frames, seed, channels=2, bits=24, level=0.15):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i in range(n):
        x = (level * rng.standard_normal((channels, frames + i))).astype(np.float32)
        p = os.path.join(d, f"m{i}.wav")
        wav.write_wav(p, x, 44100, bits=bits)
        paths.append(p)
    return paths


def _job(cls, out, paths, mesh, **kw):
    cfg = (TConfig if cls is BatchProcessor else JConfig)(
        output_dir=out, target_rate=48000, quality="low", **{"batch_size": 8, **kw})
    extra = dict(device="cpu") if cls is BatchProcessor and mesh is None else {}
    proc = cls(cfg, mesh=mesh, **extra)
    res = proc.run(paths)
    return cfg, res, proc


@pytest.mark.parametrize("dither", [False, True], ids=["no_dither", "dither"])
def test_batch_processor_on_mesh(tmp_path, dither):
    """The scheduler on the files axis: each file's bytes equal the
    one-device job's; within 2 LSB of the JAX scheduler on its mesh, and
    <= -100 dB against the oracle (test_files_sharded_dither_bytes_match_
    unsharded is the dithered case)."""
    paths = _write_takes(str(tmp_path / "in"), 8, 4410, seed=50)
    kw = dict(dither=dither, remove_dc=False, seed=4)
    c1, r1, _ = _job(BatchProcessor, str(tmp_path / "one"), paths, None, **kw)
    c2, r2, _ = _job(BatchProcessor, str(tmp_path / "mesh"), paths, _tmesh(), **kw)
    c3, r3, _ = _job(JBatchProcessor, str(tmp_path / "jax"), paths, _jmesh(), **kw)
    assert r1.completed == r2.completed == r3.completed == 8
    for p in paths:
        a, b, j = (build_output_path(p, c.output_dir, c.postfix) for c in (c1, c2, c3))
        assert _sha(a) == _sha(b), p
        assert _max_lsb(_codes(b)[0], _codes(j)[0]) <= 2
        if not dither:
            src, _ = wav.read_wav(p)
            ref = resample_oracle(src[0], 44100, 48000, quality="low")
            y = _codes(b)[0][0] / (1 << 23)
            db = 20 * np.log10(np.sqrt(((y - ref) ** 2).mean()) / np.sqrt((ref ** 2).mean()))
            assert db < -100, db


def test_files_sharded_dither_bytes_match_unsharded(tmp_path):
    """Seeded dither: the bytes do not depend on the sharding (the noise is
    keyed by seed, channel and absolute frame, not by device)."""
    paths = _write_takes(str(tmp_path / "in"), 8, 3000, seed=51, level=0.2)
    outs = [_job(BatchProcessor, str(tmp_path / name), paths, mesh, seed=4, remove_dc=False)[0]
            for name, mesh in (("o1", None), ("o2", _tmesh()), ("o3", _tmesh(2, 1, 4)))]
    for p in paths:
        digests = {_sha(build_output_path(p, c.output_dir, c.postfix)) for c in outs}
        assert len(digests) == 1, p


def test_batch_processor_mesh_batch_size_check(tmp_path):
    with pytest.raises(ValueError, match="not divisible"):
        BatchProcessor(TConfig(output_dir=str(tmp_path), batch_size=6), mesh=_tmesh())
    with pytest.raises(ValueError, match="not divisible"):
        JBatchProcessor(JConfig(output_dir=str(tmp_path), batch_size=6), mesh=_jmesh())


def test_scheduler_mesh_with_oversized_file_streams_single_chip(tmp_path):
    """A file past the largest bucket streams on the processor's device
    while the rest ride the sharded batches; every byte equals the
    one-device job's, and JAX streams the same file."""
    rng = np.random.default_rng(23)
    paths = []
    for i in range(4):
        p = str(tmp_path / f"n{i}.wav")
        wav.write_wav(p, (0.2 * rng.standard_normal((2, 6_000))).astype(np.float32),
                      44100, bits=24)
        paths.append(p)
    big = str(tmp_path / "big.wav")
    wav.write_wav(big, (0.2 * rng.standard_normal((2, 90_000))).astype(np.float32),
                  44100, bits=24)
    paths.append(big)
    kw = dict(seed=4, bucket_frames=(8_192, 16_384))
    c1, r1, _ = _job(BatchProcessor, str(tmp_path / "one"), paths, None, **kw)
    c2, r2, _ = _job(BatchProcessor, str(tmp_path / "mesh"), paths, _tmesh(), **kw)
    _, r3, _ = _job(JBatchProcessor, str(tmp_path / "jax"), paths, _jmesh(), **kw)
    assert r2.completed == r3.completed == 5 and r2.failed == 0
    assert r2.per_file[big].get("streamed") is True and r3.per_file[big].get("streamed")
    for p in paths:
        assert (_sha(build_output_path(p, c1.output_dir, c1.postfix))
                == _sha(build_output_path(p, c2.output_dir, c2.postfix))), p


# --------------------------------------------------------- channels axis


def _bus(files, C, T, seed, level=0.3):
    rng = np.random.default_rng(seed)
    return (level * rng.standard_normal((files, C, T))).astype(np.float32)


_CP = {
    # the JAX tests' cases: mesh (files, channels), bus, config
    "matches_single_device": dict(mesh=(4, 2), bus=(4, 16, 4410, 1),
                                  valid=[4410, 3000, 4410, 100],
                                  cfg=dict(dither=False, remove_dc=True)),
    "bus_local_routing": dict(mesh=(4, 2), bus=(4, 16, 2205, 2),
                              cfg=dict(dither=False, channel_routing=[
                                  1, 0, 3, 2, -1, 5, 6, 7, 9, 8, 11, 10, -1, 13, 14, 15])),
    "dither_24bit": dict(mesh=(4, 2), bus=(4, 16, 2205, 3),
                         cfg=dict(dither=True, remove_dc=False)),
    "dither_16bit": dict(mesh=(4, 2), bus=(4, 16, 2205, 3),
                         cfg=dict(dither=True, remove_dc=False, bits=16)),
    "per_file_latency": dict(mesh=(4, 2), bus=(4, 4, 2205, 9), lat=[0, 100, 200, 300],
                             cfg=dict(dither=True, remove_dc=False)),
    "routing_dither_dc": dict(mesh=(2, 4), bus=(2, 8, 3000, 6),
                              cfg=dict(dither=True, remove_dc=True, seed=1,
                                       channel_routing=[1, 0, -1, 3, 5, 4, 7, -1])),
}


@pytest.mark.parametrize("case", list(_CP))
def test_channels_sharded_matches_single_device(case):
    """A bus over files x channels shards: bitwise the unsharded graph but
    the RMS (<= 1e-5); against JAX's channel-sharded graph <= 2 LSB at 24
    bits, and at 16 bits with dither <= 0.1 % of codes 1 LSB apart (the
    global channel keys the noise; a local one would move half)."""
    c = _CP[case]
    files, C, T, seed = c["bus"]
    x = _bus(files, C, T, seed)
    valid = np.asarray(c.get("valid", [T] * files), np.int32)
    seeds = np.arange(10, 10 + files, dtype=np.int32)
    lat = np.asarray(c["lat"], np.int32) if "lat" in c else 0
    kw = dict(output_dir="/tmp/x", quality="low", **c["cfg"])
    tcfg = TConfig(**kw)
    ref = tgraph.process_batch(x, valid, tcfg, 44100, seeds, device="cpu",
                               latency_frames=torch.from_numpy(np.asarray(lat)) if "lat" in c
                               else 0)
    got = tpar.process_batch_channels_sharded(
        x, valid, tcfg, 44100, seeds, _tmesh(*c["mesh"][:1], 1, c["mesh"][1]),
        latency_frames=torch.from_numpy(np.asarray(lat)) if "lat" in c else 0)
    _check_metrics(got, ref)
    jgot = jpar.process_batch_channels_sharded(
        x, valid, JConfig(**kw), 44100, seeds, _jmesh(c["mesh"][0], 1, c["mesh"][1]),
        latency_frames=jnp.asarray(lat) if "lat" in c else 0)
    assert np.array_equal(got.out_frames.numpy(), np.asarray(jgot.out_frames))
    diff = np.abs(got.codes.numpy().astype(np.int64) - np.asarray(jgot.codes, np.int64))
    if tcfg.bits == 16:
        assert diff.max() <= 1 and (diff != 0).mean() <= 1e-3, (diff.max(), (diff != 0).mean())
    else:
        assert diff.max() <= 2
    if tcfg.channel_routing is not None:
        silent = np.asarray(tcfg.channel_routing) < 0
        assert not got.codes.numpy()[:, silent].any()


def test_channels_sharded_reverb_tail_verdict_consistent():
    """Reverb mode: only channel 5 carries audio, on one shard; every shard
    reaches the same end frame (a pmax of the envelope), as the unsharded
    graph and JAX's sharded one do."""
    files, C, T = 2, 8, 4410
    x = np.zeros((files, C, T), np.float32)
    t = np.arange(T)
    x[:, 5, :] = (0.5 * np.sin(2 * np.pi * 440 * t / 44100) * np.exp(-t / 800)).astype(np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(files, dtype=np.int32)
    kw = dict(output_dir="/tmp/x", quality="low", dither=False, reverb_mode=True,
              noise_floor_db=-90.0)
    ref = tgraph.process_batch(x, valid, TConfig(**kw), 44100, seeds, device="cpu")
    got = tpar.process_batch_channels_sharded(x, valid, TConfig(**kw), 44100, seeds,
                                              _tmesh(2, 1, 4))
    _check_metrics(got, ref)
    jgot = jpar.process_batch_channels_sharded(x, valid, JConfig(**kw), 44100, seeds,
                                               _jmesh(2, 1, 4))
    assert np.array_equal(got.out_frames.numpy(), np.asarray(jgot.out_frames))
    assert np.array_equal(got.tail_terminated.numpy(), np.asarray(jgot.tail_terminated))
    assert _max_lsb(got.codes.numpy(), np.asarray(jgot.codes)) <= 2


def test_channels_sharded_with_chain():
    """Channel-local chain stages run on each shard (a FIR insert, as JAX's
    test, then a delay and an EQ)."""
    rng = np.random.default_rng(3)
    files, C, T = 4, 4, 2205
    x = _bus(files, C, T, 3)
    valid = np.full(files, T, np.int32)
    seeds = np.arange(files, dtype=np.int32)
    taps = rng.standard_normal(31).astype(np.float32) * 0.1
    taps[0] = 1.0
    for tch, jch in ((tchain.Chain(tchain.FIRInsert(taps)), jchain.Chain(jchain.FIRInsert(taps))),
                     (tchain.Chain(tchain.Delay(0.002), tchain.Biquad("peaking", 1000, 1, 3)),
                      jchain.Chain(jchain.Delay(0.002), jchain.Biquad("peaking", 1000, 1, 3)))):
        kw = dict(output_dir="/tmp/x", quality="low", dither=False)
        tcfg = TConfig(chain=tch, **kw)
        ref = tgraph.process_batch(x, valid, tcfg, 44100, seeds, device="cpu")
        got = tpar.process_batch_channels_sharded(x, valid, tcfg, 44100, seeds, _tmesh(4, 1, 2))
        _check_metrics(got, ref)
        jgot = jpar.process_batch_channels_sharded(x, valid, JConfig(chain=jch, **kw), 44100,
                                                   seeds, _jmesh(4, 1, 2))
        assert _max_lsb(got.codes.numpy(), np.asarray(jgot.codes)) <= 2


def test_channels_sharded_dither_decorrelated_and_reproducible():
    """The same local channel on two shards draws other noise, and reruns
    give the same codes."""
    files, C, T = 2, 8, 2205
    x = np.full((files, C, T), 0.5 / (1 << 23), np.float32)
    valid = np.full(files, T, np.int32)
    seeds = np.array([11, 22], np.int32)
    cfg = TConfig(output_dir="/tmp/x", quality="low", dither=True, remove_dc=False)
    mesh = _tmesh(2, 1, 4)
    a = tpar.process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh).codes.numpy()
    b = tpar.process_batch_channels_sharded(x, valid, cfg, 44100, seeds, mesh).codes.numpy()
    assert np.array_equal(a, b)
    n = int(0.9 * a.shape[-1])
    for f in range(files):
        assert not np.array_equal(a[f, 0, :n], a[f, 2, :n])
        assert not np.array_equal(a[f, 0, :n], a[f, 4, :n])


_REASONS = [
    (dict(), 6, (1, 1, 8), None),
    (dict(), 6, (4, 1, 2), None),
    (dict(channel_routing=[0, 1, 2]), 4, (4, 1, 2), None),
    (dict(channel_routing=[8] + list(range(1, 16))), 16, (4, 1, 2), None),
    (dict(output_channels=2), 4, (4, 1, 2), None),
    (dict(), 4, (4, 1, 2), "comp"),
    (dict(), 4, (4, 1, 2), "width"),
    (dict(), 4, (4, 1, 2), "stereo_ir"),
    (dict(), 4, (4, 1, 2), "mono_ir"),
]


@pytest.mark.parametrize("kw,channels,shape,chain", _REASONS)
def test_channels_shardable_reasons_match_jax(kw, channels, shape, chain):
    """`channels_shardable`'s verdict and reason, word for word JAX's."""
    ir = np.zeros((2, 64), np.float32)
    ir[:, 0] = 1.0
    stages = {"comp": ("Compressor", ()), "width": ("StereoWidth", (1.5,)),
              "stereo_ir": ("ConvolutionReverb", (ir,)),
              "mono_ir": ("ConvolutionReverb", (ir[:1],))}
    t_extra, j_extra = {}, {}
    if chain:
        name, args = stages[chain]
        t_extra["chain"] = tchain.Chain(getattr(tchain, name)(*args))
        j_extra["chain"] = jchain.Chain(getattr(jchain, name)(*args))
    got = tpar.channels_shardable(TConfig(output_dir="/tmp/x", **kw, **t_extra), channels,
                                  _tmesh(*shape))
    want = jpar.channels_shardable(JConfig(output_dir="/tmp/x", **kw, **j_extra), channels,
                                   _jmesh(*shape))
    assert got == want


def test_channels_sharded_rejects_channelless_mesh():
    x = np.zeros((8, 2, 441), np.float32)
    valid = np.full(8, 441, np.int32)
    seeds = np.arange(8, dtype=np.int32)
    with pytest.raises(ValueError, match="not channel-shardable: mesh has no channels axis"):
        tpar.process_batch_channels_sharded(x, valid, TConfig(output_dir="/tmp/x"), 44100,
                                            seeds, _tmesh())
    bad = TConfig(output_dir="/tmp/x", quality="low", channel_routing=[8] + list(range(1, 16)))
    with pytest.raises(ValueError, match="crosses channel shards"):
        tpar.process_batch_channels_sharded(np.zeros((4, 16, 441), np.float32),
                                            np.full(4, 441, np.int32), bad, 44100,
                                            np.arange(4, dtype=np.int32), _tmesh(4, 1, 2))


def test_scheduler_uses_channel_sharding(tmp_path, monkeypatch):
    """BatchProcessor on a files x channels mesh: a float bus goes through
    the channel-sharded graph, the raw-bytes path and a cross-shard routing
    map keep the files axis with their reasons logged, and every byte
    equals the one-device job's; the 24-bit bus is within 2 LSB of the JAX
    scheduler on its mesh (which also keeps the files axis for it)."""
    calls = []
    real = tpar.process_batch_channels_sharded

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tpar, "process_batch_channels_sharded", spy)
    bus24 = _write_takes(str(tmp_path / "in24"), 4, 2205, seed=4, channels=8, level=0.3)
    bus32 = _write_takes(str(tmp_path / "in32"), 4, 2205, seed=5, channels=8, bits=32,
                         level=0.3)
    for paths, routing, want_cp, reason in (
            (bus32, None, True, None),
            (bus24, None, False, "raw-bytes path has no channel axis"),
            (bus32, [4, 1, 2, 3, 0, 5, 6, 7], False,
             "Channel sharding unavailable: routing crosses channel shards")):
        calls.clear()
        kw = dict(dither=False, batch_size=4, channel_routing=routing)
        tag = f"{os.path.basename(os.path.dirname(paths[0]))}{routing is not None}"
        c1, r1, _ = _job(BatchProcessor, str(tmp_path / f"one{tag}"), paths, None, **kw)
        c2, r2, proc = _job(BatchProcessor, str(tmp_path / f"mesh{tag}"), paths,
                            _tmesh(4, 1, 2), **kw)
        assert r1.completed == r2.completed == 4 and r2.failed == 0
        assert bool(calls) == want_cp
        if reason:
            assert any(reason in line for line in proc.log.lines)
        for p in paths:
            assert (_sha(build_output_path(p, c1.output_dir, c1.postfix))
                    == _sha(build_output_path(p, c2.output_dir, c2.postfix)))
    c3, r3, _ = _job(JBatchProcessor, str(tmp_path / "jax"), bus24, _jmesh(4, 1, 2),
                     dither=False, batch_size=4)
    assert r3.completed == 4
    c2, _, _ = _job(BatchProcessor, str(tmp_path / "mesh24"), bus24, _tmesh(4, 1, 2),
                    dither=False, batch_size=4)
    for p in bus24:
        assert _max_lsb(_codes(build_output_path(p, c2.output_dir, c2.postfix))[0],
                        _codes(build_output_path(p, c3.output_dir, c3.postfix))[0]) <= 2


# ----------------------------------------------------------- frames axis


@pytest.mark.parametrize("rate_in,rate_out", [(44100, 48000), (96000, 44100), (44100, 44056)])
def test_frames_sp_matches_unsharded(rate_in, rate_out):
    """Overlap-save over 4 frames shards with ppermute halos: bitwise the
    unsharded presliced SRC of the zero-padded signal (a varispeed bank
    too), <= 2e-6 from JAX's sharded SRC."""
    bank = design_cycle_bank(rate_in, rate_out, quality="low")
    rng = np.random.default_rng(1)
    T = 40000 + tpar.required_frames_padding(40000, bank, 4)
    x = (0.3 * rng.standard_normal((T,))).astype(np.float32)
    y = tpar.resample_frames_sharded(x, rate_in, rate_out, _tmesh(2, 4), quality="low")
    hl, hr = tpar.shard_halos(bank)
    ref = resample_presliced(torch.from_numpy(np.pad(x, (hl, hr))), bank, T // bank.M)
    assert torch.equal(y, ref)
    jy = np.asarray(jpar.resample_frames_sharded(jnp.asarray(x), rate_in, rate_out,
                                                 _jmesh(2, 4), quality="low"))
    assert jy.shape == tuple(y.shape) and np.abs(y.numpy() - jy).max() <= 2e-6


def test_frames_sp_matches_oracle():
    bank = design_cycle_bank(44100, 48000, quality="low")
    rng = np.random.default_rng(2)
    x = (0.3 * rng.standard_normal((2 * bank.M * 100,))).astype(np.float32)
    y = tpar.resample_frames_sharded(x, 44100, 48000, _tmesh(4, 2), quality="low").numpy()
    ref = resample_oracle(x, 44100, 48000, quality="low")
    err = y[: len(ref)] - ref
    assert 20 * np.log10(np.sqrt((err ** 2).mean()) / np.sqrt((ref ** 2).mean())) < -120.0


def test_frames_sp_outer_halos_stand_for_the_file():
    """The outer halos a stream supplies: sharded with them == the presliced
    SRC of the haloed span; a halo of the wrong shape raises like JAX's."""
    bank = design_cycle_bank(44100, 48000, quality="low")
    hl, hr = tpar.shard_halos(bank)
    rng = np.random.default_rng(4)
    T = 4 * bank.M * 20
    x = (0.3 * rng.standard_normal((2, hl + T + hr))).astype(np.float32)
    y = tpar.resample_frames_sharded(x[:, hl:hl + T], 44100, 48000, _tmesh(2, 4),
                                     quality="low", left_halo=x[:, :hl],
                                     right_halo=x[:, hl + T:])
    assert torch.equal(y, resample_presliced(torch.from_numpy(x), bank, T // bank.M))
    for mod, arr, mesh in ((tpar, x[:, hl:hl + T], _tmesh(2, 4)),
                           (jpar, jnp.asarray(x[:, hl:hl + T]), _jmesh(2, 4))):
        with pytest.raises(ValueError, match="outer halos"):
            mod.resample_frames_sharded(arr, 44100, 48000, mesh, quality="low",
                                        left_halo=np.zeros((2, hl + 1), np.float32))


@pytest.mark.parametrize("case", ["misaligned", "tiny_chunks"])
def test_frames_sp_rejects(case):
    """A length off the shards x M grid, and chunks under the filter halo,
    raise the JAX package's errors."""
    if case == "misaligned":
        args, shape, match = (1001, 44100, 48000, "low"), (2, 4), "not a multiple"
    else:
        args, shape, match = (80, 44100, 88200, "ultra"), (1, 8), "halo"
    T, ri, ro, q = args
    with pytest.raises(ValueError, match=match) as te:
        tpar.resample_frames_sharded(np.zeros(T, np.float32), ri, ro, _tmesh(*shape), quality=q)
    with pytest.raises(ValueError, match=match) as je:
        jpar.resample_frames_sharded(jnp.zeros(T), ri, ro, _jmesh(*shape), quality=q)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("rate_in,rate_out,kw", [
    (44100, 88200, dict(quality="ultra")), (44100, 48000, dict(quality="low")),
    (44100, 8000, dict(kind="lagrange")), (44100, 44056, dict(quality="low"))])
def test_required_frames_padding_covers_halo(rate_in, rate_out, kw):
    """The halos and the padding rule are JAX's numbers; a padded input is
    one the sharded path takes (lagrange's right halo clamped at 0)."""
    from f9tpu.models.filters import design_cycle_bank as jbank

    bank = design_cycle_bank(rate_in, rate_out, **kw)
    jb = jbank(rate_in, rate_out, **kw)
    hl, hr = tpar.shard_halos(bank)
    assert (hl, hr) == jpar.shard_halos(jb) and hl >= 0 and hr >= 0
    for n in (2, 8):
        pad = tpar.required_frames_padding(80, bank, n)
        assert pad == jpar.required_frames_padding(80, jb, n)
        T = 80 + pad
        assert T % (n * bank.M) == 0 and T // n >= max(hl, hr)
    y = tpar.resample_frames_sharded(np.zeros(T, np.float32), rate_in, rate_out,
                                     _tmesh(1, 8), **kw)
    assert tuple(y.shape) == (T * bank.L // bank.M,)


# ----------------------------------------------------- the sharded stream


def _src(tmp_path, ch, seconds, seed, rate=44100, bits=24, level=0.1, dc=0.0, name="src"):
    rng = np.random.default_rng(seed)
    x = (level * rng.standard_normal((ch, int(seconds * rate))) + dc).astype(np.float32)
    p = str(tmp_path / f"{name}.wav")
    wav.write_wav(p, x, rate, bits=bits)
    return p, x


_STREAM = {
    # the JAX tests' three cases
    "matches_single_chip": dict(src=(2, 3.3, 5), mesh=(2, 4), chunk=0.25,
                                cfg=dict(dither=False, remove_dc=False)),
    "dc_and_dither": dict(src=(1, 1.7, 6, 48000), mesh=(4, 2), chunk=0.2, dc=0.05,
                          rate=44100, cfg=dict(dither=True, remove_dc=True, seed=5)),
    "routing_and_normalization": dict(src=(4, 2.2, 17), mesh=(2, 4), chunk=0.4,
                                      cfg=dict(seed=3, remove_dc=False,
                                               channel_routing=[3, -1, 0, 1],
                                               normalize_lufs=-20.0)),
}


@pytest.mark.parametrize("case", list(_STREAM))
def test_stream_sharded_matches_single_chip(tmp_path, case):
    """One file over frames shards: the same frame count and bytes as the
    one-device stream, within 2 LSB of JAX's sharded stream."""
    c = _STREAM[case]
    ch, seconds, seed = c["src"][:3]
    rate_in = c["src"][3] if len(c["src"]) > 3 else 44100
    src, x = _src(tmp_path, ch, seconds, seed, rate=rate_in, bits=32, dc=c.get("dc", 0.0))
    rate_out = c.get("rate", 48000)
    kw = dict(output_dir=str(tmp_path), target_rate=rate_out, quality="low", **c["cfg"])
    o1, o2, oj = (str(tmp_path / f"{n}.wav") for n in ("one", "mesh", "jax"))
    n1 = stream_resample_file(src, o1, TConfig(**kw), chunk_seconds=c["chunk"], device="cpu")
    n2 = stream_resample_file(src, o2, TConfig(**kw), chunk_seconds=c["chunk"],
                              mesh=_tmesh(*c["mesh"]))
    nj = jstream_file(src, oj, JConfig(**kw), chunk_seconds=c["chunk"], mesh=_jmesh(*c["mesh"]))
    assert n1 == n2 == nj
    assert _sha(o1) == _sha(o2)
    assert _max_lsb(_codes(o2)[0], _codes(oj)[0]) <= 2
    y, _ = wav.read_wav(o2)
    if kw.get("channel_routing"):
        assert not y[1].any()
    if case == "matches_single_chip":
        ref = resample_oracle(x.astype(np.float64), rate_in, rate_out, quality="low")
        err = np.sqrt(np.mean((y[:, :ref.shape[1]] - ref) ** 2))
        assert 20 * np.log10(err / np.sqrt(np.mean(ref ** 2))) <= -110
    if case == "dc_and_dither":
        assert abs(y.mean()) < 1e-3


@pytest.mark.parametrize("form", ["varispeed", "raw_wire", "fft_chain", "reverb_tail",
                                  "latency_16bit"])
def test_stream_sharded_forms_equal_one_device(tmp_path, form):
    """The sharded stream's other forms give the one-device stream's bytes:
    a varispeed bank's haloed chunks (the form of dense banks), container bytes
    decoded per shard, an FFT chain finished on one device, a reverb tail
    detected on the host, a trimmed latency at 16 bits."""
    ir = (0.04 * np.random.default_rng(8).standard_normal((1, 4800))
          * np.exp(-np.arange(4800) / 700.0)).astype(np.float32)
    cfgs = {
        "varispeed": dict(target_rate=44056, seed=3),
        "raw_wire": dict(seed=3, remove_dc=True, channel_routing=[1, -1]),
        "fft_chain": dict(seed=3, latency_frames=240, chain=tchain.Chain(
            tchain.Delay(0.005), tchain.ConvolutionReverb(ir, wet=0.8),
            tchain.Limiter(-0.3))),
        "reverb_tail": dict(seed=2, reverb_mode=True, chain=tchain.Chain(
            tchain.Delay(0.002), tchain.Biquad("peaking", 1000, 1, 3))),
        "latency_16bit": dict(seed=1, bits=16, latency_frames=-30),
    }
    src, _ = _src(tmp_path, 2, 2.5, 9, bits=24 if form == "raw_wire" else 32)
    kw = dict(output_dir=str(tmp_path), quality="low", **{"target_rate": 48000, **cfgs[form]})
    o1, o2 = str(tmp_path / "one.wav"), str(tmp_path / "mesh.wav")
    n1 = stream_resample_file(src, o1, TConfig(**kw), chunk_seconds=0.2, device="cpu")
    n2 = stream_resample_file(src, o2, TConfig(**kw), chunk_seconds=0.2,
                              mesh=tpar.make_mesh(1, 4, devices=["cpu"] * 4))
    assert n1 == n2 and _sha(o1) == _sha(o2)


# ------------------------------------------------------------------ the CLI


@pytest.mark.parametrize("sub,flags", [
    ("process", ["--files-shards", "8"]),
    ("process", ["--files-shards", "4", "--channel-shards", "2"]),
    ("watch", ["--files-shards", "2"]),
    ("stream", ["--frames-shards", "8"]),
], ids=["process_files", "process_files_channels", "watch_files", "stream_frames"])
def test_cli_shard_options_on_cpu(tmp_path, capsys, sub, flags):
    """The three shard options with ``--device cpu``: the one-device run's
    bytes, and within 2 LSB of the JAX CLI on its 8-device mesh (whose mesh
    must take all 8 devices)."""
    common = ["--quality", "low", "--rate", "48000", "--seed", "7"]
    paths = [] if sub == "stream" else _write_takes(str(tmp_path / "in"), 8, 3000, seed=12,
                                                    level=0.1)
    if sub == "stream":
        src, _ = _src(tmp_path, 2, 2.0, 13)
        argv = lambda out, extra: ["stream", src, "--out", out, "--chunk-seconds", "0.2",  # noqa: E731
                                   *common, *extra]
        outs = {k: str(tmp_path / f"{k}.wav") for k in ("one", "mesh", "jax")}
    else:
        first = ([str(tmp_path / "in")] if sub == "watch" else paths)
        extra_sub = ["--sweeps", "2", "--interval", "0.05"] if sub == "watch" else []
        argv = lambda out, extra: [sub, *first, "--out", out, *common, *extra_sub,  # noqa: E731
                                   *extra]
        outs = {k: str(tmp_path / k) for k in ("one", "mesh", "jax")}
    assert cli.main(argv(outs["one"], ["--device", "cpu"])) == 0
    assert cli.main(argv(outs["mesh"], ["--device", "cpu", *flags])) == 0
    capsys.readouterr()
    if sub == "stream":
        assert _sha(outs["one"]) == _sha(outs["mesh"])
        pairs = [(outs["mesh"], outs["jax"])]
    else:
        for p in paths:
            assert (_sha(build_output_path(p, outs["one"], "_processed"))
                    == _sha(build_output_path(p, outs["mesh"], "_processed")))
        pairs = [(build_output_path(p, outs["mesh"], "_processed"),
                  build_output_path(p, outs["jax"], "_processed")) for p in paths[:2]]
    if sub != "watch":
        assert jcli.main(argv(outs["jax"], flags)) == 0
        capsys.readouterr()
        for a, b in pairs:
            assert _max_lsb(_codes(a)[0], _codes(b)[0]) <= 2


def test_cli_mesh_larger_than_the_machine_fails(tmp_path, capsys):
    """A shard count the machine cannot hold exits non-zero with the mesh's
    size; it never runs on fewer shards.  Without a card, ``cuda`` exits 1
    before any mesh; a CPU mesh of the wrong size is refused by
    `make_mesh` itself."""
    paths = _write_takes(str(tmp_path / "in"), 1, 3000, seed=14)
    rc = cli.main(["process", *paths, "--out", str(tmp_path / "o"), "--files-shards", "2"])
    err = capsys.readouterr().err
    if torch.cuda.is_available():
        assert rc == 2 and f"mesh 2x1x1 != {torch.cuda.device_count()} devices" in err
    else:
        assert rc == 1 and "no CUDA GPU" in err
    assert not os.path.exists(build_output_path(paths[0], str(tmp_path / "o"), "_processed"))
    with pytest.raises(ValueError, match="mesh 2x1x1 != 3 devices"):
        tpar.make_mesh(2, devices=["cpu"] * 3)
