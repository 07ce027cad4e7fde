"""The front end as one kernel (`f9tpu_torch/ops/frontend.py`,
`csrc/frontend.cu`) on the CPU.

- The twin, through the graph's call site (`graph._front_end`), against the
  JAX package's `f9tpu.pipeline.graph._front_end` bit for bit: the 16- and
  24-bit wires in both byte orders and the float32 bucket, 1-8 input
  channels, fan-out, identity, swapped, silent and wider-than-input routing,
  and valid lengths of 0, 1, a tile's edge and one either side, part of the
  bucket, the whole bucket and past it; rows of odd length, a trailing
  partial frame, and -0.0, NaN and inf on the float wire.
- The stream form (`stream._raw_front`) against JAX's `_raw_front` with the
  DC mean over a real span, shifted by ``idx_offset``, and without a mean.
- The CUDA source itself, built by g++ against `tests/cuda_emu.h` (a thread
  per CUDA thread, a barrier for ``__syncthreads``, shared memory filled
  with NaNs), equals the twin bit for bit: every wire, tiles of 1-4096
  frames, rows and outputs off the 16-byte grid, a row stride past the row,
  65 files of one tile, and a wire whose padding lies on a page that cannot
  be read (the kernel reads nothing past a file's valid bytes).
- Dispatch: a CPU tensor runs the twin and never loads the library; any
  other tensor takes the kernel or raises, never the twin.
- A `cuda`-marked test holds the kernel to the twin on the card; it skips
  without one (`chip_smoke.py --front-end` runs the full grid there)."""

import ctypes
import importlib
import mmap
import os
import re
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu_torch.ops import _build  # noqa: E402
from f9tpu_torch.ops import frontend as fe  # noqa: E402
from f9tpu_torch.ops.routing import route_channels  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402
from f9tpu_torch.pipeline import stream as tstream  # noqa: E402

jgraph = importlib.import_module("f9tpu.pipeline.graph")
jstream = importlib.import_module("f9tpu.pipeline.stream")

#: the wires: (bits, big-endian), None for the float32 bucket
WIRES = {"16le": (16, False), "16be": (16, True), "24le": (24, False), "24be": (24, True),
         "f32": None}


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _wire(spec, files: int, c_in: int, frames: int, seed: int, extra: int = 0) -> np.ndarray:
    """A uint8 wire ``(files, frames * c_in * bytes + extra)`` of random
    bytes with the extreme codes in file 0 (``extra`` bytes of a partial
    frame), or for ``spec`` None a float32 ``(files, c_in, frames)`` bucket
    with -0.0, NaN and inf in file 6."""
    rng = np.random.default_rng(seed)
    if spec is None:
        x = (0.5 * rng.standard_normal((files, c_in, frames))).astype(np.float32)
        x[min(6, files - 1), 0, :3] = [-0.0, np.nan, np.inf]
        return x
    nb = spec[0] // 8
    raw = rng.integers(0, 256, size=(files, frames * c_in * nb + extra), dtype=np.uint8)
    top = 1 if spec[1] else nb - 1                  # the most significant byte
    raw[0, :2 * nb] = 0
    raw[0, top] = 0x80                              # the most negative code
    raw[0, nb:2 * nb] = 0xFF
    raw[0, nb + top] = 0x7F                         # the most positive code
    return raw


def _routings(c_in: int) -> list[tuple[str, list | None, int | None]]:
    """(name, routing, out_channels) cases for a ``c_in``-channel input."""
    cases = [("none", None, None), ("identity", list(range(c_in)), None),
             ("swap", list(range(c_in))[::-1], None),
             ("silent", [-1] + list(range(1, c_in))[::-1], None),
             ("wider", [i % c_in for i in range(c_in + 2)] + [-1], None)]
    if c_in == 1:
        cases += [("fan-out", None, 2), ("fan-out routed", [5, -1, 0, 3], 6),
                  ("out_channels 1", None, 1)]
    else:
        cases.append(("out_channels ignored", None, 2))
    return cases


def _edges(tile: int, frames: int) -> np.ndarray:
    """Valid lengths of 8 files: none, one frame, a tile's edge and one
    either side, part of the bucket, all of it and past it."""
    return np.array([0, 1, tile - 1, tile, tile + 1, frames // 2 + 3, frames, frames + 5],
                    np.int32)


# -------------------------------------------------- the twin against JAX

@pytest.mark.parametrize("c_in", [1, 2, 3, 6, 8])
@pytest.mark.parametrize("wire", list(WIRES))
def test_batch_front_end_equals_jax(wire, c_in):
    """`graph._front_end` (the twin on a CPU tensor) and
    `front_end_reference` == JAX's `_front_end`, bit for bit, at a bucket of
    two tiles and three frames."""
    spec = WIRES[wire]
    bpf = 0 if spec is None else c_in * spec[0] // 8
    tile = fe.front_end_tile(bpf)
    frames = 2 * tile + 3
    x = _wire(spec, 8, c_in, frames, seed=c_in * 7 + len(wire), extra=1 if spec else 0)
    fv = _edges(tile, frames)
    raw_in = None if spec is None else (c_in, spec[0], spec[1])
    for name, routing, out_ch in _routings(c_in):
        want = np.asarray(jgraph._front_end(jnp.asarray(x), jnp.asarray(fv), routing, out_ch,
                                            raw_in))
        got = tgraph._front_end(torch.from_numpy(x), torch.from_numpy(fv), routing, out_ch,
                                raw_in)
        ref = fe.front_end_reference(torch.from_numpy(x), torch.from_numpy(fv), raw=raw_in,
                                     routing=routing, out_channels=out_ch)
        assert got.shape == want.shape == ref.shape, name
        assert np.array_equal(_bits(got), _bits(want)), name
        assert np.array_equal(_bits(ref), _bits(want)), name


@pytest.mark.parametrize("c_in", [1, 2, 6])
@pytest.mark.parametrize("wire", ["16le", "16be", "24le", "24be"])
def test_stream_front_equals_jax(wire, c_in):
    """`stream._raw_front` == JAX's `_raw_front` bit for bit: the mean off
    over real spans inside, across and past the chunk, shifted by
    ``idx_offset`` (a frames shard's place), and with no mean."""
    bits, be = WIRES[wire]
    frames = 1001
    raw = _wire(WIRES[wire], 1, c_in, frames, seed=bits + c_in, extra=1)[0]
    routings = [(None, 0), (list(range(c_in))[::-1], 0), ([-1] + list(range(c_in - 1)), 0)]
    if c_in == 1:
        routings += [(None, 2), ([1, -1, 0], 2)]
    rng = np.random.default_rng(c_in)
    for routing, fanout in routings:
        c_out = len(routing) if routing is not None else (fanout or c_in)
        mean = (0.01 * rng.standard_normal((c_out, 1))).astype(np.float32)
        for (lo, hi), off in (((0, 0), 0), ((0, frames), 0), ((37, 700), 0),
                              ((-5, 10 ** 6), 0), ((300, 900), 250), ((0, 1200), -100)):
            for m in (mean, None):
                want = np.asarray(jstream._raw_front(
                    jnp.asarray(raw), in_wire=(bits, be), in_channels=c_in, fanout=fanout,
                    routing=routing, mean=None if m is None else jnp.asarray(m),
                    valid_lo=lo, valid_hi=hi, idx_offset=off))
                got = tstream._raw_front(
                    torch.from_numpy(raw), in_wire=(bits, be), in_channels=c_in, fanout=fanout,
                    routing=routing, mean=None if m is None else torch.from_numpy(m),
                    valid=(lo, hi), idx_offset=off)
                assert tuple(got.shape) == want.shape == (c_out, frames)
                assert np.array_equal(_bits(got), _bits(want)), (routing, fanout, lo, hi, off)


def test_channel_map_is_the_twins_gather():
    """The kernel's map is fan-out then routing, -1 silent, and refuses an
    entry past the fanned-out channels as `route_channels` does."""
    assert fe.channel_map(3).tolist() == [0, 1, 2]
    assert fe.channel_map(1, 4).tolist() == [0, 0, 0, 0]
    assert fe.channel_map(1, 4, [3, -1, 0]).tolist() == [0, -1, 0]
    assert fe.channel_map(2, 6, [1, -1, 1, 0]).tolist() == [1, -1, 1, 0]
    assert fe.channel_map(1, 1, [0, -1]).tolist() == [0, -1]
    for c_in, out_ch, routing in ((2, None, [0, 2]), (1, 3, [3]), (1, None, [1])):
        with pytest.raises(ValueError, match="out of range") as got:
            fe.channel_map(c_in, out_ch, routing)
        x = torch.zeros((1, out_ch if c_in == 1 and out_ch else c_in, 4))
        with pytest.raises(ValueError, match="out of range") as twin:
            route_channels(x, routing)
        assert str(got.value) == str(twin.value)


def test_tiles_fit_the_block():
    """Every frame width up to 16,384 bytes gets a power-of-two tile whose
    shared memory fits a block without raising its limit."""
    assert fe.front_end_tile(0) == fe.FE_FLOAT_TILE
    assert fe.front_end_tile(6) == 2048 and fe.front_end_tile(2) == fe.FE_MAX_TILE
    for bpf in list(range(1, 1200)) + [4096, 5461 * 3, 16383, 16384]:
        t = fe.front_end_tile(bpf)
        assert t & (t - 1) == 0 and 1 <= t <= fe.FE_MAX_TILE
        assert t * bpf <= fe.FE_STAGE_BYTES or t == 1
        assert fe.front_end_smem(t, bpf) <= fe.FE_SMEM_MAX
        assert fe.front_end_smem(t, bpf) >= t * bpf + 15


# ------------------------------------- the kernel's source, emulated on the CPU

#: the emulated blocks' threads: the kernel strides every loop by its block
#: size, and 64 threads a block keep a launch of many blocks quick here
EMU_THREADS = 64


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """`csrc/frontend.cu` itself built by g++ against `tests/cuda_emu.h`, its
    launch and shared declaration rewritten to the emulation's, with blocks
    of `EMU_THREADS`."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's source against the emulation")
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(_build.CSRC, "frontend.cu")) as f:
        src = f.read()
    cuts = [("#include <cuda_runtime.h>", '#include "cuda_emu.h"'),
            ("extern __shared__ uint4 fe_sm[];",
             "uint4* fe_sm = reinterpret_cast<uint4*>(emu_dynamic_smem());")]
    for old, new in cuts:
        assert old in src, old
        src = src.replace(old, new)
    src, n = re.subn(r"(front_end_kernel<[^>]*>)<<<([^,]+), ([^,]+), [^>]+>>>\((.*?)\);",
                     r"emu_launch(\2, \3, [&] { \1(\4); });", src, flags=re.S)
    assert n == 1 and "<<<" not in src
    tmp = str(tmp_path_factory.mktemp("frontend_emu"))
    cpp, so = os.path.join(tmp, "frontend_emu.cpp"), os.path.join(tmp, "libfrontend_emu.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-DFE_THREADS={EMU_THREADS}",
                    "-I", here, "-o", so, cpp, "-lpthread"], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.f9_front_end.argtypes = [vp] * 5 + [i64] * 4 + [i32] * 5 + [i64] * 3 + [vp]
    lib.f9_front_end.restype = i32
    return lib


def _run_emu(lib, spec, rows: np.ndarray, c_in: int, *, routing=None, out_channels=None,
             fv=None, mean=None, span=(0, 0), off=0, tile=None, in_shift=0, row_pad=0,
             out_shift=0):
    """The emulated kernel on ``rows`` (the wire ``(files, bytes)`` or the
    float bucket), laid out ``in_shift`` bytes (floats) off the 16-byte grid
    with ``row_pad`` bytes (floats) after each row, writing ``out_shift``
    floats off it; returns the output and checks the words around it are
    untouched."""
    files = rows.shape[0]
    if spec is None:
        frames = rows.shape[2]
        cstride = frames + row_pad
        store = np.zeros(in_shift + files * c_in * cstride + 4, np.float32)
        view = store[in_shift:in_shift + files * c_in * cstride].reshape(files, c_in, cstride)
        view[..., :frames] = rows
        strides, nbytes, big = (c_in * cstride, cstride), 0, 0
    else:
        nbytes, big = spec[0] // 8, int(spec[1])
        frames = rows.shape[1] // (c_in * nbytes)
        stride = rows.shape[1] + row_pad
        store = np.zeros(in_shift + files * stride + 16, np.uint8)
        view = store[in_shift:in_shift + files * stride].reshape(files, stride)
        view[:, :rows.shape[1]] = rows
        strides = (stride, 0)
    cmap = fe.channel_map(c_in, out_channels, routing)
    c_out = len(cmap)
    n = files * c_out * frames
    out_store = np.full(out_shift + n + 8, np.nan, np.float32)
    tile = tile or fe.front_end_tile(c_in * nbytes)
    err = lib.f9_front_end(
        view.ctypes.data, cmap.ctypes.data, None if fv is None else fv.ctypes.data,
        None if mean is None else mean.ctypes.data, out_store[out_shift:].ctypes.data, files,
        frames, strides[0], strides[1], c_in, c_out, nbytes, big, tile, span[0], span[1], off,
        None)
    assert err == 0
    assert np.isnan(out_store[:out_shift]).all() and np.isnan(out_store[out_shift + n:]).all()
    return out_store[out_shift:out_shift + n].reshape(files, c_out, frames)


def _twin(spec, rows, c_in, **kw):
    raw = None if spec is None else (c_in, spec[0], spec[1])
    fv = kw.pop("fv", None)
    mean = kw.pop("mean", None)
    y = fe.front_end_reference(torch.from_numpy(rows),
                               None if fv is None else torch.from_numpy(fv), raw=raw,
                               mean=None if mean is None else torch.from_numpy(mean), **kw)
    return y.numpy()


@pytest.mark.parametrize("wire", list(WIRES))
def test_kernel_source_emulated_equals_the_twin(emu, wire):
    """The CUDA source, run on the CPU a thread per CUDA thread, == the
    twin bit for bit: small tiles (many blocks a row, a partial last tile),
    the production tile, rows and outputs 1-15 bytes (1-3 floats) off the
    16-byte grid, row strides past the row, a partial trailing frame, every
    routing of `_routings`, the batch mask at a tile's edges and the stream
    form's mean, span and offset."""
    spec = WIRES[wire]
    rng = np.random.default_rng(len(wire))
    for c_in in (1, 2, 3):
        nb = 0 if spec is None else spec[0] // 8
        for tile, frames in ((16, 3 * 16 + 5), (1, 5), (fe.front_end_tile(c_in * nb), 203)):
            rows = _wire(spec, 8, c_in, frames, seed=tile + c_in, extra=1 if spec else 0)
            fv = _edges(tile, frames)
            routings = _routings(c_in)
            if tile != 16:              # every routing at one tile, two at the others
                routings = [routings[0], routings[4]]
            for k, (name, routing, out_ch) in enumerate(routings):
                lay = dict(in_shift=(k * 5 + c_in) % (4 if spec is None else 16),
                           row_pad=k % 3, out_shift=k % 4)
                got = _run_emu(emu, spec, rows, c_in, routing=routing, out_channels=out_ch,
                               fv=fv, tile=tile, **lay)
                want = _twin(spec, rows, c_in, routing=routing, out_channels=out_ch, fv=fv)
                assert np.array_equal(_bits(got), _bits(want)), (c_in, tile, name, lay)
            if spec is None:
                continue
            # the stream form: one row, the mean over a span, shifted
            one = rows[:1]
            for (lo, hi), off in (((3, frames - 4), 0), ((0, 10 ** 6), 0), ((10, 40), -7),
                                  ((0, 0), 0)):
                routing = [c_in - 1, -1] + list(range(c_in))
                mean = (0.01 * rng.standard_normal((len(routing), 1))).astype(np.float32)
                got = _run_emu(emu, spec, one, c_in, routing=routing, mean=mean,
                               span=(lo, hi), off=off, tile=tile, in_shift=3, out_shift=1)
                want = _twin(spec, one[0], c_in, routing=routing, mean=mean, span=(lo, hi),
                             idx_offset=off)
                assert np.array_equal(_bits(got[0]), _bits(want)), (c_in, tile, lo, hi, off)


def test_kernel_source_emulated_many_files_and_wide_frames(emu):
    """65 mono files of one tile each (a block a file on the 1-D grid) and
    an 8-channel 24-bit wire whose frames fill a 2,048-frame tile's bytes."""
    spec = WIRES["24le"]
    rows = _wire(spec, 65, 1, 37, seed=1)
    fv = np.random.default_rng(2).integers(0, 40, 65).astype(np.int32)
    got = _run_emu(emu, spec, rows, 1, out_channels=2, fv=fv, in_shift=1)
    assert np.array_equal(_bits(got), _bits(_twin(spec, rows, 1, out_channels=2, fv=fv)))
    rows = _wire(spec, 2, 8, 700, seed=3)
    fv = np.array([699, 700], np.int32)
    got = _run_emu(emu, spec, rows, 8, routing=[7, 0, -1, 3], fv=fv, in_shift=5, out_shift=2)
    want = _twin(spec, rows, 8, routing=[7, 0, -1, 3], fv=fv)
    assert np.array_equal(_bits(got), _bits(want))


def test_kernel_source_emulated_reads_nothing_past_the_valid_bytes(emu):
    """A 24-bit stereo wire whose valid bytes end where an unreadable page
    begins (the padding lies on it): the emulated kernel reads none of it,
    whatever the alignment of the span's end, and equals the twin."""
    page = mmap.PAGESIZE
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mprotect.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    prot_none, prot_rw = 0, mmap.PROT_READ | mmap.PROT_WRITE
    spec, bpf = WIRES["24le"], 6
    for valid in (640, 641, 643):
        frames = valid + 100                       # the row reaches into the next page
        mm = mmap.mmap(-1, 2 * page)
        buf = (ctypes.c_char * (2 * page)).from_buffer(mm)
        base = ctypes.addressof(buf)
        try:
            start = page - valid * bpf             # the valid bytes end at the page
            data = _wire(spec, 1, 2, frames, seed=valid)[0]
            ctypes.memmove(base + start, data.ctypes.data, page - start)
            assert libc.mprotect(base + page, page, prot_none) == 0
            cmap = fe.channel_map(2)
            fv = np.array([valid], np.int32)
            out = np.zeros(2 * frames, np.float32)
            err = emu.f9_front_end(base + start, cmap.ctypes.data, fv.ctypes.data, None,
                                   out.ctypes.data, 1, frames, frames * bpf, 0, 2, 2, 3, 0,
                                   fe.front_end_tile(bpf), 0, 0, 0, None)
            assert err == 0
            row = data.copy()
            row[valid * bpf:] = 0
            want = _twin(spec, row[None], 2, fv=fv)
            assert np.array_equal(_bits(out.reshape(1, 2, frames)), _bits(want)), valid
        finally:
            libc.mprotect(base + page, page, prot_rw)
            del buf
            mm.close()


def test_kernel_source_emulated_refuses_what_it_does_not_take(emu):
    """A tile that is not a power of two or past 4,096 frames, a depth of 1
    byte, a big-endian float wire and a frame too wide to stage return an
    error and launch nothing."""
    x = np.zeros(64, np.uint8)
    out = np.zeros(64, np.float32)
    cmap = np.zeros(1, np.int32)
    base = dict(nbytes=3, big=0, tile=16, c_in=1)
    for bad in (dict(tile=3), dict(tile=8192), dict(nbytes=1), dict(nbytes=0, big=1),
                dict(c_in=20000, tile=1)):
        a = dict(base, **bad)
        assert emu.f9_front_end(x.ctypes.data, cmap.ctypes.data, None, None, out.ctypes.data,
                                1, 16, 64, 0, a["c_in"], 1, a["nbytes"], a["big"], a["tile"],
                                0, 0, 0, None) != 0
    assert not out.any()


# --------------------------------------------------------------- dispatch

def test_cpu_tensor_runs_the_twin_and_never_loads_the_library():
    """On the CPU the graph, the stream and the wrapper take the twin; the
    count stays 0 and the library is never loaded."""
    fe.launches = 0
    raw = torch.from_numpy(_wire(WIRES["24le"], 2, 2, 100, seed=5))
    fv = torch.tensor([50, 100], dtype=torch.int32)
    y = tgraph._front_end(raw, fv, [1, 0], None, (2, 24, False))
    assert torch.equal(y, fe.front_end_reference(raw, fv, raw=(2, 24, False), routing=[1, 0]))
    tstream._raw_front(raw[0], in_wire=(24, False), in_channels=2,
                       mean=torch.zeros((2, 1)), valid=(0, 50))
    assert fe.launches == 0 and _build._lib is None


def test_other_devices_take_the_kernel_or_raise(monkeypatch):
    """A tensor off the CPU never takes the twin: with no library it raises
    and counts nothing; what the kernel does not take raises first."""
    fe.launches = 0

    def no_library():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    monkeypatch.setattr(_build, "load_library", no_library)
    monkeypatch.setattr(fe, "front_end_reference",
                        lambda *a, **k: pytest.fail("the twin ran on a device tensor"))
    meta = torch.empty((2, 600), dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.front_end(meta, torch.empty(2, dtype=torch.int32, device="meta"), raw=(2, 24, False))
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.front_end(torch.empty((2, 2, 100), device="meta"))
    with pytest.raises(ValueError, match="bit depth"):
        fe.front_end(meta, raw=(2, 8, False))
    with pytest.raises(ValueError, match="float32"):
        fe.front_end(torch.empty((2, 2, 100), dtype=torch.float64, device="meta"))
    with pytest.raises(ValueError, match="frames_valid"):
        fe.front_end(meta[0], torch.empty(1, dtype=torch.int32, device="meta"),
                     raw=(2, 24, False))
    assert fe.launches == 0


# ------------------------------------------------------------ on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(card):
    """Bit for bit, every wire and routing of the CPU grid, batch and stream
    forms, through the graph's and the stream's call sites."""
    for wire, spec in WIRES.items():
        for c_in in (1, 2, 3, 6, 8):
            bpf = 0 if spec is None else c_in * spec[0] // 8
            tile = fe.front_end_tile(bpf)
            frames = 2 * tile + 3
            x = torch.from_numpy(_wire(spec, 8, c_in, frames, seed=c_in,
                                       extra=1 if spec else 0)).to(card)
            fv = torch.from_numpy(_edges(tile, frames)).to(card)
            raw_in = None if spec is None else (c_in, spec[0], spec[1])
            for name, routing, out_ch in _routings(c_in):
                n0 = fe.launches
                got = tgraph._front_end(x, fv, routing, out_ch, raw_in)
                assert fe.launches == n0 + 1
                want = fe.front_end_reference(x, fv, raw=raw_in, routing=routing,
                                              out_channels=out_ch)
                assert np.array_equal(_bits(got.cpu()), _bits(want.cpu())), (wire, c_in, name)
            if spec is None:
                continue
            mean = torch.full((c_in, 1), 0.01, device=card)
            got = tstream._raw_front(x[0], in_wire=spec, in_channels=c_in, mean=mean,
                                     valid=(5, frames - 5), idx_offset=3)
            want = fe.front_end_reference(x[0], raw=raw_in, mean=mean, span=(5, frames - 5),
                                          idx_offset=3)
            assert np.array_equal(_bits(got.cpu()), _bits(want.cpu())), (wire, c_in)
