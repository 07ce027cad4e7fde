"""Native C++ host kernels: lazy build + ctypes bindings (the port's copy of
`f9tpu/native/`, same source and build flags).

Builds ``f9native.cpp`` into a shared library on first use (g++ -O3, cached
in ``f9tpu_torch/_build/``; rebuilt when the source is newer).  Falls back
gracefully: callers check ``available()`` and keep a NumPy path, mirroring
the reference's stub-bridge fallback when the real native layer can't load
(CAAudioBridge.swift:126-134).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = [
    "AsyncLoader",
    "available",
    "flac_available",
    "flac_decode_all",
    "flac_decode_frames",
    "resample_oracle_native",
    "unpack24_to_f32",
    "pack24_from_i32",
    "interleave_f32",
    "deinterleave_f32",
]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "f9native.cpp")
_LIB = os.path.join(os.path.dirname(_DIR), "_build", "libf9native.so")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_error: str | None = None


def _build() -> str | None:
    # NOTE: -march=native binds the .so to the build host's ISA; a checkout
    # shared across heterogeneous hosts (NFS home) must delete the cached
    # library when moving to an older CPU.
    if os.path.exists(_LIB) and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC):
        return None
    # compile to a per-process temp and publish atomically: two processes
    # building concurrently (watch daemon + CLI) must never interleave
    # writes into a half-ELF at the final name, which the mtime staleness
    # check would then treat as up to date forever
    tmp = f"{_LIB}.tmp.{os.getpid()}"
    # -fwrapv: corrupt FLAC frames can overflow the int64 LPC accumulator
    # before the CRC-16 rejects the frame; wrapping is then defined
    # behaviour (the garbage never escapes — the CRC check fails).
    # -ffp-contract=off: the FLAC encoder's LPC analysis (autocorrelation,
    # Levinson, coefficient quantization) must produce bit-identical
    # float64 to the Python oracle; FMA contraction (g++'s C++ default
    # even without -ffast-math) would change the roundings.
    cmd = [
        "g++", "-O3", "-march=native", "-fwrapv", "-ffp-contract=off",
        "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC, "-lpthread",
    ]
    try:
        os.makedirs(os.path.dirname(_LIB), exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"build failed: {e}"
    if proc.returncode != 0:
        return f"build failed: {proc.stderr[-2000:]}"
    try:
        os.replace(tmp, _LIB)
    except OSError as e:
        return f"build failed: {e}"
    return None


def _load() -> ctypes.CDLL | None:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        err = _build()
        if err:
            _build_error = err
            return None
        try:
            lib = ctypes.CDLL(_LIB)
            c_i64 = ctypes.c_int64
            c_i32 = ctypes.c_int32
            pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            pi32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.f9_resample_oracle_mt.argtypes = [
                pd, c_i64, pd, c_i64, c_i64, c_i64, c_i64, pd, c_i64, c_i32]
            lib.f9_unpack24_to_f32.argtypes = [pu8, c_i64, pf]
            lib.f9_pack24_from_i32.argtypes = [pi32, c_i64, pu8]
            lib.f9_interleave_f32.argtypes = [pf, c_i64, c_i64, pf]
            lib.f9_deinterleave_f32.argtypes = [pf, c_i64, c_i64, pf]
            lib.f9_flac_decode.restype = c_i32
            lib.f9_flac_decode.argtypes = [
                pu8, c_i64, c_i32, c_i32, pi32, c_i64, c_i64,
                ctypes.POINTER(c_i64), ctypes.POINTER(c_i64)]
            lib.f9_flac_encode_frame.restype = c_i64
            lib.f9_flac_encode_frame.argtypes = [
                pi32, c_i64, c_i64, c_i32, c_i32, c_i64, c_i32, c_i32,
                pu8, c_i64]
            pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.f9_flac_encode_frames_mt.restype = c_i64
            lib.f9_flac_encode_frames_mt.argtypes = [
                pi32, c_i64, c_i64, c_i32, c_i32, c_i64, c_i32, c_i32,
                c_i32, pu8, c_i64, pi64]
            lib.f9_vorbis_setup.restype = ctypes.c_void_p
            lib.f9_vorbis_setup.argtypes = [pu8, c_i64]
            lib.f9_vorbis_free.argtypes = [ctypes.c_void_p]
            lib.f9_vorbis_packet.restype = c_i64
            lib.f9_vorbis_packet.argtypes = [
                ctypes.c_void_p, pu8, c_i64, pf, pf,
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
            lib.f9_ogg_crc.restype = ctypes.c_uint32
            lib.f9_ogg_crc.argtypes = [pu8, c_i64, ctypes.c_uint32]
            lib.f9_alac_decode_packet.restype = c_i64
            lib.f9_alac_decode_packet.argtypes = [
                c_i32, c_i32, c_i32, c_i32, c_i32, c_i32, pu8, c_i64, pi32]
            lib.f9_mp3_huff_init.restype = c_i32
            lib.f9_mp3_huff_init.argtypes = [pi32, c_i64]
            lib.f9_mp3_huffman.restype = c_i32
            lib.f9_mp3_huffman.argtypes = [
                pu8, c_i64, c_i64, c_i64, c_i32, c_i32, c_i32,
                c_i32, c_i32, c_i32, c_i32, c_i32, c_i32, c_i32,
                pi32, np.ctypeslib.ndpointer(np.int64,
                                             flags="C_CONTIGUOUS")]
            lib.f9_native_abi_version.restype = c_i32
            abi = int(lib.f9_native_abi_version())
            if abi != 4:
                raise OSError(f"ABI version {abi} != 4 (stale library?)")
        except (OSError, AttributeError) as e:
            # missing symbol / ABI mismatch (stale or hand-built .so) must
            # fall back like a failed build, not raise out of available()
            # on the hot decode path; an explicit check, not an assert —
            # python -O would strip an assert and bind a mismatched ABI
            _build_error = str(e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def resample_oracle_native(
    x: np.ndarray, H: np.ndarray, L: int, M: int, delay: int,
    out_len: int, n_threads: int | None = None,
) -> np.ndarray:
    """Double-precision polyphase resample of 1-D ``x`` using phase bank ``H``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    x = np.ascontiguousarray(x, np.float64)
    H = np.ascontiguousarray(H, np.float64)
    # validate BEFORE crossing the ctypes boundary: the NumPy oracle would
    # raise IndexError on these; the C++ loop would read out of bounds
    if H.ndim != 2 or H.shape[0] != L:
        raise ValueError(f"phase bank shape {H.shape} does not match L={L}")
    if L <= 0 or M <= 0 or delay < 0 or out_len < 0:
        raise ValueError(f"invalid resample args L={L} M={M} delay={delay} "
                         f"out_len={out_len}")
    K = H.shape[1]
    y = np.empty(out_len, np.float64)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    lib.f9_resample_oracle_mt(x, len(x), H, L, M, K, delay, y, out_len, n_threads)
    return y


def unpack24_to_f32(raw: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    raw = np.ascontiguousarray(raw, np.uint8)
    n = len(raw) // 3
    out = np.empty(n, np.float32)
    lib.f9_unpack24_to_f32(raw, n, out)
    return out


def pack24_from_i32(codes: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    codes = np.ascontiguousarray(codes, np.int32)
    out = np.empty(len(codes) * 3, np.uint8)
    lib.f9_pack24_from_i32(codes, len(codes), out)
    return out


def interleave_f32(planar: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    planar = np.ascontiguousarray(planar, np.float32)
    c, f = planar.shape
    out = np.empty(c * f, np.float32)
    lib.f9_interleave_f32(planar, c, f, out)
    return out


def deinterleave_f32(inter: np.ndarray, channels: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    inter = np.ascontiguousarray(inter, np.float32)
    frames = len(inter) // channels
    out = np.empty((channels, frames), np.float32)
    lib.f9_deinterleave_f32(inter, channels, frames, out)
    return out


_FLAC_ERRORS = {
    -1: "lost frame sync", -2: "frame header CRC-8 mismatch",
    -3: "frame CRC-16 mismatch", -4: "reserved field set",
    -5: "truncated stream", -6: "channel count differs from STREAMINFO",
    -7: "invalid field value",
}


def flac_available() -> bool:
    """True when the native FLAC frame decoder is loadable (the Python
    decoder in `f9tpu_torch.io.flac` is the fallback and parity oracle)."""
    return _load() is not None


_FLAC_MAXBLOCK = 65535


def flac_decode_frames(data, channels: int, bits: int, want_samples: int,
                       partial_ok: bool = False
                       ) -> tuple[np.ndarray, int, int, bool]:
    """Decode whole FLAC frames from a frame boundary until >= want_samples
    samples (or the window runs out): (planar int32 codes (channels, done),
    samples done, bytes consumed, truncated flag).  bytes-consumed always
    lands on a frame boundary, so a streaming caller resumes losslessly.
    CRC / sync / reserved-field violations raise ValueError; a window that
    ends mid-frame raises too unless ``partial_ok`` (then the truncated
    flag is returned with the progress made, and the caller refills)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    buf = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) \
        else np.ascontiguousarray(data, np.uint8)
    # frames are never split: capacity needs max-blocksize headroom past the
    # target so the final frame fits whole
    cap = int(want_samples) + _FLAC_MAXBLOCK + 1
    out = np.empty((channels, cap), np.int32)
    done = ctypes.c_int64(0)
    used = ctypes.c_int64(0)
    rc = lib.f9_flac_decode(buf, len(buf), channels, bits, out, cap,
                            want_samples, ctypes.byref(done),
                            ctypes.byref(used))
    if rc == -5 and partial_ok:
        return out[:, :done.value], int(done.value), int(used.value), True
    if rc != 0:
        raise ValueError(
            f"flac: {_FLAC_ERRORS.get(rc, f'decode error {rc}')} "
            f"(after {done.value} samples)")
    return out[:, :done.value], int(done.value), int(used.value), False


def flac_encode_frame(codes: np.ndarray, bits: int, frame_no: int,
                      nominal_block: int, sample_rate: int) -> bytes:
    """Encode ONE FLAC frame from planar (channels, n) integer codes —
    bit-identical to `f9tpu_torch.io.flac._encode_frame` (the Python oracle;
    parity is a tested contract)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    codes = np.ascontiguousarray(codes, np.int32)
    ch, n = codes.shape
    # worst case ~47 bits/sample (escaped 33-bit side-channel residuals
    # plus rice quotients); 8 B/sample is comfortably above it
    cap = n * ch * 8 + 256
    out = np.empty(cap, np.uint8)
    rc = lib.f9_flac_encode_frame(codes, n, n, ch, bits, frame_no,
                                  nominal_block, sample_rate, out, cap)
    if rc < 0:
        raise ValueError(f"flac: native encode error {rc}")
    return out[:rc].tobytes()


def flac_encode_frames_mt(codes: np.ndarray, bits: int, first_frame_no: int,
                          block: int, sample_rate: int,
                          n_threads: int | None = None
                          ) -> tuple[bytes, np.ndarray]:
    """Encode a run of `block`-sized frames (final one partial) in
    parallel: (concatenated frame bytes, per-frame lengths).  Frames are
    independent under fixed predictors, so the result is byte-identical
    to the sequential encoder at any thread count."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    codes = np.ascontiguousarray(codes, np.int32)
    ch, n = codes.shape
    n_frames = -(-n // block)
    cap = n * ch * 8 + 256 * n_frames
    out = np.empty(cap, np.uint8)
    lens = np.empty(n_frames, np.int64)
    if n_threads is None:
        n_threads = min(8, os.cpu_count() or 1)
    rc = lib.f9_flac_encode_frames_mt(codes, n, n, ch, bits, first_frame_no,
                                      block, sample_rate, n_threads,
                                      out, cap, lens)
    if rc < 0:
        raise ValueError(f"flac: native encode error {rc}")
    return out[:rc].tobytes(), lens


def flac_decode_all(data, si) -> np.ndarray:
    """Full-stream decode against a parsed STREAMINFO (`f9tpu_torch.io.flac`
    calls this when available; same result dtype contract: planar int64)."""
    codes, done, _, _ = flac_decode_frames(
        data, si.channels, si.bits, si.total_samples)
    if done < si.total_samples:
        raise ValueError(
            f"flac: truncated stream ({done}/{si.total_samples} samples)")
    return codes[:, :si.total_samples].astype(np.int64)


class AsyncLoader:
    """Native threaded WAV loader: submit files, poll tickets.

    Decode (file I/O, header walk, 16/24-bit conversion, deinterleave) runs on
    C++ threads into caller-owned planar float32 buffers — the native
    data-loader runtime component (JUCE AudioFormatManager's role in the
    reference, Source/MainComponent.cpp:705-749).
    """

    def __init__(self, n_threads: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        if not hasattr(lib, "_f9_loader_bound"):
            lib.f9_loader_create.restype = ctypes.c_void_p
            lib.f9_loader_create.argtypes = [ctypes.c_int32]
            lib.f9_loader_destroy.argtypes = [ctypes.c_void_p]
            lib.f9_loader_submit.restype = ctypes.c_void_p
            lib.f9_loader_submit.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int64, ctypes.c_int32]
            lib.f9_loader_poll.restype = ctypes.c_int32
            lib.f9_loader_poll.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32)]
            lib._f9_loader_bound = True
        self._handle = lib.f9_loader_create(n_threads)
        self._buffers: dict[int, np.ndarray] = {}  # keep dst alive per ticket

    def submit(self, path: str, channels: int, max_frames: int) -> int:
        """Queue a decode into a fresh (channels, max_frames) buffer; returns
        a ticket for `poll`."""
        dst = np.zeros((channels, max_frames), np.float32)
        # fsencode, not str.encode: Linux filenames are bytes, and listdir
        # surrogate-escapes non-UTF-8 names that strict UTF-8 would reject
        ticket = self._lib.f9_loader_submit(
            self._handle, os.fsencode(path), dst, max_frames, channels)
        self._buffers[ticket] = dst
        return ticket

    def poll(self, ticket: int):
        """None while pending; (data (channels, frames), rate) when done.
        Raises on decode error."""
        if ticket not in self._buffers:
            # consumed or foreign ticket: the native poll would dereference
            # a freed/garbage job pointer — refuse on the Python side
            raise KeyError(f"unknown or already-consumed ticket {ticket}")
        frames = ctypes.c_int64(0)
        rate = ctypes.c_int32(0)
        st = self._lib.f9_loader_poll(ticket, ctypes.byref(frames),
                                      ctypes.byref(rate))
        if st == 0:
            return None
        buf = self._buffers.pop(ticket)
        if st < 0:
            raise ValueError(f"native decode failed (code {st})")
        return buf[:, : frames.value], rate.value

    def wait(self, ticket: int, timeout: float = 600.0, poll_s: float = 0.001):
        # generous default: file I/O here is link-bound and varies 10x day
        # to day — a slow multi-GB read must not spuriously
        # fail files that the Python decode path would have completed
        import time as _time

        deadline = _time.monotonic() + timeout
        while True:
            res = self.poll(ticket)
            if res is not None:
                return res
            if _time.monotonic() > deadline:
                raise TimeoutError("native decode timed out")
            _time.sleep(poll_s)

    def close(self) -> None:
        if self._handle:
            self._lib.f9_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        # safety net for exception paths that skip close(): each leaked
        # loader would otherwise pin n_threads C++ threads for the process
        # lifetime (a long-lived watch daemon creates one per sweep)
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# Vorbis packet front half (see f9native.cpp "Vorbis packet front half"):
# the C++ twin of io/vorbis.py's packet decode up to the (residue, curve)
# pair — bitwise identical to the Python oracle by construction.


class VorbisNative:
    """Owns one native setup handle; decode_packet mirrors the Python
    front half and returns (n, prev, next, residue, curve) or None for
    non-audio packets."""

    def __init__(self, blob: bytes, channels: int, bs1: int):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_build_error}")
        self._lib = lib
        b = np.frombuffer(blob, np.uint8)
        self._handle = lib.f9_vorbis_setup(b, b.size)
        if not self._handle:
            raise ValueError("native Vorbis setup rejected the blob")
        self._ch = channels
        self._cap = bs1 // 2
        self._flags = np.zeros(2, np.int32)

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.f9_vorbis_free(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def decode_packet(self, pkt: bytes):
        res = np.empty((self._ch, self._cap), np.float32)
        curve = np.empty((self._ch, self._cap), np.float32)
        p = np.frombuffer(pkt, np.uint8)
        n = int(self._lib.f9_vorbis_packet(
            self._handle, p, p.size, res.reshape(-1), curve.reshape(-1),
            self._flags))
        if n <= 0:
            return None
        n2 = n // 2
        return (n, bool(self._flags[0]), bool(self._flags[1]),
                res[:, :n2], curve[:, :n2])


def ogg_crc_native(data: bytes, crc: int = 0) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    b = np.frombuffer(data, np.uint8)
    return int(lib.f9_ogg_crc(b, b.size, np.uint32(crc)))


def alac_decode_packet(cfg, data: bytes) -> np.ndarray | None:
    """Native ALAC packet decode (bit-identical twin of
    io/alac.py::AlacDecoder.decode_packet); returns (channels, n) int32
    or None when the native library is unavailable.  Raises ValueError
    on malformed/hostile packets (the Python oracle's AlacError is a
    ValueError too, so callers catch one type)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((cfg.num_channels, cfg.frame_length), np.int32)
    p = np.frombuffer(data, np.uint8)
    n = int(lib.f9_alac_decode_packet(
        cfg.frame_length, cfg.bit_depth, cfg.pb, cfg.mb, cfg.kb,
        cfg.num_channels, p, p.size, out.reshape(-1)))
    if n < 0:
        raise ValueError("malformed ALAC packet")
    return out[:, :n]


_mp3_huff_ready = False
_mp3_huff_lock = threading.Lock()


def mp3_huff_available() -> bool:
    """Build + initialize the MP3 Huffman trees (from io/mp3tables.py —
    the SAME published table data the Python oracle decodes with)."""
    global _mp3_huff_ready
    lib = _load()
    if lib is None:
        return False
    if _mp3_huff_ready:
        return True
    with _mp3_huff_lock:
        if _mp3_huff_ready:
            return True
        from ..io.mp3tables import HUFF_TABLES, QUAD_A, QUAD_B

        rows = []
        for tid, table in HUFF_TABLES.items():
            for (length, code), (x, y) in table.items():
                rows.append((tid, length, code, (x << 4) | y))
        for (length, code), v in QUAD_A.items():
            rows.append((32, length, code, v))
        for (length, code), v in QUAD_B.items():
            rows.append((33, length, code, v))
        ent = np.ascontiguousarray(np.asarray(rows, np.int32).reshape(-1))
        if int(lib.f9_mp3_huff_init(ent, len(rows))) != 0:
            return False
        _mp3_huff_ready = True
        return True


def mp3_huffman_native(data, pos: int, end: int, big_end: int, r1: int,
                       r2: int, tids, linbits, count1table: int):
    """One granule-channel Huffman walk; returns (is_[576] int32, rzero,
    pos_after) or raises ValueError exactly where the Python oracle
    raises Mp3Error.  ``data`` must already carry the >=8 zero pad bytes
    (io/mp3.py pads the reservoir+main buffer)."""
    lib = _lib
    d = np.frombuffer(data, np.uint8)
    is_ = np.empty(576, np.int32)
    meta = np.empty(2, np.int64)
    rc = int(lib.f9_mp3_huffman(
        d, d.size, pos, end, big_end, r1, r2,
        tids[0], tids[1], tids[2], linbits[0], linbits[1], linbits[2],
        count1table, is_, meta))
    if rc == -1:
        raise ValueError("bad Huffman code")
    if rc != 0:
        raise RuntimeError(f"f9_mp3_huffman internal error {rc}")
    return is_, int(meta[0]), int(meta[1])
