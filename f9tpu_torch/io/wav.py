"""WAV decode/encode: PCM 16/24/32-bit and float32/64 <-> planar float32.

Host-side replacement for the reference's file-format layer
(L0 in SURVEY.md section 1): JUCE ``AudioFormatManager``/``WavAudioFormat``
(Source/MainComponent.cpp:13,718-742,784-801) and ``AVAudioFile``
(Services/AudioProcessingService.swift:145-149,303-332).  Output default is
24-bit PCM WAV, the reference's write format (Source/MainComponent.cpp:784-791).

All sample conversion is vectorised NumPy (3-byte 24-bit pack/unpack via byte
matrix tricks); arrays are planar ``(channels, frames)`` float32, the device
layout.  Interleaving exists only at the container boundary, mirroring the
reference's planar<->interleaved marshalling (CAAudioBridge.swift:555-624).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

__all__ = ["AudioFileInfo", "probe_wav", "read_wav", "write_wav", "write_wav_codes"]

_RIFF = b"RIFF"
_WAVE = b"WAVE"
_FMT = b"fmt "
_DATA = b"data"
_RF64 = b"RF64"
_BW64 = b"BW64"     # EBU Tech 3306 alias of RF64
_DS64 = b"ds64"
_JUNK = b"JUNK"
_RIFF_MAGICS = (_RIFF, _RF64, _BW64)
_SIZE_SENTINEL = 0xFFFFFFFF   # 32-bit size fields of an RF64 file hold this;
# real 64-bit sizes live in the ds64 chunk (EBU Tech 3306, what JUCE's
# WavAudioFormat emits transparently — the behaviour the reference relies on,
# Source/MainComponent.cpp:784-801)
_DS64_SLOT = 36               # ds64/JUNK chunk bytes: 8 header + 28 payload
WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE
# KSDATAFORMAT_SUBTYPE_* GUID = <format tag as first 4 LE bytes> + fixed tail
_GUID_TAIL = b"\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
#: standard dwChannelMask speaker layouts by channel count (quad, 5.0, 5.1,
#: 6.1, 7.1); other counts get 0 = "positions unspecified", which is legal
#: and what MCFX-style discrete-bus deliverables want
_SPEAKER_MASKS = {3: 0x7, 4: 0x33, 5: 0x37, 6: 0x3F, 7: 0x70F, 8: 0x63F}


@dataclasses.dataclass(frozen=True)
class AudioFileInfo:
    """File metadata, the equivalent of the reference's ``AudioFile`` metadata
    load (Models/AudioFile.swift:11-50; Source/AppState.h:114-176)."""

    path: str
    sample_rate: int
    num_channels: int
    num_frames: int
    bit_depth: int
    is_float: bool
    container: str  # "wav" | "aiff"
    byte_order: str = "little"   # payload endianness ("little" | "big")

    @property
    def duration_seconds(self) -> float:
        return self.num_frames / self.sample_rate if self.sample_rate else 0.0

    def is_valid_for_rate(self, session_rate: float, tolerance: float = 1.0) -> bool:
        """Sample-rate validation, ±1 Hz (Source/AppState.h:137-141;
        Models/AudioFile.swift:31-34)."""
        return abs(self.sample_rate - session_rate) <= tolerance


def _parse_wav(buf: memoryview, path: str):
    if bytes(buf[0:4]) not in _RIFF_MAGICS or bytes(buf[8:12]) != _WAVE:
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = None
    data_off = data_size = None
    ds64_data = None
    pos = 12
    end = len(buf)
    try:
        while pos + 8 <= end:
            cid = bytes(buf[pos : pos + 4])
            (size,) = struct.unpack_from("<I", buf, pos + 4)
            off = pos + 8
            if cid == _DS64 and size >= 28:
                _riff64, ds64_data, _samples = struct.unpack_from("<QQQ", buf, off)
            elif cid == _FMT:
                tag, channels, rate, _, block_align, bits = struct.unpack_from("<HHIIHH", buf, off)
                if tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    (sub,) = struct.unpack_from("<H", buf, off + 24)
                    tag = sub
                if channels < 1:
                    raise ValueError(
                        f"{path}: malformed fmt ({channels} channels)")
                fmt = (tag, channels, rate, block_align, bits)
            elif cid == _DATA:
                if size == _SIZE_SENTINEL and ds64_data is not None:
                    size = ds64_data   # RF64: real 64-bit size from ds64
                data_off, data_size = off, size  # declared size (file may
                # extend beyond this buffer; callers clamp to what they hold)
                if fmt is not None:
                    # FIRST data chunk after fmt, exactly like the seek-based
                    # scanner — on a malformed double-data file, read_wav and
                    # WavReader/probe must decode the SAME chunk
                    break
            pos = off + size + (size & 1)
    except struct.error as e:
        raise ValueError(f"{path}: truncated or malformed header ({e})")
    if fmt is None or data_off is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data_off, data_size


def _scan_wav_header(f, path: str):
    """Seek-based chunk walk: returns (fmt_tuple, data_offset, data_size)
    without reading chunk payloads, so metadata chunks of any size (e.g.
    Broadcast-WAV 'bext') before 'data' are skipped correctly."""
    head = f.read(12)
    if len(head) < 12 or head[0:4] not in _RIFF_MAGICS or head[8:12] != _WAVE:
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    fmt = None
    data_off = data_size = None
    ds64_data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid = hdr[0:4]
        (size,) = struct.unpack("<I", hdr[4:8])
        pos = f.tell()
        try:
            if cid == _DS64 and size >= 28:
                payload = f.read(24)
                _riff64, ds64_data, _samples = struct.unpack("<QQQ", payload)
            elif cid == _FMT:
                payload = f.read(min(size, 64))
                tag, channels, rate, _, block_align, bits = struct.unpack_from(
                    "<HHIIHH", payload, 0)
                if tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    (sub,) = struct.unpack_from("<H", payload, 24)
                    tag = sub
                if channels < 1:
                    raise ValueError(
                        f"{path}: malformed fmt ({channels} channels)")
                fmt = (tag, channels, rate, block_align, bits)
        except struct.error as e:
            raise ValueError(f"{path}: truncated or malformed header ({e})")
        if cid == _DATA:
            if size == _SIZE_SENTINEL and ds64_data is not None:
                size = ds64_data   # RF64: real 64-bit size from ds64
            data_off, data_size = pos, size
            if fmt is not None:
                break
        f.seek(pos + size + (size & 1))
    if fmt is None or data_off is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data_off, data_size


def _seek_kept_chunks(path: str, magics: tuple, keep: tuple,
                      big_endian: bool, max_bytes: int) -> list:
    """Seek-based metadata collection shared by the WAV and AIFF readers:
    reads only the 8-byte chunk headers plus the kept payloads — the input
    may be bigger than RAM (the streaming path's constant-memory contract),
    so the file is NEVER slurped whole."""
    fmt = ">I" if big_endian else "<I"
    out = []
    ds64_data = None
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[0:4] not in magics[0] \
                or head[8:12] not in magics[1]:
            raise ValueError(f"{path}: not a {magics[2]} file")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid = hdr[0:4]
            (size,) = struct.unpack(fmt, hdr[4:8])
            pos = f.tell()
            if not big_endian and cid == _DS64 and size >= 28:
                _r, ds64_data, _s = struct.unpack("<QQQ", f.read(24))
            elif not big_endian and cid == _DATA \
                    and size == _SIZE_SENTINEL and ds64_data is not None:
                size = ds64_data  # RF64: walk past the >4 GiB data chunk
            elif cid in keep and size <= max_bytes:
                payload = f.read(size)
                if len(payload) == size:
                    out.append((cid, payload))
            f.seek(pos + size + (size & 1))
    return out


def _append_chunks_generic(path: str, chunks: list, big_endian: bool) -> None:
    """Append metadata chunks and patch the container size (RIFF or FORM);
    truncates back to the original, valid file on a mid-write failure."""
    if not chunks:
        return
    fmt = ">I" if big_endian else "<I"
    with open(path, "r+b") as f:
        f.seek(0)
        magic = f.read(4)
        rf64 = (not big_endian) and magic in (_RF64, _BW64)
        f.seek(0, 2)
        end0 = f.tell()
        try:
            if end0 & 1:
                f.write(b"\x00")
            for cid, payload in chunks:
                f.write(cid + struct.pack(fmt, len(payload)) + payload)
                if len(payload) & 1:
                    f.write(b"\x00")
            total = f.tell()
            if rf64:
                # the 32-bit RIFF size stays at the sentinel; the real size is
                # the ds64 riffSize (first chunk after WAVE per EBU Tech 3306)
                f.seek(12)
                if f.read(4) == _DS64:
                    f.seek(20)
                    f.write(struct.pack("<Q", total - 8))
            else:
                f.seek(4)
                f.write(struct.pack(fmt, total - 8))
        except (OSError, struct.error):
            # struct.error: the patched container size no longer fits 32
            # bits (non-RF64 file near 4 GiB) — restore, same as an IO fault
            f.truncate(end0)     # restore a valid file (metadata dropped)
            raise


def read_extra_chunks(path: str, max_bytes: int = 1 << 24) -> list:
    """Metadata chunks worth carrying through processing (Broadcast-WAV
    'bext', 'LIST'/INFO, 'cue ', 'smpl', 'iXML', 'axml', 'ID3 '), as
    ``[(chunk_id: bytes, payload: bytes), ...]`` in file order.  Oversized
    chunks (> max_bytes) are skipped — they are almost certainly corrupt
    sizes, and a bad size must not buffer gigabytes.  Seek-based: safe on
    files bigger than RAM."""
    keep = (b"bext", b"LIST", b"cue ", b"smpl", b"iXML", b"axml", b"ID3 ",
            b"_PMX")
    return _seek_kept_chunks(path, (_RIFF_MAGICS, (_WAVE,), "RIFF/WAVE"),
                             keep, False, max_bytes)


def scale_metadata_chunks(chunks: list, rate_in: int, rate_out: int) -> list:
    """Rescale the sample-indexed fields of carried metadata to the output
    rate: 'cue ' point positions/offsets, 'smpl' sample period + loop
    bounds, and the Broadcast-WAV 'bext' TimeReference.  Everything else
    passes verbatim; malformed structures pass verbatim too (best effort —
    no worse than an un-scaled copy)."""
    if rate_in == rate_out:
        return chunks

    def s(v: int) -> int:
        return int(round(v * rate_out / rate_in)) & 0xFFFFFFFF

    out = []
    for cid, payload in chunks:
        try:
            if cid == b"cue " and len(payload) >= 4:
                (n,) = struct.unpack_from("<I", payload, 0)
                b = bytearray(payload)
                for i in range(n):
                    base = 4 + 24 * i
                    if base + 24 > len(b):
                        break
                    pos, = struct.unpack_from("<I", b, base + 4)
                    off, = struct.unpack_from("<I", b, base + 20)
                    struct.pack_into("<I", b, base + 4, s(pos))
                    struct.pack_into("<I", b, base + 20, s(off))
                payload = bytes(b)
            elif cid == b"smpl" and len(payload) >= 36:
                b = bytearray(payload)
                struct.pack_into("<I", b, 8, int(round(1e9 / rate_out)))
                (n_loops,) = struct.unpack_from("<I", b, 28)
                for i in range(n_loops):
                    base = 36 + 24 * i
                    if base + 24 > len(b):
                        break
                    lo, = struct.unpack_from("<I", b, base + 8)
                    hi, = struct.unpack_from("<I", b, base + 12)
                    struct.pack_into("<I", b, base + 8, s(lo))
                    struct.pack_into("<I", b, base + 12, s(hi))
                payload = bytes(b)
            elif cid == b"bext" and len(payload) >= 346:
                b = bytearray(payload)
                (tref,) = struct.unpack_from("<Q", b, 338)
                struct.pack_into("<Q", b, 338,
                                 int(round(tref * rate_out / rate_in)))
                payload = bytes(b)
            elif cid == b"LIST" and payload[:4] == b"adtl":
                # region lengths live in adtl/ltxt dwSampleLength (offset 4
                # of the ltxt body) — rescale them so carried regions stay
                # consistent with the rescaled cue points
                b = bytearray(payload)
                pos = 4
                while pos + 8 <= len(b):
                    sid = bytes(b[pos : pos + 4])
                    (ssz,) = struct.unpack_from("<I", b, pos + 4)
                    if sid == b"ltxt" and ssz >= 8 and pos + 16 <= len(b):
                        (slen,) = struct.unpack_from("<I", b, pos + 12)
                        struct.pack_into("<I", b, pos + 12, s(slen))
                    pos += 8 + ssz + (ssz & 1)
                payload = bytes(b)
        except struct.error:
            pass
        out.append((cid, payload))
    return out


def append_chunks(path: str, chunks: list) -> None:
    """Append metadata chunks to an existing WAV and patch the RIFF size
    (chunk order after 'data' is legal RIFF; every mainstream reader walks
    chunks).  On any mid-write failure the file is truncated back to its
    original, valid length before the error propagates."""
    _append_chunks_generic(path, chunks, big_endian=False)


def probe_wav(path: str) -> AudioFileInfo:
    """Metadata without decoding samples (seek-based; metadata chunks of any
    size before 'data' are fine)."""
    with open(path, "rb") as f:
        (tag, channels, rate, _block_align, bits), off, size = _scan_wav_header(f, path)
        actual = max(0, os.fstat(f.fileno()).st_size - off)
    data_size = min(size, actual)
    bytes_per = max(1, bits // 8) * max(1, channels)
    return AudioFileInfo(
        path=path,
        sample_rate=rate,
        num_channels=channels,
        num_frames=data_size // bytes_per,
        bit_depth=bits,
        is_float=(tag == WAVE_FORMAT_IEEE_FLOAT),
        container="wav",
    )


def _unpack24(raw: np.ndarray) -> np.ndarray:
    """(n*3,) uint8 little-endian -> (n,) int32, sign-extended, vectorised.
    A trailing partial sample (truncated file) is dropped, matching the
    native path."""
    b = raw[: len(raw) // 3 * 3].reshape(-1, 3).astype(np.uint32)
    v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
    return (v.astype(np.int32) << 8) >> 8


def _pack24(codes: np.ndarray) -> np.ndarray:
    """(n,) int32 -> (n*3,) uint8 little-endian."""
    v = codes.astype(np.uint32)
    out = np.empty((len(v), 3), np.uint8)
    out[:, 0] = v & 0xFF
    out[:, 1] = (v >> 8) & 0xFF
    out[:, 2] = (v >> 16) & 0xFF
    return out.reshape(-1)


def _unpack24_dispatch(data: np.ndarray) -> np.ndarray:
    """24-bit bytes -> float32, via the C++ hot loop when available
    (f9tpu_torch.native; the JUCE sample-conversion role, SURVEY.md section 2.3)."""
    from .. import native

    if native.available():
        return native.unpack24_to_f32(data)
    return _unpack24(data).astype(np.float32) / 8388608.0


def _pack24_dispatch(codes: np.ndarray) -> np.ndarray:
    from .. import native

    if native.available():
        return native.pack24_from_i32(codes)
    return _pack24(codes)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Decode to planar float32 ``(channels, frames)`` in [-1, 1) + rate."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = memoryview(raw)
    (tag, channels, rate, block_align, bits), off, size = _parse_wav(buf, path)
    data = np.frombuffer(raw, np.uint8, count=min(size, len(raw) - off), offset=off)
    count = len(data)
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        dt = "<f4" if bits == 32 else "<f8"
        w = np.dtype(dt).itemsize
        with np.errstate(over="ignore"):  # corrupt float payloads overflow f32
            x = np.nan_to_num(
                np.frombuffer(raw, dt, count=count // w, offset=off)
                .astype(np.float32), posinf=0.0, neginf=0.0)
    elif tag == WAVE_FORMAT_PCM:
        # zero-copy views into the file buffer (tobytes() would copy the
        # whole payload an extra time on the hot decode path)
        if bits == 16:
            x = np.frombuffer(raw, "<i2", count=count // 2, offset=off).astype(np.float32) / 32768.0
        elif bits == 24:
            x = _unpack24_dispatch(data)
        elif bits == 32:
            x = np.frombuffer(raw, "<i4", count=count // 4, offset=off).astype(np.float32) / 2147483648.0
        elif bits == 8:
            x = (np.frombuffer(raw, np.uint8, count=count, offset=off).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported WAVE format tag {tag}")
    frames = len(x) // channels
    return np.ascontiguousarray(x[: frames * channels].reshape(frames, channels).T), rate


def _fmt_chunk(channels: int, rate: int, bits: int, is_float: bool) -> bytes:
    """The fmt chunk (id + size + body).  >2 channels emit
    WAVE_FORMAT_EXTENSIBLE with a standard speaker mask — what JUCE writes
    for the MCFX multichannel deliverables the reference targets
    (Docs/MultiChannel MCFX with JUCE.md:85-163); mono and
    stereo stay plain PCM/float for maximum compatibility."""
    bytes_per_frame = channels * (bits // 8)
    tag = WAVE_FORMAT_IEEE_FLOAT if is_float else WAVE_FORMAT_PCM
    base = struct.pack("<HHIIHH", tag, channels, rate,
                       rate * bytes_per_frame, bytes_per_frame, bits)
    if channels <= 2:
        return _FMT + struct.pack("<I", 16) + base
    mask = _SPEAKER_MASKS.get(channels, 0)
    head = struct.pack("<HHIIHH", WAVE_FORMAT_EXTENSIBLE, channels, rate,
                       rate * bytes_per_frame, bytes_per_frame, bits)
    ext = struct.pack("<HHI", 22, bits, mask) + struct.pack("<I", tag) + _GUID_TAIL
    return _FMT + struct.pack("<I", 40) + head + ext


def _wav_header(num_frames: int, channels: int, rate: int, bits: int,
                is_float: bool, reserve_upgrade: bool = False) -> bytes:
    """WAV header up to and including the data chunk header.

    Auto-upgrades to RF64 (64-bit sizes in a ds64 chunk, 32-bit fields at
    the sentinel) whenever the RIFF sizes would overflow 32 bits — the
    transparent >4 GiB handling the reference gets from JUCE's WavAudioFormat
    (Source/MainComponent.cpp:784-801).  ``reserve_upgrade`` adds a 36-byte
    JUNK placeholder where ds64 would live, so an incremental writer can
    flip RIFF -> RF64 at close without moving the payload."""
    bytes_per_frame = channels * (bits // 8)
    data_size = num_frames * bytes_per_frame
    fmt_chunk = _fmt_chunk(channels, rate, bits, is_float)
    slot = _DS64_SLOT if reserve_upgrade else 0
    riff_size = 4 + slot + len(fmt_chunk) + 8 + data_size + (data_size & 1)
    rf64 = riff_size > _SIZE_SENTINEL or data_size >= _SIZE_SENTINEL
    if rf64 and not reserve_upgrade:
        riff_size += _DS64_SLOT
    if rf64:
        pre = (_DS64 + struct.pack("<I", 28)
               + struct.pack("<QQQI", riff_size, data_size, num_frames, 0))
        return (_RF64 + struct.pack("<I", _SIZE_SENTINEL) + _WAVE + pre
                + fmt_chunk + _DATA + struct.pack("<I", _SIZE_SENTINEL))
    pre = (_JUNK + struct.pack("<I", 28) + b"\x00" * 28) if reserve_upgrade else b""
    return (_RIFF + struct.pack("<I", riff_size) + _WAVE + pre
            + fmt_chunk + _DATA + struct.pack("<I", data_size))


def _codes_payload(inter: np.ndarray, bits: int) -> bytes:
    """Interleaved int32 codes -> little-endian PCM bytes (frame-local, so
    chunked conversion is byte-identical to one-shot)."""
    if bits == 24:
        return _pack24_dispatch(inter).tobytes()
    if bits == 16:
        return inter.astype("<i2").tobytes()
    if bits == 32:
        return inter.astype("<i4").tobytes()
    raise ValueError(f"unsupported bit depth {bits}")


def write_wav_codes(path: str, codes: np.ndarray, rate: int, bits: int = 24,
                    progress_cb=None, chunk_frames: int = 1 << 20) -> None:
    """Write pre-quantized signed PCM codes ``(channels, frames)`` int32.

    This is the fast path fed by the on-device TPDF dither + quantize
    (`f9tpu_torch.ops.dither`): the host only interleaves and packs bytes.

    ``progress_cb(done_fraction)``: when given, interleave/pack/write run in
    ``chunk_frames`` slices with a callback per slice — the batch scheduler's
    sub-file encode progress (the reference's throttled per-buffer progress,
    AudioProcessingService.swift:209-264).  Output bytes are identical to
    the one-shot form (packing is frame-local; the header knows ``frames``
    up front).
    """
    if bits not in (16, 24, 32):
        raise ValueError(f"unsupported bit depth {bits}")
    codes = np.asarray(codes)
    if codes.ndim == 1:
        codes = codes[None, :]
    channels, frames = codes.shape
    with open(path, "wb") as f:
        f.write(_wav_header(frames, channels, rate, bits, is_float=False))
        if progress_cb and frames:
            for s in range(0, frames, chunk_frames):
                e = min(frames, s + chunk_frames)
                inter = np.ascontiguousarray(codes[:, s:e].T).reshape(-1)
                f.write(_codes_payload(inter, bits))
                progress_cb(e / frames)
        else:
            inter = np.ascontiguousarray(codes.T).reshape(-1)
            f.write(_codes_payload(inter, bits))
        if (frames * channels * (bits // 8)) & 1:
            f.write(b"\x00")  # RIFF chunks are word-aligned


def write_wav(path: str, x: np.ndarray, rate: int, bits: int = 24) -> None:
    """Write planar float32 ``(channels, frames)`` (or mono ``(frames,)``).

    ``bits``: 16/24 integer PCM (round-to-nearest, the reference's behaviour —
    dithering happens on device via `ops.dither` + write_wav_codes) or 32 =
    IEEE float32.  For 32-bit *integer* PCM use `write_wav_codes(bits=32)`.
    """
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    if bits == 32:  # always float32 output (see docstring)
        channels, frames = x.shape
        inter = np.ascontiguousarray(x.T).reshape(-1)
        with open(path, "wb") as f:
            f.write(_wav_header(frames, channels, rate, 32, is_float=True))
            f.write(inter.astype("<f4").tobytes())
        return
    scale = float(1 << (bits - 1))
    codes = np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int32)
    write_wav_codes(path, codes, rate, bits=bits)


class WavReader:
    """Incremental frame reader (seek-based) for streaming hour-long files
    through fixed-size device chunks (SURVEY.md section 5 'long-context':
    block-based streaming, here with overlap-save halos)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (tag, channels, rate, _block_align, bits), off, size = _scan_wav_header(f, path)
        self._fmt = (tag, channels, rate, bits)
        self._data_off = off
        self.num_channels = channels
        self.sample_rate = rate
        self._bytes_per_frame = channels * (bits // 8)
        actual = max(0, os.path.getsize(path) - off)
        self.num_frames = min(size, actual) // self._bytes_per_frame
        self._f = open(path, "rb")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, start_frame: int, count: int) -> np.ndarray:
        """Planar float32 (channels, n) for frames [start, start+count) clipped
        to the file; shorter at EOF."""
        tag, channels, rate, bits = self._fmt
        start_frame = max(0, start_frame)
        count = max(0, min(count, self.num_frames - start_frame))
        if count == 0:
            return np.zeros((channels, 0), np.float32)
        self._f.seek(self._data_off + start_frame * self._bytes_per_frame)
        raw = self._f.read(count * self._bytes_per_frame)
        if tag == WAVE_FORMAT_IEEE_FLOAT:
            dt = "<f4" if bits == 32 else "<f8"
            with np.errstate(over="ignore"):
                x = np.nan_to_num(np.frombuffer(raw, dt).astype(np.float32),
                                  posinf=0.0, neginf=0.0)
        elif bits == 16:
            x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            x = _unpack24_dispatch(np.frombuffer(raw, np.uint8))
        elif bits == 32:
            x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:   # unsigned, offset-128 (same branch as read_wav)
            x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported bit depth {bits}")
        n = len(x) // channels
        return np.ascontiguousarray(x[: n * channels].reshape(n, channels).T)

    def raw_wire(self) -> tuple[int, bool] | None:
        """``(bits, big_endian)`` when this file's payload can ride the raw
        H2D upload wire (integer PCM 16/24 — what
        `f9tpu_torch.ops.devcodec.unpack_pcm_interleaved` decodes), else None."""
        tag, _, _, bits = self._fmt
        if tag != WAVE_FORMAT_IEEE_FLOAT and bits in (16, 24):
            return bits, False
        return None

    def read_raw(self, start_frame: int, count: int) -> np.ndarray:
        """Interleaved payload bytes (uint8) for frames [start, start+count)
        clipped to the file — the raw upload wire (`raw_wire` must be
        non-None).  Whole frames only; shorter at EOF."""
        if self.raw_wire() is None:
            raise ValueError(f"{self.path}: not an integer-PCM 16/24 payload")
        start_frame = max(0, start_frame)
        count = max(0, min(count, self.num_frames - start_frame))
        if count == 0:
            return np.zeros(0, np.uint8)
        self._f.seek(self._data_off + start_frame * self._bytes_per_frame)
        raw = np.frombuffer(self._f.read(count * self._bytes_per_frame),
                            np.uint8)
        bpf = self._bytes_per_frame
        return raw[: (len(raw) // bpf) * bpf]


class WavWriter:
    """Incremental 16/24/32-bit PCM writer; the header is patched on close.

    A 36-byte JUNK placeholder after the RIFF header reserves the ds64 slot:
    when the finished stream exceeds 32-bit RIFF sizes, close() flips the
    container to RF64 in place (EBU Tech 3306) instead of corrupting the
    header — hour-long 8-ch/192 k outputs just work, as they do through
    JUCE's writer in the reference (Source/MainComponent.cpp:784-801)."""

    def __init__(self, path: str, channels: int, rate: int, bits: int = 24):
        if bits not in (16, 24, 32):
            # validate BEFORE opening: a post-open failure would leave a
            # header-only corpse claiming a bogus format at the output path
            raise ValueError(f"unsupported bit depth {bits}")
        self.path = path
        self.channels = channels
        self.rate = rate
        self.bits = bits
        self.frames_written = 0
        self._f = open(path, "wb")
        self._f.write(_wav_header(0, channels, rate, bits, is_float=False,
                                  reserve_upgrade=True))

    def append_codes(self, codes: np.ndarray) -> None:
        """(channels, n) int32 PCM codes."""
        codes = np.asarray(codes, np.int32)
        inter = np.ascontiguousarray(codes.T).reshape(-1)
        if self.bits == 24:
            self._f.write(_pack24_dispatch(inter).tobytes())
        elif self.bits == 16:
            self._f.write(inter.astype("<i2").tobytes())
        elif self.bits == 32:
            self._f.write(inter.astype("<i4").tobytes())
        else:
            raise ValueError(f"unsupported bit depth {self.bits}")
        self.frames_written += codes.shape[1]

    def append_payload(self, payload: np.ndarray) -> None:
        """Append a device-packed little-endian 24-bit interleaved payload
        (uint8, the wire format of `f9tpu_torch.ops.devcodec.pack24_interleaved`)
        — the WAV data chunk's exact byte layout, so this is one fwrite.
        The streaming download fast path: 3 bytes/sample over the link
        instead of int32's 4."""
        if self.bits != 24:
            raise ValueError("append_payload requires a 24-bit writer")
        payload = np.asarray(payload, np.uint8)
        bpf = self.channels * 3
        if payload.size % bpf:
            raise ValueError("payload length is not a whole number of frames")
        self._f.write(payload.tobytes())
        self.frames_written += payload.size // bpf

    def close(self) -> None:
        data_size = self.frames_written * self.channels * (self.bits // 8)
        if data_size & 1:
            self._f.seek(0, 2)
            self._f.write(b"\x00")  # RIFF word alignment
        self._f.seek(0)
        # same byte length whether this resolves to RIFF+JUNK or RF64+ds64,
        # so the payload written after the initial header stays in place
        self._f.write(_wav_header(self.frames_written, self.channels, self.rate,
                                  self.bits, is_float=False,
                                  reserve_upgrade=True))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_raw_pcm(path: str) -> tuple[np.ndarray, AudioFileInfo]:
    """Raw interleaved PCM payload bytes (uint8) + metadata, without sample
    conversion — the upload format for the on-device codec
    (`f9tpu_torch.ops.devcodec`).  Only integer PCM WAV."""
    info = probe_wav(path)
    if info.is_float or info.bit_depth not in (16, 24):
        raise ValueError(f"{path}: raw path supports 16/24-bit integer PCM only")
    with open(path, "rb") as f:
        (_, channels, _, _, bits), off, size = _scan_wav_header(f, path)
        bpf = channels * (bits // 8)
        want = info.num_frames * bpf
        f.seek(off)
        raw = np.frombuffer(f.read(want), np.uint8)
    return raw, info


def write_wav_payload(path: str, payload: np.ndarray, channels: int, rate: int,
                      bits: int = 24, progress_cb=None,
                      chunk_frames: int = 1 << 20) -> None:
    """Write a pre-packed interleaved PCM payload (uint8, the download format
    of `f9tpu_torch.ops.devcodec.pack24_interleaved`) after a WAV header.

    ``progress_cb(done_fraction)``: chunked fwrite with per-slice callbacks
    (sub-file encode progress; bytes identical to the one-shot form)."""
    bpf = channels * (bits // 8)
    frames = len(payload) // bpf
    if len(payload) != frames * bpf:
        # whole frames only (the AIFF twin raises too): stray tail bytes
        # would sit between the declared data chunk and the pad, where a
        # later metadata append/walk would parse them as a chunk header
        raise ValueError(
            f"payload of {len(payload)} bytes is not whole "
            f"{channels}-channel {bits}-bit frames")
    data = np.ascontiguousarray(payload)
    with open(path, "wb") as f:
        f.write(_wav_header(frames, channels, rate, bits, is_float=False))
        if progress_cb and frames:
            for s in range(0, frames, chunk_frames):
                e = min(frames, s + chunk_frames)
                f.write(data[s * bpf: e * bpf].tobytes())
                progress_cb(e / frames)
        else:
            f.write(data.tobytes())
        if (frames * bpf) & 1:
            f.write(b"\x00")
