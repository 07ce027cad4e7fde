"""FLAC codec (native, no external libraries): a spec-complete decoder
(RFC 9639) and a fixed-predictor encoder.

Reference parity: the reference's format layer registers JUCE's *basic*
formats — WAV, AIFF, **FLAC**, Ogg Vorbis (`Source/MainComponent.cpp:13`,
`Source/AppState.h:153`, ``registerBasicFormats()``) — and the Swift
capture app reads anything ``AVAudioFile`` accepts
(`Models/AudioFile.swift:38`), so a user of the reference can drop FLAC
sources straight into the batch list.  f9tpu matches that surface here:

- **Decoder** (`probe_flac` / `read_flac` / `FlacReader`): every subframe
  type (CONSTANT, VERBATIM, FIXED 0-4, LPC 1-32), both residual methods
  (RICE / RICE2) including escaped raw partitions, wasted bits, all four
  channel assignments (independent, left/side, right/side, mid/side),
  variable and fixed blocking, 8/12/16/20/24/32-bit, CRC-8 header and
  CRC-16 frame verification, STREAMINFO MD5 verification on full reads.
- **Encoder** (`write_flac` / `write_flac_codes` / `FlacWriter`): fixed
  predictors 0-4 with per-partition rice parameters (escape fallback),
  stereo decorrelation, constant-subframe detection, wasted-bits
  detection, streaminfo MD5 — a valid, genuinely compressing subset
  (the decoder accepts the full spec; the encoder emits the part of it
  that covers lossless delivery of dithered PCM).

The hot frame loop has a native C++ twin (`f9tpu_torch.native.flac_decode_*`);
this module is the readable, spec-shaped form and the parity oracle for
it.  Ogg Vorbis (the one other basic format) is perceptual-lossy — out
of scope for a mastering pipeline; `f9tpu_torch.io.codec` rejects it with an
actionable message rather than silently ignoring the file.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import struct

import numpy as np

__all__ = [
    "probe_flac", "read_flac", "read_flac_codes", "FlacReader",
    "write_flac", "write_flac_codes", "FlacWriter", "StreamInfo",
]

_MAGIC = b"fLaC"
_SYNC = 0x3FFE            # 14-bit frame sync
_BLOCK_STREAMINFO = 0

# frame-header lookup tables (RFC 9639 section 9.1)
_BLOCKSIZE_CODE = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
                   256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                   8192: 13, 16384: 14, 32768: 15}
_RATE_CODE = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5,
              22050: 6, 24000: 7, 32000: 8, 44100: 9, 48000: 10,
              96000: 11}
_RATE_FROM_CODE = {v: k for k, v in _RATE_CODE.items()}
_SSIZE_CODE = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_SSIZE_FROM_CODE = {v: k for k, v in _SSIZE_CODE.items()}


def _crc_table(poly: int, width: int) -> list[int]:
    top, mask = 1 << (width - 1), (1 << width) - 1
    table = []
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table.append(c & mask)
    return table


_CRC8_T = _crc_table(0x07, 8)      # x^8 + x^2 + x + 1, init 0
_CRC16_T = _crc_table(0x8005, 16)  # x^16 + x^15 + x^2 + 1, init 0


def _crc8(data) -> int:
    c = 0
    for b in data:
        c = _CRC8_T[c ^ b]
    return c


def _crc16(data, c: int = 0) -> int:
    t = _CRC16_T
    for b in data:
        c = ((c << 8) & 0xFFFF) ^ t[(c >> 8) ^ b]
    return c


# --------------------------------------------------------------------------
# bit-level IO
# --------------------------------------------------------------------------

class _BitReader:
    """MSB-first bit reader over an in-memory buffer.  Read methods raise
    EOFError past the end — every malformed-length path lands there, so
    callers translate one exception type into 'truncated/corrupt'."""

    __slots__ = ("d", "bitpos", "nbits")

    def __init__(self, data, bytepos: int = 0):
        self.d = data
        self.bitpos = bytepos * 8
        self.nbits = len(data) * 8

    @property
    def bytepos(self) -> int:
        return self.bitpos >> 3

    def read(self, nbits: int) -> int:
        p = self.bitpos
        q = p + nbits
        if q > self.nbits:
            raise EOFError("flac: truncated stream")
        self.bitpos = q
        first, last = p >> 3, (q + 7) >> 3
        v = int.from_bytes(self.d[first:last], "big")
        v >>= (last << 3) - q
        return v & ((1 << nbits) - 1)

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        return v - (1 << nbits) if nbits and (v >> (nbits - 1)) else v

    def unary(self) -> int:
        """Count of 0 bits before the next 1 bit (consumes the 1)."""
        d, p = self.d, self.bitpos
        i = p >> 3
        if i >= len(d):
            raise EOFError("flac: truncated stream")
        byte = d[i] & (0xFF >> (p & 7))
        if byte:
            z = (7 - (byte.bit_length() - 1)) - (p & 7)
            self.bitpos = p + z + 1
            return z
        count = 8 - (p & 7)
        i += 1
        while i < len(d) and d[i] == 0:
            count += 8
            i += 1
        if i >= len(d):
            raise EOFError("flac: truncated stream")
        z = count + (7 - (d[i].bit_length() - 1))
        self.bitpos = p + z + 1
        return z

    def align(self) -> None:
        self.bitpos = (self.bitpos + 7) & ~7


class _BitWriter:
    __slots__ = ("buf", "acc", "nb")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nb = 0

    def write(self, v: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | (v & ((1 << nbits) - 1))
        nb = self.nb + nbits
        while nb >= 8:
            nb -= 8
            self.buf.append((self.acc >> nb) & 0xFF)
        self.acc &= (1 << nb) - 1
        self.nb = nb

    def write_signed(self, v: int, nbits: int) -> None:
        self.write(v & ((1 << nbits) - 1), nbits)

    def align(self) -> None:
        if self.nb:
            self.write(0, 8 - self.nb)

    def getvalue(self) -> bytes:
        assert self.nb == 0
        return bytes(self.buf)


def _utf8_coded(n: int) -> bytes:
    """FLAC's UTF-8-style coded number (extended to 36 bits, RFC 9639
    section 9.1.5) for frame/sample numbers."""
    if n < 0x80:
        return bytes([n])
    out = []
    for total in range(2, 8):
        # payload bits of a `total`-byte form: 7-total lead bits + 6/cont.
        payload = 6 * (total - 1) + (7 - total if total < 7 else 0)
        if n < (1 << payload):
            lead = (0xFF << (8 - total)) & 0xFF if total < 7 else 0xFE
            shift = 6 * (total - 1)
            first = lead | (n >> shift) if total < 7 else lead
            out.append(first)
            for i in range(total - 2, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError(f"flac: coded number {n} exceeds 36 bits")


def _read_utf8_num(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    extra = 0
    mask = 0x40
    while b0 & mask:
        extra += 1
        mask >>= 1
    if extra < 1 or extra > 6:
        raise ValueError("flac: invalid coded number")
    n = b0 & (mask - 1)
    for _ in range(extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("flac: invalid coded-number continuation")
        n = (n << 6) | (b & 0x3F)
    return n


# --------------------------------------------------------------------------
# metadata
# --------------------------------------------------------------------------

class StreamInfo:
    __slots__ = ("min_block", "max_block", "min_frame", "max_frame",
                 "sample_rate", "channels", "bits", "total_samples", "md5",
                 "first_frame_offset", "seekpoints")

    def __init__(self, min_block, max_block, min_frame, max_frame,
                 sample_rate, channels, bits, total_samples, md5,
                 first_frame_offset, seekpoints=None):
        self.min_block = min_block
        self.max_block = max_block
        self.min_frame = min_frame
        self.max_frame = max_frame
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.total_samples = total_samples
        self.md5 = md5
        self.first_frame_offset = first_frame_offset
        #: [(first_sample, byte_offset_from_first_frame), ...] from a
        #: SEEKTABLE block (placeholder points skipped)
        self.seekpoints = seekpoints or []


def _pack_streaminfo_simple(si: StreamInfo) -> bytes:
    """34-byte STREAMINFO body (RFC 9639 section 8.2)."""
    b = bytearray()
    b += struct.pack(">HH", si.min_block, si.max_block)
    b += si.min_frame.to_bytes(3, "big")
    b += si.max_frame.to_bytes(3, "big")
    # 20-bit rate | 3-bit channels-1 | 5-bit bits-1 | 36-bit total = 64 bits
    v = (si.sample_rate << 44) | ((si.channels - 1) << 41) \
        | ((si.bits - 1) << 36) | (si.total_samples & ((1 << 36) - 1))
    b += v.to_bytes(8, "big")
    b += si.md5
    return bytes(b)


def _parse_streaminfo(body: bytes, first_frame_offset: int) -> StreamInfo:
    if len(body) < 34:
        raise ValueError("flac: STREAMINFO too short")
    min_block, max_block = struct.unpack_from(">HH", body, 0)
    min_frame = int.from_bytes(body[4:7], "big")
    max_frame = int.from_bytes(body[7:10], "big")
    v = int.from_bytes(body[10:18], "big")
    rate = v >> 44
    channels = ((v >> 41) & 0x7) + 1
    bits = ((v >> 36) & 0x1F) + 1
    total = v & ((1 << 36) - 1)
    md5 = body[18:34]
    if rate == 0:
        raise ValueError("flac: sample rate 0 in STREAMINFO")
    return StreamInfo(min_block, max_block, min_frame, max_frame,
                      rate, channels, bits, total, md5, first_frame_offset)


def _scan_metadata(f, path: str) -> StreamInfo:
    head = f.read(4)
    if head[:3] == b"ID3":           # skip an ID3v2 tag some taggers prepend
        rest = f.read(6)
        if len(rest) < 6:
            raise ValueError(f"{path}: truncated ID3 header")
        size = ((rest[2] & 0x7F) << 21) | ((rest[3] & 0x7F) << 14) \
            | ((rest[4] & 0x7F) << 7) | (rest[5] & 0x7F)
        f.seek(size, os.SEEK_CUR)
        head = f.read(4)
    if head != _MAGIC:
        raise ValueError(f"{path}: not a FLAC file")
    si = None
    seekpoints: list[tuple[int, int]] = []
    while True:
        hdr = f.read(4)
        if len(hdr) < 4:
            raise ValueError(f"{path}: truncated metadata")
        last = bool(hdr[0] & 0x80)
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        if btype == _BLOCK_STREAMINFO:
            body = f.read(size)
            si = _parse_streaminfo(body, 0)
        elif btype == 3 and size % 18 == 0:      # SEEKTABLE
            body = f.read(size)
            if len(body) != size:
                raise ValueError(f"{path}: truncated metadata")
            for off in range(0, size, 18):
                sample, byte_off, _span = struct.unpack_from(">QQH", body, off)
                if sample != 0xFFFFFFFFFFFFFFFF:  # skip placeholders
                    seekpoints.append((sample, byte_off))
        else:
            f.seek(size, os.SEEK_CUR)
        if last:
            break
    if si is None:
        raise ValueError(f"{path}: missing STREAMINFO")
    si.first_frame_offset = f.tell()
    si.seekpoints = seekpoints
    return si


# --------------------------------------------------------------------------
# frame decode
# --------------------------------------------------------------------------

def _decode_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise ValueError("flac: reserved residual method")
    pbits = 4 + method
    escape = (1 << pbits) - 1
    po = br.read(4)
    nparts = 1 << po
    if blocksize % nparts or (blocksize >> po) <= order and nparts > 1:
        # (blocksize >> po) == order is legal only when it makes the first
        # partition empty with po == 0 handled below; reject impossible splits
        if blocksize % nparts:
            raise ValueError("flac: partition order does not divide blocksize")
    psize = blocksize >> po
    if psize <= order and po > 0:
        raise ValueError("flac: first partition would be negative")
    out = np.empty(blocksize - order, np.int64)
    pos = 0
    unary, read = br.unary, br.read
    for p in range(nparts):
        cnt = psize - (order if p == 0 else 0)
        if cnt < 0:
            raise ValueError("flac: negative partition size")
        param = read(pbits)
        if param == escape:
            nb = read(5)
            if nb == 0:
                out[pos:pos + cnt] = 0
            else:
                sign = 1 << (nb - 1)
                full = 1 << nb
                for i in range(cnt):
                    v = read(nb)
                    out[pos + i] = v - full if v & sign else v
        else:
            k = param
            for i in range(cnt):
                q = unary()
                v = (q << k) | read(k) if k else q
                out[pos + i] = (v >> 1) ^ -(v & 1)
        pos += cnt
    return out


def _restore_fixed(order: int, warm: list[int], res: np.ndarray) -> np.ndarray:
    if order == 0:
        return res.astype(np.int64)
    # the residual is the order-th forward difference; invert by repeated
    # prefix-summing, seeding each level with the warmup's difference pyramid
    levels = [np.asarray(warm, np.int64)]
    for _ in range(order):
        levels.append(np.diff(levels[-1]))
    cur = res.astype(np.int64)
    for k in range(order - 1, -1, -1):
        cur = levels[k][-1] + np.cumsum(cur)
    return np.concatenate([levels[0], cur])


def _restore_lpc(warm: list[int], coefs: list[int], shift: int,
                 res: np.ndarray) -> np.ndarray:
    o = len(coefs)
    n = o + len(res)
    x = [0] * n
    x[:o] = [int(v) for v in warm]
    rl = res.tolist()
    c = coefs
    lim = 1 << 40               # valid samples fit 33 bits; corrupt LPC
    for i in range(o, n):       # params otherwise grow unbounded bignums
        acc = 0
        base = i - 1
        for j in range(o):
            acc += c[j] * x[base - j]
        v = (acc >> shift) + rl[i - o]
        if not -lim <= v <= lim:
            raise ValueError("flac: LPC sample out of range (corrupt stream)")
        x[i] = v
    return np.array(x, np.int64)


def _decode_subframe(br: _BitReader, n: int, bps: int) -> np.ndarray:
    if br.read(1):
        raise ValueError("flac: subframe padding bit set")
    t = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.unary() + 1
    eb = bps - wasted
    if eb <= 0:
        raise ValueError("flac: wasted bits exceed sample size")
    if t == 0:
        x = np.full(n, br.read_signed(eb), np.int64)
    elif t == 1:
        x = np.fromiter((br.read_signed(eb) for _ in range(n)),
                        np.int64, count=n)
    elif 8 <= t <= 12:
        order = t - 8
        if order > n:
            raise ValueError("flac: predictor order exceeds blocksize")
        warm = [br.read_signed(eb) for _ in range(order)]
        x = _restore_fixed(order, warm, _decode_residual(br, n, order))
    elif t >= 32:
        order = (t & 31) + 1
        if order > n:
            raise ValueError("flac: predictor order exceeds blocksize")
        warm = [br.read_signed(eb) for _ in range(order)]
        prec = br.read(4) + 1
        if prec == 16:
            raise ValueError("flac: invalid qlp precision code")
        shift = br.read_signed(5)
        if shift < 0:
            raise ValueError("flac: negative qlp shift")
        coefs = [br.read_signed(prec) for _ in range(order)]
        x = _restore_lpc(warm, coefs, shift, _decode_residual(br, n, order))
    else:
        raise ValueError(f"flac: reserved subframe type {t}")
    return x << wasted if wasted else x


class _Frame:
    __slots__ = ("number", "variable", "blocksize", "rate", "bits",
                 "samples", "header_end")

    def __init__(self, number, variable, blocksize, rate, bits, samples):
        self.number = number
        self.variable = variable
        self.blocksize = blocksize
        self.rate = rate
        self.bits = bits
        self.samples = samples      # (channels, blocksize) int64, decorrelated


def _decode_frame(br: _BitReader, si: StreamInfo) -> _Frame:
    """One frame at the current (byte-aligned) position.  Verifies CRC-8
    and CRC-16 (RFC 9639 sections 9.1.8 / 9.3)."""
    start = br.bytepos
    if br.read(14) != _SYNC:
        raise ValueError("flac: lost frame sync")
    if br.read(1):
        raise ValueError("flac: reserved frame-header bit")
    variable = bool(br.read(1))
    bs_code = br.read(4)
    sr_code = br.read(4)
    ch_code = br.read(4)
    ss_code = br.read(3)
    if br.read(1):
        raise ValueError("flac: reserved frame-header bit")
    number = _read_utf8_num(br)
    if bs_code == 0:
        raise ValueError("flac: reserved blocksize code")
    elif bs_code == 1:
        blocksize = 192
    elif bs_code <= 5:
        blocksize = 576 << (bs_code - 2)
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = 256 << (bs_code - 8)
    if blocksize > 65535:       # spec max; a code-7 header can claim 65536
        raise ValueError("flac: blocksize exceeds the 65535 spec maximum")
    if sr_code == 0:
        rate = si.sample_rate
    elif sr_code in _RATE_FROM_CODE:
        rate = _RATE_FROM_CODE[sr_code]
    elif sr_code == 12:
        rate = br.read(8) * 1000
    elif sr_code == 13:
        rate = br.read(16)
    elif sr_code == 14:
        rate = br.read(16) * 10
    else:
        raise ValueError("flac: invalid sample-rate code")
    if ss_code == 0:
        bits = si.bits
    elif ss_code in _SSIZE_FROM_CODE:
        bits = _SSIZE_FROM_CODE[ss_code]
    else:
        raise ValueError("flac: reserved sample-size code")
    crc_calc = _crc8(br.d[start:br.bytepos])
    if br.read(8) != crc_calc:
        raise ValueError("flac: frame header CRC-8 mismatch")

    if ch_code <= 7:
        nch = ch_code + 1
        chans = [_decode_subframe(br, blocksize, bits) for _ in range(nch)]
        samples = np.stack(chans)
    elif ch_code in (8, 9, 10):
        # stereo decorrelation: the side channel carries one extra bit
        a = _decode_subframe(br, blocksize, bits + (1 if ch_code == 9 else 0))
        b = _decode_subframe(br, blocksize, bits + (0 if ch_code == 9 else 1))
        if ch_code == 8:        # left/side
            left, right = a, a - b
        elif ch_code == 9:      # right/side (side first in the stream)
            left, right = a + b, b
        else:                   # mid/side
            side = b
            m2 = (a << 1) | (side & 1)
            left, right = (m2 + side) >> 1, (m2 - side) >> 1
        samples = np.stack([left, right])
    else:
        raise ValueError("flac: reserved channel assignment")
    br.align()
    crc16_calc = _crc16(br.d[start:br.bytepos])
    if br.read(16) != crc16_calc:
        raise ValueError("flac: frame CRC-16 mismatch")
    if samples.shape[0] != si.channels:
        raise ValueError("flac: frame channel count differs from STREAMINFO")
    return _Frame(number, variable, blocksize, rate, bits, samples)


def _md5_update(h, samples: np.ndarray, bits: int) -> None:
    """STREAMINFO MD5 runs over the original samples as interleaved
    little-endian signed integers, ceil(bits/8) bytes each (RFC 9639
    section 8.2)."""
    nbytes = (bits + 7) // 8
    inter = np.ascontiguousarray(samples.T).astype(np.int64)
    if nbytes == 1:
        h.update(inter.astype(np.int8).tobytes())
    elif nbytes == 2:
        h.update(inter.astype("<i2").tobytes())
    elif nbytes == 3:
        as4 = inter.astype("<i4").tobytes()
        buf = np.frombuffer(as4, np.uint8).reshape(-1, 4)
        h.update(np.ascontiguousarray(buf[:, :3]).tobytes())
    else:
        h.update(inter.astype("<i4").tobytes())


# --------------------------------------------------------------------------
# public decode API
# --------------------------------------------------------------------------

def probe_flac(path: str):
    """STREAMINFO metadata as an `AudioFileInfo` (container "flac").

    FLAC streams whose STREAMINFO reports 0 total samples (unknown length
    from a live capture) are rejected with an actionable message: every
    downstream consumer (bucketing, streaming grid, progress) needs the
    frame count up front, and finding it would cost a full decode."""
    from .wav import AudioFileInfo

    with open(path, "rb") as f:
        si = _scan_metadata(f, path)
    if si.total_samples == 0:
        raise ValueError(
            f"{path}: FLAC with unknown length (STREAMINFO total samples"
            " = 0); re-encode with a sample count to process it")
    return AudioFileInfo(path=path, sample_rate=si.sample_rate,
                         num_channels=si.channels,
                         num_frames=si.total_samples, bit_depth=si.bits,
                         is_float=False, container="flac",
                         byte_order="little")


def read_flac_codes(path: str, verify_md5: bool = True
                    ) -> tuple[np.ndarray, StreamInfo]:
    """Full decode to planar int64 codes (channels, frames) + StreamInfo.
    Verifies every frame's CRCs and (when the header carries one) the
    whole-stream MD5."""
    with open(path, "rb") as f:
        si = _scan_metadata(f, path)
        data = f.read()
    if si.total_samples == 0:
        raise ValueError(
            f"{path}: FLAC with unknown length (STREAMINFO total samples"
            " = 0); re-encode with a sample count to process it")
    codes = None
    try:
        from .. import native

        if getattr(native, "flac_available", lambda: False)():
            codes = native.flac_decode_all(data, si)
    except ImportError:
        pass
    if codes is None:
        codes = _py_decode_all(data, si, path)
    if verify_md5 and si.md5 != b"\x00" * 16:
        h = hashlib.md5()
        _md5_update(h, codes, si.bits)
        if h.digest() != si.md5:
            raise ValueError(f"{path}: FLAC MD5 mismatch (corrupt stream)")
    return codes, si


def _py_decode_all(data: bytes, si: StreamInfo, path: str) -> np.ndarray:
    br = _BitReader(data)
    out = np.empty((si.channels, si.total_samples), np.int64)
    done = 0
    try:
        while done < si.total_samples:
            fr = _decode_frame(br, si)
            take = min(fr.blocksize, si.total_samples - done)
            out[:, done:done + take] = fr.samples[:, :take]
            done += take
    except EOFError:
        raise ValueError(f"{path}: truncated FLAC stream "
                         f"({done}/{si.total_samples} samples)") from None
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return out


def read_flac(path: str) -> tuple[np.ndarray, int]:
    """Decode to planar float32 (channels, frames) in [-1, 1) + rate —
    the `read_audio` contract the WAV/AIFF readers share."""
    codes, si = read_flac_codes(path)
    scale = np.float32(1.0 / (1 << (si.bits - 1)))
    return codes.astype(np.float32) * scale, si.sample_rate


class FlacReader:
    """Incremental frame reader with the `WavReader.read(start, count)`
    contract (`f9tpu/io/wav.py:526`), so FLAC sources stream through the
    same fixed-size device chunks as WAV/AIFF.

    FLAC frames are bit-packed with data-dependent sizes, so random access
    needs decode state: the reader keeps a cursor (next sample, byte
    offset) plus an index of every frame boundary it has passed, and
    restarts from the nearest known boundary for backward seeks.  The
    streaming pipeline reads monotonically, which this serves with zero
    re-decode."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self._si = _scan_metadata(f, path)
        if self._si.total_samples == 0:
            raise ValueError(
                f"{path}: FLAC with unknown length (STREAMINFO total"
                " samples = 0); re-encode with a sample count")
        self.num_channels = self._si.channels
        self.sample_rate = self._si.sample_rate
        self.num_frames = self._si.total_samples
        self.bits = self._si.bits
        self._f = open(path, "rb")
        # (first_sample, byte_offset) for every frame boundary seen so far,
        # in increasing order; seeded with the first frame plus any
        # SEEKTABLE points (a wrong point surfaces as a loud sync error)
        self._index: list[tuple[int, int]] = [(0, self._si.first_frame_offset)]
        for sample, boff in sorted(self._si.seekpoints):
            if 0 < sample < self._si.total_samples:
                self._note_boundary(sample,
                                    self._si.first_frame_offset + boff)
        self._cur_sample = 0
        self._cur_off = self._si.first_frame_offset
        self._buf: bytes = b""          # undecoded tail of the last read
        self._buf_off = self._si.first_frame_offset
        self._fsize = os.path.getsize(path)
        self._native = None             # lazy tri-state: None/module/False
        #: (first_sample, codes) of the last decoded span: reads smaller than
        #: a FLAC block would otherwise re-decode the SAME frame every call
        #: (the cursor has moved past them, which reads as a backward seek)
        self._cache: tuple[int, np.ndarray] | None = None

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _seek_to(self, sample: int) -> None:
        """Position the cursor on the best known frame boundary <= sample:
        backward seeks restart there; forward seeks JUMP there when it
        beats decoding ahead from the cursor (seek points make far first
        reads O(interval), not O(file))."""
        lo, hi = 0, len(self._index)
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if self._index[mid][0] <= sample:
                lo = mid
            else:
                hi = mid
        best_s, best_off = self._index[lo]
        if sample < self._cur_sample or best_s > self._cur_sample:
            self._cur_sample, self._cur_off = best_s, best_off
            self._buf = b""
            self._buf_off = self._cur_off

    def _fill(self, need_bytes: int) -> None:
        have = len(self._buf) - (self._cur_off - self._buf_off)
        if have >= need_bytes:
            return
        self._f.seek(self._buf_off + len(self._buf))
        more = self._f.read(max(need_bytes - have, 1 << 20))
        self._buf += more

    def _note_boundary(self, sample: int, off: int) -> None:
        # sorted insert: pre-seeded seek points mean boundaries discovered
        # by sequential decode land BETWEEN existing entries (the shifted
        # tail is at most the remaining seed points — cheap)
        i = bisect.bisect_left(self._index, (sample, -1))
        if i < len(self._index) and self._index[i][0] == sample:
            return
        self._index.insert(i, (sample, off))

    def _trim(self) -> None:
        """Drop buffered bytes behind the cursor so an hour-long stream
        read front-to-back holds O(MB), not the file."""
        drop = self._cur_off - self._buf_off
        if drop > (4 << 20):
            self._buf = self._buf[drop:]
            self._buf_off = self._cur_off

    def _native_mod(self):
        if self._native is None:
            try:
                from .. import native

                self._native = native if native.flac_available() else False
            except Exception:
                self._native = False
        return self._native

    def read_codes(self, start_frame: int, count: int) -> np.ndarray:
        """Planar int64 codes for frames [start, start+count) clipped to
        the file; shorter at EOF."""
        ch = self.num_channels
        start_frame = max(0, start_frame)
        count = max(0, min(count, self.num_frames - start_frame))
        if count == 0:
            return np.zeros((ch, 0), np.int64)
        if self._cache is not None:
            # serve (the head of) the window from the last decoded span:
            # sub-block monotonic reads hit here instead of re-decoding the
            # same frame once per call
            cs, cb = self._cache
            if cs <= start_frame < cs + cb.shape[1]:
                off = start_frame - cs
                take = min(count, cb.shape[1] - off)
                head = cb[:, off : off + take]
                if take == count:
                    return head.copy()
                rest = self.read_codes(start_frame + take, count - take)
                return np.concatenate([head, rest], axis=1)
        self._seek_to(start_frame)
        out = np.empty((ch, count), np.int64)
        filled = 0
        end = start_frame + count
        # decode whole frames from the cursor until the window is covered
        while self._cur_sample < end:
            fs = self._cur_sample
            block, consumed = self._decode_block(end - fs)
            m = block.shape[1]
            if m <= (1 << 20):  # bound cache memory for huge native batches
                self._cache = (fs, block)
            lo = max(fs, start_frame)
            hi = min(fs + m, end, self.num_frames)
            if hi > lo:
                out[:, lo - start_frame:hi - start_frame] = \
                    block[:, lo - fs:hi - fs]
                filled = max(filled, hi - start_frame)
            self._cur_sample = fs + m
            self._cur_off += consumed
            self._note_boundary(self._cur_sample, self._cur_off)
            self._trim()
            if self._cur_sample >= self.num_frames:
                break
        return np.ascontiguousarray(out[:, :filled])

    def read(self, start_frame: int, count: int) -> np.ndarray:
        codes = self.read_codes(start_frame, count)
        scale = np.float32(1.0 / (1 << (self.bits - 1)))
        return codes.astype(np.float32) * scale

    def raw_wire(self) -> tuple[int, bool] | None:
        """``(bits, big_endian)`` when this stream's samples can ride the
        raw H2D upload wire: decoded codes re-pack to the SAME
        interleaved little-endian payload an integer-PCM WAV ships, so
        FLAC input moves 2-3 B/sample over the link instead of float32's
        4 (the link is the stream bottleneck; the native frame decode at
        ~95x RT is not)."""
        if self.bits in (16, 24):
            return self.bits, False
        return None

    def read_raw(self, start_frame: int, count: int) -> np.ndarray:
        """Interleaved little-endian payload bytes (uint8) for frames
        [start, start+count) — the raw upload wire (`raw_wire` must be
        non-None).  Bitwise-identical floats after the on-device decode
        (power-of-two scaling both sides)."""
        if self.raw_wire() is None:
            raise ValueError(f"{self.path}: no raw wire for {self.bits}-bit")
        codes = self.read_codes(start_frame, count)
        return _pack_payload(codes, self.bits)

    def _decode_block(self, want: int) -> tuple[np.ndarray, int]:
        """>= 1 whole frame (natively: a batch covering `want` samples)
        starting at the cursor: (codes (ch, m), bytes consumed)."""
        native = self._native_mod()
        hint = self._si.max_frame or (1 << 20)
        need = max(hint + 64, 1 << 16)
        if native:
            need = max(need, min(want * self.num_channels * 4, 8 << 20))
        while True:
            self._fill(need)
            rel = self._cur_off - self._buf_off
            at_eof = self._buf_off + len(self._buf) >= self._fsize
            if native:
                window = memoryview(self._buf)[rel:]
                try:
                    codes, done, used, trunc = native.flac_decode_frames(
                        window, self.num_channels, self.bits, want,
                        partial_ok=True)
                except ValueError as e:
                    raise ValueError(f"{self.path}: {e}") from None
                if done:
                    # take the progress; a truncated tail frame is retried
                    # from its boundary on the next call with more bytes
                    return codes.astype(np.int64), used
                if not trunc or at_eof:
                    raise ValueError(f"{self.path}: truncated FLAC stream")
                need = (len(self._buf) - rel) * 2
                continue
            br = _BitReader(self._buf, rel)
            try:
                fr = _decode_frame(br, self._si)
                return fr.samples, br.bytepos - rel
            except EOFError:
                if at_eof:
                    raise ValueError(
                        f"{self.path}: truncated FLAC stream") from None
                need = (len(self._buf) - rel) * 2
            except ValueError as e:
                raise ValueError(f"{self.path}: {e}") from None


def _pack_payload(codes: np.ndarray, bits: int) -> np.ndarray:
    """Planar int codes -> interleaved little-endian payload bytes (the
    integer-PCM WAV data-chunk layout `f9tpu_torch.ops.devcodec` decodes)."""
    inter = np.ascontiguousarray(codes.T.astype(np.int32)).reshape(-1)
    if bits == 16:
        return inter.astype("<i2").view(np.uint8).copy()
    try:
        from .. import native

        if native.available():
            return native.pack24_from_i32(inter)
    except ImportError:
        pass
    b4 = inter.astype("<i4").view(np.uint8).reshape(-1, 4)
    return np.ascontiguousarray(b4[:, :3]).reshape(-1)


def read_raw_pcm_flac(path: str):
    """Raw interleaved payload bytes + metadata for the on-device codec —
    the FLAC arm of `codec.read_raw_pcm`.  FLAC has no raw payload in the
    container, so this decodes (native, ~95x RT) and re-packs to the WAV
    byte layout: the H2D link (the batch bottleneck) then carries
    2-3 B/sample instead of float32's 4, and the on-device decode yields
    bitwise the same floats as the host conversion."""
    codes, si = read_flac_codes(path)
    if si.bits not in (16, 24):
        raise ValueError(
            f"{path}: raw path supports 16/24-bit only (got {si.bits})")
    from .wav import AudioFileInfo

    info = AudioFileInfo(path=path, sample_rate=si.sample_rate,
                         num_channels=si.channels,
                         num_frames=si.total_samples, bit_depth=si.bits,
                         is_float=False, container="flac",
                         byte_order="little")
    return _pack_payload(codes, si.bits), info


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------

_DEFAULT_BLOCK = 4096
#: SEEKTABLE placeholder point (sample number all-ones; RFC 9639 sec. 8.5)
_PLACEHOLDER_POINT = b"\xFF" * 8 + b"\x00" * 10


def _zigzag(res: np.ndarray) -> np.ndarray:
    return (res << 1) ^ (res >> 63)


def _signed_bits(arr: np.ndarray) -> int:
    """Minimum two's-complement width holding every value in `arr`.

    Mirrors the native ``signed_bits_range`` (f9native.cpp) EXACTLY: a
    non-positive maximum contributes nothing (an all ``-2**k`` partition
    needs k+1 bits, not k+2 — e.g. all -1 fits one bit).  The two encoders'
    rice-vs-escape decisions hinge on this width, so any disagreement
    breaks the BIT-IDENTICAL invariant (round-4 advisor finding)."""
    if len(arr) == 0:
        return 1
    mx, mn = int(np.max(arr)), int(np.min(arr))
    need = mx.bit_length() + 1 if mx > 0 else 1
    if mn < 0:
        need = max(need, (~mn).bit_length() + 1)
    return need


def _rice_partition_cost(u: np.ndarray, k: int) -> int:
    return int(np.sum(u >> k)) + len(u) * (k + 1)


def _best_rice_k(u: np.ndarray) -> tuple[int, int]:
    """(k, bits) minimizing the exact rice cost for zigzagged values.
    Integer arithmetic only (the floor-mean seeds a +-3 window searched
    with exact costs) so the native C++ encoder can reproduce the choice
    bit-for-bit."""
    if len(u) == 0:
        return 0, 0
    mean_floor = int(np.sum(u)) // len(u)
    k0 = max(0, mean_floor.bit_length() - 1)
    best_k, best_c = 0, None
    for k in range(max(0, k0 - 2), min(30, k0 + 3) + 1):
        c = _rice_partition_cost(u, k)
        if best_c is None or c < best_c:
            best_k, best_c = k, c
    return best_k, best_c


def _encode_residual(bw: _BitWriter, res: np.ndarray, blocksize: int,
                     order: int) -> None:
    u = _zigzag(res.astype(np.int64))
    # pick a partition order: po in [0, 6] where 2^po divides the block and
    # the first partition stays non-empty, scored with EXACT bit counts
    # (deterministic integer math — the native C++ encoder mirrors this
    # search bit-for-bit)
    best = None
    for po in range(0, 7):
        nparts = 1 << po
        psize = blocksize >> po
        if po and (blocksize % nparts or psize <= order):
            continue
        ks = []
        pos = 0
        max_k = 0
        content = 0
        for p in range(nparts):
            cnt = psize - (order if p == 0 else 0)
            seg = u[pos:pos + cnt]
            k, c = _best_rice_k(seg)
            # escape when raw coding is cheaper (huge residuals); the raw
            # bit count field is 5 bits, so escapes only fit nb <= 31
            nb = _signed_bits(res[pos:pos + cnt]) if cnt else 1
            raw_c = 5 + cnt * nb
            if nb <= 31 and c > raw_c:
                ks.append((-1, nb))
                content += raw_c
            else:
                ks.append((k, 0))
                content += c
                max_k = max(max_k, k)
            pos += cnt
        method = 1 if max_k > 14 else 0
        total = 2 + 4 + (4 + method) * nparts + content
        if best is None or total < best[0]:
            best = (total, po, ks, method)
    assert best is not None
    _, po, ks, method = best
    pbits = 4 + method
    escape = (1 << pbits) - 1
    bw.write(method, 2)
    bw.write(po, 4)
    nparts = 1 << po
    psize = blocksize >> po
    pos = 0
    for p in range(nparts):
        cnt = psize - (order if p == 0 else 0)
        k, nb = ks[p]
        if k < 0:
            bw.write(escape, pbits)
            bw.write(nb, 5)
            seg = res[pos:pos + cnt]
            for v in seg.tolist():
                bw.write_signed(v, nb)
        else:
            bw.write(k, pbits)
            seg = u[pos:pos + cnt].tolist()
            if k:
                for v in seg:
                    q = v >> k
                    bw.write(1, q + 1)      # q zeros then a 1
                    bw.write(v & ((1 << k) - 1), k)
            else:
                for v in seg:
                    bw.write(1, v + 1)
        pos += cnt


def _fixed_residuals(x: np.ndarray) -> list[np.ndarray]:
    """Residuals for fixed orders 0..4 (order capped at len-1)."""
    out = [x]
    for _ in range(min(4, len(x) - 1)):
        out.append(np.diff(out[-1]))
    return out


def _pick_fixed_order(x: np.ndarray) -> tuple[int, np.ndarray]:
    diffs = _fixed_residuals(x)
    costs = [int(np.sum(np.abs(d))) if len(d) else 0 for d in diffs]
    best = min(range(len(diffs)), key=lambda o: costs[o])
    return best, diffs[best]


_LPC_PRECISION = 15        # qlp coefficient precision (libFLAC's default)
_LPC_ORDERS = (4, 8, 12, 16)   # candidate orders, scored by residual cost

#: apodization candidates (round 5): Welch (1 - d^2) plus the quartic
#: biweight ((1 - d^2)^2) — a stronger taper whose lower sidelobes win on
#: strongly tonal material, still pure arithmetic (the window set is
#: restricted to DETERMINISTIC POLYNOMIALS: libFLAC's Tukey needs libm
#: cos, whose last-ulp platform differences would break the
#: native/python bit-parity contract)
_LPC_WINDOWS = ("welch", "biweight")


def _windowed_autocorr(xs: list[int], max_lag: int,
                       window: str = "welch") -> list[float]:
    """Apodized float64 autocorrelation with a FIXED sequential summation
    order (mirrored 1:1 in C++; neither side permits FMA contraction or
    reduction reordering, so the doubles are bit-identical).  The window
    fixes the rectangular-autocorrelation leakage that made strong tones
    predict WORSE than fixed order 4 (measured: order-8 mean|res| 10270
    rectangular -> 832 Welch on a 3-tone block, matching the
    covariance-method least-squares optimum)."""
    n = len(xs)
    half = (n - 1) / 2.0
    wd = [0.0] * n
    if window == "welch":
        for i in range(n):
            d = (i - half) / half
            wd[i] = xs[i] * (1.0 - d * d)
    else:                                      # biweight (1 - d^2)^2
        for i in range(n):
            d = (i - half) / half
            t = 1.0 - d * d
            wd[i] = xs[i] * (t * t)
    out = []
    for k in range(max_lag + 1):
        acc = 0.0
        for i in range(n - k):
            acc += wd[i] * wd[i + k]
        out.append(acc)
    return out


def _levinson(r: list[float], max_order: int) -> list[tuple[list[float], float]]:
    """Levinson-Durbin in float64 with a FIXED operation order (mirrored
    1:1 in the C++ encoder; both sides compile/run without FMA
    contraction, so the doubles are bit-identical).  Returns
    [(coefs, err), ...] per order 1..max_order (stops early if err
    hits 0)."""
    out: list[tuple[list[float], float]] = []
    err = r[0]
    lpc: list[float] = []
    for i in range(max_order):
        if err <= 0.0:
            break
        acc = r[i + 1]
        for j in range(i):
            acc -= lpc[j] * r[i - j]
        k = acc / err
        lpc = [lpc[j] - k * lpc[i - 1 - j] for j in range(i)] + [k]
        err = err * (1.0 - k * k)
        out.append((lpc[:], err))
    return out


def _quantize_lpc(coefs: list[float], precision: int) -> tuple[list[int], int]:
    """(quantized coefs, shift): round-half-away with error feedback,
    shift clamped to the 5-bit field's [0, 15] (libFLAC's scheme, in a
    deterministic form mirrored by the C++ encoder)."""
    import math

    cmax = 0.0
    for c in coefs:
        a = -c if c < 0.0 else c
        if a > cmax:
            cmax = a
    if cmax <= 0.0:
        return [0] * len(coefs), 0
    _, e = math.frexp(cmax)          # 2^(e-1) <= cmax < 2^e
    shift = precision - 1 - e
    if shift > 15:
        shift = 15
    if shift < 0:
        shift = 0
    qmax = (1 << (precision - 1)) - 1
    qmin = -(1 << (precision - 1))
    q: list[int] = []
    ferr = 0.0
    scale = float(1 << shift)
    for c in coefs:
        v = c * scale + ferr
        qi = math.floor(v + 0.5)
        if qi > qmax:
            qi = qmax
        elif qi < qmin:
            qi = qmin
        ferr = v - qi
        q.append(int(qi))
    return q, shift


def _lpc_residual(xs: list[int], q: list[int], shift: int) -> list[int]:
    o = len(q)
    n = len(xs)
    res = [0] * (n - o)
    for i in range(o, n):
        acc = 0
        base = i - 1
        for j in range(o):
            acc += q[j] * xs[base - j]
        res[i - o] = xs[i] - (acc >> shift)
    return res


def _pick_lpc(xs: np.ndarray):
    """Best LPC candidate over the (window x order) sweep as
    (order, q, shift, res ndarray, cost) or None (degenerate/too short).
    Every decision is exact-integer or fixed-order float64, and the
    candidate iteration order (windows outer, orders inner, strict-<
    keeps the earlier winner) is part of the contract, so the C++ twin
    reproduces it bit-for-bit."""
    n = len(xs)
    max_order = max(o for o in _LPC_ORDERS)
    if n <= max_order * 2:
        return None
    xl = [int(v) for v in xs]
    best = None
    for window in _LPC_WINDOWS:
        rf = _windowed_autocorr(xl, max_order, window)
        if rf[0] == 0.0:
            continue
        per_order = _levinson(rf, max_order)
        for o in _LPC_ORDERS:
            if o > len(per_order):
                continue
            coefs, _err = per_order[o - 1]
            q, shift = _quantize_lpc(coefs, _LPC_PRECISION)
            if not any(q):
                continue
            res = _lpc_residual(xl, q, shift)
            cost = sum(v if v >= 0 else -v for v in res)
            if best is None or cost < best[4]:
                best = (o, q, shift, np.array(res, np.int64), cost)
    return best


def _wasted_bits(x: np.ndarray) -> int:
    acc = int(np.bitwise_or.reduce(x))
    if acc == 0:
        return 0
    w = (acc & -acc).bit_length() - 1
    return w


def _encode_subframe(bw: _BitWriter, x: np.ndarray, bps: int) -> None:
    n = len(x)
    x = x.astype(np.int64)
    if n and bool(np.all(x == x[0])):
        bw.write(0, 1)
        bw.write(0, 6)          # CONSTANT
        bw.write(0, 1)
        bw.write_signed(int(x[0]), bps)
        return
    wasted = _wasted_bits(x)
    # cap: the shifted samples must still fit and leave >= 1 bit
    wasted = min(wasted, bps - 1)
    eb = bps - wasted
    xs = x >> wasted if wasted else x
    order, res = _pick_fixed_order(xs)
    fcost = int(np.sum(np.abs(res)))
    lpc = _pick_lpc(xs)
    if lpc is not None and lpc[4] < fcost:
        lorder, q, shift, lres, _ = lpc
        bw.write(0, 1)
        bw.write(32 + (lorder - 1), 6)  # LPC
        if wasted:
            bw.write(1, 1)
            bw.write(1, wasted)
        else:
            bw.write(0, 1)
        for v in xs[:lorder].tolist():
            bw.write_signed(v, eb)
        bw.write(_LPC_PRECISION - 1, 4)
        bw.write_signed(shift, 5)
        for c in q:
            bw.write_signed(c, _LPC_PRECISION)
        _encode_residual(bw, lres, n, lorder)
        return
    bw.write(0, 1)
    bw.write(8 + order, 6)      # FIXED
    if wasted:
        bw.write(1, 1)
        bw.write(1, wasted)     # unary: (wasted-1) zeros then a 1
    else:
        bw.write(0, 1)
    for v in xs[:order].tolist():
        bw.write_signed(v, eb)
    _encode_residual(bw, res, n, order)


def _abs_cost(x: np.ndarray) -> int:
    _, res = _pick_fixed_order(x.astype(np.int64))
    return int(np.sum(np.abs(res)))


def _encode_frame(codes: np.ndarray, frame_no: int, si: StreamInfo,
                  nominal_block: int) -> bytes:
    """One frame (fixed blocking strategy).  `codes` is (channels, n)
    int-like; stereo picks the cheapest of the four channel assignments."""
    ch, n = codes.shape
    bw = _BitWriter()
    bw.write(_SYNC, 14)
    bw.write(0, 1)
    bw.write(0, 1)              # fixed blocking
    if n == nominal_block and n in _BLOCKSIZE_CODE:
        bs_code, bs_extra = _BLOCKSIZE_CODE[n], None
    elif n - 1 < 256:
        bs_code, bs_extra = 6, n - 1
    else:
        bs_code, bs_extra = 7, n - 1
    bw.write(bs_code, 4)
    sr_code = _RATE_CODE.get(si.sample_rate, 0)
    bw.write(sr_code, 4)

    x = codes.astype(np.int64)
    if ch == 2:
        left, right = x[0], x[1]
        side = left - right
        mid = (left + right) >> 1
        c_l, c_r = _abs_cost(left), _abs_cost(right)
        c_s, c_m = _abs_cost(side), _abs_cost(mid)
        options = {0x1: c_l + c_r, 0x8: c_l + c_s,
                   0x9: c_r + c_s, 0xA: c_m + c_s}
        ch_code = min(options, key=options.get)
    else:
        ch_code = ch - 1
    bw.write(ch_code, 4)
    bw.write(_SSIZE_CODE[si.bits], 3)
    bw.write(0, 1)
    for b in _utf8_coded(frame_no):
        bw.write(b, 8)
    if bs_extra is not None:
        bw.write(bs_extra, 8 if bs_code == 6 else 16)
    hdr = bytes(bw.buf)
    bw.write(_crc8(hdr), 8)

    if ch == 2 and ch_code >= 8:
        if ch_code == 8:
            _encode_subframe(bw, left, si.bits)
            _encode_subframe(bw, side, si.bits + 1)
        elif ch_code == 9:
            _encode_subframe(bw, side, si.bits + 1)
            _encode_subframe(bw, right, si.bits)
        else:
            _encode_subframe(bw, mid, si.bits)
            _encode_subframe(bw, side, si.bits + 1)
    else:
        for c in range(ch):
            _encode_subframe(bw, x[c], si.bits)
    bw.align()
    body = bytes(bw.buf)
    bw.write(_crc16(body), 16)
    return bw.getvalue()


class FlacWriter:
    """Incremental FLAC writer with the `WavWriter` contract
    (`f9tpu/io/wav.py:607`): open → `append_codes` / `append_payload` per
    block → `close` patches STREAMINFO (totals, frame-size bounds, MD5) in
    place — so both the batch encode worker and the streaming emitter can
    target FLAC without buffering the programme."""

    #: reserved seek points (placeholders filled at close); 128 x 18 bytes
    _SEEK_SLOTS = 128

    def __init__(self, path: str, channels: int, rate: int, bits: int = 24,
                 block: int = _DEFAULT_BLOCK, seek_interval_s: float = 10.0):
        if bits not in _SSIZE_CODE:
            raise ValueError(f"flac: unsupported bit depth {bits}")
        if not 1 <= channels <= 8:
            raise ValueError(f"flac: unsupported channel count {channels}")
        if not 16 <= block <= 65535:
            # the frame header's blocksize-minus-1 field is 16-bit and the
            # STREAMINFO spec minimum is 16: outside this range the masked
            # value would silently corrupt the stream (advisor finding)
            raise ValueError(f"flac: block size out of range [16, 65535]: "
                             f"{block}")
        self.path = path
        self.channels = channels
        self.rate = rate
        self.bits = bits
        self.frames_written = 0
        self._si = StreamInfo(block, block, 0, 0, rate, channels, bits, 0,
                              b"\x00" * 16, 0)
        self._block = block
        self._pend = np.zeros((channels, 0), np.int64)
        self._frame_no = 0
        self._total = 0
        self._minf, self._maxf = None, 0
        self._md5 = hashlib.md5()
        self._native = None             # lazy tri-state: None/module/False
        # seek table: collect (first_sample, byte_offset) every
        # ~seek_interval_s during emit; placeholders reserved now so close
        # fills them in place instead of splicing the whole file
        self._seek_spacing = max(int(seek_interval_s * rate), block)
        self._next_mark = 0
        self._seekpoints: list[tuple[int, int]] = []
        self._f = open(path, "wb")
        self._f.write(_MAGIC)
        self._f.write(bytes([_BLOCK_STREAMINFO]) + (34).to_bytes(3, "big"))
        self._si_off = self._f.tell()
        self._f.write(_pack_streaminfo_simple(self._si))
        self._f.write(bytes([0x80 | 3])
                      + (self._SEEK_SLOTS * 18).to_bytes(3, "big"))
        self._seek_off = self._f.tell()
        self._f.write(_PLACEHOLDER_POINT * self._SEEK_SLOTS)
        self._frames_start = self._f.tell()

    def _mark_frames(self, first_sample: int, lens) -> None:
        """Record seek points for a run of frames about to be written at
        the current file position (one per ~seek_interval)."""
        off = self._f.tell() - self._frames_start
        s = first_sample
        for fl in lens:
            if s >= self._next_mark:
                if len(self._seekpoints) >= self._SEEK_SLOTS:
                    # slots full: thin to every other point and double the
                    # spacing, so arbitrarily long streams keep an evenly
                    # spaced table instead of a 21-minute prefix
                    self._seekpoints = self._seekpoints[::2]
                    self._seek_spacing *= 2
                self._seekpoints.append((s, off))
                self._next_mark = s + self._seek_spacing
            off += int(fl)
            s += self._block

    def append_codes(self, codes: np.ndarray) -> None:
        """codes: planar (channels, n) integer samples (two's complement
        at the writer's bit depth)."""
        codes = np.asarray(codes)
        if codes.ndim != 2 or codes.shape[0] != self._si.channels:
            raise ValueError("flac: append expects planar (channels, n)")
        self.frames_written += codes.shape[1]
        cur = codes.astype(np.int64)
        B = self._block
        if self._pend.shape[1]:
            take = min(B - self._pend.shape[1], cur.shape[1])
            self._pend = np.concatenate([self._pend, cur[:, :take]], axis=1)
            cur = cur[:, take:]
            if self._pend.shape[1] == B:
                self._emit(self._pend)
                self._pend = self._pend[:, :0]
        # full blocks straight from the incoming array (no re-buffering)
        nfull = cur.shape[1] // B
        if nfull:
            self._emit_run(cur[:, :nfull * B])
        rest = cur[:, nfull * B:]
        if rest.shape[1]:
            self._pend = np.ascontiguousarray(rest)

    def append_payload(self, payload: np.ndarray) -> None:
        """Append a device-packed little-endian interleaved integer payload
        (uint8; 3 B/sample at 24 bit, 2 B at 16 — the wire format of
        `f9tpu_torch.ops.devcodec`), unpacked to planar codes on the host.  Lets
        FLAC output ride the same narrow D2H wire as WAV/AIFF."""
        if self.bits not in (16, 24):
            raise ValueError("append_payload requires a 16/24-bit writer")
        payload = np.asarray(payload, np.uint8)
        bps = self.bits // 8
        bpf = self.channels * bps
        if payload.size % bpf:
            raise ValueError("payload length is not a whole number of frames")
        if self.bits == 16:
            inter = payload.view("<i2").astype(np.int64)
        else:
            b = payload.reshape(-1, 3).astype(np.int64)
            v = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            inter = v - ((v & 0x800000) << 1)       # sign-extend 24 bit
        self.append_codes(
            np.ascontiguousarray(inter.reshape(-1, self.channels).T))

    def _native_mod(self):
        if self._native is None:
            try:
                from .. import native

                self._native = native if native.flac_available() else False
            except Exception:
                self._native = False
        return self._native

    def _emit_run(self, region: np.ndarray) -> None:
        """A run of FULL blocks: one multithreaded native encode when
        available (frames are independent, so bytes are identical to the
        sequential form at any thread count), else per-block emits."""
        B = self._block
        nfull = region.shape[1] // B
        native = self._native_mod()
        if not native or nfull <= 1:
            for i in range(nfull):
                self._emit(region[:, i * B:(i + 1) * B])
            return
        data, lens = native.flac_encode_frames_mt(
            region, self._si.bits, self._frame_no, B,
            self._si.sample_rate)
        self._mark_frames(self._total, lens)
        self._f.write(data)
        self._frame_no += nfull
        self._total += region.shape[1]
        self._md5_block(region)
        mn = int(lens.min())
        self._minf = mn if self._minf is None else min(self._minf, mn)
        self._maxf = max(self._maxf, int(lens.max()))

    def _emit(self, block: np.ndarray) -> None:
        native = self._native_mod()
        if native:
            frame = native.flac_encode_frame(block, self._si.bits,
                                             self._frame_no, self._block,
                                             self._si.sample_rate)
        else:
            frame = _encode_frame(block, self._frame_no, self._si,
                                  self._block)
        self._mark_frames(self._total, [len(frame)])
        self._f.write(frame)
        self._frame_no += 1
        self._total += block.shape[1]
        self._md5_block(block)
        fl = len(frame)
        self._minf = fl if self._minf is None else min(self._minf, fl)
        self._maxf = max(self._maxf, fl)

    def _md5_block(self, block: np.ndarray) -> None:
        _md5_update(self._md5, block, self._si.bits)

    def close(self) -> None:
        if self._f.closed:
            return
        if self._pend.shape[1]:
            self._emit(self._pend)
            self._pend = self._pend[:, :0]
        si = self._si
        si.total_samples = self._total
        si.min_frame = min(self._minf or 0, (1 << 24) - 1)
        si.max_frame = min(self._maxf, (1 << 24) - 1)
        si.md5 = self._md5.digest()
        self._f.seek(self._si_off)
        self._f.write(_pack_streaminfo_simple(si))
        self._f.seek(self._seek_off)
        for sample, off in self._seekpoints:
            span = min(self._block, self._total - sample)
            self._f.write(struct.pack(">QQH", sample, off, span))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_flac_codes(path: str, codes: np.ndarray, rate: int,
                     bits: int = 24, progress_cb=None,
                     chunk_frames: int = 1 << 20) -> None:
    """Planar integer codes -> FLAC file (the `write_wav_codes` twin,
    including the optional sub-file encode-progress callback)."""
    codes = np.asarray(codes)
    n = codes.shape[1]
    with FlacWriter(path, codes.shape[0], rate, bits=bits) as w:
        for pos in range(0, max(n, 1), chunk_frames):
            w.append_codes(codes[:, pos:pos + chunk_frames])
            if progress_cb:
                progress_cb(min(1.0, (pos + chunk_frames) / max(n, 1)))


def write_flac_payload(path: str, payload: np.ndarray, channels: int,
                       rate: int, bits: int = 24, progress_cb=None,
                       chunk_frames: int = 1 << 20) -> None:
    """Device-packed interleaved LE payload bytes -> FLAC file (the
    `write_wav_payload` twin for the narrow D2H wire)."""
    payload = np.asarray(payload, np.uint8)
    bpf = channels * (bits // 8)
    n = payload.size // bpf
    with FlacWriter(path, channels, rate, bits=bits) as w:
        for pos in range(0, max(n, 1), chunk_frames):
            w.append_payload(payload[pos * bpf:(pos + chunk_frames) * bpf])
            if progress_cb:
                progress_cb(min(1.0, (pos + chunk_frames) / max(n, 1)))


# metadata block types worth carrying through processing: APPLICATION,
# VORBIS_COMMENT (tags), PICTURE (cover art).  All position-free, so —
# unlike WAV cue/smpl or AIFF MARK — nothing needs rescaling to the
# output rate.  SEEKTABLE/CUESHEET hold sample positions for the OLD
# stream and are deliberately not carried.
_CARRY_BLOCK_TYPES = (2, 4, 6)


def read_extra_blocks_flac(path: str, max_bytes: int = 1 << 24
                           ) -> list[tuple[int, bytes]]:
    """Carryable metadata blocks as [(block_type, payload), ...] in file
    order (the FLAC twin of `wav.read_extra_chunks`).  Oversized blocks
    (> max_bytes) are skipped — almost certainly corrupt sizes."""
    out: list[tuple[int, bytes]] = []
    with open(path, "rb") as f:
        head = f.read(4)
        if head[:3] == b"ID3":
            rest = f.read(6)
            size = ((rest[2] & 0x7F) << 21) | ((rest[3] & 0x7F) << 14) \
                | ((rest[4] & 0x7F) << 7) | (rest[5] & 0x7F)
            f.seek(size, os.SEEK_CUR)
            head = f.read(4)
        if head != _MAGIC:
            raise ValueError(f"{path}: not a FLAC file")
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                raise ValueError(f"{path}: truncated metadata")
            last = bool(hdr[0] & 0x80)
            btype = hdr[0] & 0x7F
            size = int.from_bytes(hdr[1:4], "big")
            if btype in _CARRY_BLOCK_TYPES and size <= max_bytes:
                out.append((btype, f.read(size)))
            else:
                f.seek(size, os.SEEK_CUR)
            if last:
                break
    return out


def insert_blocks_flac(path: str, blocks: list[tuple[int, bytes]]) -> None:
    """Insert metadata blocks into an existing FLAC file's metadata chain
    (FLAC blocks precede the frames, so unlike RIFF/IFF appends this is a
    splice: head + blocks + frames into a sibling temp, then an atomic
    replace — the original stays valid on any failure)."""
    if not blocks:
        return
    with open(path, "rb") as f:
        si = _scan_metadata(f, path)
    tmp = f"{path}.meta-tmp-{os.getpid()}"
    try:
        with open(path, "rb") as src, open(tmp, "wb") as dst:
            head = src.read(si.first_frame_offset)
            # clear the is-last flag on the existing final metadata block:
            # walk the chain inside `head` to find it
            magic_off = 0
            if head[:3] == b"ID3":
                magic_off = 10 + (((head[6] & 0x7F) << 21)
                                  | ((head[7] & 0x7F) << 14)
                                  | ((head[8] & 0x7F) << 7)
                                  | (head[9] & 0x7F))
            if head[magic_off:magic_off + 4] != _MAGIC:
                raise ValueError(f"{path}: not a FLAC file")
            pos = magic_off + 4
            while True:
                flag = head[pos]
                size = int.from_bytes(head[pos + 1:pos + 4], "big")
                if flag & 0x80:
                    head = head[:pos] + bytes([flag & 0x7F]) + head[pos + 1:]
                    break
                pos += 4 + size
            dst.write(head)
            for i, (btype, payload) in enumerate(blocks):
                last = 0x80 if i == len(blocks) - 1 else 0
                dst.write(bytes([last | btype])
                          + len(payload).to_bytes(3, "big") + payload)
            while True:
                chunk = src.read(1 << 22)
                if not chunk:
                    break
                dst.write(chunk)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def write_flac(path: str, x: np.ndarray, rate: int, bits: int = 24) -> None:
    """Planar float32 in [-1, 1) -> FLAC, quantized by round-to-nearest
    with clip (the `write_wav` contract; callers wanting shaped dither
    quantize upstream and use `write_flac_codes`)."""
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[None, :]
    scale = float(1 << (bits - 1))
    codes = np.clip(np.round(x.astype(np.float64) * scale),
                    -scale, scale - 1).astype(np.int64)
    write_flac_codes(path, codes, rate, bits=bits)
