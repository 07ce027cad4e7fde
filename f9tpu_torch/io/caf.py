"""CAF (Core Audio Format) container — ALAC and LPCM payloads, read only.

The reference's Swift shell accepts anything ``AVAudioFile`` reads
(_Swift Code/F9-Batch-Resampler/Models/AudioFile.swift:38);
CAF is Apple's native container for both PCM and Apple Lossless.  f9tpu
reads both payloads: ``lpcm`` decodes inline (int 16/24/32 and float
32/64, either endianness), ``alac`` routes packets through
``io/alac.py``.  Writing CAF is intentionally absent (deliverables are
WAV/AIFF/FLAC).

Layout (Apple CAF spec): ``caff`` file header, then chunks of
``(4-byte type, int64 size, payload)``:

  * ``desc`` — AudioStreamBasicDescription (big-endian: float64 sample
    rate, format id, format flags, bytes/packet, frames/packet,
    channels, bits);
  * ``kuki`` — codec magic cookie (the ALAC config);
  * ``pakt`` — packet table: int64 packet count, int64 valid frames,
    int32 priming, int32 remainder, then VLQ (7-bit big-endian) packet
    byte sizes for variable-rate codecs;
  * ``data`` — uint32 edit count + audio bytes (size may be -1:
    rest-of-file).
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

from .alac import AlacDecoder, AlacError
from .wav import AudioFileInfo

__all__ = ["CafError", "probe_caf", "read_caf", "CafReader"]


class CafError(ValueError):
    """Malformed or unsupported CAF data."""


_LPCM_FLAG_FLOAT = 1
_LPCM_FLAG_LITTLE = 2


def _element_frame_count(head: bytes, frames_per_packet: int) -> int:
    """Frame count of an ALAC packet from its FIRST element header alone
    (3 elem + 4 tag + 12 reserved + 1 has_size + 2 shift + 1 escape
    [+ 32 count]) — no entropy decode needed."""
    if len(head) < 8:
        return frames_per_packet
    v = int.from_bytes(head[:8], "big")          # 64 bits, MSB-first
    elem = v >> 61                               # 3 bits
    if elem == 7:                                # END: empty packet
        return 0
    # 4 tag + 12 reserved consumed -> has_size at bit 44; then 2 shift
    # bits + 1 escape bit -> the 32-bit count occupies bits 40..9
    if not ((v >> 44) & 1):
        return frames_per_packet
    return (v >> 9) & 0xFFFFFFFF


@dataclasses.dataclass
class _CafStream:
    rate: int
    format_id: str
    format_flags: int
    bytes_per_packet: int
    frames_per_packet: int
    channels: int
    bits: int
    cookie: bytes | None
    data_off: int              # first audio byte (after the edit count)
    data_len: int
    packet_sizes: list | None  # ALAC: per-packet byte sizes
    valid_frames: int
    priming: int


def _parse(path: str) -> _CafStream:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        hdr = f.read(8)
        if hdr[:4] != b"caff":
            raise CafError(f"{path}: not a CAF file")
        desc = None
        cookie = None
        data_off = data_len = None
        pakt = None
        pos = 8
        while pos + 12 <= size:
            f.seek(pos)
            head = f.read(12)
            if len(head) < 12:
                break
            ctype = head[:4]
            (clen,) = struct.unpack(">q", head[4:12])
            body_off = pos + 12
            if clen == -1:                       # rest of file (data only)
                clen = size - body_off
            if body_off + clen > size:
                raise CafError(f"{path}: truncated '{ctype.decode(errors='replace')}' chunk")
            if ctype == b"desc":
                body = f.read(32)
                if len(body) < 32:
                    raise CafError(f"{path}: truncated desc chunk")
                (rate, fid, flags, bpp, fpp, ch, bits) = struct.unpack(
                    ">dIIIIII", body)
                desc = (rate, fid, flags, bpp, fpp, ch, bits)
            elif ctype == b"kuki":
                cookie = f.read(clen)
            elif ctype == b"pakt":
                body = f.read(clen)
                if len(body) < 24:
                    raise CafError(f"{path}: truncated pakt chunk")
                n_pkts, valid, priming, remainder = struct.unpack_from(
                    ">qqii", body, 0)
                sizes = []
                p = 24
                for _ in range(n_pkts):
                    v = 0
                    while True:
                        if p >= len(body):
                            raise CafError(f"{path}: truncated packet table")
                        b = body[p]
                        p += 1
                        v = (v << 7) | (b & 0x7F)
                        if not (b & 0x80):
                            break
                    sizes.append(v)
                pakt = (sizes, valid, priming, remainder)
            elif ctype == b"data":
                if clen < 4:
                    raise CafError(f"{path}: data chunk too short")
                data_off = body_off + 4          # skip the edit count
                data_len = clen - 4
            pos = body_off + clen
        if desc is None or data_off is None:
            raise CafError(f"{path}: missing desc or data chunk")
        rate, fid, flags, bpp, fpp, ch, bits = desc
        fid_s = struct.pack(">I", fid).decode("latin1")
        if fid_s == "lpcm":
            valid = data_len // bpp if bpp else 0
            return _CafStream(int(round(rate)), fid_s, flags, bpp, fpp, ch,
                              bits, None, data_off, data_len, None,
                              valid, 0)
        if fid_s == "alac":
            if cookie is None:
                raise CafError(f"{path}: ALAC without a kuki cookie")
            if pakt is None:
                raise CafError(f"{path}: ALAC without a packet table")
            sizes, valid, priming, _rem = pakt
            # the authoritative length comes from the BITSTREAM: the last
            # packet's has_size element header carries the partial count
            # (some muxers — ffmpeg's CAF writer among them — put
            # packets*frames_per_packet in mNumberValidFrames)
            if sizes:
                f.seek(data_off + sum(sizes[:-1]))
                head = f.read(min(sizes[-1], 16))
                last = _element_frame_count(head, fpp)
                derived = fpp * (len(sizes) - 1) + last - priming
                valid = min(valid, derived) if valid > 0 else derived
            return _CafStream(int(round(rate)), fid_s, flags, bpp, fpp, ch,
                              bits, cookie, data_off, data_len, sizes,
                              valid, priming)
        raise CafError(
            f"{path}: unsupported CAF codec '{fid_s}' (lpcm/alac only)")


def _lpcm_dtype(s: _CafStream):
    le = bool(s.format_flags & _LPCM_FLAG_LITTLE)
    if s.format_flags & _LPCM_FLAG_FLOAT:
        if s.bits == 32:
            return np.dtype("<f4" if le else ">f4"), None
        if s.bits == 64:
            return np.dtype("<f8" if le else ">f8"), None
        raise CafError(f"unsupported CAF float width {s.bits}")
    if s.bits in (16, 32):
        return np.dtype(("<i2" if le else ">i2") if s.bits == 16
                        else ("<i4" if le else ">i4")), 1 << (s.bits - 1)
    if s.bits == 24:
        return None, 1 << 23                     # 3-byte path
    raise CafError(f"unsupported CAF PCM width {s.bits}")


def _lpcm_decode(s: _CafStream, raw: bytes) -> np.ndarray:
    """Interleaved LPCM bytes -> planar float32 (channels, frames)."""
    ch = s.channels
    if s.bits == 24 and not (s.format_flags & _LPCM_FLAG_FLOAT):
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if s.format_flags & _LPCM_FLAG_LITTLE:
            v = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
        else:
            v = ((b[:, 0].astype(np.int32) << 16)
                 | (b[:, 1].astype(np.int32) << 8) | b[:, 2].astype(np.int32))
        v = (v << 8) >> 8                        # sign extend
        x = v.astype(np.float32) / (1 << 23)
    else:
        dt, scale = _lpcm_dtype(s)
        v = np.frombuffer(raw, dt)
        x = (v.astype(np.float32) / scale if scale
             else v.astype(np.float32))
    return np.ascontiguousarray(x.reshape(-1, ch).T)


def probe_caf(path: str) -> AudioFileInfo:
    s = _parse(path)
    return AudioFileInfo(
        path=path, sample_rate=s.rate, num_channels=s.channels,
        num_frames=s.valid_frames,
        bit_depth=(s.bits if s.format_id == "lpcm"
                   else AlacDecoder(s.cookie).cfg.bit_depth),
        is_float=bool(s.format_id == "lpcm"
                      and s.format_flags & _LPCM_FLAG_FLOAT),
        container="caf",
        byte_order=("little" if s.format_id == "lpcm"
                    and s.format_flags & _LPCM_FLAG_LITTLE else "big"))


def read_caf(path: str) -> tuple[np.ndarray, int]:
    """Decode a whole CAF file to planar float32 + rate."""
    with CafReader(path) as r:
        return r.read(0, r.num_frames), r.sample_rate


class CafReader:
    """Incremental frame reader with the `WavReader.read(start, count)`
    contract.  ALAC packets are independent frames indexed by the packet
    table, so random access is exact and O(1) per packet; LPCM seeks are
    raw byte offsets."""

    def __init__(self, path: str):
        self.path = path
        self._s = _parse(path)
        s = self._s
        self.sample_rate = s.rate
        self.num_channels = s.channels
        self.num_frames = s.valid_frames
        self._f = open(path, "rb")
        self._alac = None
        self._cache: tuple[int, np.ndarray] | None = None
        if s.format_id == "alac":
            self._alac = AlacDecoder(s.cookie)
            self.bits = self._alac.cfg.bit_depth
            self._scale = np.float32(1 << (self.bits - 1))
            # packet byte offsets (cumulative)
            offs = [s.data_off]
            for sz in s.packet_sizes:
                offs.append(offs[-1] + sz)
            if offs[-1] - s.data_off > s.data_len:
                raise CafError(f"{path}: packet table exceeds data chunk")
            self._pkt_off = offs
        else:
            self.bits = s.bits

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _alac_packet(self, p: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == p:
            return self._cache[1]
        s = self._s
        self._f.seek(self._pkt_off[p])
        data = self._f.read(s.packet_sizes[p])
        try:
            codes = self._alac.decode_packet(data)
        except AlacError as e:
            raise CafError(f"{self.path}: packet {p}: {e}") from None
        x = codes.astype(np.float32) / self._scale
        self._cache = (p, x)
        return x

    def read(self, start: int, count: int) -> np.ndarray:
        start = max(0, int(start))
        count = max(0, min(int(count), self.num_frames - start))
        ch = self.num_channels
        if count == 0:
            return np.zeros((ch, 0), np.float32)
        s = self._s
        if self._alac is None:
            bpf = s.bytes_per_packet
            self._f.seek(s.data_off + start * bpf)
            raw = self._f.read(count * bpf)
            if len(raw) < count * bpf:
                raise CafError(f"{self.path}: truncated data chunk")
            return _lpcm_decode(s, raw)
        fpp = s.frames_per_packet
        first = (start + s.priming) // fpp
        out = np.zeros((ch, count), np.float32)
        got = 0
        p = first
        while got < count and p < len(s.packet_sizes):
            x = self._alac_packet(p)
            p0 = p * fpp - s.priming             # stream pos of packet start
            lo = start + got - p0
            take = min(x.shape[1] - lo, count - got)
            if take <= 0:
                raise CafError(f"{self.path}: packet {p} shorter than the "
                               "packet table implies")
            out[:, got:got + take] = x[:, lo:lo + take]
            got += take
            p += 1
        if got < count:
            raise CafError(f"{self.path}: stream ends early "
                           f"({got}/{count} frames)")
        return out
