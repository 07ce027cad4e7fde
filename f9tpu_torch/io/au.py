"""Sun/NeXT .au (.snd) audio — read only.

The reference's Swift shell reads anything ``AVAudioFile`` accepts
(_Swift Code/F9-Batch-Resampler/Models/AudioFile.swift:38),
and Core Audio ships a Sun AU file reader; the format also still shows
up in legacy sample libraries.  Trivial container: a 24+ byte big-endian
header (magic ".snd", data offset, data size, encoding, rate, channels)
followed by interleaved big-endian samples.

Supported encodings: G.711 mu-law (1) and A-law (27), signed linear PCM
8/16/24/32 (2..5), IEEE float32/64 (6/7).  The G.711 expanders are the
exact ITU segment codecs, cross-checked sample-exact against libavcodec
in tests/test_au.py.  Integer-PCM payloads are big-endian interleaved —
the same wire AIFF uses — so 16/24-bit .au sources ride the on-device
raw codec through ``read_raw_pcm_au``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .wav import AudioFileInfo

__all__ = ["AuError", "probe_au", "read_au", "AuReader",
           "read_raw_pcm_au"]

_MAGIC = b".snd"

# encoding id -> (bytes per sample, kind)
_ENCODINGS = {
    1: (1, "ulaw"),
    2: (1, "int"),
    3: (2, "int"),
    4: (3, "int"),
    5: (4, "int"),
    6: (4, "f32"),
    7: (8, "f64"),
    27: (1, "alaw"),
}


class AuError(ValueError):
    """Malformed or unsupported .au data."""


def _g711_tables():
    """Exact ITU G.711 expanders to 16-bit codes (the segmented
    companding law, computed — not transcribed — from the segment
    structure; pinned against libavcodec's pcm_mulaw/pcm_alaw)."""
    ulaw = np.empty(256, np.int16)
    for b in range(256):
        u = ~b & 0xFF
        t = (((u & 0x0F) << 3) + 0x84) << ((u & 0x70) >> 4)
        ulaw[b] = (0x84 - t) if (u & 0x80) else (t - 0x84)
    alaw = np.empty(256, np.int16)
    for b in range(256):
        a = b ^ 0x55
        mant = a & 0x0F
        seg = (a & 0x70) >> 4
        if seg:
            t = ((mant << 1) + 33) << (seg + 2)
        else:
            t = ((mant << 1) + 1) << 3
        alaw[b] = t if (a & 0x80) else -t
    return ulaw, alaw


_ULAW16, _ALAW16 = _g711_tables()


def _parse_header(data: bytes, path: str):
    if len(data) < 24 or data[:4] != _MAGIC:
        raise AuError(f"{path}: not a Sun .au file (missing .snd magic)")
    off, size, enc, rate, ch = struct.unpack_from(">IIIII", data, 4)
    if off < 24 or off > len(data):
        raise AuError(f"{path}: bad data offset {off}")
    if enc not in _ENCODINGS:
        raise AuError(f"{path}: unsupported .au encoding {enc}")
    if not 1 <= ch <= 64 or not 1 <= rate <= 1_000_000:
        raise AuError(f"{path}: implausible channels/rate {ch}/{rate}")
    avail = len(data) - off
    nbytes = avail if size in (0, 0xFFFFFFFF) else min(size, avail)
    bps, kind = _ENCODINGS[enc]
    frames = nbytes // (bps * ch)
    return off, enc, rate, ch, frames


def _decode(payload: np.ndarray, enc: int, ch: int) -> np.ndarray:
    """Interleaved payload bytes -> planar float32 (channels, frames)."""
    bps, kind = _ENCODINGS[enc]
    n = payload.size // (bps * ch)
    payload = payload[: n * bps * ch]
    if kind == "ulaw":
        x = _ULAW16[payload].astype(np.float32) / 32768.0
    elif kind == "alaw":
        x = _ALAW16[payload].astype(np.float32) / 32768.0
    elif kind == "f32":
        x = payload.view(">f4").astype(np.float32)
    elif kind == "f64":
        x = payload.view(">f8").astype(np.float32)
    elif bps == 1:
        x = payload.view(np.int8).astype(np.float32) / 128.0
    elif bps == 2:
        x = payload.view(">i2").astype(np.float32) / 32768.0
    elif bps == 3:
        b = payload.reshape(-1, 3).astype(np.uint32)
        u = (b[:, 0] << 16) | (b[:, 1] << 8) | b[:, 2]
        v = u.astype(np.int32)
        v = np.where(v >= 1 << 23, v - (1 << 24), v)
        x = v.astype(np.float32) / 8388608.0
    else:
        x = payload.view(">i4").astype(np.float32) / 2147483648.0
    return np.ascontiguousarray(x.reshape(n, ch).T)


class AuReader:
    """Incremental frame reader with the `WavReader.read(start, count)`
    contract (all supported encodings are fixed-rate, so seeks are byte
    arithmetic)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(24)
        # the size field may be 0/0xFFFFFFFF (unknown); derive the frame
        # count from the on-disk size, clipped by the field when present
        fsize = os.path.getsize(path)
        if head[:4] != _MAGIC or len(head) < 24:
            raise AuError(f"{path}: not a Sun .au file (missing .snd magic)")
        off, size, enc, rate, ch = struct.unpack_from(">IIIII", head, 4)
        if enc not in _ENCODINGS:
            raise AuError(f"{path}: unsupported .au encoding {enc}")
        if not 1 <= ch <= 64 or not 1 <= rate <= 1_000_000:
            raise AuError(f"{path}: implausible channels/rate {ch}/{rate}")
        if off < 24 or off > fsize:
            raise AuError(f"{path}: bad data offset {off}")
        bps, kind = _ENCODINGS[enc]
        avail = fsize - off
        nbytes = avail if size in (0, 0xFFFFFFFF) else min(size, avail)
        self._off = off
        self._enc = enc
        self._bpf = bps * ch
        self.sample_rate = rate
        self.num_channels = ch
        self.num_frames = int(nbytes // self._bpf)
        self.bits = {1: 16, 2: 8, 3: 16, 4: 24, 5: 32, 6: 32, 7: 64,
                     27: 16}[enc]
        self._f = open(path, "rb")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def read(self, start: int, count: int) -> np.ndarray:
        start = max(0, int(start))
        count = max(0, min(int(count), self.num_frames - start))
        if count == 0:
            return np.zeros((self.num_channels, 0), np.float32)
        self._f.seek(self._off + start * self._bpf)
        raw = np.frombuffer(self._f.read(count * self._bpf), np.uint8)
        return _decode(raw, self._enc, self.num_channels)


def probe_au(path: str) -> AudioFileInfo:
    with AuReader(path) as r:
        return AudioFileInfo(path=path, sample_rate=r.sample_rate,
                             num_channels=r.num_channels,
                             num_frames=r.num_frames, bit_depth=r.bits,
                             is_float=r._enc in (6, 7), container="au",
                             byte_order="big")


def read_au(path: str) -> tuple[np.ndarray, int]:
    """Decode a whole .au/.snd file to planar float32 + rate."""
    with AuReader(path) as r:
        return r.read(0, r.num_frames), r.sample_rate


def read_raw_pcm_au(path: str):
    """Raw interleaved integer-PCM payload + metadata for the on-device
    codec.  Linear 16/24-bit .au payloads ship their container bytes
    verbatim (big-endian interleaved — the AIFF wire); G.711 mu-law and
    A-law expand on the host to the exact int16 codes first (the same
    re-pack move the FLAC raw path makes), so they ride the 2-byte wire
    too."""
    with AuReader(path) as r:
        if r._enc not in (1, 3, 4, 27):
            raise ValueError(f"{path}: no raw integer PCM payload to ship")
        info = AudioFileInfo(path=path, sample_rate=r.sample_rate,
                             num_channels=r.num_channels,
                             num_frames=r.num_frames, bit_depth=r.bits,
                             is_float=False, container="au",
                             byte_order="big")
        r._f.seek(r._off)
        payload = np.frombuffer(
            r._f.read(r.num_frames * r._bpf), np.uint8)
        if r._enc in (1, 27):
            table = _ULAW16 if r._enc == 1 else _ALAW16
            payload = np.ascontiguousarray(
                table[payload].astype(">i2")).view(np.uint8)
        return payload, info
