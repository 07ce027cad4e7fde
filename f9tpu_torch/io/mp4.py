"""MP4/M4A container — Apple Lossless tracks, read only.

The reference's Swift shell reads anything ``AVAudioFile`` accepts
(_Swift Code/F9-Batch-Resampler/Models/AudioFile.swift:38),
which includes ALAC in .m4a.  f9tpu reads exactly that: a minimal ISO
BMFF box walk down to the sound track's sample table, the ``alac``
magic cookie, and per-packet byte ranges — then packets decode through
``io/alac.py``.  AAC tracks are rejected with the lossy-input message
(same policy as .mp3); writing MP4 is intentionally absent.

Sample-table mechanics (ISO 14496-12): ``stsd`` carries the codec
config, ``stsz`` per-sample byte sizes, ``stsc`` sample-to-chunk runs,
``stco``/``co64`` chunk offsets, ``stts`` per-sample durations (for
ALAC: frames per packet, the last one partial).
"""

from __future__ import annotations

import os
import struct

import numpy as np

from .alac import AlacDecoder, AlacError
from .wav import AudioFileInfo

__all__ = ["Mp4Error", "probe_m4a", "read_m4a", "M4aReader"]


class Mp4Error(ValueError):
    """Malformed or unsupported MP4 data."""


def _boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        (size,) = struct.unpack_from(">I", data, pos)
        btype = data[pos + 4: pos + 8]
        body = pos + 8
        if size == 1:
            if pos + 16 > end:
                raise Mp4Error("truncated 64-bit box header")
            (size,) = struct.unpack_from(">Q", data, pos + 8)
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < 8 or pos + size > end:
            raise Mp4Error(f"bad box size at {pos}")
        yield btype, body, pos + size
        pos += size


def _find(data, start, end, btype):
    for t, b, e in _boxes(data, start, end):
        if t == btype:
            return b, e
    return None


def _parse_track(data: bytes, path: str):
    moov = _find(data, 0, len(data), b"moov")
    if moov is None:
        raise Mp4Error(f"{path}: no moov box")
    for t, b, e in _boxes(data, *moov):
        if t != b"trak":
            continue
        mdia = _find(data, b, e, b"mdia")
        if mdia is None:
            continue
        hdlr = _find(data, *mdia, b"hdlr")
        if hdlr is None or data[hdlr[0] + 8: hdlr[0] + 12] != b"soun":
            continue
        minf = _find(data, *mdia, b"minf")
        stbl = _find(data, *minf, b"stbl") if minf else None
        if stbl is None:
            raise Mp4Error(f"{path}: sound track without a sample table")
        return stbl
    raise Mp4Error(f"{path}: no sound track")


def _parse_stbl(data: bytes, stbl, path: str):
    boxes = {t: (b, e) for t, b, e in _boxes(data, *stbl)}
    # --- stsd: the codec entry ---
    if b"stsd" not in boxes:
        raise Mp4Error(f"{path}: missing stsd")
    b, e = boxes[b"stsd"]
    (count,) = struct.unpack_from(">I", data, b + 4)
    if count < 1:
        raise Mp4Error(f"{path}: empty stsd")
    entry_off = b + 8
    (esize,) = struct.unpack_from(">I", data, entry_off)
    fmt = data[entry_off + 4: entry_off + 8]
    if fmt == b"mp4a":
        raise ValueError(
            f"{path}: AAC is lossy; transcode to WAV/AIFF/FLAC first "
            "(ALAC .m4a is supported)")
    if fmt != b"alac":
        raise Mp4Error(
            f"{path}: unsupported m4a codec "
            f"'{fmt.decode('latin1')}' (ALAC only)")
    # AudioSampleEntry: 6 reserved + 2 dref + 8 version block + 2 ch +
    # 2 samplesize + 4 + 4 rate(16.16), then child boxes
    ase = entry_off + 8
    channels, samplesize = struct.unpack_from(">HH", data, ase + 16)
    cookie = None
    child = ase + 28
    for t, cb, ce in _boxes(data, child, entry_off + esize):
        if t == b"alac":
            cookie = data[cb + 4: ce]            # fullbox version/flags
            break
        if t == b"wave":                          # QuickTime wrapper
            inner = _find(data, cb, ce, b"alac")
            if inner:
                cookie = data[inner[0] + 4: inner[1]]
                break
    if cookie is None:
        raise Mp4Error(f"{path}: ALAC track without a config cookie")
    # --- stsz: per-sample sizes ---
    b, e = boxes.get(b"stsz", (None, None))
    if b is None:
        raise Mp4Error(f"{path}: missing stsz")
    fixed, n_samples = struct.unpack_from(">II", data, b + 4)
    if fixed:
        sizes = [fixed] * n_samples
    else:
        sizes = list(struct.unpack_from(f">{n_samples}I", data, b + 12))
    # --- chunk offsets ---
    if b"stco" in boxes:
        b, e = boxes[b"stco"]
        (nc,) = struct.unpack_from(">I", data, b + 4)
        chunk_offs = list(struct.unpack_from(f">{nc}I", data, b + 8))
    elif b"co64" in boxes:
        b, e = boxes[b"co64"]
        (nc,) = struct.unpack_from(">I", data, b + 4)
        chunk_offs = list(struct.unpack_from(f">{nc}Q", data, b + 8))
    else:
        raise Mp4Error(f"{path}: missing stco/co64")
    # --- stsc: sample-to-chunk runs -> per-sample file offsets ---
    if b"stsc" not in boxes:
        raise Mp4Error(f"{path}: missing stsc")
    b, e = boxes[b"stsc"]
    (nr,) = struct.unpack_from(">I", data, b + 4)
    runs = [struct.unpack_from(">III", data, b + 8 + 12 * i)
            for i in range(nr)]
    offsets = []
    si = 0
    for ri, (first, spc, _desc) in enumerate(runs):
        last = (runs[ri + 1][0] - 1 if ri + 1 < len(runs)
                else len(chunk_offs))
        for ci in range(first - 1, last):
            off = chunk_offs[ci]
            for _ in range(spc):
                if si >= len(sizes):
                    break
                offsets.append(off)
                off += sizes[si]
                si += 1
    if si < len(sizes):
        raise Mp4Error(f"{path}: sample-to-chunk table short of samples")
    # --- stts: per-sample frame counts ---
    if b"stts" not in boxes:
        raise Mp4Error(f"{path}: missing stts")
    b, e = boxes[b"stts"]
    (nt,) = struct.unpack_from(">I", data, b + 4)
    frames = []
    for i in range(nt):
        cnt, delta = struct.unpack_from(">II", data, b + 8 + 8 * i)
        frames.extend([delta] * cnt)
    if len(frames) != len(sizes):
        raise Mp4Error(f"{path}: stts/stsz sample counts disagree")
    return cookie, channels, sizes, offsets, np.asarray(frames, np.int64)


class M4aReader:
    """Incremental frame reader with the `WavReader.read(start, count)`
    contract; packet-granular random access via the sample table."""

    def __init__(self, path: str):
        self.path = path
        # the box walk parses the moov tables from one read; audio
        # packets then stream FROM DISK by sample-table offset, so the
        # reader never holds the mdat payload (an hour of 24-bit ALAC is
        # hundreds of MB)
        with open(path, "rb") as f:
            data = f.read()
        stbl = _parse_track(data, path)
        cookie, _ch, sizes, offsets, frames = _parse_stbl(data, stbl, path)
        del data
        self._dec = AlacDecoder(cookie)
        cfg = self._dec.cfg
        self.sample_rate = cfg.sample_rate
        self.num_channels = cfg.num_channels
        self.bits = cfg.bit_depth
        self._scale = np.float32(1 << (self.bits - 1))
        self._f = open(path, "rb")
        self._sizes = sizes
        self._offsets = offsets
        #: stream position of each packet's first frame (+ total sentinel)
        self._starts = np.concatenate([[0], np.cumsum(frames)])
        self.num_frames = int(self._starts[-1])
        self._cache: tuple[int, np.ndarray] | None = None

    def close(self):
        self._f.close()
        self._cache = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _packet(self, p: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == p:
            return self._cache[1]
        self._f.seek(self._offsets[p])
        raw = self._f.read(self._sizes[p])
        try:
            codes = self._dec.decode_packet(raw)
        except AlacError as e:
            raise Mp4Error(f"{self.path}: packet {p}: {e}") from None
        x = codes.astype(np.float32) / self._scale
        self._cache = (p, x)
        return x

    def read(self, start: int, count: int) -> np.ndarray:
        start = max(0, int(start))
        count = max(0, min(int(count), self.num_frames - start))
        ch = self.num_channels
        if count == 0:
            return np.zeros((ch, 0), np.float32)
        out = np.zeros((ch, count), np.float32)
        p = int(np.searchsorted(self._starts, start, "right")) - 1
        got = 0
        while got < count:
            x = self._packet(p)
            lo = start + got - int(self._starts[p])
            take = min(x.shape[1] - lo, count - got)
            if take <= 0:
                raise Mp4Error(f"{self.path}: packet {p} shorter than the "
                               "sample table implies")
            out[:, got:got + take] = x[:, lo:lo + take]
            got += take
            p += 1
        return out


def probe_m4a(path: str) -> AudioFileInfo:
    with M4aReader(path) as r:
        return AudioFileInfo(path=path, sample_rate=r.sample_rate,
                             num_channels=r.num_channels,
                             num_frames=r.num_frames, bit_depth=r.bits,
                             is_float=False, container="m4a",
                             byte_order="big")


def read_m4a(path: str) -> tuple[np.ndarray, int]:
    """Decode a whole ALAC .m4a to planar float32 + rate."""
    with M4aReader(path) as r:
        return r.read(0, r.num_frames), r.sample_rate
