"""Ogg container (RFC 3533) — page parsing and packet assembly, from
scratch.

The reference registers an Ogg Vorbis *reader* via JUCE's
``registerBasicFormats()`` (Source/MainComponent.cpp:13,
Source/AppState.h:153), so ``.ogg`` sources are part of the input surface
a batch user expects; f9tpu mirrors that as decode-only (lossy OUTPUT
stays rejected — ``io/codec.py``).  This module is the container layer:
CRC-checked page scan, lacing-value packet reassembly (255-run
continuation across pages), granule positions, and logical-stream
bookkeeping.  The codec layer on top is ``io/vorbis.py``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

__all__ = ["OggPage", "read_pages", "packets_from_pages", "OggError"]


class OggError(ValueError):
    """Malformed Ogg container data."""


# CRC-32 with polynomial 0x04c11db7, no bit reflection, init 0, xorout 0
# (RFC 3533 section 6 — NOT the zlib crc32).
def _make_crc_table() -> np.ndarray:
    tab = np.zeros(256, np.uint32)
    for i in range(256):
        r = i << 24
        for _ in range(8):
            r = ((r << 1) ^ (0x04C11DB7 if r & 0x80000000 else 0)) & 0xFFFFFFFF
        tab[i] = r
    return tab


_CRC_TAB = _make_crc_table()


def ogg_crc(data: bytes) -> int:
    try:                              # C++ hot loop (same table; the page
        from .. import native         # scan is per-page, ~4 KB calls)

        if native.available():
            return native.ogg_crc_native(data)
    except Exception:
        pass
    crc = 0
    tab = _CRC_TAB
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tab[((crc >> 24) ^ b) & 0xFF])
    return crc


@dataclasses.dataclass
class OggPage:
    version: int
    continued: bool        # first packet continues from the previous page
    bos: bool
    eos: bool
    granule: int           # -1 = no packet completes on this page
    serial: int
    seq: int
    lacing: list[int]
    body: bytes
    offset: int            # byte offset of the page in the stream


def read_pages(data: bytes, verify_crc: bool = True):
    """Yield :class:`OggPage` for every page in ``data`` (one full scan;
    a malformed capture pattern or CRC raises :class:`OggError`)."""
    pos, n = 0, len(data)
    while pos < n:
        if data[pos : pos + 4] != b"OggS":
            raise OggError(f"bad capture pattern at byte {pos}")
        if pos + 27 > n:
            raise OggError("truncated page header")
        (version, htype, granule, serial, seq, crc, nseg) = struct.unpack_from(
            "<BBqIIIB", data, pos + 4)
        if version != 0:
            raise OggError(f"unsupported Ogg version {version}")
        seg_end = pos + 27 + nseg
        if seg_end > n:
            raise OggError("truncated segment table")
        lacing = list(data[pos + 27 : seg_end])
        body_len = sum(lacing)
        if seg_end + body_len > n:
            raise OggError("truncated page body")
        body = data[seg_end : seg_end + body_len]
        if verify_crc:
            hdr = bytearray(data[pos : seg_end + body_len])
            hdr[22:26] = b"\x00\x00\x00\x00"
            if ogg_crc(bytes(hdr)) != crc:
                raise OggError(f"page CRC mismatch at byte {pos}")
        yield OggPage(version=version, continued=bool(htype & 0x1),
                      bos=bool(htype & 0x2), eos=bool(htype & 0x4),
                      granule=granule, serial=serial, seq=seq,
                      lacing=lacing, body=body, offset=pos)
        pos = seg_end + body_len


def packets_from_pages(pages, serial: int | None = None):
    """Assemble logical packets from an in-order page iterable.

    Yields ``(packet_bytes, granule, eos)`` where ``granule`` is the page
    granule position if this packet is the LAST one completing on its page
    (else -1) — the Vorbis mapping ties sample counts to exactly those.
    A lacing value of 255 continues the packet into the next page
    (RFC 3533 section 5.1); spanning is validated via the continued flag.
    """
    partial = bytearray()
    open_packet = False
    for pg in pages:
        if serial is not None and pg.serial != serial:
            continue
        if open_packet and not pg.continued:
            raise OggError(
                f"page {pg.seq}: expected continuation of an open packet")
        if not open_packet and pg.continued:
            # continuation of a packet we never saw (mid-stream join):
            # drop the fragment, as the spec prescribes for capture
            partial.clear()
        ends = []                      # (end_offset_in_body, is_complete)
        off = 0
        complete_idx = []
        for lv in pg.lacing:
            off += lv
            ends.append(off)
            complete_idx.append(lv < 255)
        start = 0
        n_complete = sum(1 for c in complete_idx if c)
        seen_complete = 0
        for end, comp in zip(ends, complete_idx):
            seg = pg.body[start:end]
            start = end
            partial.extend(seg)
            if comp:
                seen_complete += 1
                gran = pg.granule if seen_complete == n_complete else -1
                yield bytes(partial), gran, pg.eos
                partial.clear()
                open_packet = False
            else:
                open_packet = True
        # a page may end mid-packet (all-255 tail): stays open
    if open_packet and partial:
        raise OggError("stream ends mid-packet")
