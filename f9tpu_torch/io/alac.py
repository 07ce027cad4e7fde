"""Apple Lossless (ALAC) decoder — from scratch, decode only.

The reference's Swift shell reads anything ``AVAudioFile`` accepts
(_Swift Code/F9-Batch-Resampler/Models/AudioFile.swift:38),
which includes Apple Lossless in CAF and M4A containers — lossless
sources a mastering pipeline legitimately ingests.  f9tpu mirrors that
input surface; ALAC output is intentionally absent (WAV/AIFF/FLAC are
the deliverable formats).

Format per Apple's published ALAC specification (the open-sourced
reference implementation defines the bitstream):

  * magic cookie — ``ALACSpecificConfig``: frameLength, bitDepth, the
    adaptive-Rice tuning triple (pb, mb, kb), channels, sampleRate;
  * packets — a sequence of AAC-style syntactic elements (SCE mono,
    CPE stereo pair, LFE, END), each carrying: 12 reserved bits, a
    partial-frame flag + 32-bit count, ``bytes_shifted`` (low bytes
    stored raw), an escape flag (verbatim PCM), the stereo
    decorrelation pair (mixBits/mixRes), per-channel prediction headers
    (mode, quant, rice-history multiplier, order, int16 coefficients);
  * entropy coding — the ALAC flavour of adaptive Golomb-Rice: unary
    prefix of ones (>= 9 escapes to a raw ``bps``-bit value), truncated
    binary remainder against ``m = 2^k - 1``, a decaying history that
    sets ``k``, and zero-run blocks below the history threshold;
  * prediction — warm-up cumulative sum, then the adaptive FIR: anchor
    ``d = out[i-order-1]``, quantized dot product, and the sign-driven
    per-coefficient adaptation loop (order 31 = pure first difference);
  * stereo decorrelation — ``a -= (b * mixRes) >> mixBits; b += a``
    yielding (left, right) = (b, a).

All math is exact integer, so the decoder is deterministic across
platforms (the FLAC-pattern property a native C++ twin would mirror).
Containers live in ``io/caf.py`` (CAF) and ``io/mp4.py`` (M4A); the
independent oracle is the system FFmpeg ALAC codec via tests/avref.py.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

__all__ = ["AlacError", "AlacConfig", "parse_alac_cookie", "AlacDecoder"]


class AlacError(ValueError):
    """Malformed or unsupported ALAC data."""


@dataclasses.dataclass(frozen=True)
class AlacConfig:
    """The ALACSpecificConfig magic cookie (24 bytes, big-endian)."""

    frame_length: int
    compatible_version: int
    bit_depth: int
    pb: int                  # rice history multiplier
    mb: int                  # rice initial history
    kb: int                  # rice parameter limit
    num_channels: int
    max_run: int
    max_frame_bytes: int
    avg_bit_rate: int
    sample_rate: int


def parse_alac_cookie(cookie: bytes) -> AlacConfig:
    """Parse the magic cookie; tolerates the optional 12-byte
    ``frma``/``alac`` atom prefix some muxers keep (QuickTime legacy)."""
    if len(cookie) >= 36 and cookie[4:8] == b"frma":
        cookie = cookie[12:]
    if len(cookie) >= 36 and cookie[4:8] == b"alac":
        cookie = cookie[12:]
    if len(cookie) < 24:
        raise AlacError(f"ALAC cookie too short ({len(cookie)} bytes)")
    (frame_length, version, bit_depth, pb, mb, kb, channels, max_run,
     max_frame_bytes, avg_bit_rate, rate) = struct.unpack_from(
        ">IBBBBBBHIII", cookie, 0)
    if version != 0:
        raise AlacError(f"unsupported ALAC version {version}")
    if bit_depth not in (16, 20, 24, 32):
        raise AlacError(f"unsupported ALAC bit depth {bit_depth}")
    if channels < 1 or channels > 8:
        raise AlacError(f"unsupported ALAC channel count {channels}")
    if frame_length == 0 or rate == 0:
        raise AlacError("degenerate ALAC cookie")
    return AlacConfig(frame_length, version, bit_depth, pb, mb, kb,
                      channels, max_run, max_frame_bytes, avg_bit_rate,
                      rate)


# --------------------------------------------------------------------------
# bit reader (MSB-first, like FLAC; unlike Vorbis)


class _Bits:
    __slots__ = ("d", "pos", "n")

    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0
        self.n = 8 * len(data)

    def read(self, k: int) -> int:
        p = self.pos
        q = p + k
        if q > self.n:
            raise AlacError("truncated ALAC packet")
        self.pos = q
        first, last = p >> 3, (q + 7) >> 3
        v = int.from_bytes(self.d[first:last], "big")
        v >>= (last << 3) - q
        return v & ((1 << k) - 1)

    def read_signed(self, k: int) -> int:
        v = self.read(k)
        return v - (1 << k) if k and (v >> (k - 1)) else v

    def unary_ones_max9(self) -> int:
        """Count of consecutive 1 bits, up to 9; the terminating 0 is
        consumed only when fewer than 9 ones were read (the ALAC escape
        convention)."""
        count = 0
        while count < 9:
            p = self.pos
            if p >= self.n:
                raise AlacError("truncated ALAC packet")
            bit = (self.d[p >> 3] >> (7 - (p & 7))) & 1
            if not bit:
                self.pos = p + 1
                return count
            self.pos = p + 1
            count += 1
        return count


def _sign_extend(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


# --------------------------------------------------------------------------
# entropy decode (adaptive Golomb-Rice, the ALAC flavour)


def _decode_scalar(br: _Bits, k: int, bps: int) -> int:
    x = br.unary_ones_max9()
    if x > 8:                                   # escape: raw value
        return br.read(bps)
    if k == 1:
        return x
    # truncated binary remainder against m = 2^k - 1
    extra = br.read(k)
    x = (x << k) - x                            # x * (2^k - 1)
    if extra > 1:
        return x + extra - 1
    br.pos -= 1                                 # remainder 0 uses k-1 bits
    return x


def _rice_decompress(br: _Bits, nb: int, bps: int, cfg: AlacConfig,
                     history_mult: int) -> np.ndarray:
    """Decode ``nb`` prediction residuals (zigzag-decoded, with the
    decaying history driving k and the zero-run blocks)."""
    out = np.zeros(nb, np.int64)
    history = cfg.mb
    sign_modifier = 0
    kb = cfg.kb
    i = 0
    while i < nb:
        k = ((history >> 9) + 3).bit_length() - 1
        if k > kb:
            k = kb
        x = _decode_scalar(br, k, bps) + sign_modifier
        sign_modifier = 0
        out[i] = (x >> 1) ^ -(x & 1)
        if x > 0xFFFF:
            history = 0xFFFF
        else:
            history += x * history_mult - ((history * history_mult) >> 9)
        # zero-run block below the history threshold (log2(0) reads as 0,
        # the reference table convention)
        if history < 128 and i + 1 < nb:
            k = 7 - max(history.bit_length() - 1, 0) + ((history + 16) >> 6)
            if k > kb:
                k = kb
            block_size = _decode_scalar(br, k, 16)
            if block_size > 0:
                if block_size >= nb - i:
                    block_size = nb - i - 1
                # out already zero-filled
                i += block_size
            if block_size <= 0xFFFF:
                sign_modifier = 1
            history = 0
        i += 1
    return out


# --------------------------------------------------------------------------
# prediction


def _lpc_predict(errors: np.ndarray, bps: int, coefs: list[int],
                 order: int, quant: int) -> np.ndarray:
    nb = len(errors)
    out = np.zeros(nb, np.int64)
    if nb == 0:
        return out
    out[0] = errors[0]
    if order == 0:
        out[:] = errors
        return out
    if order == 31:                            # pure first difference
        acc = int(errors[0])
        out[0] = acc
        for i in range(1, nb):
            acc = _sign_extend(acc + int(errors[i]), bps)
            out[i] = acc
        return out
    if quant <= 0:
        raise AlacError(f"invalid LPC quant {quant} for order {order}")
    # warm-up: cumulative sum over the first `order` samples
    i = 1
    while i <= order and i < nb:
        out[i] = _sign_extend(int(out[i - 1]) + int(errors[i]), bps)
        i += 1
    c = list(coefs)
    while i < nb:
        error_val = int(errors[i])
        d = int(out[i - order - 1])
        val = 0
        base = i - order
        for j in range(order):
            val += (int(out[base + j]) - d) * c[j]
        val = (val + (1 << (quant - 1))) >> quant
        val += d + error_val
        if val > (1 << 40) or val < -(1 << 40):
            # hostile-stream guard (the FLAC decoder's 2^40 rule,
            # io/flac.py): a crafted packet can push the unbounded-int
            # accumulator past any valid encoder's range — reject rather
            # than emit wrapped garbage (ADVICE r4 #2 precedent)
            raise AlacError("LPC reconstruction out of range "
                            "(corrupt or hostile packet)")
        out[i] = _sign_extend(val, bps)
        # sign-driven coefficient adaptation
        if error_val > 0:
            for j in range(order):
                if error_val <= 0:
                    break
                v = d - int(out[base + j])
                sign = (v > 0) - (v < 0)
                c[j] -= sign
                error_val -= ((v * sign) >> quant) * (j + 1)
        elif error_val < 0:
            for j in range(order):
                if error_val >= 0:
                    break
                v = d - int(out[base + j])
                sign = -((v > 0) - (v < 0))
                c[j] -= sign
                error_val -= ((v * sign) >> quant) * (j + 1)
        i += 1
    return out


# --------------------------------------------------------------------------
# packet decode


_SCE, _CPE, _CCE, _LFE, _DSE, _PCE, _FIL, _END = range(8)

#: ALAC's per-count channel layouts are fixed by the Apple spec (AAC
#: orderings: C L R Ls Rs ... LFE); this maps each DECODE-ORDER channel
#: to its slot in the conventional FL FR FC LFE BL BR SL SR order, so
#: callers see the same channel order every other reader emits
_CHANNEL_SLOTS = {
    1: (0,),
    2: (0, 1),
    3: (2, 0, 1),
    4: (2, 0, 1, 3),
    5: (2, 0, 1, 3, 4),
    6: (2, 0, 1, 4, 5, 3),
    7: (2, 0, 1, 4, 5, 6, 3),
    8: (2, 6, 7, 0, 1, 4, 5, 3),
}


class AlacDecoder:
    """Stateless packet-at-a-time ALAC decoder (every packet is an
    independent frame; random access is packet-granular by design).

    Decodes through the native C++ twin when available (bit-identical —
    both sides are exact integer math mirrored 1:1, the FLAC coder
    discipline; ~40x faster than the Python oracle) and falls back to
    the pure-Python spec implementation below."""

    def __init__(self, cookie: bytes):
        self.cfg = parse_alac_cookie(cookie)
        self._native = None                 # tri-state: None/module/False

    def decode_packet(self, data: bytes) -> np.ndarray:
        """Decode one packet to planar int codes ``(channels, frames)``
        at the cookie's bit depth."""
        if self._native is None:
            try:
                from .. import native

                self._native = native if native.available() else False
            except Exception:
                self._native = False
        if self._native:
            try:
                out = self._native.alac_decode_packet(self.cfg, data)
            except ValueError as e:
                raise AlacError(str(e)) from None
            if out is not None:
                return out
        return self._decode_packet_py(data)

    def _decode_packet_py(self, data: bytes) -> np.ndarray:
        """The pure-Python spec oracle (tested bit-identical to the
        native twin)."""
        cfg = self.cfg
        br = _Bits(data)
        out = np.zeros((cfg.num_channels, cfg.frame_length), np.int64)
        ch_index = 0
        nb_packet = None
        while True:
            element = br.read(3)
            if element == _END:
                break
            if element in (_SCE, _LFE):
                ch = 1
            elif element == _CPE:
                ch = 2
            else:
                raise AlacError(f"unsupported ALAC element type {element}")
            if ch_index + ch > cfg.num_channels:
                raise AlacError("ALAC elements exceed channel count")
            bufs, nb = self._decode_element(br, ch)
            slots = _CHANNEL_SLOTS.get(cfg.num_channels)
            for c in range(ch):
                row = (slots[ch_index + c] if slots else ch_index + c)
                out[row, :nb] = bufs[c][:nb]
            ch_index += ch
            nb_packet = nb if nb_packet is None else nb_packet
            if nb != nb_packet:
                raise AlacError("ALAC elements disagree on sample count")
        if ch_index != cfg.num_channels:
            raise AlacError("ALAC packet short of channels")
        n = nb_packet if nb_packet is not None else 0
        return out[:, :n]

    def _decode_element(self, br: _Bits, channels: int):
        cfg = self.cfg
        br.read(4)                              # element instance tag
        if br.read(12) != 0:
            raise AlacError("nonzero reserved element header bits")
        has_size = br.read(1)
        bytes_shifted = br.read(2)
        if bytes_shifted == 3:
            raise AlacError("invalid bytes_shifted = 3")
        uncompressed = br.read(1)
        nb = br.read(32) if has_size else cfg.frame_length
        if nb > cfg.frame_length:
            raise AlacError("element sample count exceeds frame length")
        extra_bits = bytes_shifted * 8
        bps = cfg.bit_depth - extra_bits + channels - 1
        if bps <= 0 or bps > 32:
            raise AlacError(f"invalid element bps {bps}")
        bufs = [np.zeros(nb, np.int64) for _ in range(channels)]
        if not uncompressed:
            decorr_shift = br.read(8)           # mixBits
            decorr_weight = br.read_signed(8)   # mixRes
            pred = []
            for _ in range(channels):
                mode = br.read(4)
                quant = br.read(4)
                pbf = br.read(3)
                order = br.read(5)
                # coefficients are stored highest index first
                coefs = [0] * order
                for j in range(order - 1, -1, -1):
                    coefs[j] = br.read_signed(16)
                if mode not in (0, 15):
                    raise AlacError(f"unsupported prediction mode {mode}")
                pred.append((mode, quant, pbf, order, coefs))
            shift_vals = None
            if bytes_shifted:
                # the raw low bytes, interleaved, stored before the
                # entropy-coded residuals
                shift_vals = np.zeros((channels, nb), np.int64)
                for i in range(nb):
                    for c in range(channels):
                        shift_vals[c, i] = br.read(extra_bits)
            for c in range(channels):
                mode, quant, pbf, order, coefs = pred[c]
                hist_mult = (cfg.pb * pbf) >> 2
                errs = _rice_decompress(br, nb, bps, cfg, hist_mult)
                if mode == 15:
                    # mode 15: the residuals were passed through a second
                    # first-difference stage; undo it before prediction
                    for i in range(1, nb):
                        errs[i] = _sign_extend(
                            int(errs[i]) + int(errs[i - 1]), bps)
                bufs[c] = _lpc_predict(errs, bps, coefs, order, quant)
            if channels == 2 and decorr_weight:
                a = bufs[0]
                b = bufs[1]
                a = a - ((b * decorr_weight) >> decorr_shift)
                b = b + a
                bufs[0], bufs[1] = b, a
            if bytes_shifted:
                for c in range(channels):
                    bufs[c] = (bufs[c] << extra_bits) | shift_vals[c]
        else:
            raw_bits = cfg.bit_depth
            for i in range(nb):
                for c in range(channels):
                    bufs[c][i] = br.read_signed(raw_bits)
        return bufs, nb
