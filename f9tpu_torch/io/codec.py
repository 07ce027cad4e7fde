"""Format dispatch: one entry point for .wav/.aif/.aiff/.flac/.ogg/.caf/
.m4a/.mp3/.au — the drop-zone filter of the reference
(Source/FileListAndLogComponent.cpp:150-181).  WAV/AIFF/FLAC/Ogg come from
JUCE ``registerBasicFormats()`` (Source/MainComponent.cpp:13); CAF (LPCM +
Apple Lossless), ALAC .m4a, MPEG audio and Sun .au come from the Swift
shell's AVAudioFile surface (Models/AudioFile.swift:38).  All are
implemented natively; Ogg Vorbis, ALAC, MPEG audio and .au are INPUT-only
— perceptual-lossy deliverables stay pointless, so lossy OUTPUT formats
are rejected with an actionable message, and AAC .m4a input is rejected
the same way."""

from __future__ import annotations

import os

import numpy as np

from .aiff import probe_aiff, read_aiff
from .wav import AudioFileInfo, probe_wav, read_wav

__all__ = ["SUPPORTED_EXTENSIONS", "probe", "read_audio",
           "read_audio_progress", "read_raw_pcm", "is_supported",
           "open_reader"]

SUPPORTED_EXTENSIONS = (".wav", ".aif", ".aiff", ".flac", ".ogg", ".oga",
                        ".caf", ".m4a", ".mp3", ".mp2", ".mp1", ".au",
                        ".snd")


def is_supported(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in SUPPORTED_EXTENSIONS


def _kind(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return "wav"
    if ext in (".aif", ".aiff"):
        return "aiff"
    if ext == ".flac":
        return "flac"
    if ext in (".ogg", ".oga"):
        return "ogg"
    if ext == ".caf":
        return "caf"
    if ext == ".m4a":
        return "m4a"           # ALAC only; AAC raises the lossy message
    if ext in (".mp3", ".mp2", ".mp1"):
        return "mp3"           # MPEG-1/2/2.5 Layers I-III, decode only
    if ext in (".au", ".snd"):
        return "au"            # Sun/NeXT audio, decode only
    reason = {
        ".aac": "AAC is not decodable here; transcode to WAV/AIFF/FLAC "
                "first (ALAC .m4a, MP3, Ogg Vorbis and FLAC inputs are)",
        ".opus": "Opus is not decodable here; transcode to WAV/AIFF/FLAC",
        ".wma": "WMA is not decodable here; transcode to WAV/AIFF/FLAC",
        ".ape": "Monkey's Audio is not decodable here; transcode to "
                "WAV/AIFF/FLAC",
        ".wv": "WavPack is not decodable here; transcode to WAV/AIFF/FLAC",
    }.get(ext)
    if reason:
        raise ValueError(f"{path}: {reason}")
    raise ValueError(f"unsupported audio file type: {path}")


def probe(path: str) -> AudioFileInfo:
    k = _kind(path)
    if k == "wav":
        return probe_wav(path)
    if k == "flac":
        from .flac import probe_flac

        return probe_flac(path)
    if k == "ogg":
        from .vorbis import probe_ogg

        return probe_ogg(path)
    if k == "caf":
        from .caf import probe_caf

        return probe_caf(path)
    if k == "m4a":
        from .mp4 import probe_m4a

        return probe_m4a(path)
    if k == "mp3":
        from .mp3 import probe_mp3

        return probe_mp3(path)
    if k == "au":
        from .au import probe_au

        return probe_au(path)
    return probe_aiff(path)


def read_audio(path: str) -> tuple[np.ndarray, int]:
    """Decode any supported file to planar float32 (channels, frames) + rate."""
    k = _kind(path)
    if k == "wav":
        return read_wav(path)
    if k == "flac":
        from .flac import read_flac

        return read_flac(path)
    if k == "ogg":
        from .vorbis import read_ogg

        return read_ogg(path)
    if k == "caf":
        from .caf import read_caf

        return read_caf(path)
    if k == "m4a":
        from .mp4 import read_m4a

        return read_m4a(path)
    if k == "mp3":
        from .mp3 import read_mp3

        return read_mp3(path)
    if k == "au":
        from .au import read_au

        return read_au(path)
    return read_aiff(path)


def read_audio_progress(path: str, progress_cb,
                        chunk_frames: int = 1 << 20) -> tuple[np.ndarray, int]:
    """`read_audio`, but decoded in seek-based chunks with
    ``progress_cb(done_fraction)`` per chunk — the batch scheduler's
    sub-file decode progress (the reference's throttled per-buffer
    callbacks, AudioProcessingService.swift:209-264).  Returns the same
    planar float32 array as `read_audio` (readers share the one decode
    path per container)."""
    with open_reader(path) as r:
        n, ch = r.num_frames, r.num_channels
        out = np.empty((ch, n), np.float32)
        done = 0
        while done < n:
            c = r.read(done, min(chunk_frames, n - done))
            got = c.shape[1]
            if got == 0:
                break            # truncated mid-frame: clip like read_audio
            out[:, done:done + got] = c
            done += got
            progress_cb(done / n)
        return np.ascontiguousarray(out[:, :done]), r.sample_rate


def open_reader(path: str):
    """Incremental seek-based frame reader for any supported container
    (`wav.WavReader` / `aiff.AiffReader` — the same `read(start, count)`
    contract), so the streaming path accepts the full drop-zone surface."""
    k = _kind(path)
    if k == "wav":
        from .wav import WavReader

        return WavReader(path)
    if k == "flac":
        from .flac import FlacReader

        return FlacReader(path)
    if k == "ogg":
        from .vorbis import OggVorbisReader

        return OggVorbisReader(path)
    if k == "caf":
        from .caf import CafReader

        return CafReader(path)
    if k == "m4a":
        from .mp4 import M4aReader

        return M4aReader(path)
    if k == "mp3":
        from .mp3 import Mp3Reader

        return Mp3Reader(path)
    if k == "au":
        from .au import AuReader

        return AuReader(path)
    from .aiff import AiffReader

    return AiffReader(path)


def read_raw_pcm(path: str):
    """Raw interleaved integer-PCM payload + metadata for the on-device
    codec, from either container.  Payload endianness is
    ``info.byte_order`` ("little" for WAV and AIFC sowt, "big" for AIFF
    NONE); `f9tpu_torch.ops.devcodec.unpack_pcm_interleaved` handles both."""
    k = _kind(path)
    if k == "wav":
        from .wav import read_raw_pcm as _wav_raw

        return _wav_raw(path)
    if k == "flac":
        from .flac import read_raw_pcm_flac

        return read_raw_pcm_flac(path)
    if k in ("ogg", "caf", "m4a", "mp3"):
        # no raw wire: Vorbis decodes to float; ALAC/CAF payloads are
        # compressed or layout-varied (the scheduler's raw_bits grouping
        # never selects these — container gate at pipeline/scheduler.py)
        raise ValueError(f"{path}: no raw integer PCM payload to ship")
    if k == "au":
        from .au import read_raw_pcm_au

        return read_raw_pcm_au(path)
    from .aiff import read_raw_pcm_aiff

    return read_raw_pcm_aiff(path)


def carry_metadata(in_path: str, out_path: str, output_format: str,
                   rate_in: int, rate_out: int) -> None:
    """Same-container metadata passthrough (--keep-metadata): WAV->WAV
    carries bext/LIST/cue/smpl/iXML with sample-indexed fields rescaled;
    AIFF->AIFF carries NAME/AUTH/ANNO/COMT/MARK/INST with marker positions
    rescaled; FLAC->FLAC carries VORBIS_COMMENT/PICTURE/APPLICATION blocks
    verbatim (position-free).  Chunk formats don't translate across
    containers, so
    cross-container jobs carry nothing.  The ONE carry rule for the batch
    encode worker and the streaming path (they must never drift: metadata
    survival would otherwise depend on file length via the oversized-file
    routing).  Raises ValueError/OSError on failure — callers decide
    whether to log or swallow (metadata is best-effort; audio is complete
    by the time this runs)."""
    src_kind = _kind(in_path)
    if src_kind == "wav" and output_format == "wav":
        from .wav import append_chunks, read_extra_chunks, scale_metadata_chunks

        append_chunks(out_path, scale_metadata_chunks(
            read_extra_chunks(in_path), rate_in, rate_out))
    elif src_kind == "aiff" and output_format == "aiff":
        from .aiff import (append_chunks_aiff, read_extra_chunks_aiff,
                           scale_metadata_chunks_aiff)

        append_chunks_aiff(out_path, scale_metadata_chunks_aiff(
            read_extra_chunks_aiff(in_path), rate_in, rate_out))
    elif src_kind == "flac" and output_format == "flac":
        # VORBIS_COMMENT tags / PICTURE art / APPLICATION blocks are
        # position-free: carried verbatim, nothing to rescale
        from .flac import insert_blocks_flac, read_extra_blocks_flac

        insert_blocks_flac(out_path, read_extra_blocks_flac(in_path))
