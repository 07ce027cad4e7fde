"""Processing configuration — the TPU-native ``ProcessingSettings``.

Mirrors the reference's single plain-struct settings object
(Source/AppState.h:183-259; Models/ProcessingSettings.swift:23-89; field
inventory at _Swift Docs/TECHNICAL_DOCUMENTATION.md:139-154) plus the
batch/device knobs the TPU pipeline adds.  Same invalidation semantics for
cached calibration: changing the rate pair or quality invalidates a measured
latency (Models/ProcessingSettings.swift:60-65;
Source/SettingsComponent.cpp:321-327).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["ProcessingConfig", "RECORDING_LENGTH_LATENCY_FACTOR", "recording_length"]

#: The reference's capture head-room rule: record source + latency + 4*latency
#: frames (Source/AppState.h:240-243).
RECORDING_LENGTH_LATENCY_FACTOR = 4


def recording_length(source_frames: int, latency_frames: int) -> int:
    """src + lat + 4*lat (Source/AppState.h:240-243)."""
    return source_frames + latency_frames + RECORDING_LENGTH_LATENCY_FACTOR * latency_frames


@dataclasses.dataclass
class ProcessingConfig:
    """Everything a batch run needs; plain data, UI/CLI-bindable."""

    # --- core SRC (replaces the analog loop) ---
    target_rate: int = 48000            # output ("session") rate
    quality: str = "high"               # QUALITY_PRESETS key
    kind: str = "sinc"                  # "sinc" | "minphase" | "lagrange"
    bits: int = 24
    """Output PCM depth: 16/24 (reference writes 24,
    Source/MainComponent.cpp:784-801) or 32 (int32 container; the device
    graph computes in float32, so ~25 bits are significant — use 24 unless a
    downstream tool demands 32-bit files)."""
    dither: bool = True                 # TPDF dither before quantize
    seed: int | None = 0
    """Dither RNG seed.  Per-file noise keys derive from (seed, file path), so
    re-running a batch is byte-identical whatever the batch grouping — which
    keeps the manifest's resume size-verification and A/B debugging sound.
    ``None`` opts into wall-clock seeding (fresh noise every run)."""
    remove_dc: bool = True              # Source/MainComponent.cpp:884-902
    gain_db: float = 0.0
    normalize_lufs: float | None = None
    """Loudness-normalize each file to this integrated LUFS target (BS.1770-4
    measured on the decoded SOURCE; the per-file gain is applied at the
    output stage, after the chain, composed with ``gain_db`` so the NET
    output gain hits the target).  Forces host decode (the raw-bytes device
    path has no float samples to meter).  Silent/too-short files pass
    through ungained; per-file gains are clamped to +-40 dB (extreme
    material lands short of target, logged).  None = off."""
    normalize_tp_db: float | None = None
    """With ``normalize_lufs``: cap the per-file gain so the projected true
    peak (BS.1770-4 Annex 2, 4x oversampled) stays at or below this ceiling
    in dBTP (e.g. -1.0 for streaming deliverables).  Quiet files may then
    land below the loudness target — the ceiling wins, as in mastering
    practice.  SOURCE-referenced: exact for plain resampling; with an insert
    chain the chain reshapes peaks after the measurement, so verify
    deliverables with ``probe --loudness``.  None = no ceiling."""
    surround_weights: bool = False
    """Apply BS.1770-4 channel weights when metering 6/8-channel files laid
    out as standard 5.1/7.1 (L R C LFE [BL BR] SL SR): surrounds 1.41, LFE
    excluded — what a conforming broadcast meter reads.  OFF by default
    because this framework's multichannel buses are typically DISCRETE
    channel sets (MCFX), not 5.1 beds, where weighting would be wrong."""

    # --- input validation ---
    require_input_rate: int | None = None
    """Strict reference semantics: only accept files at this rate ±1 Hz
    (Source/AppState.h:137-141).  None = accept any rate and resample
    (the mixed-rate library config, BASELINE.json config 5)."""

    # --- output naming (OUTPUT_FOLDER_PROTECTION.md: out dir is mandatory,
    # originals are never overwritten; postfix appended before extension) ---
    output_dir: str = ""
    postfix: str = "_processed"
    keep_metadata: bool = False
    """Carry the source's metadata chunks (Broadcast-WAV 'bext', LIST/INFO,
    cue/smpl/iXML/axml/ID3) into the output file (WAV outputs only; appended
    after 'data' with the RIFF size patched).  Off by default — the
    reference's writers drop metadata."""
    output_format: str = "wav"
    """Output container: "wav" (reference behaviour,
    Source/MainComponent.cpp:784-801) or "aiff" (big-endian PCM; the
    reference reads .aif/.aiff, this also round-trips them out)."""

    # --- latency compensation (Source/MainComponent.cpp:824-861) ---
    trim_enabled: bool = True
    latency_frames: int | None = None   # None = auto-measure (calibration)

    # --- insert chain (the external-processor loop the reference exists to
    # drive, AudioProcessingService.swift:339-536) ---
    chain: object | None = None
    """Optional ``f9tpu_torch.ops.chain.Chain``: in-graph effect stages applied at
    the output rate before latency trimming.  Its group delay is measured by
    calibration and trimmed; its ring-out scales the reverb-mode capture
    head-room (up to ``max_tail_seconds``)."""

    # --- reverb mode (tail termination; REVERB_MODE_IMPLEMENTATION.md) ---
    reverb_mode: bool = False
    noise_floor_db: float | None = None    # measured; None -> -80 dB fallback
    noise_floor_margin_pct: float = 10.0   # 0-50 step 5 in the UI
    tail_mode: str = "peak"                # "peak" (Swift) | "rms" (C++)
    tail_window_ms: int = 100
    tail_hop_ms: int = 50
    tail_consecutive: int = 3
    max_tail_seconds: float = 60.0         # the 60 s cap

    # --- preview / playlist (AudioProcessingService.swift:539-876) ---
    silence_between_files_ms: int = 150    # 0-2000, default 150
    monitor_mixdown: bool = True

    # --- routing (MCFX-style; Docs/MultiChannel MCFX with JUCE.md) ---
    channel_routing: Sequence[int] | None = None   # out[i] <- in[routing[i]]
    output_channels: int | None = None             # fan mono out to N

    # --- TPU batch execution ---
    batch_size: int = 8                 # files per compiled device step
    bucket_frames: Sequence[int] = (
        1 << 16, 1 << 18, 1 << 20, 1 << 22, 60 * 192000
    )                                   # length buckets to bound recompiles
    native_loader: bool = False
    """Opt-in: decode integer-PCM WAVs with the C++ thread-pool loader
    (``f9tpu_torch.native.AsyncLoader``) instead of Python decode threads.
    Measured SLOWER than the default (0.5-0.6x, docs/PERF.md 'decode stage'):
    the Python path already runs the same native 24-bit unpack loop and
    releases the GIL during file I/O, while the loader adds ticket polling
    and an extra buffer copy.  Kept as a knob for GIL-free end-to-end decode
    experiments."""
    device_layout: str = "packed"
    """Result layout trade-off (docs/PERF.md):
    - "packed": flat layout + on-device 24-bit byte packing — minimum bytes
      over the host<->device link (best when the link is slow, e.g. remote
      TPU tunnels; 25% fewer bytes than int32).
    - "rows": the SRC's native (n_rows, L) tiling end-to-end on device —
      ~3x less device time (skips a pathological flat-reshape relayout);
      best for locally attached TPUs where PCIe dwarfs the graph time.
    """

    def validate(self) -> None:
        from .models.filters import QUALITY_PRESETS

        if self.kind not in ("sinc", "minphase", "lagrange"):
            raise ValueError(
                f"kind must be sinc|minphase|lagrange, got {self.kind!r}")
        if self.kind in ("sinc", "minphase") \
                and self.quality not in QUALITY_PRESETS:
            raise ValueError(f"unknown quality {self.quality!r}")
        if self.bits not in (16, 24, 32):
            raise ValueError(f"bits must be 16/24/32, got {self.bits}")
        if not self.output_dir:
            # mandatory, so originals can never be overwritten
            # (AudioProcessingService.swift:664-667)
            raise ValueError("output_dir is required")
        if self.target_rate <= 0:
            raise ValueError("target_rate must be positive")
        if self.batch_size < 1:
            # the scheduler hard-assumes a positive batch width; 0 would
            # pass startup validation and IndexError mid-run instead
            raise ValueError(f"batch_size must be >= 1, got {self.batch_size}")
        if self.output_channels is not None and self.output_channels < 1:
            raise ValueError(
                f"output_channels must be >= 1, got {self.output_channels}")
        if self.device_layout not in ("packed", "rows"):
            raise ValueError("device_layout must be 'packed' or 'rows'")
        if self.output_format not in ("wav", "aiff", "flac"):
            raise ValueError("output_format must be 'wav', 'aiff' or 'flac'")
        if self.normalize_lufs is not None and not (
                -70.0 <= self.normalize_lufs <= 0.0):
            raise ValueError("normalize_lufs out of range [-70, 0] LUFS")
        if self.normalize_tp_db is not None:
            if self.normalize_lufs is None:
                raise ValueError(
                    "normalize_tp_db requires normalize_lufs (it caps the "
                    "normalization gain)")
            if not -20.0 <= self.normalize_tp_db <= 0.0:
                raise ValueError("normalize_tp_db out of range [-20, 0] dBTP")
        if self.chain is not None and not (
                callable(getattr(self.chain, "apply", None))
                and callable(getattr(self.chain, "tail_frames", None))
                and callable(getattr(self.chain, "sig_str", None))):
            raise ValueError(
                "chain must be an f9tpu_torch.ops.chain.Chain-like object "
                "(apply/tail_frames/sig_str)")
        if not 0 <= self.noise_floor_margin_pct <= 50:
            # the reference UI bounds the margin at 0-50 %
            # (Source/SettingsComponent: slider 0-50 step 5)
            raise ValueError("noise_floor_margin_pct out of range (0-50)")
        if self.channel_routing is not None:
            for r in self.channel_routing:
                if int(r) != r or r < -1:
                    raise ValueError(
                        f"channel_routing entries must be integer source "
                        f"channel indices or -1 (silence), got {r!r}")
            # upper bound depends on each file's channel count and is
            # checked per file (routing_channel_bound_error)

    def routing_channel_bound_error(self, in_channels: int) -> str | None:
        """Per-file upper-bound check for ``channel_routing``: entries index
        the channels AFTER the mono fan-out (both execution paths fan out
        before routing), so the bound is the file's post-fan-out channel
        count.  Returns an error message (for a clean per-file failure
        BEFORE any output is written — the device gather would silently
        clamp, the host gather would IndexError mid-stream) or None."""
        if self.channel_routing is None:
            return None
        c_eff = (self.output_channels
                 if (in_channels == 1 and self.output_channels)
                 else in_channels)
        bad = sorted({int(r) for r in self.channel_routing if r >= c_eff})
        if bad:
            return (f"channel_routing references source channel(s) {bad} "
                    f"but the input has only {c_eff} channel(s)"
                    + (" after mono fan-out" if in_channels == 1 else ""))
        return None

    @property
    def noise_floor_threshold_db(self) -> float:
        """nf + nf*margin% with -80 dB fallback (Source/AppState.h:245-258;
        AudioProcessingService.swift:710-737)."""
        nf = self.noise_floor_db
        if nf is None or nf >= 0:
            return -80.0
        return nf + nf * self.noise_floor_margin_pct / 100.0
