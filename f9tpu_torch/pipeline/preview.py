"""Preview: a gapless playlist rendered onto a bus, with a monitor mixdown
(port of `f9tpu/pipeline/preview.py`).

Each item is decoded, resampled to the session rate where its rate differs,
expanded to the bus's channel count and laid end to end with
``silence_ms`` of zeros between items, ``loops`` times over.
`render_playlist` returns the whole programme as host arrays;
`stream_playlist` writes it one block at a time through `io.wav.WavWriter`
(RF64 past 4 GiB) in constant memory.  Both take each item's samples from
`_iter_item_blocks`, so their bytes are the same.

Mixed-rate items are resampled in haloed chunks by `resample_presliced` on
``device`` (default CUDA, raising without a GPU), chunk-invariant bit
for bit on either device.  The monitor mixdown (`ops.routing.mixdown_monitor`) runs on the same
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..io import codec
from ..models.filters import design_cycle_bank, resolve_ratio
from ..ops.resample import resample_presliced
from ..ops.routing import mixdown_monitor

__all__ = ["PlaylistItem", "playlist_item_frames", "projected_frames",
           "render_playlist", "stream_playlist"]

#: frames per block of a rate-matched item, read straight from its file
_MATCHED_BLOCK = 1 << 18


@dataclasses.dataclass
class PlaylistItem:
    path: str
    start_frame: int
    num_frames: int


def _expand_channels(x: np.ndarray, num_out: int) -> np.ndarray:
    """Mono -> N copies; otherwise the channel count is cut or zero-padded."""
    c = x.shape[0]
    if c == num_out:
        return x
    if c == 1:
        return np.broadcast_to(x, (num_out, x.shape[1])).copy()
    if c > num_out:
        return x[:num_out]
    out = np.zeros((num_out, x.shape[1]), x.dtype)
    out[:c] = x
    return out


def playlist_item_frames(path: str, rate: int) -> int:
    """One item's resampled length from its header alone (no decode):
    ``ceil(n * L / M)``, or ``n`` at the session rate."""
    info = codec.probe(path)
    if info.sample_rate == rate:
        return info.num_frames
    L, M = resolve_ratio(info.sample_rate, rate)
    return -(-info.num_frames * L // M)


def projected_frames(files: list[str], rate: int, silence_ms: int = 150,
                     loops: int = 1) -> int:
    """The programme's exact length from the headers alone: the items'
    resampled lengths plus the gaps (what routes the CLI to the streaming
    renderer)."""
    silence = int(round(silence_ms * rate / 1000.0))
    total = sum(playlist_item_frames(p, rate) for p in files)
    loops = max(1, loops)
    return total * loops + max(0, len(files) * loops - 1) * silence


def _validate_placement(output_channels: int, monitor: bool,
                        target_channels, monitor_channels) -> list | None:
    """The channel placement both forms accept; returns the target list, or
    None in plain mode."""
    if target_channels is not None:
        tc = list(target_channels)
        if not tc:
            raise ValueError("target_channels must not be empty")
        if len(set(tc)) != len(tc):
            raise ValueError(f"duplicate target channels: {tc}")
        bad = [c for c in tc if not 0 <= c < output_channels]
        if bad:
            raise ValueError(
                f"target channels {bad} outside the {output_channels}-channel bus")
    else:
        tc = None
    if monitor:
        if len(tuple(monitor_channels)) != 2:
            raise ValueError("monitor_channels must be exactly two channels")
        if monitor_channels[0] == monitor_channels[1]:
            # a fancy-index += with a repeated index applies only one row
            raise ValueError("monitor_channels must be two DISTINCT channels")
        ml, mr = monitor_channels
        if not (0 <= ml < output_channels and 0 <= mr < output_channels):
            raise ValueError(
                f"monitor channels {monitor_channels} outside the "
                f"{output_channels}-channel bus")
        if tc is None and tuple(monitor_channels) != (0, 1):
            raise ValueError(
                "monitor_channels placement requires target_channels "
                "(bus-render mode); plain previews return the mixdown "
                "separately")
    return tc


def _iter_item_blocks(path: str, rate: int, quality: str, kind: str,
                      chunk_seconds: float = 8.0, device=None):
    """One item's resampled float32 blocks ``(channels, n)`` on the host, in
    O(chunk) memory.

    A rate-matched item is read in `_MATCHED_BLOCK`-frame blocks.  Any other
    is cut into chunks of whole cycles (`stream.stream_chunk_plan`), each
    read with the bank's halos (zero past the item's ends) and resampled by
    `resample_presliced` on ``device``.  The last chunk is capped at the
    item's remaining cycles, so a short item is one chunk of exactly its
    cycles rather than a full chunk of zeros."""
    from .stream import stream_chunk_plan

    dev = resolve_device(device)
    with codec.open_reader(path) as reader:
        r, T = reader.sample_rate, reader.num_frames
        if r == rate:
            pos = 0
            while pos < T:
                blk = reader.read(pos, min(_MATCHED_BLOCK, T - pos))
                yield np.ascontiguousarray(blk, np.float32)
                pos += blk.shape[1]
            return
        bank = design_cycle_bank(r, rate, quality=quality, kind=kind)
        M, W = bank.M, bank.W
        halo_left = bank.pad_front
        halo_right = max(0, W - M - halo_left)
        chunk_in = stream_chunk_plan(bank, chunk_seconds, r)
        cycles = chunk_in // M
        out_total = bank.out_len(T)
        total_cycles = -(-T // M)
        emitted, k = 0, 0
        while emitted < out_total:
            start = k * chunk_in
            cyc = min(cycles, total_cycles - k * cycles)
            lo, hi = start - halo_left, start + cyc * M + halo_right
            span = reader.read(max(0, lo), min(hi, T) - max(0, lo))
            pad_l = max(0, -lo)
            pad_r = (hi - lo) - pad_l - span.shape[1]
            xp = np.pad(np.ascontiguousarray(span, np.float32),
                        ((0, 0), (pad_l, max(0, pad_r))))
            y = resample_presliced(torch.from_numpy(xp).to(dev), bank, cyc).cpu().numpy()
            take = min(y.shape[1], out_total - emitted)
            yield y[:, :take]
            emitted += take
            k += 1


def _mixdown(block: np.ndarray, dev: torch.device) -> np.ndarray:
    """`mixdown_monitor` of a host block on ``dev``, back on the host."""
    return mixdown_monitor(torch.from_numpy(np.ascontiguousarray(block)).to(dev)).cpu().numpy()


def render_playlist(
    files: list[str],
    rate: int,
    silence_ms: int = 150,
    output_channels: int = 2,
    monitor: bool = False,
    loops: int = 1,
    target_channels: list[int] | None = None,
    monitor_channels: tuple[int, int] = (0, 1),
    quality: str = "high",
    kind: str = "sinc",
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, np.ndarray | None, list[PlaylistItem]]:
    """Render ``files`` into one gapless ``(channels, frames)`` float32 array.

    ``target_channels`` picks which channels of the ``output_channels``-wide
    bus carry the programme (expanded to that many channels; the rest stay
    silent).  With ``monitor`` a stereo mixdown of the programme is returned
    beside it and, in bus mode (``target_channels`` set), also added onto
    ``monitor_channels`` of the bus.  Returns ``(main, monitor | None,
    items)``."""
    dev = resolve_device(device)
    tc = _validate_placement(output_channels, monitor, target_channels,
                             monitor_channels)
    content_ch = len(tc) if tc is not None else output_channels
    silence = int(round(silence_ms * rate / 1000.0))
    rendered: list[np.ndarray] = []
    items: list[PlaylistItem] = []
    cursor = 0
    playlist = [p for _ in range(max(1, loops)) for p in files]
    decoded: dict[str, np.ndarray] = {}
    for i, path in enumerate(playlist):
        if path not in decoded:
            blocks = list(_iter_item_blocks(path, rate, quality, kind, device=dev))
            x = (np.concatenate(blocks, axis=1) if blocks
                 else np.zeros((codec.probe(path).num_channels, 0), np.float32))
            decoded[path] = _expand_channels(x, content_ch)
        x = decoded[path]
        items.append(PlaylistItem(path=path, start_frame=cursor, num_frames=x.shape[1]))
        rendered.append(x)
        cursor += x.shape[1]
        if i != len(playlist) - 1 and silence > 0:
            rendered.append(np.zeros((content_ch, silence), np.float32))
            cursor += silence
    if not rendered:
        return np.zeros((output_channels, 0), np.float32), None, []
    programme = np.concatenate(rendered, axis=1)
    mon = _mixdown(programme, dev) if monitor else None
    if tc is None:
        main = programme
    else:
        main = np.zeros((output_channels, programme.shape[1]), np.float32)
        main[tc] = programme
        if monitor:
            # the mixdown adds onto the monitor channels of the same bus
            main[list(monitor_channels)] += mon
    return main, mon, items


def stream_playlist(
    files: list[str],
    rate: int,
    out_path: str,
    silence_ms: int = 150,
    output_channels: int = 2,
    monitor: bool = False,
    monitor_out: str | None = None,
    loops: int = 1,
    target_channels: list[int] | None = None,
    monitor_channels: tuple[int, int] = (0, 1),
    quality: str = "high",
    kind: str = "sinc",
    bits: int = 24,
    chunk_seconds: float = 8.0,
    device: torch.device | str | None = None,
) -> tuple[list[PlaylistItem], int]:
    """`render_playlist` in constant memory: each item is decoded,
    resampled, placed, quantized and written one block at a time, the
    monitor mixdown made per block (``monitor_out`` writes it to its own
    file and needs ``monitor``).  Every per-frame step is local to its
    frame and the SRC is chunk-invariant, so the bytes equal those of
    `render_playlist` + `io.wav.write_wav`.  Loops read their items again
    rather than keep them.  Returns ``(items, frames_written)``."""
    from ..io.wav import WavWriter

    dev = resolve_device(device)
    if monitor_out and not monitor:
        raise ValueError("monitor_out requires monitor=True")
    tc = _validate_placement(output_channels, monitor, target_channels,
                             monitor_channels)
    content_ch = len(tc) if tc is not None else output_channels
    silence = int(round(silence_ms * rate / 1000.0))
    playlist = [p for _ in range(max(1, loops)) for p in files]
    scale = float(1 << (bits - 1))

    def quantize(x: np.ndarray) -> np.ndarray:
        # write_wav's conversion: round half to even, then clip
        return np.clip(np.round(x * scale), -scale, scale - 1).astype(np.int32)

    items: list[PlaylistItem] = []
    cursor = 0
    mon_writer = None
    writer = WavWriter(out_path, output_channels, rate, bits=bits)
    try:
        if monitor_out:
            mon_writer = WavWriter(monitor_out, 2, rate, bits=bits)

        def emit(block: np.ndarray) -> None:
            nonlocal cursor
            mon = _mixdown(block, dev) if monitor else None
            if tc is None:
                mainb = block
            else:
                mainb = np.zeros((output_channels, block.shape[1]), np.float32)
                mainb[tc] = block
                if monitor:
                    mainb[list(monitor_channels)] += mon
            writer.append_codes(quantize(mainb))
            if mon_writer is not None:
                mon_writer.append_codes(quantize(mon))
            cursor += block.shape[1]

        for i, path in enumerate(playlist):
            n_item = playlist_item_frames(path, rate)
            items.append(PlaylistItem(path=path, start_frame=cursor, num_frames=n_item))
            got = 0
            for blk in _iter_item_blocks(path, rate, quality, kind,
                                         chunk_seconds=chunk_seconds, device=dev):
                emit(_expand_channels(blk, content_ch))
                got += blk.shape[1]
            if got != n_item:
                raise RuntimeError(f"{path}: {got} frames resampled, header says {n_item}")
            if i != len(playlist) - 1 and silence > 0:
                emit(np.zeros((content_ch, silence), np.float32))
    finally:
        writer.close()
        if mon_writer is not None:
            mon_writer.close()
    return items, cursor
