"""The plain reverb-tail detector, and the test of a tail verdict against it.

Levels are taken over hop-aligned windows of ``ceil(window / hop)`` hops
(the loudest channel's peak, in dB); ``consecutive`` windows in a row below
the threshold, each ending at or after the file's source span, end the
capture where the last of them ends.  A capture that never falls quiet keeps
its whole length and is not terminated.
"""

from __future__ import annotations

import torch

FALLBACK_DB = -80.0


def threshold_db(noise_floor_db, margin_pct: float) -> float:
    """``nf + nf * margin / 100`` for a negative floor, else -80 dB."""
    if noise_floor_db is None or noise_floor_db >= 0:
        return FALLBACK_DB
    return noise_floor_db + noise_floor_db * margin_pct / 100.0


def levels(mono: torch.Tensor, rate: int, window_ms: int, hop_ms: int):
    """``(levels_db (n_win,), win, hop)`` of ``mono (T,)`` float64."""
    hop = max(1, rate * hop_ms // 1000)
    win = max(1, rate * window_ms // 1000)
    factor = -(-win // hop)
    win = factor * hop
    T = mono.shape[-1]
    n_win = (T - win) // hop + 1
    if n_win <= 0:
        return mono.new_zeros((0,)), win, hop
    chunks = mono[:(n_win + factor - 1) * hop].reshape(-1, hop).amax(dim=-1)
    peaks = chunks.unfold(0, factor, 1).amax(dim=-1)[:n_win]
    lv = torch.where(peaks > 0, 20.0 * torch.log10(torch.clamp(peaks, min=1e-300)),
                     torch.full_like(peaks, -200.0))
    return lv, win, hop


def _first_run(quiet: torch.Tensor, consecutive: int) -> int:
    """Index of the first window ending a run of ``consecutive`` quiet ones,
    or -1."""
    n = quiet.shape[0]
    run = quiet.clone()
    for s in range(1, consecutive):
        shifted = torch.zeros_like(quiet)
        if s < n:
            shifted[s:] = quiet[:n - s]
        run &= shifted
    hit = torch.nonzero(run)
    return int(hit[0]) if hit.numel() else -1


def verdict(lv: torch.Tensor, win: int, hop: int, T: int, thr: float, min_frames: int,
            consecutive: int, slack_db: float = 0.0, at: int | None = None):
    """``(end_frame, terminated)`` of the levels ``lv``.  With ``at`` (a
    window index) the quietest verdict the levels allow within ``slack_db``
    that still puts a run's end at ``at``: the windows of that run count as
    quiet where they lie below ``thr + slack_db``, every other window only
    where it lies below ``thr - slack_db``."""
    n = lv.shape[0]
    ends = torch.arange(n, device=lv.device) * hop + win
    eligible = ends >= min_frames
    quiet = (lv < thr - slack_db) & eligible
    if at is not None:
        lo = max(0, at - consecutive + 1)
        forced = (lv[lo:at + 1] < thr + slack_db) & eligible[lo:at + 1]
        quiet[lo:at + 1] = forced
    first = _first_run(quiet, consecutive)
    if first < 0:
        return T, False
    return min(first * hop + win, T), True


def consistent(lv, win: int, hop: int, T: int, thr: float, min_frames: int,
               consecutive: int, slack_db: float, end: int, terminated: bool) -> bool:
    """Whether a detector whose window levels each lie within ``slack_db``
    of ``lv`` can reach the verdict ``(end, terminated)``."""
    if not terminated:
        return end == T and not verdict(lv, win, hop, T, thr, min_frames, consecutive,
                                        slack_db)[1]
    at = (end - win) // hop
    if end < win or (end - win) % hop or at >= lv.shape[0]:
        return False
    return verdict(lv, win, hop, T, thr, min_frames, consecutive, slack_db,
                   at=at) == (end, True)
