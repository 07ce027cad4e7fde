"""The plain reference of one batch, from the PCM wire to each file's codes
and figures, in float64 on the device it is given.

wire -> 24-bit decode -> routing -> zero past each file's length -> capture
head-room (reverb mode, or a chain) -> SRC -> chain -> latency trim ->
reverb-tail verdict -> DC removal, gain, statistics, dither, quantisation.

It takes from the run only the inputs both sides were handed (the wire, the
lengths, the dither seeds, the impulse responses) and, to judge a reverb
tail, the program's verdicts, which it accepts where its own window levels
allow them within ``slack_db``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import calibrate, design, finish, src, tail
from . import chain as plain_chain

#: a measured noise floor at or below this is numerically silent: the tail
#: detector falls back to its fixed threshold
SILENT_FLOOR_DB = -150.0


def decode(raw: torch.Tensor, channels: int, bits: int) -> torch.Tensor:
    """``(files, frames * channels * bits // 8)`` uint8 little-endian
    interleaved PCM -> ``(files, channels, frames)`` float64 in [-1, 1)."""
    nb = bits // 8
    files = raw.shape[0]
    b = raw.reshape(files, -1, channels, nb).to(torch.int64)
    v = sum(b[..., k] << (8 * k) for k in range(nb))
    v = v - ((v >> (bits - 1)) << bits)
    return (v.to(torch.float64) / float(1 << (bits - 1))).transpose(1, 2)


def capture_pad(cfg: dict, rate_in: int, latency: int, ringout_out: int) -> int:
    """Input frames of silence after the bucket: room for the latency (the
    source plus four times it), the chain's ring-out and, in reverb mode,
    one whole detection run, capped at ``max_tail_seconds``."""
    rate_out = cfg["target_rate"]
    lat_in = -(-max(0, latency) * rate_in // rate_out)
    tail_in = -(-ringout_out * rate_in // rate_out)
    cap = int(cfg.get("max_tail_seconds", 60.0) * rate_in)
    head = 5 * lat_in + tail_in + 4096
    if not cfg.get("reverb_mode"):
        return min(head, cap) if cfg.get("chain") else 0
    detect_ms = (cfg["tail_window_ms"] + (cfg["tail_consecutive"] + 1) * cfg["tail_hop_ms"]
                 + 100)
    return min(head + detect_ms * rate_in // 1000, cap)


class Reference:
    """The reference of one configuration at one input rate: its own
    calibration, made once, and `batch`."""

    def __init__(self, cfg: dict, rate_in: int, irs: dict, device, tf32: bool = False):
        self.cfg, self.rate_in, self.irs, self.dev, self.tf32 = cfg, rate_in, irs, device, tf32
        self.stages = cfg.get("chain") or []
        rate_out = cfg["target_rate"]
        self.ringout = (plain_chain.tail_frames(self.stages, rate_out, irs)
                        if self.stages else 0)
        self.latency, nf = calibrate.measure(rate_in, rate_out, cfg["quality"], cfg["kind"],
                                             self.stages, irs, device)
        self.floor_db = nf if cfg.get("reverb_mode") and nf > SILENT_FLOOR_DB else None
        self.latency_trim = self.latency if cfg.get("trim_enabled", True) else 0

    def batch(self, raw: torch.Tensor, valid, seeds, channels: int, bits: int,
              verdicts=None, slack_db: float = 0.0) -> dict:
        """The reference of one batch: ``files`` (a dict per file) and
        ``frames_bad``, the program's tail verdicts it cannot accept."""
        cfg, rate_in = self.cfg, self.rate_in
        rate_out = cfg["target_rate"]
        L, M = design.ratio(rate_in, rate_out)
        x = decode(raw.to(self.dev), channels, bits)
        routing = cfg.get("channel_routing")
        if routing:
            x = x[:, list(routing)]
        files, C, bucket = x.shape
        pos = torch.arange(bucket, device=self.dev)
        lens = torch.as_tensor([int(v) for v in valid], device=self.dev)
        x = torch.where(pos[None, None, :] < lens[:, None, None], x, 0.0)
        pad = capture_pad(cfg, rate_in, self.latency, self.ringout)
        x = F.pad(x, (0, pad))
        n_out = src.out_len(bucket + pad, rate_in, rate_out)
        whole = not self.stages and not cfg.get("reverb_mode") and self.latency_trim == 0
        y = src.resample(x.reshape(files * C, -1), rate_in, rate_out,
                         -(-n_out // L) * L if whole else n_out,
                         cfg["quality"], cfg["kind"], tf32=self.tf32).reshape(files, C, -1)
        del x
        if self.stages:
            y = plain_chain.apply(y, self.stages, rate_out, self.irs)
        y = y[..., :n_out]
        if self.latency_trim:
            lat = self.latency_trim
            y = (F.pad(y, (0, lat))[..., lat:] if lat > 0 else F.pad(y, (-lat, 0))[..., :n_out])
        out = []
        bad = 0
        thr = tail.threshold_db(self.floor_db, cfg.get("noise_floor_margin_pct", 10.0))
        win_floor = max(1, rate_out * cfg.get("tail_window_ms", 100) // 1000)
        for f in range(files):
            n_valid = min(-(-int(valid[f]) * L // M), n_out)
            frames, term = n_valid, True
            if cfg.get("reverb_mode"):
                lv, win, hop = tail.levels(y[f].abs().amax(dim=0), rate_out,
                                           cfg["tail_window_ms"], cfg["tail_hop_ms"])
                args = (lv, win, hop, n_out, thr, n_valid, cfg["tail_consecutive"])
                end, term = tail.verdict(*args)
                frames = max(min(end, n_out), n_valid) if n_valid > 0 else 0
                if verdicts is not None:
                    p_frames, p_term = verdicts[f]
                    if n_valid > 0 and tail.consistent(*args, slack_db, p_frames, p_term):
                        frames, term = p_frames, p_term
                    elif (p_frames, p_term) != (frames, term):
                        bad += 1
            elif verdicts is not None and tuple(verdicts[f]) != (frames, True):
                bad += 1
            codes, pk, rms, nf, exact, noise = finish.finish(
                y[f], frames, int(seeds[f]), bits=cfg["bits"], dither=cfg["dither"],
                remove_dc=cfg["remove_dc"], gain_db=cfg.get("gain_db", 0.0),
                floor_frames=win_floor)
            out.append(dict(codes=codes, out_frames=frames, terminated=term, peak_db=pk,
                            rms_db=rms, noise_floor_db=nf, exact=exact, dither=noise))
        return dict(files=out, frames_bad=bad)
