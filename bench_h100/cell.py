"""A cell of the benchmark, found by its name in ``BENCHMARK.json``: its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and the limits of its output check
(``limits/<workload>.json``), and what one general generator makes of them
from a seed: the library of files, the dispatch seeds, the impulse
responses and the program's configuration."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MASK64 = (1 << 64) - 1


def mix64(*words: int) -> int:
    """SplitMix64 over ``words``: a 64-bit key from a seed and indices."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (int(w) & MASK64)) & MASK64
        h = (h + 0x9E3779B97F4A7C15) & MASK64
        h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & MASK64
        h ^= h >> 31
    return h


def _read(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def name(self) -> str:
        return self.workload["name"]

    def bucket(self) -> int:
        """The one length bucket the mix's files fall in, by the batch
        job's rule: the first bucket that holds the file; in reverb mode the
        capture is capped at ``max_tail_seconds`` and sized between."""
        cfg, tr = self.config, self.traffic
        found = set()
        for n in self.lengths_set():
            b = next((b for b in sorted(cfg["bucket_frames"]) if n <= b), n)
            if cfg.get("reverb_mode"):
                cap = int(cfg["max_tail_seconds"] * tr["rate_in"])
                b = min(max(b, min(n, cap)), cap)
            found.add(b)
        if len(found) != 1 or max(found) > max(cfg["bucket_frames"]):
            raise ValueError(f"{self.name}: the mix's files span buckets {sorted(found)}")
        return found.pop()

    def lengths_set(self) -> list[int]:
        """Every seed's file lengths, in frames: evenly spread over the
        mix's range, so each seed makes the same work in another order."""
        tr = self.traffic
        lo, hi = tr["seconds"]
        n = tr["files"]
        return [int(round((lo + (hi - lo) * (i + 0.5) / n) * tr["rate_in"])) for i in range(n)]

    def lengths(self, seed: int) -> list[int]:
        order = np.random.default_rng(mix64(seed, 1) & 0xFFFFFFFF).permutation(self.traffic["files"])
        base = self.lengths_set()
        return [base[i] for i in order]

    def dither_seeds(self, seed: int, dispatch: int) -> np.ndarray:
        """The int32 per-file dither seeds of one dispatch."""
        files = self.config["batch_size"]
        return np.array([mix64(seed, 2, dispatch, i) & 0x7FFFFFFF for i in range(files)],
                        np.int32)

    def impulse_responses(self) -> dict:
        """``{stage index: (channels, frames) float32}`` of the reverb
        stages: exponentially decaying noise at unit energy per channel,
        ``decay_db`` down at its end, behind a direct-sound spike, made
        from the configuration's own seed."""
        out = {}
        for i, s in enumerate(self.config.get("chain") or []):
            if s["stage"] != "reverb":
                continue
            ir = s["ir"]
            rate = self.config["target_rate"]
            n = int(ir["seconds"] * rate)
            tau = ir["seconds"] / (ir["decay_db"] / (20.0 * np.log10(np.e)))
            rng = np.random.default_rng(ir["seed"])
            h = rng.standard_normal((ir["channels"], n)) * np.exp(-np.arange(n) / (tau * rate))
            h /= np.sqrt(np.sum(np.square(h), axis=-1, keepdims=True))
            h[:, 0] = ir["direct"]
            out[i] = h.astype(np.float32)
        return out


def load(workload: str, overrides: dict | None = None) -> Cell:
    """The cell named ``workload`` in ``BENCHMARK.json`` at the checkout's
    root, each of its files updated by ``overrides`` (``{"config": {...},
    "traffic": {...}, "limits": {...}}``, for tests)."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    ov = overrides or {}
    config = {**_read("configs", wl["config"] + ".json"), **ov.get("config", {})}
    traffic = {**_read("traffic", wl["traffic"] + ".json"), **ov.get("traffic", {})}
    limits = {**_read("limits", workload + ".json"), **ov.get("limits", {})}

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return Cell(wl, config, traffic, limits,
                [m for m in bench["end_to_end"] if here(m)],
                [m for m in bench["per_layer"] if here(m)])
