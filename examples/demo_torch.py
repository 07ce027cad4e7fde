"""End-to-end demo of the PyTorch/CUDA port: `examples/demo.py`'s 13
configurations, through `f9tpu_torch.cli.main`, with the same asserts.

Generates a small synthetic library, then drives each configuration
through the port's CLI on ``--device`` (default ``cuda``; ``cpu`` runs the
plain PyTorch path):

    python examples/demo_torch.py [workdir] [--device cpu] [--configs 1-5]

``--configs`` runs a subset (``1-5``, ``1,3,8``); the library is written
whole either way.  Imports nothing of JAX or of the JAX package.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from f9tpu_torch.cli import main as cli_main  # noqa: E402
from f9tpu_torch.io import read_wav, write_wav  # noqa: E402
from f9tpu_torch.models import resample_oracle  # noqa: E402

CONFIGS = tuple(range(1, 14))


def db(err, ref):
    return 20 * np.log10(np.sqrt((err**2).mean()) / np.sqrt((ref**2).mean()) + 1e-30)


def _configs(spec: str) -> set[int]:
    """``"1-5"`` / ``"1,3,8"`` / ``"all"`` -> the configuration numbers."""
    if spec == "all":
        return set(CONFIGS)
    out = set()
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out.update(range(int(lo), int(hi or lo) + 1))
    return out


def run(workdir: str, device: str = "cuda", configs=CONFIGS) -> None:
    def main(argv):
        return cli_main([*argv, "--device", device])

    rng = np.random.default_rng(0)
    lib = os.path.join(workdir, "lib")
    os.makedirs(lib, exist_ok=True)

    # each configuration's inputs are written whether it runs or not, in
    # demo.py's order, so every configuration sees demo.py's data and folder

    # --- config 1: single mono 44.1k -> 48k, parity vs the oracle ---
    mono = (0.12 * rng.standard_normal(44100)).astype(np.float32)
    write_wav(f"{lib}/mono.wav", mono, 44100, bits=24)
    if 1 in configs:
        rc = main(["process", f"{lib}/mono.wav", "--out", f"{workdir}/c1",
                   "--rate", "48000", "--quality", "high", "--no-dither", "--keep-dc"])
        assert rc == 0
        y, _ = read_wav(f"{workdir}/c1/mono_processed.wav")
        ref = resample_oracle(mono, 44100, 48000, quality="high")
        parity = db(y[0].astype(np.float64) - ref, ref)
        print(f"[1] mono 44.1->48k parity vs oracle: {parity:.1f} dB (target <= -120)")
        assert parity <= -120

    # --- config 2: stereo batch 96k -> 44.1k, TPDF dither to 24-bit ---
    for i in range(3):
        x = (0.2 * rng.standard_normal((2, 96000))).astype(np.float32)
        write_wav(f"{lib}/s96_{i}.wav", x, 96000, bits=24)
    if 2 in configs:
        rc = main(["process", f"{lib}/s96_0.wav", f"{lib}/s96_1.wav", f"{lib}/s96_2.wav",
                   "--out", f"{workdir}/c2", "--rate", "44100", "--quality", "high"])
        assert rc == 0
        print("[2] stereo 96k->44.1k batch with TPDF dither: 3/3 completed")

    # --- config 3: MCFX 8-ch with routing map ---
    bus = (0.15 * rng.standard_normal((8, 44100))).astype(np.float32)
    write_wav(f"{lib}/bus.wav", bus, 44100, bits=24)
    if 3 in configs:
        rc = main(["process", f"{lib}/bus.wav", "--out", f"{workdir}/c3",
                   "--rate", "48000", "--quality", "high", "--routing", "7,0,-1,3"])
        assert rc == 0
        y3, _ = read_wav(f"{workdir}/c3/bus_processed.wav")
        assert y3.shape[0] == 4 and np.all(y3[2] == 0)
        print("[3] MCFX 8-ch routed to 4 buses (silent bus is digital zero)")

    # --- config 4: latency-compensated render + reverb tail trim ---
    t = np.arange(44100) / 44100
    hit = (0.4 * np.sin(2 * np.pi * 220 * t) * np.exp(-t * 8)).astype(np.float32)
    write_wav(f"{lib}/hit.wav", np.stack([hit, hit]), 44100, bits=24)
    if 4 in configs:
        rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c4",
                   "--rate", "48000", "--quality", "high", "--reverb",
                   "--noise-floor", "-96"])
        assert rc == 0
        print("[4] reverb-mode render with auto latency calibration + tail trim")

    # --- config 5: mixed-rate library in one run ---
    for rate in (44100, 48000, 88200, 96000, 192000):
        x = (0.15 * rng.standard_normal((2, rate // 2))).astype(np.float32)
        write_wav(f"{lib}/r{rate}.wav", x, rate, bits=24)
    if 5 in configs:
        rc = main(["process", lib, "--out", f"{workdir}/c5",
                   "--rate", "48000", "--quality", "high", "--json"])
        assert rc == 0
        print("[5] mixed-rate studio library -> 48k in one batch")

    # --- config 6: the insert loop: convolution reverb in the chain,
    # latency measured and trimmed, tail kept to the noise floor ---
    ir_len = 24000                                   # 0.5 s ring-out @ 48k
    tt = np.arange(ir_len) / 48000
    ir = np.zeros(ir_len, np.float32)
    ir[0] = 1.0
    ir[1:] = (0.03 * rng.standard_normal(ir_len - 1)
              * np.exp(-tt[1:] / 0.12)).astype(np.float32)
    write_wav(f"{lib}/hall_ir.wav", ir[None], 48000, bits=32)
    if 6 in configs:
        rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c6",
                   "--rate", "48000", "--quality", "high", "--reverb",
                   "--noise-floor", "-90", "--chain-ir", f"{lib}/hall_ir.wav",
                   "--chain-wet", "0.6", "--chain-dry", "0.4"])
        assert rc == 0
        y6, _ = read_wav(f"{workdir}/c6/hit_processed.wav")
        src_out = int(np.ceil(44100 * 48000 / 44100))
        assert y6.shape[1] > src_out            # the tail extended past the source
        print(f"[6] insert-loop reverb: tail extended {y6.shape[1] - src_out} "
              f"frames past the source and terminated at the noise floor")

    # --- config 7: an outboard rack in the loop: EQ -> bus compressor ->
    # tape saturation -> stereo width ---
    if 7 in configs:
        rc = main(["process", f"{lib}/s96_0.wav", "--out", f"{workdir}/c7",
                   "--rate", "48000", "--quality", "high",
                   "--chain-eq", "highshelf:8000:0.7:2.0", "--chain-comp=-20:3:5:120:1",
                   "--chain-sat", "tanh:3:0.8", "--chain-width", "1.2", "--seed", "1"])
        assert rc == 0
        y7, _ = read_wav(f"{workdir}/c7/s96_0_processed.wav")
        assert np.isfinite(y7).all() and np.abs(y7).max() <= 1.0
        print("[7] outboard rack: EQ -> compressor -> saturator -> width")

    # --- config 8: varispeed, NTSC pull-down 44.1k -> 44.056k (no dense
    # cycle matrix: the kernel's windowed form), AIFF out ---
    if 8 in configs:
        from f9tpu_torch.io.aiff import read_aiff

        rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c8",
                   "--rate", "44056", "--quality", "high", "--format", "aiff",
                   "--seed", "1"])
        assert rc == 0
        y8, r8 = read_aiff(f"{workdir}/c8/hit_processed.aiff")
        assert r8 == 44056
        print(f"[8] NTSC pull-down 44.1k->44.056k (windowed form), AIFF out: "
              f"{y8.shape[1]} frames")

    # --- config 9: loudness normalization to a streaming deliverable ---
    if 9 in configs:
        from f9tpu_torch.ops.loudness import integrated_lufs, true_peak_db

        rc = main(["process", f"{lib}/hit.wav", f"{lib}/s96_0.wav",
                   "--out", f"{workdir}/c9", "--rate", "48000", "--quality", "high",
                   "--normalize-lufs=-16", "--normalize-tp=-1", "--seed", "1"])
        assert rc == 0
        for stem in ("hit", "s96_0"):
            y9, r9 = read_wav(f"{workdir}/c9/{stem}_processed.wav")
            y9 = y9.astype(np.float32)
            lufs = float(integrated_lufs(y9, r9, device=device))
            tp = float(true_peak_db(y9, r9, device=device))
            # two-sided: AT the target, unless the dBTP ceiling held it
            # below (a one-sided bound would pass a normalizer that applied
            # no gain)
            assert (-17.0 < lufs < -15.0) or (lufs < -15.0 and tp > -1.3), (stem, lufs, tp)
        print("[9] loudness-normalized to -16 LUFS / -1 dBTP ceiling")

    # --- config 10: the streaming feature set in one pass: AIFF in,
    # routing with a silent bus, loudness-normalized, constant memory ---
    from f9tpu_torch.io.aiff import write_aiff

    quad = (0.15 * rng.standard_normal((4, 44100 * 2))).astype(np.float32)
    write_aiff(f"{lib}/quad.aiff", quad, 44100, bits=24)
    if 10 in configs:
        rc = main(["stream", f"{lib}/quad.aiff", "--out", f"{workdir}/c10/quad48.wav",
                   "--rate", "48000", "--quality", "high", "--routing", "3,0,-1,1",
                   "--normalize-lufs=-18", "--seed", "1", "--chunk-seconds", "0.5"])
        assert rc == 0
        y10, r10 = read_wav(f"{workdir}/c10/quad48.wav")
        assert r10 == 48000 and y10.shape[0] == 4 and np.all(y10[2] == 0)
        print("[10] streamed AIFF -> routed 4-bus, normalized WAV (constant memory)")

    # --- config 11: minimum-phase SRC, no pre-ringing ahead of transients ---
    if 11 in configs:
        rc = main(["process", f"{lib}/hit.wav", "--out", f"{workdir}/c11",
                   "--rate", "48000", "--quality", "high", "--kind", "minphase",
                   "--seed", "1"])
        assert rc == 0
        y11, r11 = read_wav(f"{workdir}/c11/hit_processed.wav")
        assert r11 == 48000 and np.isfinite(y11).all()
        print("[11] minimum-phase resample (no pre-ringing)")

    # --- config 12: FLAC in -> FLAC out with tags carried ---
    from f9tpu_torch.io.flac import (insert_blocks_flac, read_extra_blocks_flac,
                                     read_flac, write_flac)

    stem12 = (0.2 * rng.standard_normal((2, 44100))).astype(np.float32)
    write_flac(f"{lib}/stem.flac", stem12, 44100, bits=24)
    vc = (b"\x0a\x00\x00\x00f9tpu-demo\x01\x00\x00\x00"
          b"\x10\x00\x00\x00TITLE=Demo Stem!")
    insert_blocks_flac(f"{lib}/stem.flac", [(4, vc)])
    if 12 in configs:
        rc = main(["process", f"{lib}/stem.flac", "--out", f"{workdir}/c12",
                   "--rate", "48000", "--format", "flac", "--keep-metadata", "--seed", "1"])
        assert rc == 0
        y12, r12 = read_flac(f"{workdir}/c12/stem_processed.flac")
        assert r12 == 48000 and y12.shape == (2, 48000)
        assert read_extra_blocks_flac(f"{workdir}/c12/stem_processed.flac") == [(4, vc)]
        print("[12] FLAC -> FLAC (tags carried, MD5-verified lossless output)")

    # --- config 13: the drop-zone input surface in one batch: Ogg Vorbis,
    # ALAC-in-CAF, ALAC-in-M4A, MP3 and AU fixtures to 48k WAV ---
    if 13 in configs:
        fx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
        srcs13 = [f"{fx}/tone.ogg", f"{fx}/tone.caf", f"{fx}/tone.m4a",
                  f"{fx}/tone.mp3", f"{fx}/tone.au"]
        if all(os.path.exists(p) for p in srcs13):
            rc = main(["process", *srcs13, "--out", f"{workdir}/c13",
                       "--rate", "48000", "--quality", "low", "--seed", "1"])
            assert rc == 0
            outs = sorted(os.listdir(f"{workdir}/c13"))
            # same stem from five containers: collision-safe naming suffixes
            done = [o for o in outs if o.endswith(".wav")]
            assert len(done) == 5, outs
            for o in done:
                yy, rr = read_wav(f"{workdir}/c13/{o}")
                assert rr == 48000 and np.isfinite(yy).all()
            print("[13] drop-zone surface: .ogg/.caf/.m4a/.mp3/.au -> 48k WAV")
        else:
            print("[13] skipped (fixtures missing)")
    print("demo complete:", workdir)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--configs", default="all")
    args = ap.parse_args()
    t0 = time.time()
    run(args.workdir or tempfile.mkdtemp(prefix="f9tpu_torch_demo_"), args.device,
        _configs(args.configs))
    print(f"demo wall: {time.time() - t0:.1f} s on {args.device}")
