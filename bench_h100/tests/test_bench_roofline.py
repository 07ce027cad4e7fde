"""Each roofline count recounted by hand from shapes, on the CPU, and
`PERF.md`'s bound column recounted with the counts: a bound that counted the
algorithm's bytes stays, one that counted an implementation's instructions
moves."""

from __future__ import annotations

import importlib.util
import os

import pytest

from bench_h100 import tracing
from bench_h100.reference import src
from bench_h100.roofline import peaks

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _count(kernel: str):
    spec = importlib.util.spec_from_file_location(
        "t_" + kernel, os.path.join(HERE, "roofline", kernel + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shape(**kw):
    base = dict(files=8, channels_in=2, channels=2, bytes_in=3, bytes_out=3, bucket=1 << 22,
                pad=0, rate_in=44100, rate_out=48000, L=160, M=147,
                taps=[int(t) for t in src.taps_per_output(44100, 48000)], chain=[])
    base.update(kw)
    return base


def test_front_end_full_bucket_is_pr19s_bound():
    s = _shape(valid=[1 << 22] * 8)
    flops, nbytes = _count("front_end").work(s)
    assert (flops, nbytes) == (0.0, 8 * (1 << 22) * 6 + 8 * 2 * (1 << 22) * 4)
    assert peaks.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.1402, abs=1e-4)


def test_cycle_src_kernel_table_bound_stays():
    # 32 signals x 2^20 frames, 44.1k -> 48k high: 280.5 MB, bytes-bound
    n_out = src.out_len(1 << 20, 44100, 48000)
    s = _shape(files=16, valid=[1 << 20] * 16, src_out=n_out)
    flops, nbytes = _count("cycle_src").work(s)
    assert flops == pytest.approx(2 * 32 * n_out * 128, rel=1e-3)      # 9.35 GFLOP
    assert flops / 1e9 == pytest.approx(9.35, abs=0.01)
    assert nbytes == 4 * 32 * ((1 << 20) + n_out) + 4 * 20480
    assert peaks.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0837, abs=1e-4)


def test_epilogue_payload_bound_stays():
    # bench.py's 16 x 2 x 1,141,440 outputs into the 24-bit payload
    s = _shape(files=16, out_frames=[1141440] * 16, out_total=1141440)
    assert peaks.bound_s(*_count("epilogue").work(s)) * 1e3 == pytest.approx(0.0763, abs=1e-4)


def test_fir_fold_bound_moves_to_the_algorithms_operations():
    # the EQ's 351 taps over 8 x 2 x 2,903,040: 0.972 ms counted 701 float32
    # instructions an output at the float32 cores' rate; the algorithm's 702
    # operations at float32 accuracy take 0.197 ms
    T = 2903040
    s = _shape(out_total=T, valid=[T * 147 // 160] * 8,
               chain=[dict(stage="biquad", taps=351)])
    flops, nbytes = _count("fir_fold").work(s)
    assert flops == pytest.approx(2 * 351 * 16 * T, rel=1e-6)
    assert peaks.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.1976, abs=1e-3)


def test_upols_mac_group_bound_moves_to_bytes():
    # one group of the reverb: K = 30, 32 blocks, 2 x 8 rows, 4097 bins:
    # 0.0225 ms counted the float64 instruction mix; the K-deep complex
    # multiply-add at float32 accuracy is 3.05 us, the spectra 15.2 us
    rows, K, G, bins = 16, 30, 32, 4097
    flops = 8.0 * rows * G * bins * K
    nbytes = 8.0 * bins * (rows * (K - 1 + G) + rows * G + 2 * K)
    assert flops / peaks.FP32_ACCURATE_FLOP_PER_S * 1e6 == pytest.approx(3.05, abs=0.01)
    assert peaks.bound_s(flops, nbytes) * 1e3 == pytest.approx(0.0152, abs=2e-4)


def test_upols_mac_counts_only_blocks_that_hold_signal():
    s = _shape(out_total=4096 * 100, valid=[4096 * 10 * 147 // 160] * 8,
               chain=[dict(stage="reverb", ir_frames=4096 * 30, ir_channels=2)])
    flops, nbytes = _count("upols_mac").work(s)
    # 10 blocks of signal (11 with the rounding up), each meeting all 30 partitions
    per_row = 8.0 * 4097 * 30 * 10
    assert flops == pytest.approx(16 * per_row, rel=0.11)
    assert _count("upols_mac").work(_shape(chain=[])) is None


def test_share_reads_kernel_time_against_the_bound():
    s = _shape(valid=[1 << 22] * 8)
    bound = peaks.bound_s(*_count("front_end").work(s))
    rec = dict(events=[dict(name="void front_end_kernel(FeArgs)", start=0.0,
                            end=2e6 * bound, kind="kernel")], shapes=[s], port=["front_end_kernel"])
    assert tracing.roofline_share(rec, "front_end") == pytest.approx(50.0)
    rec["events"] = []
    assert tracing.roofline_share(rec, "front_end") is None


def test_busy_is_a_union_over_streams():
    assert tracing._union([(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)]) == [
        (0, 12), (20, 30), (40, 41)]


def test_trace_check_names_missing_kernels():
    rec = dict(events=[dict(name="void cycle_src_tc<8, false>(...)", kind="kernel", start=0,
                            end=1), dict(name="Memcpy HtoD (Pinned -> Device)", kind="htod",
                                         start=0, end=1)],
               port=["cycle_src_tc", "front_end_kernel"])
    assert tracing.missing_kernels(rec, ["cycle_src", "front_end_kernel"]) == ["front_end_kernel"]
    assert tracing.port_kernels_seen(rec) == ["cycle_src_tc"]


def test_port_kernel_names_are_found():
    names = tracing.port_kernel_names()
    for k in ("cycle_src_tc", "front_end_kernel", "dc_pass", "finish_pass", "fir_fold_kernel",
              "upols_mac_reg", "env_scan", "wmax_reg"):
        assert k in names
