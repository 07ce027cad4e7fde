"""The port's batch graph against the JAX package's, on the same inputs.

3 files x 2 channels x 5000 frames with valid lengths 5000 / 3000 / 17,
seeds 1..3, dither on.  `out_frames` and `tail_terminated` must be
identical; peak, RMS and noise-floor dB within 1e-3 dB; PCM codes within
2 LSB (the JAX package's own tolerance between its SRC forms, which sum in
different orders and so round differently at exact quantizer boundaries)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from f9tpu.config import ProcessingConfig  # noqa: E402
from f9tpu.ops import trim as jtrim  # noqa: E402
from f9tpu.pipeline import graph as jgraph  # noqa: E402
from f9tpu_torch.config import ProcessingConfig as TConfig  # noqa: E402
from f9tpu_torch.models import design_cycle_bank as tbank  # noqa: E402
from f9tpu_torch.ops import trim as ttrim  # noqa: E402
from f9tpu_torch.pipeline import graph as tgraph  # noqa: E402

FILES, C, T = 3, 2, 5000
VALID = np.array([5000, 3000, 17], np.int32)
SEEDS = np.arange(1, FILES + 1, dtype=np.int32)


def _float_batch(channels: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(T) / 44100
    x = (0.25 * np.sin(2 * np.pi * 997.0 * t)
         + 0.05 * rng.standard_normal((FILES, channels, T)) + 0.01)
    return x.astype(np.float32)


def _raw_batch(bits: int, big_endian: bool, seed: int) -> np.ndarray:
    """Interleaved integer-PCM bytes of _float_batch, zero beyond each
    file's valid length (as the scheduler stages them)."""
    s = 1 << (bits - 1)
    codes = np.round(_float_batch(C, seed) * s).astype(np.int64)
    inter = np.swapaxes(codes, 1, 2) & ((1 << bits) - 1)     # (files, T, C)
    nb = bits // 8
    b = np.stack([(inter >> (8 * k)) & 0xFF for k in range(nb)], axis=-1)
    if big_endian:
        b = b[..., ::-1]
    raw = b.astype(np.uint8).reshape(FILES, -1)
    for i, n in enumerate(VALID):
        raw[i, n * C * nb:] = 0
    return raw


def _payload_codes(payload: np.ndarray, bits: int) -> np.ndarray:
    nb = bits // 8
    b = payload.reshape(payload.shape[0], -1, nb).astype(np.int64)
    v = sum(b[..., k] << (8 * k) for k in range(nb))
    return v - ((v >> (bits - 1)) << bits)                  # sign-extend


def _check(got, want, codes_got, codes_want, bits=24):
    assert np.array_equal(got.out_frames.numpy(), np.asarray(want.out_frames))
    assert np.array_equal(got.tail_terminated.numpy(),
                          np.asarray(want.tail_terminated))
    for name in ("peak_db", "rms_db", "noise_floor_db"):
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert np.abs(g - w).max() <= 1e-3, (name, g, w)
    assert codes_got.shape == codes_want.shape
    diff = np.abs(codes_got.astype(np.int64) - codes_want.astype(np.int64))
    # float32 carries 24 significant bits: at 32-bit output the 2 LSB bound
    # is 2 LSB of 24-bit resolution, 2 * 2^8 codes
    tol = 2 << max(0, bits - 24)
    assert diff.max() <= tol, (
        f"{int((diff != 0).sum())} of {diff.size} codes differ, max {diff.max()} LSB")


@pytest.mark.parametrize("in_bits,big_endian,out_bits", [
    (24, False, 24), (24, True, 24), (16, False, 24), (16, True, 16)])
def test_process_batch_raw_matches_jax(in_bits, big_endian, out_bits):
    raw = _raw_batch(in_bits, big_endian, seed=in_bits + big_endian)
    kw = dict(output_dir="/tmp/x", target_rate=48000, bits=out_bits)
    want = jgraph.process_batch_raw(jnp.asarray(raw), VALID, ProcessingConfig(**kw), 44100,
                                    jnp.asarray(SEEDS), in_channels=C,
                                    in_bits=in_bits, in_big_endian=big_endian)
    got = tgraph.process_batch_raw(raw, VALID, TConfig(**kw), 44100, SEEDS, in_channels=C,
                                   in_bits=in_bits, in_big_endian=big_endian,
                                   device="cpu")
    assert got.codes.dtype == torch.uint8
    _check(got, want, _payload_codes(got.codes.numpy(), out_bits),
           _payload_codes(np.asarray(want.codes), out_bits))


@pytest.mark.parametrize("case", ["stereo", "mono_to_stereo", "no_dither_gain",
                                  "latency", "acausal", "bits32_48k_to_44k",
                                  "identity_rate"])
def test_process_batch_matches_jax(case):
    kw = dict(output_dir="/tmp/x", target_rate=48000)
    rate_in, channels, latency = 44100, C, 0
    if case == "mono_to_stereo":
        channels, kw["output_channels"] = 1, 2
    elif case == "no_dither_gain":
        kw.update(dither=False, remove_dc=False, gain_db=-3.0)
    elif case == "latency":
        latency = 3
    elif case == "acausal":
        latency = -2
    elif case == "identity_rate":           # L = M = 1: the unfold form
        kw.update(target_rate=44100)
    elif case == "bits32_48k_to_44k":
        rate_in = 48000
        kw.update(target_rate=44100, bits=32, quality="medium")
    cfg = TConfig(**kw)
    x = _float_batch(channels, seed=len(case))
    for i, n in enumerate(VALID):
        x[i, :, n:] = 0.0
    want = jgraph.process_batch(jnp.asarray(x), VALID, ProcessingConfig(**kw), rate_in,
                                jnp.asarray(SEEDS), latency_frames=latency)
    got = tgraph.process_batch(torch.from_numpy(x), VALID, cfg, rate_in,
                               SEEDS, latency_frames=latency)
    assert got.codes.dtype == torch.int32
    _check(got, want, got.codes.numpy(), np.asarray(want.codes), bits=cfg.bits)


def test_trim_and_mask_match_jax():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((3, 2, 300)).astype(np.float32)
    for lat, out in [(0, 300), (7, 300), (-5, 320), (np.array([3, -1, 400]), 280)]:
        want = np.asarray(jtrim.trim_latency(jnp.asarray(y), jnp.asarray(lat), out))
        got = ttrim.trim_latency(torch.from_numpy(y), lat, out).numpy()
        assert np.array_equal(got, want), lat
    end = np.array([300, 11, 0], np.int32)
    want = np.asarray(jtrim.mask_beyond(jnp.asarray(y), jnp.asarray(end)))
    got = ttrim.mask_beyond(torch.from_numpy(y), torch.from_numpy(end)).numpy()
    assert np.array_equal(got, want)


def test_exact_length_math_and_its_guard():
    from f9tpu.models import design_cycle_bank

    bank = tbank(44100, 48000)
    n = np.array([0, 1, 146, 147, 148, 60 * 192000], np.int32)
    want = np.asarray(jgraph._exact_out_valid(jnp.asarray(n), design_cycle_bank(44100, 48000),
                                              2**31 - 1))
    got = tgraph._exact_out_valid(torch.from_numpy(n), bank, 2**31 - 1).numpy()
    assert np.array_equal(got, want)
    assert got[-1] == -(-60 * 192000 * 160 // 147)
    # beyond the int32 range the port clamps to out_total instead of wrapping
    big = torch.tensor([2**31 - 1], dtype=torch.int32)
    assert tgraph._exact_out_valid(big, bank, 2**31 - 1).tolist() == [2**31 - 1]
    fine = tbank(44100, 44056)       # L*M near 2^27: within the guard
    assert fine.L * fine.M < 2**31
    tgraph._exact_out_valid(torch.from_numpy(n), fine, 10)

    class Huge:
        L, M = 65536, 65535
    with pytest.raises(ValueError, match="int32 length math"):
        tgraph._exact_out_valid(torch.from_numpy(n), Huge, 10)


@pytest.mark.parametrize("what", ["rows_layout", "channel_axis"])
def test_unported_options_name_their_roadmap_item(what):
    """The graph's remaining refusal (the rows layout) names its ROADMAP
    item; the insert chain, reverb mode, channel routing and the channel
    axis are ported and refuse nothing.  A graph run on two channel shards
    (`run_sharded`, the channel axis's collectives) gives the one-device
    graph's codes and metrics."""
    assert not set(tgraph.NOT_PORTED) & {"chain", "reverb_mode", "channel_routing",
                                         "channel_axis", "mesh"}
    cfg = TConfig(output_dir="/tmp/x", target_rate=48000, quality="low", reverb_mode=True)
    x = torch.zeros((1, 2, 100))
    if what == "rows_layout":
        with pytest.raises(NotImplementedError, match="rows layout"):
            tgraph.process_batch(x, [100], cfg, 44100, [1], rows_layout=True)
        return
    from f9tpu_torch.parallel import P, make_mesh, run_sharded

    x = torch.from_numpy(_float_batch(4, seed=5))
    args = (x, torch.from_numpy(VALID), torch.zeros(FILES, dtype=torch.int64),
            torch.tensor(1.0), torch.from_numpy(SEEDS))
    kw = dict(rate_in=44100, rate_out=48000, cfg_key=tgraph._cfg_key(cfg, 2000),
              static_zero_latency=True)
    want = tgraph._process_impl(*args, **kw)
    got = run_sharded(
        make_mesh(1, 1, 2, devices=["cpu"] * 2),
        lambda ctx, *a: tgraph._process_impl(*a, channel_axis=ctx.axis("channels"), **kw),
        args, (P(None, "channels"), P(), P(), P(), P()),
        (P(None, "channels"), P(), P(), P(), P(), P()))
    for k, (g, w) in enumerate(zip(got, want)):
        if k == 4:          # rms: a sum of two shards' partial sums
            assert torch.allclose(g, w, rtol=1e-5, atol=0)
        else:
            assert torch.equal(g, w), k


def test_a_file_s_codes_do_not_depend_on_its_row_in_the_batch():
    """The same files in another order (so at other rows, and with an odd
    bucket length at other alignments) give each file the same codes and the
    same DC mean: the mean is accumulated in float64 and rounded once.  On
    the card a float32 reduction moved a file's mean by an ulp with its row,
    and a few samples in millions by 1 LSB, so reruns (whose decode order
    varies) were not byte-identical."""
    rng = np.random.default_rng(31)
    blen = 30001
    x = (0.2 * rng.standard_normal((5, 2, blen)) + 0.013).astype(np.float32)
    valid = np.array([blen, 29999, 12345, 30000, 7], np.int32)
    seeds = np.array([11, 22, 33, 44, 55], np.int32)
    cfg = TConfig(output_dir="unused", target_rate=48000, gain_db=-1.0)
    base = tgraph.process_batch(x, valid, cfg, 44100, seeds, device="cpu")
    order = np.array([3, 0, 4, 2, 1])
    moved = tgraph.process_batch(x[order], valid[order], cfg, 44100, seeds[order], device="cpu")
    assert np.array_equal(moved.codes.numpy(), base.codes.numpy()[order])
    assert np.array_equal(moved.out_frames.numpy(), base.out_frames.numpy()[order])
    # and the mean that came off is the float64 mean of the resampled span
    keep = TConfig(output_dir="unused", target_rate=48000, gain_db=-1.0, remove_dc=False,
                   dither=False)
    raw = tgraph.process_batch(x[:1], valid[:1], keep, 44100, seeds[:1], device="cpu")
    nodc = TConfig(output_dir="unused", target_rate=48000, gain_db=-1.0, dither=False)
    got = tgraph.process_batch(x[:1], valid[:1], nodc, 44100, seeds[:1], device="cpu")
    n = int(raw.out_frames[0])
    shift = (raw.codes[0, :, :n].double() - got.codes[0, :, :n].double()).mean(dim=-1)
    want = raw.codes[0, :, :n].double().mean(dim=-1)
    assert torch.allclose(shift, want, atol=0.51)
