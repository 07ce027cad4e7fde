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
    """The graph refuses nothing of the JAX package: the insert chain,
    reverb mode, channel routing, the channel axis and the rows layout are
    ported.  A reverb-mode batch asked for the rows layout runs packed, as
    in the JAX package, and a 4-D rows input there raises ValueError.  A
    graph run on two channel shards (`run_sharded`, the channel axis's
    collectives) gives the one-device graph's codes and metrics."""
    assert not set(tgraph.NOT_PORTED) & {"chain", "reverb_mode", "channel_routing",
                                         "channel_axis", "mesh", "rows_layout"}
    cfg = TConfig(output_dir="/tmp/x", target_rate=48000, quality="low", reverb_mode=True)
    x = torch.zeros((1, 2, 100))
    if what == "rows_layout":
        x = torch.from_numpy(_float_batch(2, seed=9)[:1])
        got = tgraph.process_batch(x, [4000], cfg, 44100, [1], rows_layout=True)
        want = tgraph.process_batch(x, [4000], cfg, 44100, [1])
        assert got.layout == want.layout == "flat"
        for name in ("codes", "out_frames", "tail_terminated", "peak_db", "rms_db"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        with pytest.raises(ValueError, match="rows layout"):
            tgraph.process_batch(torch.zeros((1, 2, 9, 147)), [100], cfg, 44100, [1],
                                 rows_layout=True)
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


#: a bucket the files fill little of: their payload is narrower than its row
BUCKET = 20000
SHORT = np.array([3000, 2000, 17], np.int32)
NARROW = {"packed": {}, "rows": {"rows_layout": True}, "latency": {"latency_frames": 3},
          "reverb": {"noise_floor_db": -90.0}}


def _short_wire(fill: int) -> np.ndarray:
    """`_raw_batch`'s 24-bit wire in `BUCKET` frames, ``fill`` past each
    file's `SHORT` length."""
    rng = np.random.default_rng(77)
    x = (0.25 * np.sin(2 * np.pi * 997.0 * np.arange(BUCKET) / 44100)
         + 0.05 * rng.standard_normal((FILES, C, BUCKET)) + 0.01)
    codes = np.round(x * (1 << 23)).astype(np.int64)
    inter = np.swapaxes(codes, 1, 2) & 0xFFFFFF
    raw = np.stack([(inter >> (8 * k)) & 0xFF for k in range(3)], -1)
    raw = raw.astype(np.uint8).reshape(FILES, -1)
    for i, n in enumerate(SHORT):
        raw[i, n * C * 3:] = fill
    return raw


def _short_run(raw, case: str):
    cfg = TConfig(output_dir="unused", target_rate=48000, reverb_mode=case == "reverb")
    return tgraph.process_batch_raw(raw, SHORT, cfg, 44100, SEEDS, in_channels=C,
                                    in_bits=24, device="cpu", **NARROW[case])


def _same_files(got, want):
    """Each file's bytes up to its end and every per-file result, bit for
    bit; past the narrower payload the wider one holds only zeros."""
    for name in ("out_frames", "tail_terminated", "peak_db", "rms_db", "noise_floor_db"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    w = min(got.codes.shape[-1], want.codes.shape[-1])
    for i, of in enumerate(want.out_frames.tolist()):
        n = of * C * 3
        assert n <= w and torch.equal(got.codes[i, :n], want.codes[i, :n]), i
    for r in (got, want):
        assert not r.codes[:, w:].any()


@pytest.mark.parametrize("case", list(NARROW))
def test_wire_bytes_past_each_file_are_never_read(case):
    """0xA5 past each file's valid wire bytes gives the zero-padded
    batch's payload, out_frames and metrics bit for bit: nothing on the
    device reads past a file's valid span, which is why the link uploads
    only that span."""
    _same_files(_short_run(_short_wire(0xA5), case), _short_run(_short_wire(0), case))


@pytest.mark.parametrize("case", list(NARROW))
def test_payload_is_as_wide_as_the_longest_file_on_the_host(case, monkeypatch):
    """With the lengths on the host the payload is the longest file's
    out_frames rounded up to the epilogue's TILE (whole cycles in the rows
    layout), not the bucket's row; in reverb mode, or with the lengths on a
    device (`_host_lengths` None: the wire goes up whole), it is the whole
    row.  Each file's bytes and results are the same either way."""
    got = _short_run(_short_wire(0), case)
    monkeypatch.setattr(tgraph, "_host_lengths", lambda v: None)
    whole = _short_run(_short_wire(0), case)
    _same_files(got, whole)
    bank = tbank(44100, 48000, quality="high")
    out_total = whole.codes.shape[-1] // (C * 3)
    assert out_total >= bank.out_len(BUCKET)
    longest = int(got.out_frames.max())
    width = -(-longest // 4096) * 4096
    if case == "rows":
        width = -(-width // bank.L) * bank.L
    want = out_total if case == "reverb" else width
    assert got.codes.shape == (FILES, want * C * 3)
    assert case == "reverb" or want < out_total


def test_host_lengths_are_found_where_they_live():
    """numpy, a list and a CPU tensor are on the host; a tensor elsewhere
    is not."""
    for v in (SHORT, SHORT.tolist(), torch.from_numpy(SHORT)):
        got = tgraph._host_lengths(v)
        assert got.dtype == np.int64 and np.array_equal(got, SHORT)
    assert tgraph._host_lengths(torch.empty(3, dtype=torch.int32, device="meta")) is None


def test_link_counters_add_up_to_the_valid_spans(monkeypatch):
    """One raw batch: the link is handed each file's valid wire bytes (one
    ragged upload) and the four per-file and scalar vectors, and its
    download is the narrowed payload and the five per-file results."""
    from f9tpu_torch.pipeline import link

    for name in ("bytes_up", "bytes_down", "ragged_uploads"):
        monkeypatch.setattr(link, name, 0)
    res = _short_run(_short_wire(0xA5), "latency")
    # lengths and seeds (int32), the latency (int64) and the noise floor
    assert link.bytes_up == int(SHORT.sum()) * C * 3 + 2 * 4 * FILES + 8 + 4
    assert link.ragged_uploads == 1
    outs = (res.codes, res.out_frames, res.peak_db, res.rms_db, res.noise_floor_db,
            res.tail_terminated)
    link.Download(*outs, side=None).get()
    assert link.bytes_down == 4096 * C * 3 * FILES + 4 * 4 * FILES + FILES


def test_narrow_payload_matches_jax():
    """The port's narrowed payload against the JAX package's whole row:
    the shared prefix within 2 LSB as `test_process_batch_raw_matches_jax`
    holds it, and the JAX row all zero past the port's width."""
    raw = _short_wire(0)
    kw = dict(output_dir="/tmp/x", target_rate=48000)
    want = jgraph.process_batch_raw(jnp.asarray(raw), SHORT, ProcessingConfig(**kw), 44100,
                                    jnp.asarray(SEEDS), in_channels=C, in_bits=24)
    got = tgraph.process_batch_raw(raw, SHORT, TConfig(**kw), 44100, SEEDS, in_channels=C,
                                   in_bits=24, device="cpu")
    wc = np.asarray(want.codes)
    w = got.codes.shape[-1]
    assert w < wc.shape[-1] and not wc[:, w:].any()
    _check(got, want, _payload_codes(got.codes.numpy(), 24), _payload_codes(wc[:, :w], 24))
