"""The batch job's and the stream's host <-> card link
(`f9tpu_torch.pipeline.link`).

On the CPU the helpers are a passthrough (no copy, no pinned memory), and
the scheduler sends every batch upload and all six result tensors through
them, counted here by wrapping the module's functions.  The card test holds
a pinned side-stream download to a pageable ``.cpu()`` bit for bit; it needs
an NVIDIA GPU and skips without one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from f9tpu_torch.config import ProcessingConfig  # noqa: E402
from f9tpu_torch.io import wav  # noqa: E402
from f9tpu_torch.pipeline import graph, link  # noqa: E402
from f9tpu_torch.pipeline import scheduler as tsched  # noqa: E402

CPU = torch.device("cpu")


def test_link_is_a_passthrough_on_the_cpu():
    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = link.upload(a, CPU)
    assert t.dtype == torch.int32 and np.shares_memory(t.numpy(), a)
    h = link.host_empty((2, 5), torch.float32, CPU)
    assert h.shape == (2, 5) and not h.is_pinned()
    assert link.upload(h, CPU) is h
    assert link.side_stream(CPU) is None
    x = torch.randn(4, 3)
    got = link.Download(x, None, torch.arange(3), side=None).get()
    assert got[1] is None and np.shares_memory(got[0], x.numpy())
    assert np.array_equal(got[2], np.arange(3))
    w = np.full((2, 6), 0xA5, np.uint8)
    assert np.shares_memory(link.upload_rows(w, [3, 0], CPU).numpy(), w)


@pytest.mark.parametrize("a,n", [
    (np.zeros((2, 6), np.uint8), [7, 0]), (np.zeros((2, 6), np.uint8), [-1, 0]),
    (np.zeros((2, 6), np.uint8), [1]), (np.zeros((2, 6), np.int16), [1, 1]),
    (np.zeros(6, np.uint8), [1])], ids=["past", "negative", "count", "dtype", "1-d"])
def test_upload_rows_refuses_what_it_cannot_copy(a, n):
    with pytest.raises(ValueError):
        link.upload_rows(a, n, CPU)


def test_link_counts_the_bytes_it_is_handed(monkeypatch):
    """``bytes_up`` counts a whole upload and the heads of a ragged one,
    ``ragged_uploads`` the ragged ones, ``bytes_down`` every tensor a
    `Download` is handed; the CPU's passthrough counts what a card's
    copies would carry."""
    for name in ("bytes_up", "bytes_down", "ragged_uploads"):
        monkeypatch.setattr(link, name, 0)
    link.upload(np.zeros((3, 4), np.int32), CPU)
    link.upload_rows(np.zeros((3, 10), np.uint8), [10, 0, 4], CPU)
    link.Download(torch.zeros(5, dtype=torch.float64), None, torch.zeros(2, 3), side=None)
    assert (link.bytes_up, link.ragged_uploads, link.bytes_down) == (48 + 14, 1, 40 + 24)


@pytest.fixture
def counted(monkeypatch):
    """Count the link's uploads (their shapes and dtypes; the row-ragged
    form's under "upload_rows") and downloads (their tensors) while the
    real helpers do the work."""
    seen = {"upload": [], "upload_rows": [], "download": []}
    real_upload, real_rows, real_download = link.upload, link.upload_rows, link.Download

    def upload(a, dev):
        seen["upload"].append((tuple(a.shape), str(a.dtype)))
        return real_upload(a, dev)

    def upload_rows(a, row_bytes, dev):
        seen["upload_rows"].append((tuple(a.shape), str(a.dtype)))
        return real_rows(a, row_bytes, dev)

    class Download(real_download):
        def __init__(self, *tensors, side=None):
            seen["download"].append(len(tensors))
            super().__init__(*tensors, side=side)

    monkeypatch.setattr(link, "upload", upload)
    monkeypatch.setattr(link, "upload_rows", upload_rows)
    monkeypatch.setattr(link, "Download", Download)
    return seen


def _write(d, n_files, frames, seed=3):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_files):
        p = str(d / f"f{i}.wav")
        wav.write_wav(p, (0.1 * rng.standard_normal((2, frames))).astype(np.float32),
                      44100, bits=24)
        paths.append(p)
    return paths


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "float"])
def test_scheduler_routes_every_batch_through_the_link(tmp_path, counted, normalize):
    """Two 2-file batches: each uploads its (pinned, on a card) host batch
    through the link and downloads codes, out_frames, peak, RMS, noise
    floor and tail flags through one `link.Download`; the raw PCM path
    uploads uint8 bytes, each file's valid span (`link.upload_rows`), the
    normalized path float32 samples (`link.upload`).  The dispatch
    thread's time on them is its own stage."""
    paths = _write(tmp_path, 4, 20000)
    cfg = ProcessingConfig(output_dir=str(tmp_path / "out"), target_rate=48000,
                           bucket_frames=(1 << 15,), batch_size=2,
                           normalize_lufs=-20.0 if normalize else None)
    res = tsched.BatchProcessor(cfg, device="cpu").run(paths)
    assert res.completed == 4 and res.failed == 0
    assert counted["download"] == [6, 6]
    form = "upload" if normalize else "upload_rows"
    want = ((2, 2, 1 << 15), "torch.float32") if normalize else ((2, (1 << 15) * 6), "torch.uint8")
    assert counted[form].count(want) == 2, counted[form]
    assert counted["upload_rows"] == ([] if normalize else [want, want])
    # the dispatch thread's stage counts the same audio as the collector's
    th = res.throughput
    assert th["dispatch"]["audio_seconds"] == pytest.approx(th["collect"]["audio_seconds"])
    assert th["dispatch"]["audio_seconds"] == pytest.approx(4 * 20000 / 44100)


def test_graph_uploads_host_inputs_through_the_link(counted):
    """`process_batch` on numpy input: the batch and its per-file vectors
    all go up through `link.upload` (none by a pageable `as_tensor`)."""
    cfg = ProcessingConfig(output_dir="unused", target_rate=48000)
    x = (0.1 * np.random.default_rng(1).standard_normal((2, 2, 3000))).astype(np.float32)
    r = graph.process_batch(x, np.array([3000, 2000], np.int32), cfg, 44100,
                            np.array([1, 2], np.int32), device="cpu")
    assert r.codes.shape[0] == 2
    shapes = [s for s, _ in counted["upload"]]
    assert (2, 2, 3000) in shapes and shapes.count((2,)) == 2


@pytest.mark.cuda
def test_pinned_side_stream_download_equals_cpu_copy():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    side = link.side_stream(dev)
    codes = torch.randint(0, 256, (8, 1 << 20), dtype=torch.uint8, device=dev, generator=g)
    vals = torch.randn((8,), device=dev, generator=g)
    flags = vals > 0
    # queue more work behind the tensors: the copy must wait for it
    codes.add_(1)
    dl = link.Download(codes, vals, flags, None, side=side)
    got = dl.get()
    assert got[3] is None
    for host, t in zip(got, (codes, vals, flags)):
        assert np.array_equal(host, t.cpu().numpy())
    up = link.upload(got[0], dev)
    assert torch.equal(up, codes)


@pytest.mark.cuda
def test_ragged_upload_copies_each_row_s_head():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    host = link.host_empty((4, 1 << 20), torch.uint8, dev)
    host.copy_(torch.randint(0, 256, host.shape, dtype=torch.uint8))
    n = [1 << 20, 0, 12345, 1]
    up = link.upload_rows(host, n, dev)
    assert up.shape == host.shape and up.device.type == "cuda"
    got = up.cpu()
    for i, k in enumerate(n):
        assert torch.equal(got[i, :k], host[i, :k])
