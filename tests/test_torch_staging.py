"""A collated batch's way to the card (``mca_tpu_torch.data.staging``):
pinned host blocks, the copy from them (``to_device``) and the metric
that reads its counters (``portbench/metrics/pinned_copy_share.train.py``).

On the CPU: :func:`staging.empty` asks for a pinned block on any thread
once CUDA is initialised, and not before (both stubbed, since this build
has no pinned allocator); :func:`staging.pinned_tensor` finds the block
under a column and under a row slice of it, and nothing under other
memory; a label whose dtype torch lacks (strings, bytes, objects) stays
``np.stack``'s array; ``to_device`` counts the bytes it copies, none of
them pinned here; the trainer's staging names are this module's; the
reader gives 100, 0 and nothing on hand-made records.

On the card only (``-m card``; this file imports no JAX, so it runs
there with ``--noconftest``): a block is not handed to the next batch
while a copy from a view into it is still queued, and at CMU's shapes
every byte copied comes from a pinned block.  A planted fault, the copy
issued on a ``torch.from_numpy`` alias of the view, must show as a
corrupted batch.  Serving copies every byte of its batches from pinned
blocks.
"""

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from mca_tpu_torch.data import staging
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.dataset import BatchedLoader
from mca_tpu_torch.data.staging import to_device
from mca_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def unpinned_cuda_blocks(monkeypatch):
    """CUDA reported initialised, and ``torch.empty(..., pin_memory=True)``
    made as a plain CPU tensor (a CPU build has no pinned allocator), so
    that ``mca_tpu_torch.data.staging`` takes its block path; returns the
    blocks handed out.  ``tests/test_torch_dataset.py`` imports it."""
    handed = []
    real = torch.empty

    def empty(*shape, pin_memory=False, **kw):
        t = real(*shape, **kw)
        if pin_memory:
            handed.append(t)
        return t

    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    return handed


def test_empty_pins_on_any_thread_once_cuda_is_initialised(unpinned_cuda_blocks,
                                                            monkeypatch):
    handed = unpinned_cuda_blocks
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_initialized", lambda: False)
        assert staging.empty((2, 3), np.float32).base is None  # no CUDA context
        assert not handed
    seen = []
    block = staging.empty((2, 3), np.bool_)
    worker = threading.Thread(target=lambda: seen.append(staging.empty((4,), np.int64)))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert len(handed) == 2 and isinstance(seen[0].base, torch.Tensor)  # the worker pins too
    assert seen[0].dtype == np.int64 and seen[0].shape == (4,)
    assert isinstance(block.base, torch.Tensor) and block.dtype == np.bool_
    assert block.shape == (2, 3)


@pytest.mark.parametrize("tags", [["a", "bcd"], [b"a", b"bcd"], [None, 3]],
                         ids=["str", "bytes", "object"])
def test_a_label_torch_has_no_dtype_for_is_stacked_by_numpy(tags, unpinned_cuda_blocks):
    """Under the loader with CUDA initialised, a label field of strings,
    bytes or objects (no torch dtype) is ``np.stack``'s array, as
    without CUDA; the numeric columns beside it lie in blocks."""
    rows = [{"m": {"data": np.full((1 + i, 3), i, np.float32)},
             "Labels": {"values": np.float32(i), "tag": tag}} for i, tag in enumerate(tags)]
    modalities = {"m": {"type": "embedded_sequence", "pad_len": 4, "data_col_name": "data",
                        "pad_token": -1, "embedding_size": 3}}
    collator = MultimodalCollator(modalities, labels="Labels")
    got = BatchedLoader(rows, collator, len(rows)).first_batch()
    want = np.stack(tags)
    assert got["Labels"]["tag"].dtype == want.dtype and got["Labels"]["tag"].base is None
    np.testing.assert_array_equal(got["Labels"]["tag"], want)
    assert isinstance(got["Labels"]["values"].base, torch.Tensor)
    assert isinstance(got["m"]["tokens"].base, torch.Tensor)
    assert len(unpinned_cuda_blocks) == 3  # tokens, mask and the numeric label


def test_pinned_tensor_finds_the_block_under_a_column(unpinned_cuda_blocks, monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: True)
    col = staging.empty((6, 4, 3), np.float32)
    col[...] = np.arange(col.size, dtype=np.float32).reshape(col.shape)
    for x in (col, col[2:5], col[3]):
        t = staging.pinned_tensor(x)
        assert t.shape == x.shape and t.data_ptr() == x.ctypes.data
        np.testing.assert_array_equal(t.numpy(), x)
    assert staging.pinned_tensor(col[:, 1]) is None  # not contiguous
    assert staging.pinned_tensor(col.view(np.int32)) is None  # another dtype than the block's
    assert staging.pinned_tensor(np.zeros((6, 4), np.float32)) is None  # numpy's own memory
    assert staging.pinned_tensor(col[:0]) is None
    assert staging.pinned_tensor(torch.from_numpy(col)) is None  # narrowed columns are tensors


def test_to_device_counts_the_bytes_it_copies():
    batch = {"a": {"tokens": np.ones((4, 5, 3), np.float32),
                   "attention_mask": np.zeros((4, 5), bool)},
             "b": {"values": torch.ones(4, 7, dtype=torch.float16)}}
    mark = trace.RECORDER.mark()
    out = to_device(batch, "cpu")
    assert out["b"]["values"].dtype == torch.float32
    copy = trace.RECORDER.records("data.copy", since=mark)
    assert len(copy["seq"]) == 1
    for name, want in (("data.copied_bytes", 4 * 5 * 3 * 4 + 4 * 5 + 4 * 7 * 2),
                       ("data.pinned_bytes", 0)):
        rec = trace.RECORDER.records(name, since=mark)
        assert list(rec["value"]) == [want] and list(rec["parent"]) == copy["seq"].tolist()


def test_the_trainer_stages_through_this_module():
    """``mca_tpu_torch.train`` holds the staging module's own objects: the
    benchmark's drivers import them from the trainer and its fault
    control patches ``train.to_device``."""
    from mca_tpu_torch import train

    for name in ("to_device", "narrow_for_staging", "staging_sentinels", "STAGE_DTYPES"):
        assert getattr(train, name) is getattr(staging, name), name


@pytest.mark.parametrize("pinned_of, want", [((100, 100, 100), 100.0), ((0, 0, 0), 0.0),
                                             ((100, 0, 50), 50.0), (None, None)])
def test_pinned_copy_share_reads_the_window_copies(pinned_of, want, monkeypatch):
    from portbench import harness, spans

    rec = trace.Recorder(capacity=1 << 10)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    with rec.span("data.copy"):  # before the window: left out
        rec.count("data.copied_bytes", 100)
        rec.count("data.pinned_bytes", 0 if pinned_of else 100)
    for p in pinned_of or (None,) * 3:
        with rec.span("data.copy"):
            if p is not None:  # the parent's program counts nothing
                rec.count("data.copied_bytes", 100)
                rec.count("data.pinned_bytes", p)
    assert harness.reader("pinned_copy_share.train")({"host": {"steps": 3}}) == want


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    """A CUDA device, or the test skips: pinned memory needs one."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: pinned host memory and DMA need one")
    return torch.device("cuda")


def _cmu_rows(n: int, seed: int):
    from portbench.data import make_rows

    cfg = json.loads((ROOT / "portbench/configs/cmu_mca.json").read_text())
    return cfg["modality_config"], make_rows(cfg, n, seed, 0.25)


def _bits(x) -> np.ndarray:
    x = np.ascontiguousarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


@pytest.mark.card
@pytest.mark.parametrize("copy_from", ["block", "planted alias"])
def test_a_block_is_not_reused_while_its_copy_is_in_flight(card, copy_from, monkeypatch):
    """Rows 16: of batch A (views at an offset into its blocks, as the
    data-parallel stager's are) are copied behind a long kernel; A's host
    batch is dropped and B collated at once; A's rows on the card must
    still be A's bit for bit, and every byte copied came from a pinned
    block.  The planted fault copies from ``torch.from_numpy`` aliases of
    the views, which the allocator cannot trace to their blocks: it must
    corrupt A."""
    modalities, rows = _cmu_rows(128, 3_220_000_001)
    collator = MultimodalCollator(modalities)
    want_a = collator(rows[:64])
    want_b = collator(rows[64:])
    torch.zeros(1, device=card)  # CUDA initialised: the loader pins
    if copy_from == "planted alias":
        block_of = staging.pinned_tensor
        monkeypatch.setattr(staging, "pinned_tensor", lambda x: None if block_of(x) is None
                            else torch.from_numpy(x))
    loader_a, loader_b = (BatchedLoader(part, collator, 64) for part in (rows[:64], rows[64:]))
    for _ in range(3):  # the allocator's cache holds blocks of these sizes
        warm = loader_a.first_batch()
        to_device(warm, card)
        torch.cuda.synchronize(card)
        del warm
    batch_a = loader_a.first_batch()  # no generator frame keeps it alive
    staged = {m: {k: v[16:] for k, v in f.items()} for m, f in batch_a.items()}
    assert all(staging.pinned_tensor(v) is not None for f in staged.values() for v in f.values())
    torch.cuda._sleep(2_000_000_000)  # about a second of the card's clock
    mark = trace.RECORDER.mark()
    t0 = time.perf_counter()
    dev_a = to_device(staged, card)
    enqueue_s = time.perf_counter() - t0
    del batch_a, staged
    batch_b = loader_b.first_batch()
    busy = torch.cuda.Event()
    busy.record()
    assert not busy.query(), "the card finished A's copy before B was collated: no test"
    torch.cuda.synchronize(card)
    corrupt = [(m, k) for m in want_a for k in want_a[m]
               if not np.array_equal(_bits(dev_a[m][k].cpu().numpy()), _bits(want_a[m][k][16:]))]
    if copy_from == "planted alias":
        assert corrupt, "the planted alias copy left A intact: the check cannot see reuse"
        return
    assert not corrupt, corrupt
    assert enqueue_s < 0.2, enqueue_s  # the host did not wait for the copy
    for m in want_b:
        for k in want_b[m]:
            np.testing.assert_array_equal(_bits(batch_b[m][k]), _bits(want_b[m][k]))
    copied = trace.RECORDER.records("data.copied_bytes", since=mark)["value"]
    from_blocks = trace.RECORDER.records("data.pinned_bytes", since=mark)["value"]
    assert copied.sum() == from_blocks.sum() > 118_000_000 * 48 // 64


@pytest.mark.card
def test_serving_copies_its_batches_from_pinned_blocks(card):
    """TCGA_config1's service at batch 32 on the card: every byte of
    every served batch, the warm-up's included, is copied from a pinned
    block, one ``data.copy`` inside each ``serve.batch``."""
    from mca_tpu_torch.config import training_config
    from mca_tpu_torch.serve import EmbeddingService
    from mca_tpu_torch.tools import request_rows

    config = training_config(str(ROOT / "configs/tcga_mca.yaml"))
    mark = trace.RECORDER.mark()
    svc = EmbeddingService(config, max_batch=32, device="cuda", seed=0)
    rows = request_rows(config, 40)
    got = svc.embed(rows)
    assert all(np.isfinite(e).all() for e in got["embeddings"].values())
    t = trace.RECORDER.records(since=mark)
    batches = t["seq"][t["name"] == "serve.batch"]
    copies = t["seq"][(t["name"] == "data.copy") & np.isin(t["parent"], batches)]
    assert len(batches) == 3 and len(copies) == 3  # the warm-up and two chunks
    inside = np.isin(t["parent"], copies)
    copied = t["value"][inside & (t["name"] == "data.copied_bytes")]
    from_blocks = t["value"][inside & (t["name"] == "data.pinned_bytes")]
    assert len(copied) == 3 and (copied > 0).all()
    np.testing.assert_array_equal(from_blocks, copied)
