"""Dataset setup and batching, ported from ``mca_tpu/data/dataset.py``.

- :func:`setup_data`: an HF on-disk dataset (``load_from_disk``) or a
  sequence of row dicts held in memory -> optional ``ds_frac``
  head-select -> optional predrop -> the train / test split, as
  ``datasets.Dataset.train_test_split(split, seed=ds_seed)`` draws it.
- :class:`BatchPreDropout` / :func:`batch_predrop`: per-sample
  whole-modality dropout applied once, offline.
- :class:`BatchDropout`: in-batch whole-modality dropout.
- :class:`BatchedLoader`: fixed-size collated batches, shuffled per
  epoch with ``np.random.default_rng(seed + epoch)``, the last partial
  batch dropped; ``preload`` decodes every row once, ``preload=False``
  reads each batch's rows straight from the arrow buffers
  (:func:`_arrow_take_rows`), ``prefetch`` collates ahead on a thread.

Every RNG is a seeded numpy Generator, drawn in the JAX package's
order, so the same seed gives the same rows and the same batches in
both packages.  ``datasets`` and ``pyarrow`` are imported inside the
functions that read an HF dataset: a run on rows held in memory needs
neither.
"""

from __future__ import annotations

import math
import queue
import threading
from typing import Any, Dict, Optional, Sequence

import numpy as np

from mca_tpu_torch.utils import trace


class BatchDropout:
    """In-batch whole-modality dropout: overwrites the given fields of a
    random ``dropout`` fraction of the batch rows with constants (e.g.
    attention mask -> 1 = padded)."""

    def __init__(
        self,
        kvs: Optional[Dict[str, Any]] = None,
        dropout: float = 0.1,
        random_seed: int = 42,
    ):
        self.kvs = kvs or {"attention_mask": 1, "tokens": 0}
        self.dropout = float(dropout)
        self.rng = np.random.default_rng(random_seed)

    def __call__(self, batch_mode: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if not set(self.kvs) <= set(batch_mode):
            raise KeyError(f"{set(self.kvs)} not all in {set(batch_mode)}")
        nb = next(iter(batch_mode.values())).shape[0]
        size = int(nb * self.dropout)
        if size == 0:
            return batch_mode
        idx = self.rng.permutation(nb)[:size]
        out = dict(batch_mode)
        for k, v in self.kvs.items():
            arr = np.array(out[k], copy=True)
            arr[idx] = v
            out[k] = arr
        return out


class BatchPreDropout:
    """Whole-modality dropout for one modality: ``delete`` sets every
    field to None (collates to fully padded), ``fill`` overwrites the
    fields with constants."""

    def __init__(
        self,
        mode: str = "delete",
        kvs: Optional[Dict[str, Any]] = None,
        dropout: float = 0.1,
        random_seed: int = 42,
    ):
        if mode not in ("delete", "fill"):
            raise ValueError(f"mode must be delete or fill, got {mode!r}")
        self.mode = mode
        self.kvs = kvs or {"attention_mask": 1, "tokens": 0}
        self.dropout = float(dropout)
        self.rng = np.random.default_rng(random_seed)

    def drop(self) -> bool:
        return bool(self.rng.random() < self.dropout)

    def __call__(
        self, modality_value: Optional[Dict[str, Any]]
    ) -> Optional[Dict[str, Any]]:
        if modality_value is None:
            return None
        if self.drop():
            if self.mode == "fill":
                return {
                    k: (
                        np.full_like(np.asarray(modality_value[k]), v)
                        if modality_value.get(k) is not None
                        else None
                    )
                    for k, v in self.kvs.items()
                }
            return {k: None for k in modality_value}
        return modality_value


def _predrop_fn(modality_config: Dict[str, Dict[str, Any]], random_seed: int):
    """The per-row dropout map: one dropper per modality with a
    ``dropout`` rate, seeded ``random_seed + i`` by its position."""
    droppers = {
        name: BatchPreDropout(
            kvs={"attention_mask": cfg.get("pad_token", 0), "data": 0.0},
            dropout=cfg["dropout"],
            random_seed=random_seed + i,
        )
        for i, (name, cfg) in enumerate(modality_config.items())
        if cfg.get("dropout")
    }

    def drop(sample: Dict[str, Any]) -> Dict[str, Any]:
        return {k: droppers[k](v) if k in droppers else v for k, v in sample.items()}

    return drop


def batch_predrop(
    dataset: Any,
    modality_config: Dict[str, Dict[str, Any]],
    random_seed: int = 42,
):
    """Whole-modality dropout over every row, in order: ``dataset.map``
    over an HF dataset, a new list for a sequence of rows."""
    drop = _predrop_fn(modality_config, random_seed)
    if isinstance(dataset, (list, tuple)):
        return [drop(row) for row in dataset]

    def to_arrow_friendly(v: Any) -> Any:
        if isinstance(v, np.ndarray):
            return v.tolist()  # pyarrow rejects >1-D ndarrays
        if isinstance(v, dict):
            return {k: to_arrow_friendly(x) for k, x in v.items()}
        return v

    fmt = dataset.format
    out = dataset.with_format(None).map(
        lambda sample: to_arrow_friendly(drop(sample)), batched=False
    )
    return out.with_format(fmt["type"] if fmt and fmt.get("type") else "numpy")


def train_test_split_rows(rows: Sequence[Any], split: float, seed: int) -> Dict[str, list]:
    """``datasets.Dataset.train_test_split(split, seed=seed)`` on a list:
    a ``split`` fraction (rounded up) or count of the rows, drawn by one
    permutation from ``np.random.default_rng(seed)``, is the test set,
    the rest of the permutation the train set."""
    n = len(rows)
    n_test = math.ceil(split * n) if isinstance(split, float) else int(split)
    perm = np.random.default_rng(seed).permutation(n)
    return {
        "train": [rows[int(i)] for i in perm[n_test:]],
        "test": [rows[int(i)] for i in perm[:n_test]],
    }


def setup_data(
    source: Any,
    split: float = 0.1,
    ds_frac: float = 1.0,
    ds_seed: int = 42,
    predrop: bool = False,
    predrop_config: Optional[Dict[str, Dict[str, Any]]] = None,
):
    """Load and split a dataset: ``source`` is the path of an HF
    ``save_to_disk`` directory, or a sequence of row dicts.  Returns
    ``{"train": ..., "test": ...}``, or the whole dataset when ``split``
    is 0 or 1.0."""
    if isinstance(source, str):
        import datasets as hfds

        dataset = hfds.load_from_disk(source)
        if ds_frac < 1.0:
            dataset = dataset.select(range(int(len(dataset) * ds_frac)))
    else:
        dataset = list(source)
        if ds_frac < 1.0:
            dataset = dataset[: int(len(dataset) * ds_frac)]
    if predrop:
        dataset = batch_predrop(dataset, predrop_config or {}, random_seed=ds_seed)
    if split and split != 1.0:
        if isinstance(dataset, list):
            return train_test_split_rows(dataset, split, ds_seed)
        return dataset.train_test_split(split, seed=ds_seed)
    return dataset


def _arrow_decode_values(arr, n: int) -> list:
    """One arrow column -> a list of per-row numpy values (None for
    nulls), read from the flat values buffer instead of HF's per-row
    Python materialisation."""
    import pyarrow as pa

    valid = arr.is_valid().to_numpy(zero_copy_only=False)
    if pa.types.is_list(arr.type) and pa.types.is_list(arr.type.value_type):
        oo = arr.offsets.to_numpy()
        inner = arr.values
        io = inner.offsets.to_numpy()
        flat = inner.values.to_numpy(zero_copy_only=False)
        out = []
        for i in range(n):
            if not valid[i]:
                out.append(None)
                continue
            s, e = int(oo[i]), int(oo[i + 1])
            if e == s:
                out.append(np.zeros((0, 0), flat.dtype))
                continue
            widths = np.diff(io[s : e + 1])
            if (widths == widths[0]).all():
                out.append(flat[int(io[s]) : int(io[e])].reshape(e - s, int(widths[0])))
            else:  # ragged inner rows: rare, one array per inner row
                out.append([flat[int(io[j]) : int(io[j + 1])] for j in range(s, e)])
        return out
    if pa.types.is_list(arr.type):
        oo = arr.offsets.to_numpy()
        flat = arr.values.to_numpy(zero_copy_only=False)
        return [flat[int(oo[i]) : int(oo[i + 1])] if valid[i] else None for i in range(n)]
    if pa.types.is_primitive(arr.type):
        vals = arr.to_numpy(zero_copy_only=False)
        return [vals[i] if valid[i] else None for i in range(n)]
    vals = arr.to_pylist()
    return [vals[i] if valid[i] else None for i in range(n)]


def _decode_table(table) -> list:
    """An arrow (sub-)table -> collator row dicts (``{column: {field:
    array-or-None}}``; a null struct maps to None in every field)."""
    import pyarrow as pa

    n = table.num_rows
    rows: list = [dict() for _ in range(n)]
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        if pa.types.is_struct(col.type):
            svalid = col.is_valid().to_numpy(zero_copy_only=False)
            for fi, field in enumerate(col.type):
                vals = _arrow_decode_values(col.field(fi), n)
                for i in range(n):
                    rows[i].setdefault(name, {})[field.name] = vals[i] if svalid[i] else None
        else:
            vals = _arrow_decode_values(col, n)
            for i in range(n):
                rows[i][name] = vals[i]
    return rows


def _arrow_take_rows(dataset, idx) -> list:
    """Rows ``idx`` of an HF dataset through zero-copy arrow slices (a
    ``Table.take`` on a memory-mapped table copies whole chunks)."""
    table = dataset.data.table
    idx = [int(i) for i in idx]
    # a split or shuffled HF dataset is indices-mapped: row i lives at
    # _indices[i] of the underlying table, and reading the table by
    # position would return the wrong rows
    indices = getattr(dataset, "_indices", None)
    if indices is not None:
        col = indices.column(0)
        idx = [int(col[i].as_py()) for i in idx]
    start = idx[0]
    if idx == list(range(start, start + len(idx))):
        return _decode_table(table.slice(start, len(idx)))
    out: list = []
    for i in idx:
        out.extend(_decode_table(table.slice(i, 1)))
    return out


class _PrefetchIterator:
    """Batches produced on a background thread into a bounded queue, so
    collation overlaps the device's work; the producer's exception
    re-raises at the consumer."""

    _DONE = object()

    def __init__(self, produce, depth: int):
        # the producer closure must not capture self: the running thread
        # would keep the iterator alive and __del__ could never stop it
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        err_box: list = []
        done = self._DONE

        def put_or_stop(item) -> bool:
            # a bounded put that gives up once stopped, so an abandoned
            # iterator's producer exits instead of blocking on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in produce():
                    if not put_or_stop(item):
                        return
            except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
                err_box.append(e)
            finally:
                put_or_stop(done)

        self._q = q
        self._stop = stop
        self._err_box = err_box
        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def close(self) -> None:
        """Stop the producer and release the queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._DONE:
            self._thread.join()
            if self._err_box:
                raise self._err_box[0]
            raise StopIteration
        return item


class BatchedLoader:
    """Fixed-size collated batches over a dataset split.

    ``dataset`` is an HF dataset or any sequence of row dicts.  Every batch
    has ``batch_size`` rows; the last partial batch is dropped unless
    ``drop_last`` is false.  ``shuffle`` orders each epoch by
    ``np.random.default_rng(seed + epoch)`` (:meth:`set_epoch`).
    ``preload`` decodes every row once up front; otherwise each batch's
    rows are decoded from the arrow buffers when it is drawn.
    ``prefetch > 0`` collates that many batches ahead on a thread.
    Each batch's collation is recorded as ``data.collate``
    (:mod:`mca_tpu_torch.utils.trace`), on the thread that collates it.
    """

    def __init__(
        self,
        dataset: Any,
        collator: Any,
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        preload: bool = True,
        prefetch: int = 0,
    ):
        self.dataset = dataset
        self.collator = collator
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = int(prefetch)
        self._epoch = 0
        self._skip_next = 0
        self._items = (
            [dataset[int(i)] for i in range(len(dataset))] if preload else None
        )

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def skip_batches(self, n: int) -> None:
        """Start the next iteration ``n`` batches in, without fetching
        or collating them (a batch is a function of its index, so
        mid-epoch resume slices the order).  One-shot."""
        self._skip_next = int(n)

    def _batch_samples(self, idx) -> list:
        if self._items is not None:
            return [self._items[int(i)] for i in idx]
        if hasattr(self.dataset, "data"):  # an HF dataset's arrow table
            return _arrow_take_rows(self.dataset, idx)
        return [self.dataset[int(i)] for i in idx]

    def _produce(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(order)
        usable = n - n % self.batch_size if self.drop_last else n
        first = self._skip_next * self.batch_size
        self._skip_next = 0
        for start in range(first, usable, self.batch_size):
            with trace.span("data.collate", epoch=self._epoch, batch=start // self.batch_size):
                batch = self.collator(self._batch_samples(order[start : start + self.batch_size]))
            yield batch

    def first_batch(self):
        """One full batch, collated on the calling thread (rows wrap
        when the split is smaller than a batch), for model init."""
        idx = np.arange(self.batch_size) % max(len(self.dataset), 1)
        return self.collator(self._batch_samples(idx))

    def __iter__(self):
        if self.prefetch > 0:
            return _PrefetchIterator(self._produce, self.prefetch)
        return self._produce()

