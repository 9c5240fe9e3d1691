"""Static-shape batch collation, the port's copy of
``mca_tpu/data/collators.py``.

- :class:`SequenceCollator` — right-pad 1-D rows to ``pad_len`` with
  ``pad_token``; ``attention_mask = (x == pad_token)`` (int64, 1 =
  padded); optional second column padded with 0.  TCGA's collator.
- :class:`EmbeddedSequenceCollator` — pre-embedded ``[T, width]`` float
  sequences (CMU-MOSEI): truncated to ``pad_len``, NaN -> 0 and
  +-Inf -> +-FLT_MAX when ``clean``, rows padded with ``fill_value``
  into ``"tokens"``, and an explicit bool ``attention_mask`` from each
  row's length.  A row longer than ``pad_len`` under ``truncate:
  false``, or a row of another width, raises.
- :class:`MatrixCollator` — 2-D matrices row-padded with ``pad_token``
  into ``"values"`` (numpy, as in the JAX package); the PatchEncoder
  derives the mask.
- :class:`MultimodalCollator` — re-group a list of per-sample dicts
  into per-modality column dicts and apply each modality's collator.

The first two pad through the C++ collate (:mod:`mca_tpu_torch.native`,
built with ``g++`` at first use; its numpy plain versions give the same
bits).  A missing modality (value ``None``) collates to a fully padded
row, which downstream becomes an absent-sample mask.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from mca_tpu_torch import native


def _to_numpy(x: Any) -> Optional[np.ndarray]:
    if x is None:
        return None
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "numpy"):  # torch tensor
        return x.numpy()
    return np.asarray(x)


class SequenceCollator:
    """Pad 1-D sequences / tabular rows to ``pad_len``."""

    def __init__(
        self,
        pad_token: float = 0,
        pad_len: int = 2048,
        data_col_name: str = "indices",
        other_col: str = "data",
        attn_mask: bool = True,
        **kwargs: Any,
    ):
        self.pad_token = pad_token
        self.pad_len = pad_len
        self.attn_mask = attn_mask
        self.data_col_name = data_col_name
        self.other_col = other_col

    def __call__(
        self, data: Dict[str, List[Any]]
    ) -> Dict[str, np.ndarray]:
        out, mask = native.pad_rows(
            [_to_numpy(x) for x in data[self.data_col_name]],
            self.pad_len, self.pad_token, with_mask=self.attn_mask,
        )
        collated = {self.data_col_name: out}
        if self.attn_mask:
            collated["attention_mask"] = mask
        if self.other_col in data:
            collated[self.other_col] = native.pad_rows_fill(
                [_to_numpy(x) for x in data[self.other_col]], self.pad_len, 0.0
            )
        return collated


class EmbeddedSequenceCollator:
    """Pad pre-embedded ``[T, width]`` sequences to ``[B, pad_len,
    width]``.  A missing row (``None``) is ``(0, embedding_size)``; the
    width is the first non-empty row's (``embedding_size`` when every
    row is empty)."""

    def __init__(
        self,
        pad_token: float = -1,
        fill_value: float = 0.0,
        pad_len: int = 2048,
        embedding_size: int = 512,
        data_col_name: str = "values",
        attn_mask: bool = True,
        truncate: bool = True,
        clean: bool = True,
        **kwargs: Any,
    ):
        self.pad_token = pad_token
        self.fill_value = fill_value
        self.pad_len = pad_len
        self.attn_mask = attn_mask
        self.data_col_name = data_col_name
        self.truncate = truncate
        self.clean = clean
        self.embedding_size = embedding_size

    def __call__(
        self, data: Dict[str, List[Any]]
    ) -> Dict[str, np.ndarray]:
        rows = [
            _to_numpy(x)
            if x is not None
            else np.zeros((0, self.embedding_size), np.float32)
            for x in data[self.data_col_name]
        ]
        if self.truncate:
            rows = [r[: self.pad_len] for r in rows]
        emb = next((r.shape[-1] for r in rows if r.size), self.embedding_size)
        tokens, mask = native.pad_seq2d(
            rows, self.pad_len, emb, self.fill_value, clean=self.clean
        )
        out: Dict[str, np.ndarray] = {"tokens": tokens}
        if self.attn_mask:
            out["attention_mask"] = mask
        return out


class MatrixCollator:
    """Row-pad 2-D matrices to ``[B, pad_len, width]`` with
    ``pad_token`` (a missing row stays all ``pad_token``); the width is
    the first present row's, else ``max_channels``; ``max_channels``
    also cuts the width."""

    def __init__(
        self,
        pad_token: float = -10000,
        pad_len: int = 2048,
        attn_mask: bool = True,
        max_channels: int = 0,
        **kwargs: Any,
    ):
        self.pad_token = pad_token
        self.pad_len = pad_len
        self.max_channels = max_channels

    def __call__(
        self, data: Dict[str, List[Any]]
    ) -> Dict[str, np.ndarray]:
        rows = [_to_numpy(x) for x in data["values"]]
        width = next((r.shape[1] for r in rows if r is not None), self.max_channels)
        out = np.full((len(rows), self.pad_len, width), self.pad_token, dtype=np.float32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            t = min(r.shape[0], self.pad_len)
            out[i, :t] = r[:t]
        if self.max_channels:
            out = out[:, :, : self.max_channels]
        return {"values": out}


collators = {
    "matrix": MatrixCollator,
    "sequence": SequenceCollator,
    "embedded_sequence": EmbeddedSequenceCollator,
}


class MultimodalCollator:
    """Top-level collate_fn: list of ``{modality: {field: array-or-None}}``
    samples -> ``{modality: {field: np.ndarray[B, ...]}}`` plus,
    optionally, the stacked label column."""

    def __init__(
        self,
        modality_config: Dict[str, Dict[str, Any]],
        labels: Optional[str] = None,
        **kwargs: Any,
    ):
        for name, cfg in modality_config.items():
            if cfg["type"] not in collators:
                raise ValueError(
                    f"modality {name!r}: unknown collator type {cfg['type']!r}"
                )
        self.modality_collators = {
            name: collators[cfg["type"]](**cfg)
            for name, cfg in modality_config.items()
        }
        self.labels = labels

    def __call__(
        self, batch: Sequence[Dict[str, Any]]
    ) -> Dict[str, Dict[str, np.ndarray]]:
        missing = set(self.modality_collators) - set(batch[0].keys())
        if missing:
            raise ValueError(f"rows lack modalities {sorted(missing)}")
        out = {
            modality: coll(self._group_fields(modality, batch))
            for modality, coll in self.modality_collators.items()
        }
        if self.labels:
            label_fields: Dict[str, list] = defaultdict(list)
            for sample in batch:
                for field, fv in sample[self.labels].items():
                    label_fields[field].append(_to_numpy(fv))
            out[self.labels] = {
                k: np.stack(v) for k, v in label_fields.items()
            }
        return out

    def _group_fields(
        self, modality: str, batch: Sequence[Dict[str, Any]]
    ) -> Dict[str, list]:
        """Per-field lists over the batch; a sample whose modality was
        deleted (``None``) contributes ``None`` at its position."""
        coll = self.modality_collators[modality]
        primary = getattr(coll, "data_col_name", "values")
        field_names = {primary}
        for sample in batch:
            if sample[modality] is not None:
                field_names.update(sample[modality].keys())
        grouped: Dict[str, list] = {f: [] for f in field_names}
        for sample in batch:
            value = sample[modality]
            for f in field_names:
                grouped[f].append(
                    None if value is None else value.get(f)
                )
        return {
            f: v
            for f, v in grouped.items()
            if f == primary or any(x is not None for x in v)
        }
