"""Static-shape batch collation (numpy), the port's copy.

The pure-numpy branches of ``mca_tpu/data/collators.py``:

- :class:`SequenceCollator` — right-pad 1-D rows to ``pad_len`` with
  ``pad_token``; ``attention_mask = (x == pad_token)`` (int, 1 =
  padded); optional second column padded with 0.  TCGA's collator.
- :class:`MultimodalCollator` — re-group a list of per-sample dicts
  into per-modality column dicts and apply each modality's collator.

A missing modality (value ``None``) collates to a fully padded row,
which downstream becomes an absent-sample mask.  The JAX package's C++
fast path (``mca_tpu.native``) and the ``matrix`` / ``embedded_sequence``
collators are not ported yet.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


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
        rows = [
            _to_numpy(x) if x is not None else np.zeros((0,), np.float32)
            for x in data[self.data_col_name]
        ]
        out = np.full(
            (len(rows), self.pad_len), self.pad_token, dtype=np.float32
        )
        for i, r in enumerate(rows):
            r = r.reshape(-1)[: self.pad_len]
            out[i, : r.shape[0]] = r
        collated = {self.data_col_name: out}
        if self.attn_mask:
            collated["attention_mask"] = (out == self.pad_token).astype(
                np.int64
            )
        if self.other_col in data:
            other_rows = [_to_numpy(x) for x in data[self.other_col]]
            other = np.zeros((len(other_rows), self.pad_len), np.float32)
            for i, r in enumerate(other_rows):
                if r is None:
                    continue
                r = r.reshape(-1)[: self.pad_len]
                other[i, : r.shape[0]] = r
            collated[self.other_col] = other
        return collated


collators = {"sequence": SequenceCollator}


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
                raise NotImplementedError(
                    f"collator type {cfg['type']!r} (modality {name!r}) "
                    "is not ported yet; the port collates 'sequence' "
                    "(tabular) modalities"
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
