"""Masked mean pooling over token types, ported from ``mca_tpu/models/pool.py``.

One masked segment mean per token type over the whole batch: a type's
valid tokens (not padded) are averaged, and a type with no valid token
in a sample gives a zero vector.  Types come out in the order of
:func:`mca_tpu_torch.masks.pooling_token_type_order` (modalities
ascending, then fusion / global), the attentive pool's return layout.
``token_types=None`` pools every valid token into one vector (EAO).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from mca_tpu_torch.masks import pooling_token_type_order


class MeanTokenProjectionPool(nn.Module):
    """``(x [B, T, D], key_padding_mask [B, T]) -> [B, n_types, D]``,
    with an optional ``nn.Linear`` per type (``proj.{i}``, flax's
    ``proj_{i}``) when ``projection`` is set (no shipped family sets it:
    MCA's ``mean_pool`` and EAO build theirs without)."""

    def __init__(
        self,
        token_types: Optional[Sequence[int]] = None,
        in_dim: int = 512,
        out_dim: int = 512,
        projection: bool = True,
    ):
        super().__init__()
        select = None  # one type: every valid token
        if token_types is not None:
            tt = np.asarray(token_types)
            # [n_types, T], True where the token is of that type
            select = torch.from_numpy(
                np.stack([tt == t for t in pooling_token_type_order(tt)])
            )
        self.register_buffer("type_select", select, persistent=False)
        n_types = 1 if select is None else select.shape[0]
        self.proj = (
            nn.ModuleList([nn.Linear(in_dim, out_dim) for _ in range(n_types)])
            if projection
            else None
        )

    def forward(self, x: torch.Tensor, key_padding_mask: torch.Tensor) -> torch.Tensor:
        sel = ~key_padding_mask.bool()[:, None, :]  # [B, 1, T]: valid tokens
        if self.type_select is not None:
            sel = self.type_select[None] & sel  # [B, n, T]
        cnt = sel.sum(dim=-1).to(x.dtype)[..., None]  # [B, n, 1]
        total = torch.einsum("bnt,btd->bnd", sel.to(x.dtype), x)
        pooled = torch.where(cnt > 0, total / cnt.clamp(min=1.0), torch.zeros_like(total))
        if self.proj is not None:
            pooled = torch.stack(
                [p(pooled[:, i]) for i, p in enumerate(self.proj)], dim=1
            )
        return pooled
