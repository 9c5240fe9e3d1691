"""Modality encoders (PyTorch), built from the YAML ``encoder_configs``.

Ported from ``mca_tpu/encoders.py``.  Every encoder maps a collated
batch dict to ``(tokens [B, T, D], attention_mask [B, T])`` with the
mask convention 1/True = padded.  Parameter names follow the torch
reference's state_dict (``token_encoder.embedding.weight``,
``value_encoder.{linear1,linear2,norm}.*``), so a state dict carried
from the JAX package loads with ``strict=True``.

This slice ports ``TabularEncoder`` (TCGA); the Sequence,
SparseTabular, EmbeddedSequence and Patch encoders come later.

LayerNorm epsilon is 1e-6 everywhere: the JAX package uses flax's
default, not torch's 1e-5.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

LN_EPS = 1e-6


class TokenEncoder(nn.Module):
    """Embedding lookup with max-norm row renormalisation at lookup time.

    Rows whose L2 norm exceeds ``max_norm`` are scaled down to it on
    the looked-up copy; the table itself is never rewritten (unlike
    ``nn.Embedding(max_norm=...)``).  ``padding_idx`` wraps like torch
    (``-1`` is the last row) and looks up a zero vector.
    """

    def __init__(
        self,
        num_embeddings: int,
        embedding_dim: int,
        padding_idx: Optional[int] = None,
        max_norm: Optional[float] = 1.0,
    ):
        super().__init__()
        self.embedding = nn.Embedding(num_embeddings, embedding_dim)
        self.padding_idx = padding_idx
        self.max_norm = max_norm

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        emb = self.embedding.weight[idx]
        if self.max_norm is not None:
            norm_sq = emb.square().sum(dim=-1, keepdim=True)
            safe = torch.sqrt(norm_sq.clamp(min=self.max_norm**2))
            emb = emb * (self.max_norm / safe)
        if self.padding_idx is not None:
            pad = self.padding_idx % self.embedding.num_embeddings
            emb = emb.masked_fill((idx == pad)[..., None], 0.0)
        return emb


class ContinuousValueEncoder(nn.Module):
    """Scalar -> vector MLP: ``Linear(1,d) -> ReLU -> Linear(d,d) ->
    LayerNorm``; input clamped to ``max_value`` from above; positions
    equal to ``padding_value`` are zeroed in the output."""

    def __init__(
        self,
        d_model: int,
        max_value: float = 512.0,
        padding_value: float = 0.0,
    ):
        super().__init__()
        self.linear1 = nn.Linear(1, d_model)
        self.linear2 = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.max_value = max_value
        self.padding_value = padding_value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[..., None]
        pad_mask = x == self.padding_value
        x = x.clamp(max=self.max_value)
        x = self.norm(self.linear2(torch.relu(self.linear1(x))))
        return x.masked_fill(pad_mask, 0.0)


class TabularEncoder(nn.Module):
    """Dense table -> tokens: column-identity embeddings + encoded
    values, summed.  TCGA's encoder.

    The padding value seen by the value encoder is ``float(padding_idx)``
    = -1.0, as in the JAX package; the collator pads with -10000, so
    padded values pass through the MLP and are hidden by the attention
    mask instead.
    """

    def __init__(
        self,
        num_embeddings: int = 128,
        embedding_dim: int = 512,
        padding_idx: int = -1,
        max_value: float = 10000.0,
    ):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.token_encoder = TokenEncoder(
            num_embeddings, embedding_dim, padding_idx
        )
        self.value_encoder = ContinuousValueEncoder(
            embedding_dim,
            max_value=max_value,
            padding_value=float(padding_idx),
        )

    def forward(
        self, batch: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        values = batch["values"]
        index = torch.arange(self.num_embeddings, device=values.device)
        x_t = self.token_encoder(index)
        x_v = self.value_encoder(values)
        if x_v.shape[1] != self.num_embeddings:
            raise ValueError(
                f"{x_v.shape[1]} values for {self.num_embeddings} columns"
            )
        return x_t[None] + x_v, batch["attention_mask"]


def build_encoder(
    name: str, encoder_config: Dict[str, Any], embedding_dim: int
) -> nn.Module:
    """Instantiate an encoder from a YAML ``encoder_configs`` entry."""
    cfg = dict(encoder_config)
    etype = cfg.pop("type")
    if etype != "TabularEncoder":
        raise NotImplementedError(
            f"encoder {etype!r} (modality {name!r}) is not ported yet; "
            "the port has TabularEncoder"
        )
    keys = ("num_embeddings", "embedding_dim", "padding_idx", "max_value")
    kwargs = {k: v for k, v in cfg.items() if k in keys}
    kwargs.setdefault("embedding_dim", embedding_dim)
    return TabularEncoder(**kwargs)
