"""Modality encoders (PyTorch), built from the YAML ``encoder_configs``.

Ported from ``mca_tpu/encoders.py``.  Every encoder maps a collated
batch dict to ``(tokens [B, T, D], attention_mask [B, T])`` with the
mask convention 1/True = padded.  Parameter names follow the torch
reference's state_dict, so a state dict carried from the JAX package
(:mod:`mca_tpu_torch.interop`) loads with ``strict=True``:

- ``TabularEncoder`` / ``SparseTabularEncoder``:
  ``token_encoder.embedding.weight``, ``value_encoder.{linear1,linear2,norm}.*``;
- ``SequenceEncoder``: ``token_encoder.embedding.weight`` (the
  sinusoidal table is a constant, not a parameter);
- ``EmbeddedSequenceEncoder``: ``token_encoder.{0,1,2}.*`` (LayerNorm,
  Linear, LayerNorm);
- ``PatchEncoder``: ``batch_to_tokens.{1,2,3}.*`` (index 0 is the
  parameter-free patchify) and ``embedding.weight`` (the learnable
  position embedding).

Dropout (``PositionalEncoder``'s, drawn per sample as the reference's
``dropout(pe.repeat(B, 1, 1))``, and ``PatchEncoder``'s) runs only in
train mode, and only from the ``torch.Generator`` its caller hands it
(``mca_tpu_torch.train`` derives one per step): nothing draws from the
global RNG, and a train-mode forward that would draw without a
generator raises.  The bits differ from JAX's threefry for the same
seed; the semantics (which entries may drop, at what rate, the
``1 / (1 - rate)`` rescale) are the same.

LayerNorm epsilon is 1e-6 everywhere: the JAX package uses flax's
default, not torch's 1e-5.
"""

from __future__ import annotations

import inspect
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-6

Encoded = Tuple[torch.Tensor, Optional[torch.Tensor]]


def dropout(
    x: torch.Tensor, rate: float, generator: Optional[torch.Generator]
) -> torch.Tensor:
    """flax's ``nn.Dropout``: each entry kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, else 0; the draw comes
    from ``generator`` (on ``x``'s device) alone."""
    if generator is None:
        raise ValueError(
            "train-mode dropout needs a torch.Generator: pass generator= "
            "(mca_tpu_torch.train.dropout_generator makes the step's)"
        )
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


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


class PositionalEncoder(nn.Module):
    """The fixed sinusoidal table (a buffer, not a parameter), returned
    broadcast to ``[batch, seq_len, d]`` for the caller to add; in train
    mode with ``dropout > 0`` each sample's copy gets its own mask."""

    def __init__(self, d_model: int, dropout: float = 0.1, max_len: int = 2048):
        super().__init__()
        position = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, d_model, 2) * (-math.log(10000.0) / d_model))
        pe = np.zeros((max_len, d_model), dtype=np.float32)
        pe[:, 0::2] = np.sin(position * div)
        pe[:, 1::2] = np.cos(position * div)
        self.register_buffer("pe", torch.from_numpy(pe), persistent=False)
        self.d_model = d_model
        self.rate = float(dropout)

    def forward(
        self, seq_len: int, batch: int = 1, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        pe = self.pe[:seq_len].expand(batch, seq_len, self.d_model)
        if self.rate > 0.0 and self.training:
            pe = dropout(pe, self.rate, generator)
        return pe


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
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Encoded:
        values = batch["values"]
        index = torch.arange(self.num_embeddings, device=values.device)
        x_t = self.token_encoder(index)
        x_v = self.value_encoder(values)
        if x_v.shape[1] != self.num_embeddings:
            raise ValueError(
                f"{x_v.shape[1]} values for {self.num_embeddings} columns"
            )
        return x_t[None] + x_v, batch["attention_mask"]


class SparseTabularEncoder(nn.Module):
    """Sparse table -> tokens: embedded column indices + encoded values,
    summed; ``padding_idx`` (0) marks padded entries of both."""

    def __init__(
        self,
        num_embeddings: int = 36602,
        embedding_dim: int = 512,
        padding_idx: int = 0,
        max_value: float = 10000.0,
    ):
        super().__init__()
        self.token_encoder = TokenEncoder(num_embeddings, embedding_dim, padding_idx)
        self.value_encoder = ContinuousValueEncoder(
            embedding_dim, max_value=max_value, padding_value=float(padding_idx)
        )

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Encoded:
        x_t = self.token_encoder(batch["indices"].long())
        x_v = self.value_encoder(batch["data"])
        return x_t + x_v, batch["attention_mask"]


class SequenceEncoder(nn.Module):
    """Token-id sequences: embedded ids plus the sinusoidal table."""

    def __init__(
        self,
        num_embeddings: int = 36602,
        embedding_dim: int = 512,
        padding_idx: int = 0,
        dropout: float = 0.0,
        max_tokens: int = 1024,
    ):
        super().__init__()
        self.token_encoder = TokenEncoder(num_embeddings, embedding_dim, padding_idx)
        self.positional_encoder = PositionalEncoder(embedding_dim, dropout, max_tokens)

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Encoded:
        tokens = batch["tokens"].long()
        x_t = self.token_encoder(tokens)
        x_p = self.positional_encoder(tokens.shape[1], tokens.shape[0], generator)
        return x_t + x_p, batch["attention_mask"]


class EmbeddedSequenceEncoder(nn.Module):
    """Pre-embedded ``[T, input_size]`` sequences (CMU-MOSEI).

    Padded rows are zeroed before AND after ``LayerNorm -> Linear ->
    LayerNorm``, then the sinusoidal table is added, so padded rows
    carry pure positional encoding (the attention mask hides them)."""

    def __init__(
        self,
        input_size: int = 128,
        embedding_dim: int = 512,
        dropout: float = 0.0,
        max_tokens: int = 1024,
    ):
        super().__init__()
        self.token_encoder = nn.Sequential(
            nn.LayerNorm(input_size, eps=LN_EPS),
            nn.Linear(input_size, embedding_dim),
            nn.LayerNorm(embedding_dim, eps=LN_EPS),
        )
        self.positional_encoder = PositionalEncoder(embedding_dim, dropout, max_tokens)

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Encoded:
        pad = batch["attention_mask"].bool()[..., None]
        x = batch["tokens"].masked_fill(pad, 0.0)
        x = self.token_encoder(x).masked_fill(pad, 0.0)
        x_p = self.positional_encoder(x.shape[1], x.shape[0], generator)
        return x + x_p, batch["attention_mask"]


class Patchify(nn.Module):
    """``[B, ...] -> [B, n_patches, patch_elems]`` in ``einops``'s order:
    matrix ``b (h p1) (w p2) -> b (h w) (p1 p2)``, image ``b c (h p1)
    (w p2) -> b (h w) (c p1 p2)``, video ``b c (t p1) (h p2) (w p3) ->
    b (t h w) (c p1 p2 p3)``."""

    def __init__(self, patch_size: Sequence[int], mode: str):
        super().__init__()
        self.patch_size = tuple(int(p) for p in patch_size)
        self.mode = mode

    def forward(self, values: torch.Tensor) -> torch.Tensor:
        p = self.patch_size
        lead = 1 if self.mode == "matrix" else 2  # b, or b c
        sizes = values.shape[lead:]
        if len(sizes) != len(p) or any(s % q for s, q in zip(sizes, p)):
            raise ValueError(f"{self.mode} of shape {tuple(values.shape)} "
                             f"does not cut into patches of {p}")
        grid = [s // q for s, q in zip(sizes, p)]
        split = list(values.shape[:lead])
        for g, q in zip(grid, p):
            split += [g, q]
        x = values.reshape(split)
        n = len(p)
        grid_axes = [lead + 2 * i for i in range(n)]
        patch_axes = [lead + 2 * i + 1 for i in range(n)]
        chan = [1] if lead == 2 else []
        x = x.permute(0, *grid_axes, *chan, *patch_axes)
        return x.reshape(values.shape[0], math.prod(grid), -1)


class PatchEncoder(nn.Module):
    """ViT-style patching for matrix / image / video values.

    ``LayerNorm -> Linear -> LayerNorm`` over the flattened patches plus
    a learnable position embedding over ``max_tokens``, then dropout in
    train mode; the attention mask marks patches entirely equal to
    ``pad_token`` (``None`` with ``attn_mask=False``).  Image and video
    need ``num_channels`` for the patch width (flax infers it at the
    first call; torch sizes its layers at construction)."""

    def __init__(
        self,
        patch_size: Sequence[int] = (16, 16),
        mode: str = "matrix",
        num_channels: int = 0,
        embedding_dim: int = 512,
        max_tokens: int = 1024,
        dropout: float = 0.1,
        attn_mask: bool = True,
        pad_token: float = -10000.0,
    ):
        super().__init__()
        p = tuple(int(x) for x in patch_size)
        if mode not in ("matrix", "image", "video") or len(p) != (3 if mode == "video" else 2):
            raise ValueError(f"mode {mode!r} with patch_size {p}")
        if mode != "matrix" and int(num_channels) < 1:
            raise ValueError(f"PatchEncoder mode {mode!r} needs num_channels >= 1")
        elems = math.prod(p) * (1 if mode == "matrix" else int(num_channels))
        self.batch_to_tokens = nn.Sequential(
            Patchify(p, mode),
            nn.LayerNorm(elems, eps=LN_EPS),
            nn.Linear(elems, embedding_dim),
            nn.LayerNorm(embedding_dim, eps=LN_EPS),
        )
        self.embedding = nn.Embedding(max_tokens, embedding_dim)
        self.max_tokens = max_tokens
        self.rate = float(dropout)
        self.attn_mask = attn_mask
        self.pad_token = pad_token

    def forward(
        self, batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None
    ) -> Encoded:
        patches = self.batch_to_tokens[0](batch["values"])
        x = patches
        for layer in self.batch_to_tokens[1:]:
            x = layer(x)
        if x.shape[1] != self.max_tokens:
            raise ValueError(f"{x.shape[1]} patches for max_tokens {self.max_tokens}")
        x = x + self.embedding.weight[None]
        if self.rate > 0.0 and self.training:
            x = dropout(x, self.rate, generator)
        mask = (patches == self.pad_token).all(dim=-1).long() if self.attn_mask else None
        return x, mask


encoders_dict = {
    "SequenceEncoder": SequenceEncoder,
    "TabularEncoder": TabularEncoder,
    "SparseTabularEncoder": SparseTabularEncoder,
    "PatchEncoder": PatchEncoder,
    "EmbeddedSequenceEncoder": EmbeddedSequenceEncoder,
}

_TAKES_MAX_TOKENS = ("SequenceEncoder", "EmbeddedSequenceEncoder", "PatchEncoder")


def build_encoder(
    name: str, encoder_config: Dict[str, Any], embedding_dim: int
) -> nn.Module:
    """Instantiate a registry encoder from a YAML ``encoder_configs``
    entry (``mca_tpu.encoders.build_encoder``'s rules): keys the
    constructor does not take are dropped, ``embedding_dim`` defaults to
    the model's width, and the Sequence, EmbeddedSequence and Patch
    encoders get ``max_tokens`` (default 1024); collator and bookkeeping
    keys (``type``, ``pad_len``, ``dropout_collator``) reach none."""
    cfg = dict(encoder_config)
    etype = cfg.get("type")
    if etype not in encoders_dict:
        raise ValueError(f"modality {name!r}: unknown encoder type {etype!r}")
    cls = encoders_dict[etype]
    takes = set(inspect.signature(cls.__init__).parameters) - {"self"}
    kwargs = {k: v for k, v in cfg.items() if k in takes}
    if "embedding_dim" in takes:
        kwargs.setdefault("embedding_dim", embedding_dim)
    if etype in _TAKES_MAX_TOKENS:
        kwargs["max_tokens"] = cfg.get("max_tokens", 1024)
    return cls(**kwargs)
