"""Multi-head latent attention (MLA), DeepSeek-V2's attention (arXiv
2405.04434, section 2.1) as DeepSeek-V3 and Moonlight-16B-A3B run it,
without the query's low-rank path (``q_lora_rank`` null):

- ``q = h W_q``, ``[H, d_nope + d_rope]``, split into ``q_nope`` and
  ``q_pe``;
- ``[c_kv, k_pe] = h W_kv_a`` (``kv_lora_rank + d_rope`` wide), then
  ``c_kv = RMSNorm(c_kv)``;
- ``[k_nope, v] = c_kv W_kv_b`` per head (``d_nope + d_v`` a head);
- decoupled RoPE on ``q_pe`` and on the one ``k_pe`` every head shares,
  as DeepSeek-V3's modelling code applies it: each pair de-interleaved
  (even dims first, then odd), then rotate-half, with ``inv_freq =
  theta^(-2i / d_rope)``;
- ``softmax([q_nope, q_pe] [k_nope, k_pe]^T / sqrt(d_nope + d_rope)
  + mask) v``, then ``W_o``.

The position of a token is its slot in the packed sequence (a static
layout: the modalities in configuration order, then the fusion tokens).
The attention itself is the masked flash attention
(:func:`mca_tpu_torch.ops.attention.masked_attention`) at head dims
``(d_nope + d_rope, d_v)``: K1 / K2 at (192, 128) on the card, the plain
versions on the CPU.  Parameter names are the Hugging Face DeepSeek-V3
ones (``q_proj``, ``kv_a_proj_with_mqa``, ``kv_a_layernorm``,
``kv_b_proj``, ``o_proj``).  Projections run in the compute dtype on
fp32 weights cast at use; the norm and the rotation in fp32.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops.attention import masked_attention


class RMSNorm(nn.Module):
    """``x / sqrt(mean(x^2) + eps) * weight`` in fp32 (DeepSeek-V3's
    ``RMSNorm``); returns fp32."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = float(eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps) * self.weight


def rope_tables(positions: int, dim: int, theta: float, device=None):
    """``(cos, sin)`` ``[positions, dim]`` in fp32: ``inv_freq =
    theta^(-2i / dim)``, the angles of each frequency repeated over both
    halves (rotate-half layout)."""
    inv_freq = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float64) / dim)
    ang = torch.outer(torch.arange(positions, dtype=torch.float64), inv_freq)
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's rotation of ``x`` ``[..., T, d]`` in fp32: the pairs
    de-interleaved, then ``x cos + rotate_half(x) sin``."""
    *lead, t, d = x.shape
    x = x.float().reshape(*lead, t, d // 2, 2).transpose(-1, -2).reshape(*lead, t, d)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


class MLAttention(nn.Module):
    """Latent attention over the whole packed sequence (module docstring);
    ``attn_mask`` static ``[T, T]`` (True = blocked), ``key_padding_mask``
    ``[B, T]`` (True = padded)."""

    def __init__(
        self,
        dim: int,
        heads: int,
        kv_lora_rank: int,
        qk_nope_head_dim: int,
        qk_rope_head_dim: int,
        v_head_dim: int,
        rope_theta: float,
        max_positions: int,
        eps: float = 1e-6,
        dtype: torch.dtype = torch.float32,
        impl: str = "auto",
    ):
        super().__init__()
        self.heads = heads
        self.d_nope, self.d_rope, self.d_v = qk_nope_head_dim, qk_rope_head_dim, v_head_dim
        self.kv_lora_rank = kv_lora_rank
        self.q_proj = nn.Linear(dim, heads * (self.d_nope + self.d_rope), bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(dim, kv_lora_rank + self.d_rope, bias=False)
        self.kv_a_layernorm = RMSNorm(kv_lora_rank, eps)
        self.kv_b_proj = nn.Linear(kv_lora_rank, heads * (self.d_nope + self.d_v), bias=False)
        self.o_proj = nn.Linear(heads * self.d_v, dim, bias=False)
        self.dtype, self.impl = dtype, impl
        self.scale = (self.d_nope + self.d_rope) ** -0.5
        cos, sin = rope_tables(max_positions, self.d_rope, rope_theta)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def _linear(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        return F.linear(x, lin.weight.to(self.dtype))

    def forward(self, h: torch.Tensor, attn_mask=None,
                key_padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training and torch.is_grad_enabled():
            flash.check_bwd_impl(flash.default_bwd_impl, self.d_nope + self.d_rope, self.d_v)
        b, t, _ = h.shape
        H = self.heads
        x = h.to(self.dtype)
        q = self._linear(x, self.q_proj).view(b, t, H, self.d_nope + self.d_rope).transpose(1, 2)
        q_nope, q_pe = q.split([self.d_nope, self.d_rope], dim=-1)
        ckv, k_pe = self._linear(x, self.kv_a_proj_with_mqa).split(
            [self.kv_lora_rank, self.d_rope], dim=-1)
        kv = self._linear(self.kv_a_layernorm(ckv).to(self.dtype), self.kv_b_proj)
        kv = kv.view(b, t, H, self.d_nope + self.d_v).transpose(1, 2)
        k_nope, v = kv.split([self.d_nope, self.d_v], dim=-1)
        cos, sin = self.rope_cos[:t], self.rope_sin[:t]
        q_pe = apply_rope(q_pe, cos, sin).to(self.dtype)
        k_pe = apply_rope(k_pe[:, None], cos, sin).to(self.dtype)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, H, t, self.d_rope)], dim=-1)
        out = masked_attention(q, k, v.contiguous(), scale=self.scale, attn_mask=attn_mask,
                               key_padding_mask=key_padding_mask, impl=self.impl)
        out = out.transpose(1, 2).reshape(b, t, H * self.d_v)
        return self._linear(out, self.o_proj)
