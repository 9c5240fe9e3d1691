"""Masked multi-head attention ops.

Two implementations of one contract (``mca_tpu/ops/attention.py``):

- ``dense``: the numeric oracle.  Scores at full ``[B, H, Tq, Tk]``;
  blocked and padded positions are *set* to ``finfo(float32).min``
  before an fp32 softmax, so a fully masked row softmaxes to a uniform
  average over all keys (the attentive pool relies on that for the
  return token of a missing modality).
- ``pallas`` (the configs' name for it): the block-sparse flash kernel
  of :mod:`mca_tpu_torch.ops.flash_attention`; fully masked rows give
  zeros.

``impl="auto"`` takes the flash path when the mask is static (numpy):
the Hopper kernel for CUDA tensors, its plain version for CPU tensors.

Masks: ``attn_mask`` ``[Tq, Tk]`` bool (True = blocked), shared by the
batch; ``key_padding_mask`` ``[B, Tk]`` bool (True = padded key).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NEG = float(torch.finfo(torch.float32).min)


def dense_masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    attn_mask: Optional[torch.Tensor] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``[B, H, Tq, Dh] x [B, H, Tk, Dh] -> [B, H, Tq, Dh]``."""
    out_dtype = q.dtype
    sim = torch.einsum("bhid,bhjd->bhij", (q * scale).float(), k.float())
    if attn_mask is not None:
        sim = sim.masked_fill(attn_mask[None, None], _NEG)
    if key_padding_mask is not None:
        sim = sim.masked_fill(key_padding_mask[:, None, None, :].bool(), _NEG)
    attn = torch.softmax(sim, dim=-1)
    out = torch.einsum(
        "bhij,bhjd->bhid", attn.to(out_dtype).float(), v.float()
    )
    return out.to(out_dtype)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    attn_mask=None,
    key_padding_mask: Optional[torch.Tensor] = None,
    impl: str = "dense",
) -> torch.Tensor:
    """Dispatch between the dense oracle and the flash kernel."""
    if impl == "auto":
        impl = (
            "pallas"
            if attn_mask is None or isinstance(attn_mask, np.ndarray)
            else "dense"
        )
    if impl == "pallas":
        from mca_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v, attn_mask, key_padding_mask, scale
        )[0]
    if impl != "dense":
        raise NotImplementedError(
            f"attention_impl={impl!r} is not ported; use dense, pallas "
            "or auto"
        )
    if isinstance(attn_mask, np.ndarray):
        attn_mask = torch.from_numpy(attn_mask).to(q.device)
    return dense_masked_attention(
        q,
        k,
        v,
        scale=scale,
        attn_mask=attn_mask,
        key_padding_mask=key_padding_mask,
    )
