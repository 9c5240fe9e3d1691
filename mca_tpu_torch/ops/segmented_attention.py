"""Segment-decomposed attention, ported from ``mca_tpu/ops/segmented_attention.py``.

In the zorro / MCA masks a modality's token rows attend only their own
modality's segment, and only the fusion-token rows cross segments.
Softmax is per row, so splitting the query rows is exact:

- each self-attention segment runs the flash path with no static mask
  (:func:`mca_tpu_torch.ops.flash_attention.flash_attention` with
  ``attn_mask=None``: every tile live; on CUDA tensors K1 forward and K2,
  or K3a + K3b, backward; on CPU tensors their plain versions) over the
  segment's slice of q, k, v and the key padding;
- the cross row-runs (the fusion tokens' runs) run together through one
  :func:`~mca_tpu_torch.ops.attention.dense_masked_attention` call over
  the full key range with their rows of the mask (adjacent runs are one
  slice of q: TCGA_config1's 11 runs are its last 88 rows);
- the pieces are concatenated back in row order.

The decomposition comes from the mask alone (:func:`analyze_mask`, the
JAX package's, in numpy): TCGA_config1's mask splits into four segments
(800, 198, 800, 662 rows) and 11 cross runs (88 fusion rows); an
unmasked call (EAO) is one segment; a mask with no self-attention
structure is all cross rows (dense semantics).  A model's mask is
static, so its decomposition and its cross rows' mask on the device are
kept per mask and device (the last :data:`PLANS_KEPT`); an unmasked call
keeps nothing.

Semantics match the flash path's: a fully padded row inside a segment
returns zeros; cross rows keep the dense path's semantics.

The JAX package's ``_segment_blocks`` (a TPU block shape per segment
length) has no counterpart: the Hopper kernels' tiles are fixed by
their design (64 x 64), whatever the segment's length.  A segment's q,
k and v are copied out of the ``[B, H, T, D]`` tensors (a slice along T
is not contiguous, and the kernels take contiguous tensors only); the
copies and the concatenation are differentiable, so the gradients of
q, k and v flow back through them.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Tuple

import numpy as np
import torch

from mca_tpu_torch.ops.attention import dense_masked_attention
from mca_tpu_torch.ops.flash_attention import flash_attention

Runs = List[Tuple[int, int]]

#: how many (mask, device) plans :func:`_plan` keeps, least recently used
#: out first
PLANS_KEPT = 8
# (id(mask), device) -> (mask, (segments, spans, cross mask on the
# device)); the mask is kept alive with its entry, so its id cannot be
# reused while cached
_PLANS: "OrderedDict[tuple, tuple]" = OrderedDict()


def analyze_mask(attn_mask: np.ndarray) -> Tuple[Runs, Runs]:
    """Partition the query rows of a static ``[T, T]`` bool mask (True =
    blocked) into ``(segments, cross)``, both lists of ``(start,
    length)`` row ranges.  A *segment* is a maximal run of identical rows
    whose unblocked key set is exactly the run itself (self-attention
    within the segment); every other run is *cross* (the full key range
    with its sub-mask)."""
    mask = np.asarray(attn_mask, bool)
    t = mask.shape[0]
    segments: Runs = []
    cross: Runs = []
    i = 0
    while i < t:
        j = i + 1
        while j < t and np.array_equal(mask[j], mask[i]):
            j += 1
        cols = np.flatnonzero(~mask[i])
        if len(cols) == j - i and len(cols) > 0 and cols[0] == i and cols[-1] == j - 1:
            segments.append((i, j - i))
        else:
            cross.append((i, j - i))
        i = j
    return segments, cross


def _spans(runs: Runs) -> Runs:
    """``runs`` with adjacent ones merged (the slices of q they take)."""
    out: Runs = []
    for start, length in runs:
        if out and out[-1][0] + out[-1][1] == start:
            out[-1] = (out[-1][0], out[-1][1] + length)
        else:
            out.append((start, length))
    return out


def _plan(attn_mask: np.ndarray, device: torch.device):
    """``(segments, spans, cross_mask)`` of a static mask on ``device``:
    :func:`analyze_mask`'s segments, its cross runs merged into spans,
    and the spans' rows of the mask as one bool tensor on the device;
    made once per mask and device."""
    key = (id(attn_mask), str(device))
    hit = _PLANS.get(key)
    if hit is not None and hit[0] is attn_mask:
        _PLANS.move_to_end(key)
        return hit[1]
    segments, cross = analyze_mask(attn_mask)
    spans = _spans(cross)
    cross_mask = None
    if spans:
        rows = np.concatenate([np.arange(s, s + n) for s, n in spans])
        cross_mask = torch.from_numpy(np.ascontiguousarray(attn_mask[rows])).to(device)
    plan = (segments, spans, cross_mask)
    _PLANS[key] = (attn_mask, plan)
    while len(_PLANS) > PLANS_KEPT:
        _PLANS.popitem(last=False)
    return plan


def segmented_masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    scale: float,
    attn_mask: Optional[np.ndarray] = None,
    key_padding_mask: Optional[torch.Tensor] = None,
    bwd_impl: Optional[str] = None,
) -> torch.Tensor:
    """``[B, H, T, D]`` attention under a static numpy mask, decomposed by
    its query-row structure (module docstring); ``bwd_impl`` picks the
    segments' flash backward as in
    :func:`~mca_tpu_torch.ops.flash_attention.flash_attention`."""
    t = q.shape[2]
    if attn_mask is None:
        segments, spans, cross_mask = [(0, t)], [], None
    elif not isinstance(attn_mask, np.ndarray) or attn_mask.shape != (t, t):
        raise ValueError("the segmented path needs a static numpy [T, T] attn_mask")
    else:
        segments, spans, cross_mask = _plan(attn_mask, q.device)
    pieces = []
    for start, length in segments:
        rows = slice(start, start + length)
        pad = None if key_padding_mask is None else key_padding_mask[:, rows]
        out, _ = flash_attention(
            q[:, :, rows].contiguous(), k[:, :, rows].contiguous(),
            v[:, :, rows].contiguous(), None, pad, scale, bwd_impl,
        )
        pieces.append((start, out))
    if spans:
        qc = [q[:, :, s:s + n] for s, n in spans]
        out = dense_masked_attention(
            qc[0] if len(qc) == 1 else torch.cat(qc, dim=2), k, v, scale=scale,
            attn_mask=cross_mask, key_padding_mask=key_padding_mask,
        )
        pieces += zip((s for s, _ in spans), out.split([n for _, n in spans], dim=2))
    if len(pieces) == 1:
        return pieces[0][1]
    pieces.sort(key=lambda p: p[0])
    return torch.cat([p[1] for p in pieces], dim=2)
