"""Int8 weights for the serving forward, ported from ``mca_tpu/ops/quant.py``.

The post-training recipe of the JAX package, for the online serving
path (``python -m mca_tpu_torch.serve ... --quantize int8``) and the
exported forward (``tools.export_aot --quantize int8``):

- **weights**: symmetric per-output-channel int8
  (``scale[o] = max_i |W[i, o]| / 127``), computed once from the fp32
  parameters (:func:`quantize_weight`, :func:`quantize_state_dict`);
  the int8 values and scales are bitwise the JAX package's;
- **activations**: symmetric per-row dynamic int8
  (``s[r] = max_c |x[r, c]| / 127``), quantised inside the forward;
- the product is one ``s8 x s8 -> s32`` matrix product
  (``torch._int_mm``: cuBLAS's int8 tensor-core GEMM on the card, an
  exact integer product on the CPU), then ``y = yq * s_row * scale`` in
  fp32, cast back to the input's dtype.

Only the five fusion-block projections (``to_q``, ``to_kv``,
``to_out`` and the GEGLU's ``feedforward.0`` / ``feedforward.2``, the
JAX package's ``w_in`` / ``w_out``) are quantised; the encoders, norms
and the attentive pool stay float.

``torch._int_mm`` on CUDA takes more than 16 rows and inner and output
widths that are multiples of 8.  :func:`int8_matmul` pads the rows, the
inner width (zero columns of x, zero rows of the weight) and the output
width (zero columns of the weight) to fit, on every device, and slices
the output back: a zero term adds nothing to an integer sum, so the
padding is exact.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: the fusion blocks' projections whose weight becomes ``weight_q`` +
#: ``scale``; the JAX package's names (``QUANT_DENSE_NAMES``) and the
#: port's modules they are
QUANT_DENSE_NAMES = ("to_q", "to_kv", "to_out", "w_in", "w_out")
#: the ``quant`` / ``quantize`` modes of the models and the service
QUANT_MODES = ("none", "int8")
PORT_NAMES = {"w_in": "feedforward.0", "w_out": "feedforward.2"}

_EPS = 1e-8
_MULTIPLE = 8  # torch._int_mm's inner and output widths on CUDA
_MIN_ROWS = 17  # and its rows: more than 16


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 of an ``[in, out]`` kernel:
    ``(q int8 [in, out], scale fp32 [out])``, in the JAX package's
    order of operations (``max(|w|, eps) / 127``, ``w / scale`` rounded
    half to even), so bitwise equal to its numpy version."""
    w = torch.as_tensor(w).detach().to(torch.float32)
    scale = torch.clamp(w.abs().amax(dim=0), min=_EPS) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def _pad_to(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row dynamic int8 of ``[m, k]`` rows: ``(xq int8, s_row fp32
    [m, 1])`` with ``s_row = max(max|x|, eps) / 127`` and ``xq =
    round(x / s_row)`` (a division, rounded half to even), as the JAX
    package's ``int8_dot`` computes them."""
    xf = x.to(torch.float32)
    s_row = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=_EPS) / 127.0
    xq = torch.clamp(torch.round(xf / s_row), -127, 127).to(torch.int8)
    return xq, s_row


def int8_matmul(xq: torch.Tensor, weight_q: torch.Tensor) -> torch.Tensor:
    """The exact ``s8 x s8 -> s32`` product ``[m, k] x [k, n]`` through
    ``torch._int_mm``, padded to its shape rules and sliced back."""
    (m, k), n = xq.shape, weight_q.shape[1]
    kp, np_ = _pad_to(k, _MULTIPLE), _pad_to(n, _MULTIPLE)
    xq = F.pad(xq, (0, kp - k, 0, max(_MIN_ROWS - m, 0)))
    wq = F.pad(weight_q, (0, np_ - n, 0, kp - k))
    return torch._int_mm(xq, wq)[:m, :n]


def int8_dot(
    x: torch.Tensor, weight_q: torch.Tensor, scale: torch.Tensor
) -> torch.Tensor:
    """``x @ dequant(weight_q)`` with per-row dynamic activation int8.

    ``x`` ``[..., in]`` float, ``weight_q`` ``[in, out]`` int8, ``scale``
    ``[out]`` fp32; returns ``[..., out]`` in ``x.dtype``:
    ``yq * s_row * scale`` in fp32, in that order.
    """
    lead = x.shape[:-1]
    k, n = weight_q.shape
    xq, s_row = quantize_rows(x.reshape(-1, k))
    y = int8_matmul(xq, weight_q).to(torch.float32) * s_row * scale
    return y.to(x.dtype).reshape(*lead, n)


class QuantLinear(nn.Module):
    """Bias-free linear over an int8 kernel and its per-channel scale
    (the JAX package's ``QuantDense``).

    ``weight_q`` ``[in, out]`` int8 and ``scale`` ``[out]`` fp32 are
    buffers (state-dict entries beside the float model's ``weight``
    name: ``to_q.weight_q``, ``to_q.scale``), filled from
    :func:`quantize_state_dict`; a module built alone holds zeros.
    ``dtype`` is the compute dtype its input is cast to.
    """

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.register_buffer(
            "weight_q", torch.zeros((in_features, out_features), dtype=torch.int8)
        )
        self.register_buffer("scale", torch.zeros(out_features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dot(x.to(self.dtype), self.weight_q, self.scale)


def _quantised_prefix(key: str, skip_substr: Tuple[str, ...]) -> str:
    """The module prefix of a projection weight that becomes int8, or
    ``""``: ``layers.{i}.attn.{to_q,to_kv,to_out}.weight`` and
    ``layers.{i}.ff.feedforward.{0,2}.weight``, unless a path part holds
    one of ``skip_substr``."""
    if not key.endswith(".weight"):
        return ""
    prefix = key[: -len(".weight")]
    parts = prefix.split(".")
    if any(s in p for s in skip_substr for p in parts):
        return ""
    names = {PORT_NAMES.get(n, n) for n in QUANT_DENSE_NAMES}
    if parts[-1] in names or ".".join(parts[-2:]) in names:
        return prefix
    return ""


def quantize_state_dict(
    state_dict: Mapping[str, torch.Tensor],
    skip_substr: Tuple[str, ...] = ("attn_pool",),
) -> Dict[str, torch.Tensor]:
    """A float state dict -> the int8 model's (the JAX package's
    ``quantize_params`` over the port's names): each projection's
    ``<prefix>.weight`` ``[out, in]`` becomes ``<prefix>.weight_q``
    ``[in, out]`` int8 and ``<prefix>.scale`` ``[out]`` fp32; every
    other entry, the attentive pool's projections included, is kept."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        prefix = _quantised_prefix(key, skip_substr)
        if prefix:
            q, s = quantize_weight(torch.as_tensor(value).t())
            out[f"{prefix}.weight_q"] = q
            out[f"{prefix}.scale"] = s
        else:
            out[key] = value
    return out
