"""The work a ``deepseek_v3`` block configuration asks of the chip,
counted from its shapes, as :mod:`portbench.counts` counts the MCA one
(a multiply-add is 2 operations; bytes are each input read once and each
output written once, in bf16; the same peaks).

Latent attention is K1 / K2 at head dims (d_qk, d_v) = (nope + rope,
v): the forward does two products over the mask's live entries, of
depth d_qk (the scores) and d_v (p v); the backward five, of depths
d_qk (the scores again), d_v (dP), d_v (dV), d_qk (dQ) and d_qk (dK).
The routed experts' grouped products are counted from the assignments
to the held experts that the program's counter ``moe.held_tokens``
reports: each assignment runs one SwiGLU of the expert width forward
(two products, ``2 d x inner`` and ``inner x d``) and twice that
backward.  The model's operations a step (for ``mfu.train``) count the
held share at balance, ``tokens * k * held / E`` assignments.
"""

from __future__ import annotations

from portbench import counts
from portbench.counts import BF16, gemm_flops, live_entries, sample_tokens
from portbench.reference.model import Layout


def _dims(cfg: dict):
    h = int(cfg["heads"])
    dqk = int(cfg["qk_nope_head_dim"]) + int(cfg["qk_rope_head_dim"])
    return h, dqk, int(cfg["v_head_dim"])


def mla_attn_fwd_work(cfg: dict, batch: int):
    """``(operations, bytes)`` of one latent-attention forward (K1 at
    (d_qk, d_v)) over ``batch`` rows: q and k at d_qk, v and o at d_v."""
    h, dqk, dv = _dims(cfg)
    flops = 2 * (dqk + dv) * live_entries(cfg) * batch * h
    nbytes = batch * h * sample_tokens(cfg) * (2 * dqk + 2 * dv) * BF16
    return flops, nbytes


def mla_attn_bwd_work(cfg: dict, batch: int):
    """``(operations, bytes)`` of one latent-attention backward (K2 at
    (d_qk, d_v)): five products; q, k, v, o, dO read and dq, dk, dv
    written."""
    h, dqk, dv = _dims(cfg)
    flops = 2 * (3 * dqk + 2 * dv) * live_entries(cfg) * batch * h
    nbytes = batch * h * sample_tokens(cfg) * (2 * dqk + 3 * dv + 2 * dqk + dv) * BF16
    return flops, nbytes


def held(cfg: dict) -> int:
    return int(cfg["n_routed_experts"]) // int(cfg["ep_size"])


def moe_layers(cfg: dict) -> int:
    return max(int(cfg["layers"]) - int(cfg["first_k_dense_replace"]), 0)


def expert_gemm_work(cfg: dict, assignments: float):
    """``(operations, bytes)`` of the grouped expert products of one
    routed layer, forward and backward, for ``assignments`` held
    token-expert pairs: forward ``x W1`` (both halves) and ``a W2``;
    backward their input and weight gradients.  Bytes: each product's
    operands read and its output written once."""
    d, inner, n = int(cfg["hidden_size"]), int(cfg["moe_intermediate_size"]), held(cfg)
    m = float(assignments)
    flops = 3 * (gemm_flops(1, d, 2 * inner) + gemm_flops(1, inner, d)) * m
    w1, w2 = n * 2 * inner * d, n * d * inner
    fwd = (m * d + w1 + m * 2 * inner) + (m * inner + w2 + m * d)
    dgrad = (m * 2 * inner + w1 + m * d) + (m * d + w2 + m * inner)
    wgrad = (m * d + m * 2 * inner + w1) + (m * inner + m * d + w2)
    return flops, (fwd + dgrad + wgrad) * BF16


def balanced_assignments(cfg: dict, batch: int) -> float:
    """Held assignments of ``batch`` rows a routed layer at balance."""
    return (batch * sample_tokens(cfg) * int(cfg["num_experts_per_tok"]) * held(cfg)
            / int(cfg["n_routed_experts"]))


def forward_flops(cfg: dict, batch: int) -> float:
    """Model forward operations for ``batch`` rows: the encoders, each
    block's latent-attention projections and live attention, the dense
    SwiGLU or the router, the held experts at balance and the shared
    experts, and the attentive pool.  The loss is not counted."""
    d, t = int(cfg["hidden_size"]), sample_tokens(cfg)
    h, dqk, dv = _dims(cfg)
    rank, rope = int(cfg["kv_lora_rank"]), int(cfg["qk_rope_head_dim"])
    nope = int(cfg["qk_nope_head_dim"])
    attn = (gemm_flops(t, d, h * dqk) + gemm_flops(t, d, rank + rope)
            + gemm_flops(t, rank, h * (nope + dv)) + gemm_flops(t, h * dv, d)
            + mla_attn_fwd_work(cfg, 1)[0])
    dense = 3 * gemm_flops(t, d, int(cfg["intermediate_size"]))
    inner = int(cfg["moe_intermediate_size"])
    routed = (gemm_flops(t, d, int(cfg["n_routed_experts"]))
              + 3 * gemm_flops(t, d, inner * int(cfg["n_shared_experts"])))
    dense_layers = int(cfg["layers"]) - moe_layers(cfg)
    hd = int(cfg["heads"]) * int(cfg["dim_head"])
    r = len(Layout(cfg).return_types)
    pool = (gemm_flops(r, d, hd) + gemm_flops(t, d, 2 * hd) + gemm_flops(r, hd, d)
            + 2 * gemm_flops(1, int(cfg["dim_head"]), 1) * counts.pool_live_entries(cfg)
            * int(cfg["heads"]))
    per_row = (counts.encoder_flops(cfg) + int(cfg["layers"]) * attn + dense_layers * dense
               + moe_layers(cfg) * routed + pool)
    experts = moe_layers(cfg) * expert_gemm_work(cfg, balanced_assignments(cfg, batch))[0] / 3
    return batch * per_row + experts


def train_flops(cfg: dict, batch: int) -> float:
    """Model operations of one training step: the forward's, times 3."""
    return 3 * forward_flops(cfg, batch)
