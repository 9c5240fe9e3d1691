"""The work a configuration asks of the chip, counted from its shapes.

Operations count a multiply-add as 2.  Attention counts only the score
entries that the static mask leaves live (the fusion-channel mask keeps
about a third of them at TCGA_config1); each product over them has the
depth of one head.  Bytes count each input read once and each output
written once, in bf16, whatever a kernel reads again.

Peaks are NVIDIA's data sheet for one H100 SXM, dense: 989e12 bf16
operations a second and 3.35e12 bytes a second of HBM.
"""

from __future__ import annotations

from portbench.reference.model import Layout, ff_inner

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def sample_tokens(cfg: dict) -> int:
    """Tokens one row puts through the blocks: every modality's token
    slots and the fusion tokens."""
    return Layout(cfg).seq_len


def live_entries(cfg: dict) -> int:
    """Score entries the static self-attention mask leaves live."""
    return int((~Layout(cfg).attn_blocked).sum())


def pool_live_entries(cfg: dict) -> int:
    return int((~Layout(cfg).pool_blocked).sum())


def gemm_flops(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def attn_fwd_work(cfg: dict, batch: int):
    """``(operations, bytes)`` of one masked attention forward over
    ``batch`` rows: two products over the live entries; q, k, v read and
    o written."""
    h, dh = int(cfg["heads"]), int(cfg["dim_head"])
    flops = 2 * gemm_flops(1, dh, 1) * live_entries(cfg) * batch * h
    nbytes = 4 * batch * h * sample_tokens(cfg) * dh * BF16
    return flops, nbytes


def attn_bwd_work(cfg: dict, batch: int):
    """``(operations, bytes)`` of one masked attention backward: five
    products over the live entries (the scores again, dP, dV, dQ, dK);
    q, k, v, o, dO read and dq, dk, dv written."""
    h, dh = int(cfg["heads"]), int(cfg["dim_head"])
    flops = 5 * gemm_flops(1, dh, 1) * live_entries(cfg) * batch * h
    nbytes = 8 * batch * h * sample_tokens(cfg) * dh * BF16
    return flops, nbytes


def geglu_ff_work(cfg: dict, batch: int):
    """``(operations, bytes)`` of one GEGLU feed-forward over every token
    of ``batch`` rows: ``x W1`` (both halves) and ``(gelu(g) * h) W2``;
    x, W1 and W2 read and the output written."""
    d, inner = int(cfg["hidden_size"]), ff_inner(cfg)
    m = batch * sample_tokens(cfg)
    flops = gemm_flops(m, d, 2 * inner) + gemm_flops(m, inner, d)
    nbytes = (2 * m * d + 3 * d * inner) * BF16
    return flops, nbytes


def encoder_flops(cfg: dict) -> int:
    """Forward operations of the encoders for one row (their matrix
    products; norms and sums are not counted)."""
    d = int(cfg["hidden_size"])
    total = 0
    for e in cfg["encoder_configs"].values():
        t = int(e["max_tokens"])
        if e["type"] == "TabularEncoder":
            total += gemm_flops(t, 1, d) + gemm_flops(t, d, d)
        elif e["type"] == "EmbeddedSequenceEncoder":
            total += gemm_flops(t, int(e["input_size"]), d)
        else:
            raise ValueError(f"no count for encoder {e['type']!r}")
    return total


def forward_flops(cfg: dict, batch: int) -> int:
    """Model forward operations for ``batch`` rows: encoders, each
    block's projections, feed-forward and live attention, and the
    attentive pool.  The loss is not counted."""
    d = int(cfg["hidden_size"])
    hd = int(cfg["heads"]) * int(cfg["dim_head"])
    t = sample_tokens(cfg)
    r = len(Layout(cfg).return_types)
    block = (gemm_flops(t, d, hd) + gemm_flops(t, d, 2 * hd) + gemm_flops(t, hd, d)
             + geglu_ff_work(cfg, 1)[0] + attn_fwd_work(cfg, 1)[0])
    h, dh = int(cfg["heads"]), int(cfg["dim_head"])
    pool = (gemm_flops(r, d, hd) + gemm_flops(t, d, 2 * hd) + gemm_flops(r, hd, d)
            + 2 * gemm_flops(1, dh, 1) * pool_live_entries(cfg) * h)
    return batch * (encoder_flops(cfg) + int(cfg["layers"]) * block + pool)


def train_flops(cfg: dict, batch: int) -> int:
    """Model operations of one training step: the forward's, times 3."""
    return 3 * forward_flops(cfg, batch)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the operations
    at the bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def share(part: float, whole: float, what: str) -> float:
    """``part / whole`` in percent, refused outside (0, 105]: above 100
    the work is counted too high or the time leaves some out."""
    value = 100.0 * part / whole if whole > 0 else float("nan")
    if not (0.0 < value <= 105.0):
        raise ValueError(f"{what} reads {value!r}%, outside (0, 105]")
    return value

