"""A plain PyTorch reference of the MCA fusion transformer and its loss.

Written from the published description of Sparsely Multimodal Data
Fusion (MCA): per-modality encoders, learnable fusion tokens split into
one channel per modality combination, a stack of pre-norm transformer
blocks under the static fusion-channel mask and the per-sample padding
mask, a final norm, attentive pooling into one return token per
modality, per combination and a global one, and the CLIP losses between
modalities, fusion and the fusion channels.  fp32 throughout, einsum
products, no kernels and no batching tricks.

It imports nothing of the measured program.  Parameters are a flat
``{name: tensor}`` dict (the torch reference's names, which the program
loads with ``strict=True``); :func:`param_specs` lists them with their
shapes and initialisers, so that the benchmark can make one set of
weights for both sides.

Departures from a literal dense reading, each the program's stated
semantics: a query row whose every key is blocked (the tokens of a
missing modality) gets a zero attention output in the blocks, while the
attentive pool softmaxes such a row over all keys uniformly.

``precision="fp8"`` is the control: every product's inputs are rounded
to float8 e4m3 with a per-tensor scale, forward and backward
(:class:`_RoundedEinsum`); everything else stays fp32.  ``"bf16"``
rounds them to bfloat16 the same way: a witness of how far the
program's own rounding alone carries a trajectory.
"""

from __future__ import annotations

import math
from itertools import chain, combinations
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

LN_EPS = 1e-6
LOGIT_MIN = math.log(1.0)
LOGIT_MAX = math.log(100.0)
LOGIT_INIT = math.log(1.0 / 0.07)
FUSION = -1
GLOBAL = -2
E4M3_MAX = 448.0


# ---------------------------------------------------------------- layout


class Layout:
    """Token layout, masks and return tokens of one configuration."""

    def __init__(self, cfg: dict):
        if cfg.get("zorro") or cfg.get("no_fusion") or cfg.get("mean_pool") or cfg.get("eao"):
            raise ValueError("the reference covers the MCA family with FCL pooling")
        if not cfg["fcl"]:
            raise ValueError("the reference covers fcl: true")
        self.modalities = list(cfg["encoder_configs"])
        self.token_dims = [int(cfg["encoder_configs"][m]["max_tokens"]) for m in self.modalities]
        n = len(self.modalities)
        self.combos: List[Tuple[int, ...]] = list(chain.from_iterable(
            combinations(range(n), r) for r in cfg["fusion_combos"]))
        self.n_fusion = int(cfg["num_fusion_tokens"])
        if self.n_fusion % len(self.combos):
            raise ValueError("num_fusion_tokens must divide by the number of combinations")
        per = self.n_fusion // len(self.combos)
        types = np.concatenate([np.full(t, i) for i, t in enumerate(self.token_dims)]
                               + [np.full(self.n_fusion, FUSION)])
        self.token_types = types
        self.seq_len = len(types)
        fusion_pos = np.nonzero(types == FUSION)[0]
        # a modality token sees its own modality; fusion channel c sees
        # the modalities of combo c and its own fusion tokens
        allowed = types[:, None] == types[None, :]
        allowed[types == FUSION] = False
        for c, combo in enumerate(self.combos):
            own = fusion_pos[c * per:(c + 1) * per]
            row = np.isin(types, combo)
            row[own] = True
            allowed[own] = row[None, :]
        self.attn_blocked = ~allowed
        ret = list(range(n)) + [FUSION] * len(self.combos) + [GLOBAL]
        self.return_types = np.asarray(ret)
        pool_allowed = (self.return_types[:, None] == types[None, :]) | (
            self.return_types[:, None] == GLOBAL)
        for c in range(len(self.combos)):
            r = n + c
            pool_allowed[r] = False
            pool_allowed[r, fusion_pos[c * per:(c + 1) * per]] = True
        self.pool_blocked = ~pool_allowed

    def combo_key(self, c: int) -> str:
        return "combo:" + ",".join(str(i) for i in sorted(self.combos[c]))

    def combo_name(self, c: int) -> str:
        return "_".join(sorted(self.modalities[i] for i in self.combos[c]))

    def output_keys(self) -> List[str]:
        keys = set(self.modalities) | {self.combo_key(c) for c in range(len(self.combos))}
        return sorted(keys | {"fusion"})


def ff_inner(cfg: dict) -> int:
    return int(int(cfg["hidden_size"]) * float(cfg["ff_mult"]) * 2 / 3)


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, init)`` of every parameter; ``init`` is ``normal``,
    ``ones``, ``zeros``, ``logit`` or ``uniform`` (bound ``1/sqrt(fan_in)``,
    fan-in the last axis)."""
    d = int(cfg["hidden_size"])
    hd = int(cfg["heads"]) * int(cfg["dim_head"])
    inner = ff_inner(cfg)
    lay = Layout(cfg)
    specs: List[Tuple[str, Tuple[int, ...], str]] = [
        ("fusion_tokens", (lay.n_fusion, d), "normal"),
        ("return_tokens", (len(lay.return_types), d), "normal"),
    ]
    for m, e in cfg["encoder_configs"].items():
        p = f"encoders.{m}."
        if e["type"] == "TabularEncoder":
            specs += [
                (p + "token_encoder.embedding.weight", (int(e["num_embeddings"]), d), "normal"),
                (p + "value_encoder.linear1.weight", (d, 1), "uniform"),
                (p + "value_encoder.linear1.bias", (d,), "zeros"),
                (p + "value_encoder.linear2.weight", (d, d), "uniform"),
                (p + "value_encoder.linear2.bias", (d,), "zeros"),
                (p + "value_encoder.norm.weight", (d,), "ones"),
                (p + "value_encoder.norm.bias", (d,), "zeros"),
            ]
        elif e["type"] == "EmbeddedSequenceEncoder":
            w = int(e["input_size"])
            specs += [
                (p + "token_encoder.0.weight", (w,), "ones"),
                (p + "token_encoder.0.bias", (w,), "zeros"),
                (p + "token_encoder.1.weight", (d, w), "uniform"),
                (p + "token_encoder.1.bias", (d,), "zeros"),
                (p + "token_encoder.2.weight", (d,), "ones"),
                (p + "token_encoder.2.bias", (d,), "zeros"),
            ]
        else:
            raise ValueError(f"the reference has no encoder {e['type']!r}")
    for i in range(int(cfg["layers"])):
        p = f"layers.{i}."
        specs += [
            (p + "attn.to_q.weight", (hd, d), "uniform"),
            (p + "attn.to_kv.weight", (2 * hd, d), "uniform"),
            (p + "attn.to_out.weight", (d, hd), "uniform"),
            (p + "ff.feedforward.0.weight", (2 * inner, d), "uniform"),
            (p + "ff.feedforward.2.weight", (d, inner), "uniform"),
            (p + "norm.gamma", (d,), "ones"),
        ]
    specs += [
        ("norm.gamma", (d,), "ones"),
        ("attn_pool.to_q.weight", (hd, d), "uniform"),
        ("attn_pool.to_kv.weight", (2 * hd, d), "uniform"),
        ("attn_pool.to_out.weight", (d, hd), "uniform"),
        ("loss.loss_fn.logit_scale", (), "logit"),
    ]
    return specs


# ---------------------------------------------------------------- products


def _fq(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in fp32."""
    amax = x.detach().abs().amax().clamp(min=1e-12)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def _bf(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, back in fp32."""
    return x.bfloat16().float()


ROUNDING = {"fp8": _fq, "bf16": _bf}


class _RoundedEinsum(torch.autograd.Function):
    """An einsum whose inputs, and whose incoming gradient in the
    backward, are rounded by ``rnd``: the products of a lower precision."""

    @staticmethod
    def forward(ctx, spec, rnd, a, b):
        qa, qb = rnd(a), rnd(b)
        ctx.spec, ctx.rnd = spec, rnd
        ctx.save_for_backward(qa, qb)
        return torch.einsum(spec, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a = qa.detach().requires_grad_()
            b = qb.detach().requires_grad_()
            out = torch.einsum(ctx.spec, a, b)
            ga, gb = torch.autograd.grad(out, (a, b), ctx.rnd(g))
        return None, None, ga, gb


class Ops:
    """The products of one precision: ``fp32``, ``fp8`` (the control) or
    ``bf16`` (rounding as the program's)."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", *ROUNDING):
            raise ValueError(f"precision {precision!r}")
        self.rnd = ROUNDING.get(precision)

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.rnd is not None:
            return _RoundedEinsum.apply(spec, self.rnd, a, b)
        return torch.einsum(spec, a, b)

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.einsum("...i,oi->...o", x, w)


def layer_norm(x, weight, bias=None):
    return F.layer_norm(x, (x.shape[-1],), weight, bias, LN_EPS)


def sinusoid(n: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float64, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros(n, d, dtype=torch.float64, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.float()


# ---------------------------------------------------------------- model


class Reference:
    """Forward pass and loss of one configuration over a parameter dict."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        self.cfg = cfg
        self.layout = Layout(cfg)
        self.ops = Ops(precision)
        self.heads = int(cfg["heads"])
        self.dim_head = int(cfg["dim_head"])
        self.depth = int(cfg["layers"])

    def encode(self, P: Dict[str, torch.Tensor], batch: Dict[str, Dict[str, torch.Tensor]]):
        """Tokens ``[B, T, D]`` and padding ``[B, T]`` (True = padded)
        of the packed sequence, and each modality's presence ``[B]``."""
        ops = self.ops
        tokens, pads, present = [], [], {}
        for m, e in self.cfg["encoder_configs"].items():
            p = f"encoders.{m}."
            cols = batch[m]
            pad = cols["padded"]
            if e["type"] == "TabularEncoder":
                n_emb = int(e["num_embeddings"])
                emb = P[p + "token_encoder.embedding.weight"]
                # rows longer than 1 are scaled to norm 1 (max_norm), and
                # the padding index (-1, the last row) looks up zeros
                emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1.0)
                emb = emb * (torch.arange(n_emb, device=emb.device) != n_emb - 1)[:, None]
                v = cols["values"][..., None]
                is_pad_value = v == -1.0
                v = v.clamp(max=float(e.get("max_value", 10000.0)))
                h = torch.relu(ops.linear(v, P[p + "value_encoder.linear1.weight"])
                               + P[p + "value_encoder.linear1.bias"])
                h = ops.linear(h, P[p + "value_encoder.linear2.weight"]) + P[p + "value_encoder.linear2.bias"]
                h = layer_norm(h, P[p + "value_encoder.norm.weight"], P[p + "value_encoder.norm.bias"])
                h = h.masked_fill(is_pad_value, 0.0)
                x = emb[None] + h
            else:
                x = cols["tokens"].masked_fill(pad[..., None], 0.0)
                x = layer_norm(x, P[p + "token_encoder.0.weight"], P[p + "token_encoder.0.bias"])
                x = ops.linear(x, P[p + "token_encoder.1.weight"]) + P[p + "token_encoder.1.bias"]
                x = layer_norm(x, P[p + "token_encoder.2.weight"], P[p + "token_encoder.2.bias"])
                x = x.masked_fill(pad[..., None], 0.0)
                x = x + sinusoid(x.shape[1], x.shape[2], x.device)[None]
            tokens.append(x)
            pads.append(pad)
            present[m] = (~pad).any(dim=1)
        b = tokens[0].shape[0]
        tokens.append(P["fusion_tokens"][None].expand(b, -1, -1))
        pads.append(torch.zeros(b, self.layout.n_fusion, dtype=torch.bool, device=tokens[0].device))
        return torch.cat(tokens, 1), torch.cat(pads, 1), present

    def attention(self, x, ctx, wq, wkv, wo, blocked, empty_rows_zero: bool):
        """Multi-head attention of ``x`` over ``ctx``; ``blocked``
        ``[B, Tq, Tk]`` (True = blocked)."""
        ops = self.ops
        b, tq, _ = x.shape
        h, dh = self.heads, self.dim_head
        q = ops.linear(x, wq).view(b, tq, h, dh)
        k, v = ops.linear(ctx, wkv).chunk(2, dim=-1)
        k = k.reshape(b, -1, h, dh)
        v = v.reshape(b, -1, h, dh)
        s = ops.einsum("bqhd,bkhd->bhqk", q * dh ** -0.5, k)
        s = s.masked_fill(blocked[:, None], torch.finfo(torch.float32).min)
        p = torch.softmax(s, dim=-1)
        if empty_rows_zero:
            p = p * (~blocked).any(-1)[:, None, :, None]
        o = ops.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, tq, h * dh)
        return ops.linear(o, wo)

    def pooled(self, P: Dict[str, torch.Tensor], batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Pooled return tokens ``[B, R, D]`` and modality presence."""
        lay = self.layout
        x, pad, present = self.encode(P, batch)
        dev = x.device
        blocked = torch.as_tensor(lay.attn_blocked, device=dev)[None] | pad[:, None, :]
        for i in range(self.depth):
            p = f"layers.{i}."
            g = P[p + "norm.gamma"]
            x = layer_norm(x, g)
            x = self.attention(x, x, P[p + "attn.to_q.weight"], P[p + "attn.to_kv.weight"],
                               P[p + "attn.to_out.weight"], blocked, True) + x
            x = layer_norm(x, g)
            hgate = self.ops.linear(x, P[p + "ff.feedforward.0.weight"])
            hh, gate = hgate.chunk(2, dim=-1)
            x = self.ops.linear(F.gelu(gate) * hh, P[p + "ff.feedforward.2.weight"]) + x
        x = layer_norm(x, P["norm.gamma"])
        b = x.shape[0]
        ret = P["return_tokens"][None].expand(b, -1, -1)
        pblocked = torch.as_tensor(lay.pool_blocked, device=dev)[None] | pad[:, None, :]
        out = self.attention(ret, x, P["attn_pool.to_q.weight"], P["attn_pool.to_kv.weight"],
                             P["attn_pool.to_out.weight"], pblocked, False) + ret
        return out, present

    def embeddings(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        lay = self.layout
        n = len(lay.modalities)
        out = {m: pooled[:, i] for i, m in enumerate(lay.modalities)}
        for c in range(len(lay.combos)):
            out[lay.combo_key(c)] = pooled[:, n + c]
        out["fusion"] = out[lay.combo_key(0)]
        return out

    def losses(self, pooled, present, logit_scale) -> Dict[str, torch.Tensor]:
        """Every CLIP loss of the configuration, by name; NaN where no
        row is live."""
        cfg, lay = self.cfg, self.layout
        emb = self.embeddings(pooled)
        temp = torch.exp(logit_scale.clamp(LOGIT_MIN, LOGIT_MAX))

        def clip(a, b, rows):
            la = torch.log_softmax((a @ b.T) * temp, dim=-1).diagonal()
            lb = torch.log_softmax((b @ a.T) * temp, dim=-1).diagonal()
            w = rows.float()
            cnt = w.sum()
            ce_a = -(la * w).sum() / cnt.clamp(min=1.0)
            ce_b = -(lb * w).sum() / cnt.clamp(min=1.0)
            loss = (ce_a + ce_b) / 2
            return torch.where(cnt > 0, loss, torch.full_like(loss, float("nan")))

        def live(a):
            return torch.ones_like(present[lay.modalities[0]]) if a == "fusion" else present[a]

        names = list(lay.modalities)
        if cfg["bimodal_contrastive"]:
            pairs = list(combinations(names + ["fusion"], 2))
        else:
            pairs = [(m, "fusion") for m in names]
        out = {}
        for a, b in pairs:
            out["_".join(sorted((a, b)))] = clip(emb[a], emb[b], live(a) & live(b))
        for c in range(1, len(lay.combos)):
            any_present = torch.stack([present[names[i]] for i in lay.combos[c]]).any(0)
            key = lay.combo_key(c)
            out[f"fcl_fusion|{lay.combo_name(c)}"] = clip(emb["fusion"], emb[key], any_present)
            if cfg["non_fusion_fcl"]:
                for m in names:
                    out[f"fcl_{m}|{lay.combo_name(c)}"] = clip(emb[m], emb[key], present[m] & any_present)
        return out

    @staticmethod
    def total(losses: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean of the finite losses (0 where none is)."""
        v = torch.stack(list(losses.values()))
        fin = torch.isfinite(v)
        return torch.where(fin, v, torch.zeros_like(v)).sum() / fin.sum().clamp(min=1)
