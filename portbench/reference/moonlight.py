"""A plain PyTorch reference of Moonlight-16B-A3B's decoder block as the
MCA fusion stack, its loss and its training steps.

Written from the published equations: latent attention (DeepSeek-V2,
arXiv 2405.04434, section 2.1) and the sigmoid router with its
correction bias, sequence-wise balance loss and bias update
(DeepSeek-V3, arXiv 2412.19437, section 2.1.2), at the widths of
https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json.
Each block, on the fp32 stream ``x`` of the packed MCA sequence:

- ``h = RMSNorm(x)``; ``q = h W_q`` per head, ``[q_nope, q_pe]``;
  ``[c_kv, k_pe] = h W_kv_a``, ``c_kv = RMSNorm(c_kv)``; ``[k_nope, v] =
  c_kv W_kv_b`` per head; ``q_pe`` and the one ``k_pe`` all heads share
  rotated by RoPE (each pair split into even and odd dims, the halves
  rotated by ``theta^(-2i/d)`` times the slot's index in the packed
  sequence); ``x += softmax([q_nope, q_pe] [k_nope, k_pe]^T / sqrt(d_qk)
  + mask) v W_o`` with the MCA fusion-channel mask and the key padding;
- ``h = RMSNorm(x)``; the first ``first_k_dense_replace`` layers add
  ``SwiGLU(h)``, the rest the routed and shared experts: ``s =
  sigmoid(h W_r)`` over all experts in fp32, the top ``k`` of ``s + b``,
  weights ``s_chosen / sum s_chosen * routed_scaling_factor``, the held
  experts' ``w_e SwiGLU_e(h)`` summed (a loop over them) plus the shared
  experts' SwiGLU;
- then the final RMSNorm, the MCA attentive pool and CLIP losses of
  :mod:`portbench.reference.model`.

Departures from the language model, each this benchmark's: padded slots
take no routed expert and count in no load or balance statistic (a
language model has no padded slots); there is no vocabulary, LM head or
multi-token prediction (MCA's encoders and its contrastive objective
take their place); the optimizer is AdamW, as MCA trains, not Muon.

Training follows :mod:`portbench.reference.train`'s blocked gradient,
with the balance loss (``alpha`` a sequence, the mean over the batch's
sequences, summed over the routed layers) added to the loss, and after
each AdamW step the bias update ``b_i += gamma sign(mean load - load_i)``
over the batch's loads of all the experts.  Dense masked softmax,
einsums, fp32 throughout (``precision`` rounds the products as
:class:`portbench.reference.model.Ops` does: the router stays fp32).
It imports nothing of the measured program.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from portbench.reference import model as base
from portbench.reference.train import AdamW, collate, lr_at

BIAS = "ff.gate.e_score_correction_bias"


def held_experts(cfg: dict) -> Tuple[int, int]:
    """``[lo, hi)``: the routed experts the first of ``ep_size``
    expert-parallel shares holds."""
    return 0, int(cfg["n_routed_experts"]) // int(cfg["ep_size"])


def is_moe(cfg: dict, i: int) -> bool:
    return i >= int(cfg["first_k_dense_replace"])


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """``(name, shape, init)`` of every leaf, the correction biases
    (``zeros``, updated by the rule, not by the optimizer) among them;
    the encoders, tokens, pool and temperature as
    :func:`portbench.reference.model.param_specs` has them."""
    d, h = int(cfg["hidden_size"]), int(cfg["heads"])
    nope, rope = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
    dv, rank = int(cfg["v_head_dim"]), int(cfg["kv_lora_rank"])
    outer = base.param_specs(dict(cfg, layers=0, ff_mult=cfg.get("ff_mult", 4)))
    specs = [s for s in outer if s[0] != "norm.gamma"]
    lo, hi = held_experts(cfg)
    for i in range(int(cfg["layers"])):
        p = f"layers.{i}."
        specs += [
            (p + "attn_norm.weight", (d,), "ones"),
            (p + "attn.q_proj.weight", (h * (nope + rope), d), "uniform"),
            (p + "attn.kv_a_proj_with_mqa.weight", (rank + rope, d), "uniform"),
            (p + "attn.kv_a_layernorm.weight", (rank,), "ones"),
            (p + "attn.kv_b_proj.weight", (h * (nope + dv), rank), "uniform"),
            (p + "attn.o_proj.weight", (d, h * dv), "uniform"),
            (p + "ff_norm.weight", (d,), "ones"),
        ]
        if not is_moe(cfg, i):
            inner = int(cfg["intermediate_size"])
            specs += [(p + "ff.w1.weight", (2 * inner, d), "uniform"),
                      (p + "ff.w2.weight", (d, inner), "uniform")]
            continue
        inner, e = int(cfg["moe_intermediate_size"]), int(cfg["n_routed_experts"])
        shared = inner * int(cfg["n_shared_experts"])
        specs += [
            (p + "ff.gate.weight", (e, d), "uniform"),
            (p + BIAS, (e,), "zeros"),
            (p + "ff.w1", (hi - lo, 2 * inner, d), "uniform"),
            (p + "ff.w2", (hi - lo, d, inner), "uniform"),
            (p + "ff.shared.w1.weight", (2 * shared, d), "uniform"),
            (p + "ff.shared.w2.weight", (d, shared), "uniform"),
        ]
    specs.append(("norm.weight", (d,), "ones"))
    return specs


def is_state(name: str) -> bool:
    """A leaf the optimizer does not step (the correction biases)."""
    return name.endswith(BIAS)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x`` ``[B, T, ..., d]`` rotated by its position along T: the pairs
    split into their even and odd dims, then each half rotated against
    the other."""
    d, t = x.shape[-1], x.shape[1]
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64, device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    shape = (1, t) + (1,) * (x.dim() - 3) + (d // 2,)
    cos, sin = ang.cos().float().view(shape), ang.sin().float().view(shape)
    a, b = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


class MoonlightReference(base.Reference):
    """Forward, losses and routing of one configuration over a leaf dict."""

    def __init__(self, cfg: dict, precision: str = "fp32"):
        super().__init__(cfg, precision)
        self.eps = float(cfg["rms_norm_eps"])
        self.held = held_experts(cfg)

    def swiglu(self, x, w1, w2):
        gate, up = self.ops.linear(x, w1).chunk(2, dim=-1)
        return self.ops.linear(F.silu(gate) * up, w2)

    def mla(self, P, p, x, blocked):
        cfg, ops = self.cfg, self.ops
        b, t, _ = x.shape
        h = int(cfg["heads"])
        nope, rp = int(cfg["qk_nope_head_dim"]), int(cfg["qk_rope_head_dim"])
        dv, rank = int(cfg["v_head_dim"]), int(cfg["kv_lora_rank"])
        theta = float(cfg["rope_theta"])
        q = ops.linear(x, P[p + "attn.q_proj.weight"]).view(b, t, h, nope + rp)
        a = ops.linear(x, P[p + "attn.kv_a_proj_with_mqa.weight"])
        c_kv = rms_norm(a[..., :rank], P[p + "attn.kv_a_layernorm.weight"], self.eps)
        k_pe = rope(a[..., rank:], theta)  # [B, T, rope], shared by the heads
        kv = ops.linear(c_kv, P[p + "attn.kv_b_proj.weight"]).view(b, t, h, nope + dv)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
        k = torch.cat([kv[..., :nope], k_pe[:, :, None].expand(b, t, h, rp)], dim=-1)
        v = kv[..., nope:]
        s = ops.einsum("bqhd,bkhd->bhqk", q * (nope + rp) ** -0.5, k)
        s = s.masked_fill(blocked[:, None], torch.finfo(torch.float32).min)
        attn = torch.softmax(s, dim=-1) * (~blocked).any(-1)[:, None, :, None]
        o = ops.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, t, h * dv)
        return ops.linear(o, P[p + "attn.o_proj.weight"])

    def moe(self, P, p, x, valid):
        """``(output, balance loss of each row [B], load [E], chosen [N, k])``."""
        cfg = self.cfg
        b, t, d = x.shape
        k, e = int(cfg["num_experts_per_tok"]), int(cfg["n_routed_experts"])
        xs = x.reshape(b * t, d)
        vs = valid.reshape(-1)
        s = torch.sigmoid(torch.einsum("nd,ed->ne", xs, P[p + "ff.gate.weight"]))
        chosen = torch.topk(s + P[p + BIAS], k, dim=-1).indices
        w = s.gather(1, chosen)
        if cfg["norm_topk_prob"]:
            w = w / w.sum(-1, keepdim=True)
        w = w * float(cfg["routed_scaling_factor"])
        out = torch.zeros_like(xs)
        lo, hi = self.held
        for j, ex in enumerate(range(lo, hi)):
            hit = (chosen == ex) & vs[:, None]
            rows = hit.any(-1)
            if rows.any():
                y = self.swiglu(xs[rows], P[p + "ff.w1"][j], P[p + "ff.w2"][j])
                out = out.index_add(0, rows.nonzero()[:, 0], (w * hit).sum(-1)[rows, None] * y)
        out = out + self.swiglu(xs, P[p + "ff.shared.w1.weight"], P[p + "ff.shared.w2.weight"])
        # the sequence-wise balance loss of each row, over its real slots
        one = F.one_hot(chosen, e).sum(1).float() * vs[:, None]  # [N, E]
        vf = vs.float().view(b, t, 1)
        n = vf.sum(1)  # [B, 1]
        f = one.view(b, t, e).sum(1) * (e / k) / n
        share = (s / s.sum(-1, keepdim=True)).view(b, t, e)
        pr = (share * vf).sum(1) / n
        bal = float(cfg.get("aux_loss_alpha", 0.0)) * (f.detach() * pr).sum(-1)
        return out.view(b, t, d), bal, one.sum(0).detach(), chosen

    def forward(self, P, batch, keep_chosen: bool = False):
        """``(pooled [B, R, D], presence, balance loss of each row [B],
        loads [routed layers, E], chosen experts by layer)``."""
        lay = self.layout
        x, pad, present = self.encode(P, batch)
        dev = x.device
        blocked = torch.as_tensor(lay.attn_blocked, device=dev)[None] | pad[:, None, :]
        bal = torch.zeros(x.shape[0], device=dev)
        loads, chosen = [], []
        for i in range(self.depth):
            p = f"layers.{i}."
            x = x + self.mla(P, p, rms_norm(x, P[p + "attn_norm.weight"], self.eps), blocked)
            hn = rms_norm(x, P[p + "ff_norm.weight"], self.eps)
            if is_moe(self.cfg, i):
                y, bl, load, ch = self.moe(P, p, hn, ~pad)
                bal = bal + bl
                loads.append(load)
                if keep_chosen:
                    chosen.append(ch)
            else:
                y = self.swiglu(hn, P[p + "ff.w1.weight"], P[p + "ff.w2.weight"])
            x = x + y
        x = rms_norm(x, P["norm.weight"], self.eps)
        b = x.shape[0]
        ret = P["return_tokens"][None].expand(b, -1, -1)
        pblocked = torch.as_tensor(lay.pool_blocked, device=dev)[None] | pad[:, None, :]
        pooled = self.attention(ret, x, P["attn_pool.to_q.weight"], P["attn_pool.to_kv.weight"],
                                P["attn_pool.to_out.weight"], pblocked, False) + ret
        return pooled, present, bal, torch.stack(loads) if loads else None, chosen

    def pooled(self, P, batch):
        return self.forward(P, batch)[:2]


def gradients(ref: MoonlightReference, P: Dict[str, torch.Tensor], rows, block: int, device,
              keep_chosen: bool = False):
    """``(total loss, {name: gradient}, loads [routed layers, E], chosen
    experts by layer)`` of one batch, in blocks of rows: pooled tokens,
    balance losses and loads without gradients, the loss and its
    gradient with respect to the pooled tokens, then each block again
    with its share of that gradient and ``1 / B`` of its balance loss."""
    pooled, present, bal, loads, chosen = [], [], [], None, []
    with torch.no_grad():
        for i in range(0, len(rows), block):
            p, pr, bl, ld, ch = ref.forward(P, collate(ref.cfg, rows[i:i + block], device),
                                            keep_chosen)
            pooled.append(p)
            present.append(pr)
            bal.append(bl)
            loads = ld if loads is None else loads + ld
            chosen.append(ch)
    pooled = torch.cat(pooled).requires_grad_(True)
    present = {m: torch.cat([p[m] for p in present]) for m in present[0]}
    n = len(rows)
    scale = P["loss.loss_fn.logit_scale"].detach().clone().requires_grad_(True)
    total = ref.total(ref.losses(pooled, present, scale)) + torch.cat(bal).sum() / n
    d_pooled, d_scale = torch.autograd.grad(total, (pooled, scale), allow_unused=True)
    names = [k for k in P if k != "loss.loss_fn.logit_scale" and not is_state(k)]
    leaves = {k: v.detach().requires_grad_(k in names) for k, v in P.items()}
    grads = {k: torch.zeros_like(P[k]) for k in names + ["loss.loss_fn.logit_scale"]}
    for i in range(0, len(rows), block):
        p, _, bl, _, _ = ref.forward(leaves, collate(ref.cfg, rows[i:i + block], device))
        out = torch.autograd.grad([p, bl.sum()], [leaves[k] for k in names],
                                  [d_pooled[i:i + block], torch.tensor(1.0 / n, device=device)],
                                  allow_unused=True)
        for k, g in zip(names, out):
            if g is not None:
                grads[k] += g
    if d_scale is not None:
        grads["loss.loss_fn.logit_scale"] += d_scale
    chosen = [torch.cat([c[j] for c in chosen]) for j in range(len(chosen[0]))] if keep_chosen else []
    return total.detach(), {k: v.detach() for k, v in grads.items()}, loads, chosen


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], batches: List[Sequence[dict]],
                horizon: int, block: int, device, precision: str = "fp32",
                keep: Optional[list] = None) -> dict:
    """Follow ``len(batches)`` training steps from ``params`` (copied), as
    :func:`portbench.reference.train.train_steps` does, with the balance
    loss in the loss and the bias update after each step; also returns
    ``chosen``, the first step's experts of every token by routed layer,
    and ``bias``, the correction biases after the last step."""
    ref = MoonlightReference(cfg, precision)
    P = {k: v.detach().to(device, torch.float32).clone() for k, v in params.items()}
    start = {k: v.clone() for k, v in P.items()}
    trained = [k for k in P if not is_state(k)]
    opt = AdamW({k: P[k] for k in trained})
    clip = float(cfg["clip"] or 0.0)
    gamma = float(cfg.get("bias_update_speed", 0.0))
    biases = [f"layers.{i}.{BIAS}" for i in range(int(cfg["layers"])) if is_moe(cfg, i)]
    losses, first_grad, first_chosen = [], None, []
    for step, rows in enumerate(batches):
        total, g, loads, chosen = gradients(ref, P, rows, block, device, keep_chosen=step == 0)
        losses.append(float(total))
        norm = torch.stack([x.square().sum() for x in g.values()]).sum().sqrt()
        if clip and float(norm) > clip:
            for x in g.values():
                x.mul_(clip / norm)
        if step == 0:
            first_grad = {k: float(x.norm()) for k, x in g.items()}
            first_chosen = chosen
        opt.step({k: P[k] for k in trained}, g, lr_at(cfg, step, horizon))
        P["loss.loss_fn.logit_scale"].clamp_(base.LOGIT_MIN, base.LOGIT_MAX)
        for name, load in zip(biases, loads if loads is not None else []):
            P[name] += gamma * torch.sign(load.mean() - load)
        if keep is not None:
            keep.append({k: v.detach().cpu().clone() for k, v in P.items()})
    change = {k: float((P[k] - start[k]).norm()) for k in trained}
    return {"losses": losses, "grad": first_grad, "change": change, "chosen": first_chosen,
            "bias": {k: P[k].cpu() for k in biases}}
