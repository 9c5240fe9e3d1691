"""The reference's collate, blocked gradient, clip, AdamW and schedule.

The loss couples every row of the batch (each row is the others'
negatives), so a batch that does not fit is taken in three passes: the
pooled tokens of every block of rows without gradients, the loss and
its gradient with respect to those pooled tokens, then each block again
with gradients, backpropagating its share of that gradient.  The sum
over the blocks is the batch's gradient.

AdamW is written out (betas 0.9 / 0.999, eps 1e-8, decoupled weight
decay 0.01 on every parameter), after the global-norm clip (scale by
``clip / norm`` only where the norm exceeds ``clip``); the learning rate
follows the configuration's warm-up and cosine decay; the temperature is
clamped after each update.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench.reference.model import LOGIT_MAX, LOGIT_MIN, Reference


def collate(cfg: dict, rows: Sequence[dict], device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Rows as padded tensors on ``device``: a ``sequence`` modality's
    values padded to ``pad_len`` with ``pad_token`` (an entry equal to it
    is padding); an ``embedded_sequence`` modality's ``[t, width]`` rows
    padded with zeros to ``pad_len`` (positions past ``t`` are padding,
    a missing row has ``t = 0``)."""
    out = {}
    for m, mc in cfg["modality_config"].items():
        col = mc["data_col_name"]
        n = int(mc["pad_len"])
        if mc["type"] == "sequence":
            pad = float(mc["pad_token"])
            vals = np.full((len(rows), n), pad, np.float32)
            for i, r in enumerate(rows):
                v = np.asarray(r[m][col], np.float32)[:n]
                vals[i, :len(v)] = v
            t = torch.from_numpy(vals).to(device)
            out[m] = {"values": t, "padded": t == pad}
        elif mc["type"] == "embedded_sequence":
            w = int(mc["embedding_size"])
            toks = np.zeros((len(rows), n, w), np.float32)
            lens = np.zeros(len(rows), np.int64)
            for i, r in enumerate(rows):
                v = r[m][col]
                if v is not None:
                    v = np.asarray(v, np.float32)[:n]
                    toks[i, :len(v)] = v
                    lens[i] = len(v)
            pos = torch.arange(n, device=device)[None]
            out[m] = {"tokens": torch.from_numpy(toks).to(device),
                      "padded": pos >= torch.from_numpy(lens).to(device)[:, None]}
        else:
            raise ValueError(f"the reference has no collate for {mc['type']!r}")
    return out


def pooled_all(ref: Reference, P, rows, block: int, device):
    """Pooled tokens ``[B, R, D]`` and presence of every row, in blocks,
    without gradients."""
    pooled, present = [], []
    with torch.no_grad():
        for i in range(0, len(rows), block):
            p, pr = ref.pooled(P, collate(ref.cfg, rows[i:i + block], device))
            pooled.append(p)
            present.append(pr)
    return torch.cat(pooled), {m: torch.cat([p[m] for p in present]) for m in present[0]}


def gradients(ref: Reference, P: Dict[str, torch.Tensor], rows, block: int, device):
    """``(total loss, every loss, {name: gradient})`` of one batch."""
    pooled, present = pooled_all(ref, P, rows, block, device)
    pooled.requires_grad_(True)
    scale = P["loss.loss_fn.logit_scale"].detach().clone().requires_grad_(True)
    losses = ref.losses(pooled, present, scale)
    total = ref.total(losses)
    d_pooled, d_scale = torch.autograd.grad(total, (pooled, scale), allow_unused=True)
    leaves = {k: v.detach().requires_grad_(True) for k, v in P.items()}
    grads = {k: torch.zeros_like(v) for k, v in P.items()}
    for i in range(0, len(rows), block):
        p, _ = ref.pooled(leaves, collate(ref.cfg, rows[i:i + block], device))
        names = [k for k in leaves if k != "loss.loss_fn.logit_scale"]
        gs = torch.autograd.grad(p, [leaves[k] for k in names], d_pooled[i:i + block],
                                 allow_unused=True)
        for k, g in zip(names, gs):
            if g is not None:
                grads[k] += g
    if d_scale is not None:
        grads["loss.loss_fn.logit_scale"] += d_scale
    return total.detach(), {k: v.detach() for k, v in losses.items()}, grads


def lr_at(cfg: dict, step: int, horizon: int) -> float:
    """Learning rate of step ``step`` (0-based): linear warm-up over
    ``num_warmup_steps``, then cosine decay to 0 at ``horizon``."""
    lr = float(cfg["lr"])
    warm = int(cfg["num_warmup_steps"])
    if cfg["lr_scheduler_type"] != "cosine":
        raise ValueError("the reference follows the cosine schedule")
    if step < warm:
        return lr * step / max(warm, 1)
    prog = min(max((step - warm) / max(horizon - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * prog))


class AdamW:
    """AdamW over a parameter dict, updated in place."""

    def __init__(self, params: Dict[str, torch.Tensor], b1=0.9, b2=0.999, eps=1e-8, wd=0.01):
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, params, grads, lr: float) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            upd = (self.m[k] / c1) / ((self.v[k] / c2).sqrt() + self.eps)
            p.sub_(lr * (upd + self.wd * p))


def train_steps(cfg: dict, params: Dict[str, torch.Tensor], batches: List[Sequence[dict]],
                horizon: int, block: int, device, precision: str = "fp32",
                keep: Optional[list] = None) -> dict:
    """Follow ``len(batches)`` training steps from ``params`` (copied):
    each step's total loss, the first step's clipped gradient by leaf,
    and each leaf's change over all the steps.  ``keep``, a list, gets a
    copy of the parameters on the host after each step."""
    ref = Reference(cfg, precision)
    P = {k: v.detach().to(device, torch.float32).clone() for k, v in params.items()}
    start = {k: v.clone() for k, v in P.items()}
    opt = AdamW(P)
    clip = float(cfg["clip"] or 0.0)
    losses, first_grad = [], None
    for step, rows in enumerate(batches):
        total, _, g = gradients(ref, P, rows, block, device)
        losses.append(float(total))
        norm = torch.stack([x.square().sum() for x in g.values()]).sum().sqrt()
        if clip and float(norm) > clip:
            for x in g.values():
                x.mul_(clip / norm)
        if step == 0:
            first_grad = {k: float(x.norm()) for k, x in g.items()}
        opt.step(P, g, lr_at(cfg, step, horizon))
        P["loss.loss_fn.logit_scale"].clamp_(LOGIT_MIN, LOGIT_MAX)
        if keep is not None:
            keep.append({k: v.detach().cpu().clone() for k, v in P.items()})
    change = {k: float((P[k] - start[k]).norm()) for k in P}
    return {"losses": losses, "grad": first_grad, "change": change}
