"""Token-choice routed experts with shared experts: DeepSeek-V3's MoE
feed-forward (arXiv 2412.19437, section 2.1.2) as Moonlight-16B-A3B
runs it, on one share of the routed experts.

- Router, in fp32: ``s = sigmoid(h W_r)`` over all ``E`` routed experts;
  each token takes the top ``k`` of ``s + b``, where ``b`` is the
  correction bias (a buffer, ``e_score_correction_bias``); its weights
  are the chosen ``s`` over their sum, times ``routed_scaling_factor``.
- The layer holds the routed experts ``[lo, hi)`` (``held``): an
  expert-parallel rank's share.  It computes only their part of
  ``sum_chosen w_e SwiGLU_e(h)`` and adds the shared experts (one SwiGLU
  of ``n_shared`` times the expert width) on every token.
- Padded slots take no routed expert and count in no statistic.
- Training (grad on): the sequence-wise balance loss, ``alpha sum_i f_i
  P_i`` a sequence, ``P_i`` the mean over its tokens of ``s_i / sum_j
  s_j`` and ``f_i = E / (k n) * (tokens choosing i)``, the mean over the
  batch's sequences (:meth:`take_balance_loss`); the load of each of the
  ``E`` experts is kept for the bias update after the optimizer step,
  ``b_i += gamma sign(mean load - load_i)`` (:meth:`RoutedMoE.update_bias`).

Dispatch keeps the host off the device and drops nothing: the
token-expert assignments are sorted by held expert (the rest last) into
a buffer that holds every assignment the held experts could take
(``tokens * min(k, held)``: at random weights a seed can route more than
twice the balanced share to one share of experts), and each expert
matrix runs as ONE grouped product over the held groups a direction
(``torch._grouped_mm``, the group ends on the device), which computes
the rows of the groups alone.  :class:`_HeldExperts` keeps only the
sorted assignments for the backward and recomputes the rest there, so
the buffer's size costs memory only while one layer runs; rows past the
last group are never written by the products, so they are zeroed
before anything reads them.

Recorded (:mod:`mca_tpu_torch.utils.trace`), each with a CUDA event
pair: ``moe.route``, ``moe.dispatch``, ``moe.experts`` (the grouped
products, forward, and the shared experts) and ``moe.combine``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mca_tpu_torch.utils import trace


class SwiGLU(nn.Module):
    """``(silu(h W_gate) * h W_up) W_down``: ``w1`` is ``[2 inner, dim]``
    (the gate half first), ``w2`` ``[dim, inner]``, bias-free, computed
    in ``dtype`` on fp32 weights cast at use."""

    def __init__(self, dim: int, inner: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.w1 = nn.Linear(dim, 2 * inner, bias=False)
        self.w2 = nn.Linear(inner, dim, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate, up = F.linear(x.to(self.dtype), self.w1.weight.to(self.dtype)).chunk(2, dim=-1)
        return F.linear(F.silu(gate) * up, self.w2.weight.to(self.dtype))


class Router(nn.Module):
    """The gate: ``weight`` ``[E, dim]`` and the correction bias ``[E]``."""

    def __init__(self, dim: int, experts: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(experts, dim))
        self.register_buffer("e_score_correction_bias", torch.zeros(experts))


def _counts(key: torch.Tensor, n: int) -> torch.Tensor:
    """How many of ``key`` fall on each of ``0 .. n - 1`` (``n`` and
    above are left out), fp32, without reading anything back to the
    host (``torch.bincount`` on the card sizes its output from the data)."""
    ones = torch.ones(key.shape, dtype=torch.float32, device=key.device)
    return torch.zeros(n + 1, device=key.device).index_add_(0, key.clamp(max=n), ones)[:n]


def _grouped(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor, keep=None) -> torch.Tensor:
    """``torch._grouped_mm(a, b, offs)``, the groups' ends in ``offs``
    (int32, on the device); with ``keep``, the output's rows past the
    last group (never written) zeroed in place."""
    out = torch._grouped_mm(a, b, offs=offs)
    if keep is not None:
        out.masked_fill_(~keep[:, None], 0)
    return out


def _pieces(n: int, parts: int = 4):
    """``parts`` slices of ``range(n)``: a combine or a gradient of the
    weights takes one at a time, so that its fp32 temporary is a quarter
    of the buffer's."""
    step = -(-n // parts)
    return [slice(a, min(a + step, n)) for a in range(0, n, step)]


class _HeldExperts(torch.autograd.Function):
    """``sum over the sorted assignments r of wt[r] SwiGLU_e(r)(h[token[r]])``
    into an fp32 ``[N, dim]``, through two grouped products forward; the
    backward recomputes them from ``h`` and the assignments, which are all
    it keeps, and runs the four grouped products of the gradients.
    ``w1`` ``[held, 2 inner, dim]`` and ``w2`` ``[held, dim, inner]`` are
    the fp32 parameters, cast to ``dtype`` at use; ``offs`` the groups'
    ends and ``keep`` the rows inside them."""

    @staticmethod
    def _inner(hb, w1c, token, offs, keep):
        x = hb[token]
        hh = _grouped(x, w1c.transpose(-2, -1), offs, keep)
        gate, up = hh.chunk(2, dim=-1)
        return x, gate, up

    @staticmethod
    def forward(ctx, h, w1, w2, token, wt, offs, keep, dtype):
        dev = h.device
        w1c, w2c = w1.to(dtype), w2.to(dtype)
        hb = h.to(dtype)
        with trace.span("moe.experts") as sp:
            sp.device_start(dev)
            _, gate, up = _HeldExperts._inner(hb, w1c, token, offs, keep)
            y = _grouped(F.silu(gate) * up, w2c.transpose(-2, -1), offs, keep)
            del gate, up
            sp.device_end()
        with trace.span("moe.combine") as sp:
            sp.device_start(dev)
            out = torch.zeros(h.shape, dtype=torch.float32, device=dev)
            for r in _pieces(len(token)):
                out.index_add_(0, token[r], y[r].float().mul_(wt[r, None]))
            sp.device_end()
        ctx.save_for_backward(h, w1, w2, token, wt, offs, keep)
        ctx.dtype = dtype
        return out

    @staticmethod
    def backward(ctx, g_out):
        h, w1, w2, token, wt, offs, keep = ctx.saved_tensors
        dtype = ctx.dtype
        w1c, w2c = w1.to(dtype), w2.to(dtype)
        x, gate, up = _HeldExperts._inner(h.to(dtype), w1c, token, offs, keep)
        act = F.silu(gate) * up
        y = _grouped(act, w2c.transpose(-2, -1), offs, keep)
        g = g_out[token]  # fp32; zero where the row is outside the groups
        g.masked_fill_(~keep[:, None], 0)
        d_wt = torch.empty_like(wt)
        for r in _pieces(len(token)):
            d_wt[r] = (g[r] * y[r]).sum(-1)
        del y
        dy = g.mul_(wt[:, None]).to(dtype)
        del g
        d_act = _grouped(dy, w2c, offs, keep)
        d_w2 = torch._grouped_mm(dy.t(), act, offs=offs).float()
        del dy, act
        d_up = d_act * F.silu(gate)
        d_gate = torch.ops.aten.silu_backward(d_act * up, gate)
        del d_act, gate, up
        dh = torch.cat([d_gate, d_up], dim=-1)
        del d_gate, d_up
        d_w1 = torch._grouped_mm(dh.t(), x, offs=offs).float()
        del x
        dx = _grouped(dh, w1c, offs, keep)
        del dh
        d_h = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
        for r in _pieces(len(token)):
            d_h.index_add_(0, token[r], dx[r].float())
        return d_h, d_w1, d_w2, None, d_wt, None, None, None


class RoutedMoE(nn.Module):
    """The routed experts ``held = (lo, hi)`` of ``experts``, and the
    shared experts (module docstring)."""

    def __init__(
        self,
        dim: int,
        experts: int,
        top_k: int,
        inner: int,
        n_shared: int,
        held: Tuple[int, int],
        scaling: float,
        norm_topk_prob: bool = True,
        aux_loss_alpha: float = 0.0,
        bias_update_speed: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        lo, hi = int(held[0]), int(held[1])
        if not 0 <= lo < hi <= experts:
            raise ValueError(f"held experts [{lo}, {hi}) outside [0, {experts})")
        self.experts, self.top_k, self.lo, self.hi = experts, top_k, lo, hi
        self.scaling, self.norm_topk_prob = float(scaling), bool(norm_topk_prob)
        self.alpha, self.gamma = float(aux_loss_alpha), float(bias_update_speed)
        self.dtype = dtype
        self.gate = Router(dim, experts)
        n = hi - lo
        self.w1 = nn.Parameter(torch.empty(n, 2 * inner, dim))  # [held, 2 inner, dim]
        self.w2 = nn.Parameter(torch.empty(n, dim, inner))
        self.shared = SwiGLU(dim, inner * n_shared, dtype) if n_shared else None
        self._balance: List[torch.Tensor] = []
        self._stats: Optional[torch.Tensor] = None  # held counts [n]
        self._loads: Optional[torch.Tensor] = None

    @property
    def n_held(self) -> int:
        return self.hi - self.lo

    def route(self, h: torch.Tensor):
        """``(experts [N, k], weights [N, k], scores [N, E])`` of the fp32
        tokens ``h`` ``[N, dim]``."""
        s = torch.sigmoid(F.linear(h.float(), self.gate.weight.float()))
        _, idx = torch.topk(s + self.gate.e_score_correction_bias, self.top_k, dim=-1)
        w = s.gather(1, idx)
        if self.norm_topk_prob:
            w = w / w.sum(-1, keepdim=True)
        return idx, w * self.scaling, s

    def _balance_loss(self, s, idx, valid, batch: int) -> torch.Tensor:
        """The sequence-wise balance loss, the mean over ``batch``
        sequences of ``alpha sum_i f_i P_i`` (padded slots left out)."""
        n_tok, e = s.shape
        v = valid.view(batch, -1).float()
        n = v.sum(1).clamp(min=1.0)  # [B]
        share = (s / s.sum(-1, keepdim=True)).view(batch, -1, e)
        p = (share * v[..., None]).sum(1) / n[:, None]  # [B, E]
        with torch.no_grad():
            chosen = torch.zeros(n_tok, e, device=s.device).scatter_(1, idx, 1.0)
            f = (chosen.view(batch, -1, e) * v[..., None]).sum(1) * (e / self.top_k) / n[:, None]
        return self.alpha * (f * p).sum(1).mean()

    def forward(self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``[B, T, dim]`` fp32 (the normed stream) -> ``[B, T, dim]`` fp32."""
        b, t, d = x.shape
        dev = x.device
        h = x.reshape(b * t, d)
        valid = (torch.ones(b * t, dtype=torch.bool, device=dev) if padding_mask is None
                 else ~padding_mask.reshape(-1).bool())
        training = torch.is_grad_enabled() and self.training
        with trace.span("moe.route") as sp:
            sp.device_start(dev)
            idx, w, s = self.route(h)
            if training and self.alpha:
                self._balance.append(self._balance_loss(s, idx, valid, b))
            if training:
                with torch.no_grad():
                    load = _counts(torch.where(valid[:, None], idx, self.experts).reshape(-1),
                                   self.experts)
                    self._loads = load if self._loads is None else self._loads + load
            sp.device_end()
        out = self.routed(h, idx, w, valid, training)
        if self.shared is not None:
            with trace.span("moe.experts") as sp:
                sp.device_start(dev)
                out = out + self.shared(h).float()
                sp.device_end()
        return out.view(b, t, d)

    def routed(self, h, idx, w, valid, training: bool) -> torch.Tensor:
        """The held experts' part of the routed sum, fp32 ``[N, dim]``."""
        n_tok = h.shape[0]
        dev, k, n = h.device, self.top_k, self.n_held
        with trace.span("moe.dispatch") as sp:
            sp.device_start(dev)
            local = idx - self.lo
            held = (local >= 0) & (local < n) & valid[:, None]
            key = torch.where(held, local, n).reshape(-1)  # the rest sort last
            order = torch.sort(key, stable=True).indices[:n_tok * min(k, n)]
            counts = _counts(key, n)
            offs = torch.cumsum(counts, 0).to(torch.int32)
            keep = torch.arange(len(order), device=dev) < offs[-1]
            sp.device_end()
        out = _HeldExperts.apply(h, self.w1, self.w2, order // k, w.reshape(-1)[order], offs,
                                 keep, self.dtype)
        if training:
            with torch.no_grad():
                self._stats = counts if self._stats is None else self._stats + counts
        return out

    # -- what the training step reads -------------------------------------

    def take_balance_loss(self) -> Optional[torch.Tensor]:
        """The balance losses of the forwards since the last call, summed."""
        if not self._balance:
            return None
        out, self._balance = torch.stack(self._balance).sum(), []
        return out

    def take_stats(self) -> Optional[torch.Tensor]:
        """``[held assignments, most on one held expert]`` since the last
        call (a device tensor; None if no training forward ran)."""
        counts, self._stats = self._stats, None
        if counts is None:
            return None
        return torch.stack([counts.sum(), counts.max()])

    @torch.no_grad()
    def update_bias(self) -> None:
        """``b_i += gamma sign(mean load - load_i)`` over the loads since
        the last update, counted over all ``E`` experts."""
        load, self._loads = self._loads, None
        if load is None or not self.gamma:
            return
        self.gate.e_score_correction_bias.add_(self.gamma * torch.sign(load.mean() - load))


def routed_layers(model: nn.Module) -> List[RoutedMoE]:
    return [m for m in model.modules() if isinstance(m, RoutedMoE)]

