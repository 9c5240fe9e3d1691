"""A closed training loop of a ``deepseek_v3`` block configuration
through the program's own loader and step, checked against
:mod:`portbench.reference.moonlight`.

The traffic parameters and the loop are :mod:`portbench.drivers.train_loop`'s
(one chip): ``rows_per_rank``, ``pool_rows``, ``p_missing``,
``warmup_steps`` (the first ``checked_steps`` of them followed by the
reference), ``horizon_steps``, ``traced_steps`` and ``reference_rows``.
What differs: the weights are made for the block's leaves
(:func:`portbench.reference.moonlight.param_specs`, the correction
biases among them), the reference is the block's, the model operations
a step are :mod:`portbench.moonlight_counts`'s, and a run also prints
the share of token-expert assignments of the first checked batch that
the program's router (bf16 upstream, fp32 scores) and the reference's
(fp32) chose differently, a diagnostic of near-ties between the k-th
and the next expert.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import check, moonlight_counts
from portbench.data import make_rows
from portbench.drivers.train_loop import Feed, leaf_norms, loader_order, sync
from portbench.harness import Outcome, Run
from portbench.reference.model import LOGIT_INIT
from portbench.reference.moonlight import param_specs, train_steps
from portbench.reference.train import collate
from portbench.trace import device_busy, profiled, span


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of :func:`param_specs`, made on ``device`` from ``seed``
    as :func:`portbench.data.make_weights` makes the MCA ones: one normal
    and one uniform draw cut into the leaves."""
    specs = param_specs(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    sizes = {name: int(np.prod(shape)) for name, shape, _ in specs}
    n_normal = sum(sizes[n] for n, _, init in specs if init == "normal")
    n_uniform = sum(sizes[n] for n, _, init in specs if init == "uniform")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device).mul_(2).sub_(1)
    out, i_n, i_u = {}, 0, 0
    for name, shape, init in specs:
        k = sizes[name]
        if init == "normal":
            t = normal[i_n:i_n + k]
            i_n += k
        elif init == "uniform":
            t = uniform[i_u:i_u + k] * shape[-1] ** -0.5
            i_u += k
        elif init == "ones":
            t = torch.ones(k, device=device)
        elif init == "zeros":
            t = torch.zeros(k, device=device)
        else:
            t = torch.full((k,), LOGIT_INIT, device=device)
        out[name] = t.view(shape)
    return out


def program_choices(model, batch) -> List[torch.Tensor]:
    """The experts the program's routed layers choose for every token of
    ``batch``, by layer, in a forward without gradients."""
    from mca_tpu_torch.models.routed_moe import routed_layers

    chosen, layers = [], routed_layers(model)

    def recording(route):
        def wrapped(h):
            out = route(h)
            chosen.append(out[0])
            return out
        return wrapped

    for m in layers:
        m.route = recording(m.route)
    try:
        with torch.no_grad():
            model(batch, no_loss=True)
    finally:
        for m in layers:
            del m.route
    return chosen


def flip_share(prog: List[torch.Tensor], ref: List[torch.Tensor], valid: torch.Tensor) -> float:
    """The share of the real slots' token-expert assignments that one side
    chose and the other did not, over every routed layer."""
    flips = total = 0
    for a, b in zip(prog, ref):
        a, b = a.cpu()[valid], b.cpu()[valid]
        same = (a[:, :, None] == b[:, None, :]).any(-1).sum()
        flips += int(a.numel() - same)
        total += int(a.numel())
    return flips / max(total, 1)


def run(r: Run) -> Outcome:
    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.data.dataset import BatchedLoader
    from mca_tpu_torch.parallel.multihost import make_stager
    from mca_tpu_torch.train import (build_trainer, staging_sentinels, to_device, train_step,
                                     training_mesh)

    if r.world != 1:
        raise ValueError("the deepseek_v3 block runs on one chip")
    tr = r.traffic
    cfg = dict(r.cfg, **tr.get("config", {}))
    bs = cfg["batch_size"] = int(tr["rows_per_rank"])
    config = training_config_from_dict(cfg)
    rows = make_rows(cfg, int(tr["pool_rows"]), r.seed, float(tr["p_missing"]))
    weights = make_weights(cfg, r.seed, r.device)
    start = {k: v.cpu() for k, v in weights.items()}
    mesh = training_mesh(config, r.device)
    horizon = int(tr["horizon_steps"])
    model, opt, sched = build_trainer(config, str(r.device), num_training_steps=horizon,
                                      params=weights, mesh=mesh)
    del weights
    collator = MultimodalCollator(cfg["modality_config"])
    loader = BatchedLoader(rows, collator, bs, shuffle=True, seed=int(config.seed),
                           prefetch=int(config.get("prefetch_batches", 0) or 0))
    feed = Feed(loader, make_stager(mesh, bs), config.get("stage_dtype", "fp32"),
                staging_sentinels(config), r.device)
    clip = float(config.clip or 0.0)
    n_checked = int(tr["checked_steps"])
    order = loader_order(len(rows), int(config.seed))
    batches = [[rows[i] for i in order[k * bs:(k + 1) * bs]] for k in range(n_checked)]
    prog_chosen = [c.cpu() for c in program_choices(
        model, to_device(collator(batches[0]), r.device))]
    ref_cols = collate(cfg, batches[0], "cpu")
    valid = torch.cat([~ref_cols[m]["padded"] for m in cfg["encoder_configs"]]
                      + [torch.ones(bs, int(cfg["num_fusion_tokens"]), dtype=torch.bool)],
                      dim=1).reshape(-1)

    def one_step() -> float:
        t = time.perf_counter()
        with span("loader"):
            batch = feed.next()
        waited = time.perf_counter() - t
        with span("step"):
            m = train_step(model, opt, sched, batch, clip=clip, dropout_seed=int(config.seed))
        losses.append(m["total_loss"])
        return waited

    losses: list = []
    prog = {}
    for i in range(max(int(tr["warmup_steps"]), n_checked)):
        one_step()
        if i == 0:
            prog["grad"] = leaf_norms(model, opt)
        if i == n_checked - 1:
            prog["change"] = {n: float((p.detach().cpu() - start[n]).norm())
                              for n, p in model.named_parameters()}
    prog["losses"] = losses[:n_checked]
    sync(r.device)
    gc.freeze()
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)

    window_start = time.time()
    t0 = time.perf_counter()
    steps, loader_s = 0, 0.0
    while True:
        loader_s += one_step()
        steps += 1
        if time.perf_counter() - t0 >= r.seconds:
            break
    elapsed = time.perf_counter() - t0

    tokens = steps * bs * moonlight_counts.sample_tokens(cfg)
    ctx = {"cfg": cfg, "device_type": r.device.type, "launch_batch": bs,
           "host": {"steps": steps, "elapsed_s": elapsed, "loader_s": loader_s,
                    "flops_per_step": moonlight_counts.train_flops(cfg, bs),
                    "traced_steps": int(tr["traced_steps"])},
           "trace": None}
    busy = window = None
    if r.trace:
        n_traced = int(tr["traced_steps"])
        light = device_busy(lambda: [one_step() for _ in range(n_traced)], r.device)
        trace = profiled(lambda: [one_step() for _ in range(n_traced)], r.device)
        ctx["trace"], ctx["busy"] = trace, light
        if light is not None:
            busy, window = light.busy_s, light.window_s
            print(f"profiled segments of {n_traced} steps: device activity alone "
                  f"{busy:.4f} s busy in {window:.4f} s; host and device "
                  f"{trace.busy_s:.4f} s busy in {trace.window_s:.4f} s; unprofiled "
                  f"{elapsed / steps:.4f} s a step", flush=True)
    peak = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0

    del model, opt, sched, feed, loader
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(cfg, start, batches, horizon, int(tr["reference_rows"]), r.device)
    checks = check.with_limits(check.train_numbers(prog, ref), r.limits)
    print("loss gap by followed step: "
          + ", ".join(repr(g) for g in check.loss_gaps(prog, ref))
          + f"; leaves left out of update_gap: {check.still_leaves(ref)}; "
          + check.worst_leaves(prog, ref)
          + f"; routed assignments flipped: {flip_share(prog_chosen, ref['chosen'], valid)!r}"
          + f"; peak {peak} B; {steps} steps in the window", flush=True)
    ctx["compared"] = {"start": start, "batches": batches, "horizon": horizon, "ref": ref,
                       "prog": prog}
    return Outcome(attempted=steps, failed=0, window_start=window_start,
                   e2e={"train_tokens_per_s": tokens / elapsed}, ctx=ctx, checks=checks,
                   memory_peak_bytes=int(peak), busy_s=busy, window_s=window)


def reference_steps(cfg, start, batches, horizon, block, device, precision="fp32", keep=None):
    """The reference's followed steps on the card, with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return train_steps(cfg, start, batches, horizon, block, device, precision, keep)

