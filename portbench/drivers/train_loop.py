"""A closed training loop through the program's own loader and step.

Traffic parameters: ``rows_per_rank`` (the batch on each chip),
``pool_rows`` and ``p_missing`` (the seeded rows the loader shuffles
each epoch), ``warmup_steps`` (the first ``checked_steps`` of them are
followed by the reference), ``horizon_steps`` (the schedule's length),
``traced_steps`` (the profiled segment of a ``--trace 1`` run),
``reference_rows`` (the reference's block of rows) and ``config`` (keys
set over the configuration, such as ``mesh_data``).

Set-up builds one trainer (``train.build_trainer``) on weights made from
the seed, one ``BatchedLoader`` over ``MultimodalCollator``, and drives
the loop body of ``train.train`` (loader, stager, staging, copy,
``train_step``, which ends in the host reading the step's metrics).
The window runs that same body until ``--seconds`` have passed, over all
steps and all the time: ``train_tokens_per_s`` is the blocks' tokens of
every step in the window, summed over the ranks, over the window's wall
seconds.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from portbench import check, counts
from portbench.data import make_rows, make_weights
from portbench.harness import Outcome, Run
from portbench.trace import device_busy, profiled, span

BETA1 = 0.9


class Feed:
    """The loop's input path: next collated batch (new epoch when one
    ends), this rank's rows, staging, the copy to the device."""

    def __init__(self, loader, stage, stage_dtype, sentinels, device):
        from mca_tpu_torch.train import narrow_for_staging, to_device

        self.loader = loader
        self.prep = lambda b: to_device(narrow_for_staging(stage(b), stage_dtype, sentinels), device)
        self.epoch = 0
        self.it = iter(loader)

    def next(self):
        try:
            batch = next(self.it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self.it = iter(self.loader)
            batch = next(self.it)
        return self.prep(batch)


def leaf_norms(model, optimizer) -> dict:
    """The first step's gradient of each leaf, as the optimizer holds it
    (``exp_avg / (1 - beta1)`` after one step), by name."""
    from mca_tpu_torch.parallel.sharding import ShardedOptimizer

    out = {}
    if isinstance(optimizer, ShardedOptimizer):
        for i, name in enumerate(optimizer.names):
            if optimizer.owned[i] and not optimizer.sharded[i] and not optimizer.tp[i]:
                st = optimizer.inner.state[optimizer.opt_params[i]]
                out[name] = float(st["exp_avg"].float().norm()) / (1 - BETA1)
        return out
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})  # a step that moved nothing left none
        out[name] = float(st["exp_avg"].float().norm()) / (1 - BETA1) if st else 0.0
    return out


def loader_order(n: int, seed: int, epoch: int = 0) -> np.ndarray:
    """The rows of an epoch in the order the loader's documented shuffle
    gives them: ``np.random.default_rng(seed + epoch)``."""
    order = np.arange(n)
    np.random.default_rng(seed + epoch).shuffle(order)
    return order


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(r: Run) -> Outcome:
    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.data.dataset import BatchedLoader
    from mca_tpu_torch.parallel.multihost import make_stager
    from mca_tpu_torch.train import build_trainer, staging_sentinels, train_step, training_mesh

    tr = r.traffic
    cfg = dict(r.cfg, **tr.get("config", {}))
    per_rank = int(tr["rows_per_rank"])
    cfg["batch_size"] = per_rank * r.world
    bs = cfg["batch_size"]
    config = training_config_from_dict(cfg)
    rows = make_rows(cfg, int(tr["pool_rows"]), r.seed, float(tr["p_missing"]))
    weights = make_weights(cfg, r.seed, r.device)
    start = {k: v.cpu() for k, v in weights.items()} if r.rank == 0 else None
    mesh = training_mesh(config, r.device)
    horizon = int(tr["horizon_steps"])
    model, opt, sched = build_trainer(config, str(r.device), num_training_steps=horizon,
                                      params=weights, mesh=mesh)
    del weights
    loader = BatchedLoader(rows, MultimodalCollator(cfg["modality_config"]), bs, shuffle=True,
                           seed=int(config.seed), prefetch=int(config.get("prefetch_batches", 0) or 0))
    feed = Feed(loader, make_stager(mesh, bs), config.get("stage_dtype", "fp32"),
                staging_sentinels(config), r.device)
    clip = float(config.clip or 0.0)
    n_accum = int(config.get("grad_accum", 1) or 1)

    def one_step() -> float:
        t = time.perf_counter()
        with span("loader"):
            batch = feed.next()
        waited = time.perf_counter() - t
        with span("step"):
            m = train_step(model, opt, sched, batch, clip=clip, n_accum=n_accum,
                           dropout_seed=int(config.seed))
        losses.append(m["total_loss"])
        return waited

    # set-up: the checked steps, then the rest of the warm-up
    losses: list = []
    n_checked = int(tr["checked_steps"])
    prog = {}
    for i in range(max(int(tr["warmup_steps"]), n_checked)):
        one_step()
        if i == 0 and r.rank == 0:
            prog["grad"] = leaf_norms(model, opt)
        if i == n_checked - 1 and r.rank == 0:
            prog["change"] = {n: float((p.detach().cpu() - start[n]).norm())
                              for n, p in model.named_parameters()}
    prog["losses"] = losses[:n_checked]
    sync(r.device)
    gc.freeze()  # the set-up's objects leave the collector's walks
    if r.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(r.device)
    stop = torch.zeros(1, device=r.device)

    window_start = time.time()
    t0 = time.perf_counter()
    steps, loader_s = 0, 0.0
    while True:
        loader_s += one_step()
        steps += 1
        done = time.perf_counter() - t0 >= r.seconds
        if r.world > 1:  # rank 0's clock ends the window on every rank
            stop.fill_(float(done))
            torch.distributed.broadcast(stop, 0)
            done = bool(stop.item())
        if done:
            break
    elapsed = time.perf_counter() - t0

    tokens = steps * bs * counts.sample_tokens(cfg)
    ctx = {"cfg": cfg, "device_type": r.device.type, "launch_batch": per_rank,
           "host": {"steps": steps, "elapsed_s": elapsed, "loader_s": loader_s,
                    "flops_per_step": counts.train_flops(cfg, per_rank),
                    "traced_steps": int(tr["traced_steps"])},
           "trace": None}
    busy = window = None
    if r.trace:  # device activity alone for the idle share, then host and device
        n_traced = int(tr["traced_steps"])
        light = device_busy(lambda: [one_step() for _ in range(n_traced)], r.device)
        trace = profiled(lambda: [one_step() for _ in range(n_traced)], r.device)
        ctx["trace"], ctx["busy"] = trace, light
        if light is not None:
            busy, window = light.busy_s, light.window_s
            if r.rank == 0:
                print(f"profiled segments of {n_traced} steps: device activity alone "
                      f"{busy:.4f} s busy in {window:.4f} s; host and device "
                      f"{trace.busy_s:.4f} s busy in {trace.window_s:.4f} s; unprofiled "
                      f"{elapsed / steps:.4f} s a step", flush=True)
    peak = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0
    if r.world > 1:
        vals = torch.tensor([float(peak), busy or 0.0, window or 0.0], device=r.device)
        allv = [torch.zeros_like(vals) for _ in range(r.world)]
        torch.distributed.all_gather(allv, vals)
        allv = torch.stack(allv).cpu()
        peak = int(allv[:, 0].max())
        if r.trace:
            busy, window = float(allv[:, 1].mean()), float(allv[:, 2].mean())

    del model, opt, sched, feed, loader
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    checks = []
    if r.rank == 0:
        order = loader_order(len(rows), int(config.seed))
        batches = [[rows[i] for i in order[k * bs:(k + 1) * bs]] for k in range(n_checked)]
        ref = reference_steps(cfg, start, batches, horizon, int(tr["reference_rows"]), r.device)
        checks = check.with_limits(check.train_numbers(prog, ref), r.limits)
        print("loss gap by followed step: "
              + ", ".join(repr(g) for g in check.loss_gaps(prog, ref))
              + f"; leaves left out of update_gap: {check.still_leaves(ref)}; "
              + check.worst_leaves(prog, ref), flush=True)
        ctx["compared"] = {"start": start, "batches": batches, "horizon": horizon, "ref": ref,
                           "prog": prog}
    return Outcome(attempted=steps, failed=0, window_start=window_start,
                   e2e={"train_tokens_per_s": tokens / elapsed}, ctx=ctx, checks=checks,
                   memory_peak_bytes=int(peak), busy_s=busy, window_s=window)


def reference_steps(cfg, start, batches, horizon, block, device, precision="fp32", keep=None):
    """The reference's three steps on the card, with TF32 off."""
    from portbench.reference.train import train_steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return train_steps(cfg, start, batches, horizon, block, device, precision, keep)
