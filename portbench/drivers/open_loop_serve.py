"""Open-loop embedding requests through the program's micro-batcher.

Traffic parameters: ``rate`` (requests a second, fixed), ``pool_rows``
and ``p_missing`` (the seeded rows a request draws from, one row a
request), ``max_batch`` and ``max_wait_ms`` (the service's), ``warm_s``
(seconds of the same load in set-up), ``traced_s`` (the profiled segment
of a ``--trace 1`` run), ``check_rows`` and ``reference_rows`` (the
sampled answers the reference recomputes, and its block), ``wait_s``
(how long past the window's close an answer is waited for).

Arrivals are Poisson: the gaps are the exponential distribution's
quantiles at ``rate``, one a request, in an order drawn from the seed
over the whole window, so every seed sends the same set of gaps and any
stretch of the window is as bursty as independent exponential gaps make
it.  Each request is ``EmbeddingService.submit`` at its due time; its
latency runs from the due time (not the send) to the moment its answer
is set.  A request never answered counts with the time the run gave up
on it.  How late each send was goes on an earlier line.
"""

from __future__ import annotations

import gc
import threading
import time

import numpy as np
import torch

from portbench import check, counts
from portbench.data import make_rows, make_weights, seed_words
from portbench.harness import Outcome, Run
from portbench.trace import device_busy, profiled


def arrivals(rate: float, seconds: float, seed: int, salt: int) -> np.ndarray:
    """Due times in ``[0, seconds]`` of Poisson arrivals at ``rate``: the
    exponential distribution's quantiles at ``round(rate * seconds)``
    levels, in an order drawn from the seed, scaled to fill the window."""
    n = max(int(round(rate * seconds)), 1)
    levels = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps = seed_words(seed, 2, salt).permutation(levels)
    return np.cumsum(gaps) * (seconds / gaps.sum())


def open_loop(svc, rows, due: np.ndarray, picks: np.ndarray, wait_s: float, keep=()):
    """Submit ``rows[picks[i]]`` at ``due[i]``; returns ``(latency_s,
    failed, answers, lateness_s, last_answer_s)``, ``answers`` those of
    the requests in ``keep`` that came and ``lateness_s`` each send's
    time behind its due time.  A request not answered by ``wait_s`` past
    the last due time has the latency it had then.  Only the futures in
    ``keep`` are held: the others go once answered, so that the window's
    requests do not pile up for the collector to walk."""
    n = len(due)
    done = np.full(n, np.nan)
    ok = np.zeros(n, bool)
    late = np.zeros(n)
    keep = {int(i) for i in keep}
    kept = {}
    left = [n]
    lock = threading.Lock()
    all_done = threading.Event()

    def answered(f, i):
        ok[i] = not f.cancelled() and f.exception() is None
        done[i] = time.perf_counter()
        with lock:
            left[0] -= 1
            if left[0] == 0:
                all_done.set()

    t0 = time.perf_counter()
    for i in range(n):
        target = t0 + due[i]
        ahead = target - time.perf_counter()
        if ahead > 0:
            time.sleep(ahead)
        late[i] = time.perf_counter() - target
        f = svc.submit(rows[int(picks[i])])
        if i in keep:
            kept[i] = f
        f.add_done_callback(lambda f, i=i: answered(f, i))
    all_done.wait(timeout=max(0.0, t0 + due[-1] + wait_s - time.perf_counter()))
    gave_up = time.perf_counter()
    done = done.copy()
    good = ok & ~np.isnan(done)
    done[~good] = gave_up
    answers = {i: f.result() for i, f in kept.items() if good[i]}
    return done - (t0 + due), int((~good).sum()), answers, late, float(np.max(done) - t0)


def run(r: Run) -> Outcome:
    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.serve import EmbeddingService

    if r.world != 1:
        raise ValueError("the serving driver runs on one chip")
    tr = r.traffic
    cfg = dict(r.cfg, **tr.get("config", {}))
    rate = float(tr["rate"])
    wait_s = float(tr["wait_s"])
    rows = make_rows(cfg, int(tr["pool_rows"]), r.seed, float(tr["p_missing"]))
    weights = make_weights(cfg, r.seed, r.device)
    start = {k: v.cpu() for k, v in weights.items()}
    svc = EmbeddingService(training_config_from_dict(cfg), params=weights,
                           max_batch=int(tr["max_batch"]), max_wait_ms=float(tr["max_wait_ms"]),
                           device=str(r.device))
    del weights
    pick = seed_words(r.seed, 3)
    svc.start()
    try:
        warm = arrivals(rate, float(tr["warm_s"]), r.seed, 1)
        open_loop(svc, rows, warm, pick.integers(0, len(rows), len(warm)), wait_s)
        gc.freeze()  # the set-up's objects leave the collector's walks
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
            torch.cuda.reset_peak_memory_stats(r.device)
        due = arrivals(rate, r.seconds, r.seed, 0)
        picks = pick.integers(0, len(rows), len(due))
        sample = np.sort(seed_words(r.seed, 4).choice(
            len(due), size=min(int(tr["check_rows"]), len(due)), replace=False))
        window_start = time.time()
        latency, failed, answers, late, last = open_loop(svc, rows, due, picks, wait_s, sample)
        trace = busy = None
        if r.trace:  # device activity alone for the idle share, then host and device
            segs = [arrivals(rate, float(tr["traced_s"]), r.seed, salt) for salt in (2, 5)]
            segs = [(s, pick.integers(0, len(rows), len(s))) for s in segs]
            busy = device_busy(lambda: open_loop(svc, rows, *segs[0], wait_s), r.device)
            trace = profiled(lambda: open_loop(svc, rows, *segs[1], wait_s), r.device)
    finally:
        svc.stop()
    peak = torch.cuda.max_memory_allocated(r.device) if r.device.type == "cuda" else 0
    ms = latency * 1e3
    print(f"load generator: {len(due)} requests at {rate} a second; sends behind their due "
          f"time p50 {np.percentile(late, 50) * 1e3:.3f} ms, p95 {np.percentile(late, 95) * 1e3:.3f}"
          f" ms, latest {late.max() * 1e3:.3f} ms; latency p95 from the send "
          f"{np.percentile(ms - late * 1e3, 95):.3f} ms, from the due time "
          f"{np.percentile(ms, 95):.3f} ms; {failed} unanswered", flush=True)
    if trace is not None and busy is not None:
        print(f"profiled segments: device activity alone {busy.busy_s:.4f} s busy in "
              f"{busy.window_s:.4f} s; host and device {trace.busy_s:.4f} s busy in "
              f"{trace.window_s:.4f} s", flush=True)
    ctx = {"cfg": cfg, "device_type": r.device.type, "launch_batch": int(tr["max_batch"]),
           "host": {"p50_ms": float(np.percentile(ms, 50)), "elapsed_s": last,
                    "rows": len(due) - failed, "flops_per_row": counts.forward_flops(cfg, 1)},
           "trace": trace, "busy": busy}
    del svc
    gc.collect()
    if r.device.type == "cuda":
        torch.cuda.empty_cache()

    checked = [i for i in sample if i in answers]
    emb, present = reference_embeddings(cfg, start, [rows[int(picks[i])] for i in checked],
                                        int(tr["reference_rows"]), r.device)
    numbers = check.serve_numbers([answers[i] for i in checked], emb, present)
    ctx["compared"] = {"start": start, "rows": [rows[int(picks[i])] for i in checked],
                       "emb": emb, "present": present}
    return Outcome(attempted=len(due), failed=failed, window_start=window_start,
                   e2e={"serve_p95_ms": float(np.percentile(ms, 95))}, ctx=ctx,
                   checks=check.with_limits(numbers, r.limits), memory_peak_bytes=int(peak),
                   busy_s=busy.busy_s if busy else None,
                   window_s=busy.window_s if busy else None)


def reference_embeddings(cfg, start, rows, block, device, precision="fp32"):
    """The reference's embeddings and presence of ``rows``, on the card
    with TF32 off."""
    from portbench.reference.model import Reference
    from portbench.reference.train import pooled_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = Reference(cfg, precision)
    P = {k: v.to(device) for k, v in start.items()}
    pooled, present = pooled_all(ref, P, rows, block, device)
    emb = {k: v.cpu().numpy() for k, v in ref.embeddings(pooled).items()}
    return emb, {m: v.cpu().numpy() for m, v in present.items()}
