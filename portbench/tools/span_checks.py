"""The consistency checks of the program's spans on a one-chip cell, and
the recorder's own cost.

    python3 portbench/tools/span_checks.py --workload <cell> --seed <n> \\
        [--seconds 20] [--device cuda|cpu] [--bench BENCHMARK.json] [--data portbench]

Runs the cell traced in this process, as ``run.py --trace 1`` does, then
reads what the program's recorder holds and prints one JSON line:

- ``metrics``: every per-layer metric of the cell, as the run reads it,
  and the seconds of each ``build.*`` span;
- training: ``collate_ms.train + copy_ms.train`` over
  ``loader_wait_ms.train``; the four host phases plus
  ``loader_wait_ms.train`` over the unprofiled step's wall (window
  seconds over steps); ``device_step_ms.train`` over that wall;
- serving: the rows counted in the window's forwards against the
  window's requests, and the p50 / p95 of each request's queue wait
  plus service time (its submission to its answer);
- the idle gaps of the profiled host-and-device segment over 1 ms, each
  put down to the innermost ``mca.*`` span that covered its middle on
  the recorder's clock (the profiler's);
- the wall time a step or a second of serving takes in each profiled
  segment, and the run's ``breakdown`` as its result line has it;
- ``cost``: microseconds a span, a count, a request's submission stamp,
  a span timed with a CUDA event pair, and the batcher's share a
  request, with no profiler (:func:`cost`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from portbench import harness, spans  # noqa: E402

GAP_NS = 1_000_000


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"))
    return p.parse_args(argv)


def cost(device, rows_a_batch: int = 28) -> dict:
    """Microseconds a recorder operation takes, over loops, in a recorder
    of their own: a span, a count, a request's submission stamp, a span
    timed with a CUDA event pair (read after a synchronise), and the
    batcher's share a request of a forward of ``rows_a_batch`` requests
    (its timed ``serve.batch`` span with two counts, the dispatch stamps,
    the answer stamps)."""
    import torch

    from mca_tpu_torch.utils.trace import Recorder

    rec, n = Recorder(), 20000

    def per(fn, k=n):
        t = time.perf_counter()
        fn(k)
        return (time.perf_counter() - t) / k * 1e6

    def spans_(k):
        for i in range(k):
            with rec.span("x", step=i):
                pass

    def counts(k):
        for _ in range(k):
            rec.count("c", 1)

    def submits(k):
        for _ in range(k):
            rec.request()

    out = {"span_us": per(spans_), "count_us": per(counts), "submit_us": per(submits)}
    if device.type == "cuda":
        def timed(k):  # the synchronise is the caller's own; one at the end
            for i in range(k):
                with rec.span("t", step=i) as sp:
                    sp.device_start(device)
                    sp.device_end()
            torch.cuda.synchronize(device)
            rec.settle()

        def batches(k):
            for _ in range(k):
                rids = ids[:rows_a_batch]
                del ids[:rows_a_batch]
                with rec.span("serve.batch") as sp:
                    rec.dispatched(rids, sp.seq)
                    rec.count("serve.rows", len(rids))
                    rec.count("serve.padded_rows", 0)
                    sp.device_start(device)
                rec.answered(rids)
            torch.cuda.synchronize(device)
            rec.settle()

        timed(1000)  # the settled events stock the pool that the rest reuse
        out["timed_span_us"] = per(timed, 1000)
        ids = [rec.request() for _ in range(1000 * rows_a_batch)]
        out["batcher_us_a_request"] = per(batches, 1000) / rows_a_batch
    return out


def attribute_gaps(trace, records) -> dict:
    """Each idle gap of ``trace`` over 1 ms, put down to the innermost
    profiled span (latest start) covering its middle."""
    prof = (records["profiled"] == 1) & (records["end"] > records["start"])
    s, e, names = records["start"][prof], records["end"][prof], records["name"][prof]
    gaps, by = [], {}
    for a, b in trace.idle_gaps():
        if b - a <= GAP_NS:
            continue
        mid = (a + b) // 2
        cover = np.flatnonzero((s <= mid) & (mid < e))
        label = "mca." + names[cover[np.argmax(s[cover])]] if len(cover) else "no mca span"
        gaps.append([label, (b - a) / 1e6])
        k = by.setdefault(label, [0, 0.0])
        k[0] += 1
        k[1] += (b - a) / 1e6
    return {"gaps_over_1ms": len(gaps), "by_span": {k: {"gaps": v[0], "ms": v[1]}
                                                    for k, v in sorted(by.items())},
            "longest": sorted(gaps, key=lambda g: -g[1])[:12]}


def training_checks(ctx, m) -> dict:
    host = ctx["host"]
    wall = 1e3 * host["elapsed_s"] / host["steps"]
    wait = m.get("loader_wait_ms.train")
    phases = [m.get(k) for k in ("forward_host_ms.train", "backward_host_ms.train",
                                 "optimizer_host_ms.train", "readback_wait_ms.train")]
    out = {"steps": host["steps"], "step_wall_ms": wall,
           "window_steps": None if spans.window_steps(ctx) is None
           else len(spans.window_steps(ctx)["seq"])}
    if None not in (wait, m.get("collate_ms.train"), m.get("copy_ms.train")):
        out["collate_plus_copy_over_loader_wait"] = (
            (m["collate_ms.train"] + m["copy_ms.train"]) / wait)
    if None not in phases and wait is not None:
        out["phases_plus_loader_over_wall"] = (sum(phases) + wait) / wall
    if m.get("device_step_ms.train") is not None:
        out["device_step_over_wall"] = m["device_step_ms.train"] / wall
    return out


def serving_checks(ctx) -> dict:
    r = spans.window_requests(ctx)
    b = spans.window_batches(ctx)
    if r is None or b is None:
        return {}
    total = (r["answer"] - r["submit"]) / 1e6
    return {"requests": int(len(r["id"])), "forwards": int(len(b["seq"])),
            "rows_counted": spans.counted("serve.rows", b["seq"]),
            "padded_counted": spans.counted("serve.padded_rows", b["seq"]),
            "submit_to_answer_ms": {"p50": float(np.percentile(total, 50)),
                                    "p95": float(np.percentile(total, 95))}}


def main(argv=None) -> int:
    args = parse(list(sys.argv[1:] if argv is None else argv))
    from portbench import run as pbrun

    pbrun.pin_caches()
    import torch

    from mca_tpu_torch.parallel.multihost import init_multihost

    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    if int(cell["chips"]) != 1:
        raise SystemExit("span_checks runs one-chip cells")
    init_multihost(device=args.device)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    data = Path(args.data)
    traffic = harness.load_json(data / "traffic" / f"{cell['traffic']}.json")
    limits_path = data / "limits" / f"{cell['name']}.json"
    run = harness.Run(cell=cell, cfg=harness.config_of(bench, CHECKOUT, cell["config"]),
                      traffic=traffic,
                      limits=harness.load_json(limits_path) if limits_path.exists() else {},
                      seed=args.seed, seconds=args.seconds, trace=True, device=device)
    out = harness.driver(traffic["driver"]).run(run)
    ctx = out.ctx
    _, layer = harness.metrics_of_cell(bench, cell["name"])
    metrics = {m["name"]: harness.reader(m["name"])(ctx) for m in layer}
    rec = spans.recorder()
    records = rec.records()
    result = {"cell": cell["name"], "seed": args.seed, "device": str(device),
              "correct": harness.check_verdict(out.checks) and out.failed == 0,
              "metrics": metrics}
    build = rec.records(prefix="build.")
    result["build_s"] = {n: float(d) / 1e9 for n, d in zip(build["name"],
                                                           build["end"] - build["start"])}
    if "steps" in ctx["host"]:
        result["checks"] = training_checks(ctx, metrics)
        per = ctx["host"]["traced_steps"]
        unit = "s a step"
    else:
        result["checks"] = serving_checks(ctx)
        per = float(traffic["traced_s"])
        unit = "s a second of load"
    trace, busy = ctx.get("trace"), ctx.get("busy")
    if trace is not None:
        result["profiled"] = {"unit": unit, "host_and_device": trace.window_s / per,
                              "device_alone": busy.window_s / per if busy else None}
        result["idle"] = attribute_gaps(trace, records)
        if trace.device:
            result["breakdown"] = trace.breakdown()
    result["cost"] = cost(device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
