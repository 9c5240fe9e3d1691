"""Find the highest request rate the serving path sustains: one service,
one process, the cell's traffic offered at each rate in turn.

    python3 portbench/tools/sweep_serve.py --workload <serve cell> \\
        --rates 600,800,1000 [--seconds 8]

For each rate: the p50 and p95 latency, the rows answered a second, and
the median latency of the last quarter of the requests against the
first (a backlog that grows shows as a ratio well above 1).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"))
    args = p.parse_args(argv)

    import torch

    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.serve import EmbeddingService
    from portbench import harness
    from portbench.data import make_rows, make_weights, seed_words
    from portbench.drivers.open_loop_serve import arrivals, open_loop

    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.config_of(bench, CHECKOUT, cell["config"])
    tr = harness.load_json(Path(args.data) / "traffic" / f"{cell['traffic']}.json")
    rows = make_rows(cfg, int(tr["pool_rows"]), args.seed, float(tr["p_missing"]))
    svc = EmbeddingService(training_config_from_dict(cfg), params=make_weights(cfg, args.seed, args.device),
                           max_batch=int(tr["max_batch"]), max_wait_ms=float(tr["max_wait_ms"]),
                           device=args.device)
    pick = seed_words(args.seed, 3)
    svc.start()
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            due = arrivals(rate, args.seconds, args.seed, 10 + i)
            lat, failed, _, late, last = open_loop(svc, rows, due, pick.integers(0, len(rows), len(due)),
                                                   float(tr["wait_s"]))
            ms = lat * 1e3
            q = max(len(ms) // 4, 1)
            print(json.dumps({
                "rate": rate, "p50_ms": float(np.percentile(ms, 50)), "p95_ms": float(np.percentile(ms, 95)),
                "rows_per_s": (len(due) - failed) / last, "failed": failed,
                "send_late_p95_ms": float(np.percentile(late, 95) * 1e3), "send_late_max_ms": float(late.max() * 1e3),
                "last_vs_first_quarter": float(np.median(ms[-q:]) / np.median(ms[:q])),
            }), flush=True)
    finally:
        svc.stop()
    if torch.cuda.is_available():
        print(torch.cuda.get_device_name(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
