"""How late the serving cell's load generator sends, alone and beside the
program's service, on the cell's own schedule, in one process.

    python3 portbench/tools/generator_lateness.py --workload <serve cell> \\
        [--seed 1] [--seconds 20] [--device-ms 25] [--real] [--switch-ms 5,0.5]

First against a stand-in service with the program's batching rules
(``max_batch`` rows or ``max_wait_ms``, one batch at a time) that only
sleeps ``--device-ms`` a batch, so that it holds no interpreter time:
the generator's own lateness.  With ``--real``, then against the
program's ``EmbeddingService`` on the card, once for each interpreter
switch interval in ``--switch-ms`` (Python's default is 5 ms).  One JSON
line each: sends behind their due time (p50, p95, p99, latest) and the
latency p95 from the due time and from the send.
"""

from __future__ import annotations

import argparse
import json
import queue
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import numpy as np

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))


class SleepingService:
    """``submit`` / ``start`` / ``stop`` as the program's service has them;
    a batch is coalesced by the same rules and answered after a sleep."""

    def __init__(self, max_batch: int, max_wait_ms: float, device_ms: float):
        self.max_batch, self.max_wait_s = max_batch, max_wait_ms / 1e3
        self.device_s = device_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def submit(self, row) -> Future:
        fut: Future = Future()
        self._queue.put(fut)
        return fut

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                pending = [self._queue.get(timeout=0.1)]
            except queue.Empty:
                continue
            t0 = time.monotonic()
            while len(pending) < self.max_batch:
                left = self.max_wait_s - (time.monotonic() - t0)
                try:
                    pending.append(self._queue.get(timeout=left) if left > 0
                                   else self._queue.get_nowait())
                except queue.Empty:
                    break
            time.sleep(self.device_s)
            for fut in pending:
                fut.set_result(None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--device-ms", type=float, default=25.0)
    p.add_argument("--real", action="store_true")
    p.add_argument("--switch-ms", default="5")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"))
    args = p.parse_args(argv)

    from portbench import harness
    from portbench.data import make_rows, seed_words
    from portbench.drivers.open_loop_serve import arrivals, open_loop

    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.config_of(bench, CHECKOUT, cell["config"])
    tr = harness.load_json(Path(args.data) / "traffic" / f"{cell['traffic']}.json")
    rate, wait_s = float(tr["rate"]), float(tr["wait_s"])
    due = arrivals(rate, args.seconds, args.seed, 0)
    picks = seed_words(args.seed, 3).integers(0, int(tr["pool_rows"]), len(due))

    def report(name, svc, rows):
        latency, failed, _, late, _ = open_loop(svc, rows, due, picks, wait_s)
        ms, late_ms = latency * 1e3, late * 1e3
        print(json.dumps({
            "service": name, "requests": len(due), "rate": rate, "failed": failed,
            "late_p50_ms": float(np.percentile(late_ms, 50)),
            "late_p95_ms": float(np.percentile(late_ms, 95)),
            "late_p99_ms": float(np.percentile(late_ms, 99)), "late_max_ms": float(late_ms.max()),
            "p95_ms_from_due": float(np.percentile(ms, 95)),
            "p95_ms_from_send": float(np.percentile(ms - late_ms, 95)),
        }), flush=True)

    stand_in = SleepingService(int(tr["max_batch"]), float(tr["max_wait_ms"]), args.device_ms)
    stand_in.start()
    try:
        report(f"sleeping stand-in, {args.device_ms} ms a batch", stand_in,
               [None] * int(tr["pool_rows"]))
    finally:
        stand_in.stop()
    if not args.real:
        return 0

    import gc

    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.serve import EmbeddingService
    from portbench.data import make_weights

    rows = make_rows(cfg, int(tr["pool_rows"]), args.seed, float(tr["p_missing"]))
    svc = EmbeddingService(training_config_from_dict(cfg), params=make_weights(cfg, args.seed, args.device),
                           max_batch=int(tr["max_batch"]), max_wait_ms=float(tr["max_wait_ms"]),
                           device=args.device)
    svc.start()
    default = sys.getswitchinterval()
    try:
        warm = arrivals(rate, float(tr["warm_s"]), args.seed, 1)
        open_loop(svc, rows, warm, picks[:len(warm)], wait_s)
        gc.freeze()
        for sw in (float(s) for s in args.switch_ms.split(",") if s):
            sys.setswitchinterval(sw / 1e3)
            report(f"EmbeddingService, switch interval {sw} ms", svc, rows)
    finally:
        sys.setswitchinterval(default)
        svc.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
