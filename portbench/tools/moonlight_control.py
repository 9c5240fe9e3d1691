"""Read a ``deepseek_v3`` training cell's compared numbers over seeds,
for the program and for the controls, in one process on the chip.

    python3 portbench/tools/moonlight_control.py --workload tcga_moonlight.train.b32 \\
        --seeds 1,2,... [--control-seeds 1,2] [--seconds 2]

As :mod:`portbench.tools.control` does for the MCA cells: the program's
readings are those of a run of the cell (a short window); the control's
are :mod:`portbench.reference.moonlight` with float8 (e4m3, per-tensor
scale) products in the program's place, forward and backward, read
against the fp32 reference on the same weights and rows; the bf16
witness is the same with bf16 products (the program's own rounding, not
a control).  The router stays fp32 in every reading.  One JSON line a
reading with its verdict under the cell's committed limits, then the
largest program reading and the smallest control reading of each
number.  The exit code is 1 where the program comes out not correct or
the control comes out correct.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"))
    args = p.parse_args(argv)

    import torch

    from portbench import check, harness
    from portbench.drivers import moonlight_train

    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.config_of(bench, CHECKOUT, cell["config"])
    traffic = harness.load_json(Path(args.data) / "traffic" / f"{cell['traffic']}.json")
    limits = harness.load_json(Path(args.data) / "limits" / f"{cell['name']}.json")
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = [int(s) for s in args.control_seeds.split(",") if s]
    readings = {"program": {}, "control": {}, "bf16": {}}
    wrong = []

    def note(kind, seed, numbers):
        correct = harness.check_verdict(check.with_limits(numbers, limits))
        print(json.dumps({"kind": kind, "seed": seed, **dict(numbers), "correct": correct}),
              flush=True)
        if (kind == "program" and not correct) or (kind == "control" and correct):
            wrong.append((kind, seed))
        for n, v in numbers:
            readings[kind].setdefault(n, []).append(v)

    for seed in sorted(set(seeds) | set(ctrl)):
        run = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits={}, seed=seed,
                          seconds=args.seconds, trace=False, device=device)
        out = moonlight_train.run(run)
        if seed in seeds:
            note("program", seed, [(n, v) for n, v, _ in out.checks])
        if seed not in ctrl:
            continue
        comp = out.ctx["compared"]
        for kind, precision in (("control", "fp8"), ("bf16", "bf16")):
            other = moonlight_train.reference_steps(
                dict(cfg, **traffic.get("config", {}), batch_size=int(traffic["rows_per_rank"])),
                comp["start"], comp["batches"], comp["horizon"], int(traffic["reference_rows"]),
                device, precision=precision)
            note(kind, seed, check.train_numbers(other, comp["ref"]))
    summary = {n: {"program_max": max(v),
                   "control_min": min(readings["control"].get(n, [float("nan")])),
                   "bf16_max": max(readings["bf16"].get(n, [float("nan")]))}
               for n, v in readings["program"].items()}
    print(json.dumps({"summary": summary, "limits": limits, "wrong_verdicts": wrong}), flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
