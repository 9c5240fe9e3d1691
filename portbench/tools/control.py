"""Read a cell's compared numbers over many seeds, for the program and
for the control, in one process on the chip.

    python3 portbench/tools/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 4,5,6] [--seconds 2]

A cell on several chips runs one such process a rank, with the
``MCA_COORDINATOR`` / ``MCA_NUM_PROCESSES`` / ``MCA_PROCESS_ID``
environment of :mod:`mca_tpu_torch.parallel.multihost`; rank 0 prints.

The program's readings are those of a run of the cell (a short window);
the control's are the reference computed with float8 products in the
program's place (the precision below the configuration's bf16), read
against the fp32 reference on the same weights and rows.  A training
cell's program can also be read with a fault planted (``--fault``): ``half_batch`` leaves out half of each
batch, the mean taken over the rest; ``no_exchange`` leaves out the
gradients' exchange between ranks.

Every reading is judged against the cell's committed limits
(``portbench/limits/<cell>.json``) as a run judges its own: one JSON
line a reading with its verdict, then the largest program reading and
the smallest of each other kind.  The exit code is 1 where the program
comes out not correct or a control or a fault comes out correct.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted for the duration."""
    import mca_tpu_torch.train as program_train
    from mca_tpu_torch.parallel.sharding import ShardedOptimizer

    whole, reduce = program_train.to_device, ShardedOptimizer.reduce_gradients

    def half(batch, dev):
        out = whole(batch, dev)
        return {m: {k: v[: len(v) // 2] for k, v in f.items()} for m, f in out.items()}

    if fault == "half_batch":
        program_train.to_device = half
    else:
        ShardedOptimizer.reduce_gradients = lambda self: None
    try:
        yield
    finally:
        program_train.to_device, ShardedOptimizer.reduce_gradients = whole, reduce


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--fault", choices=("half_batch", "no_exchange"), default="half_batch")
    p.add_argument("--fault-seeds", default="",
                   help="seeds on which a training cell's program is also read with --fault")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"))
    args = p.parse_args(argv)

    import torch

    from portbench import check, harness
    from portbench.drivers import open_loop_serve, train_loop

    from mca_tpu_torch.parallel.multihost import init_multihost, process_count, process_index

    init_multihost(device=args.device)  # a cell on several chips: one process a rank
    rank, world = process_index(), process_count()
    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.config_of(bench, CHECKOUT, cell["config"])
    traffic = harness.load_json(Path(args.data) / "traffic" / f"{cell['traffic']}.json")
    drv = harness.driver(traffic["driver"])
    limits = harness.load_json(Path(args.data) / "limits" / f"{cell['name']}.json")
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    readings = {"program": {}, "control": {}, args.fault: {}}
    wrong = []  # readings whose verdict is not what their kind must give

    def note(kind, seed, numbers):
        if rank:
            return
        correct = harness.check_verdict(check.with_limits(numbers, limits))
        print(json.dumps({"kind": kind, "seed": seed, **dict(numbers), "correct": correct}),
              flush=True)
        if (kind == "program" and not correct) or (kind in ("control", args.fault) and correct):
            wrong.append((kind, seed))
        for n, v in numbers:
            readings[kind].setdefault(n, []).append(v)

    training = traffic["driver"] == "train_loop"
    for seed in sorted(set(seeds) | set(ctrl_seeds)):
        if seed in seeds or seed in ctrl_seeds:
            run = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits={}, seed=seed,
                              seconds=args.seconds, trace=False, device=device,
                              rank=rank, world=world)
            out = drv.run(run)
            if seed in seeds:
                note("program", seed, [(n, v) for n, v, _ in out.checks])
        if seed not in ctrl_seeds or rank:
            continue
        if training:
            comp = out.ctx["compared"]
            ctrl = train_loop.reference_steps(
                dict(cfg, **traffic.get("config", {})), comp["start"], comp["batches"],
                comp["horizon"], int(traffic["reference_rows"]), device, precision="fp8")
            note("control", seed, check.train_numbers(ctrl, comp["ref"]))
        else:
            comp = out.ctx["compared"]
            emb, present = open_loop_serve.reference_embeddings(
                cfg, comp["start"], comp["rows"], int(traffic["reference_rows"]), device, "fp8")
            answers = [{"embeddings": {k: v[i] for k, v in emb.items()},
                        "present": {m: v[i] for m, v in present.items()}}
                       for i in range(len(comp["rows"]))]
            note("control", seed, check.serve_numbers(answers, comp["emb"], comp["present"]))
    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        with planted(args.fault):
            run = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits={}, seed=seed,
                              seconds=args.seconds, trace=False, device=device,
                              rank=rank, world=world)
            note(args.fault, seed, [(n, v) for n, v, _ in drv.run(run).checks])
    summary = {n: {"program_max": max(v),
                   "control_min": min(readings["control"].get(n, [float("nan")])),
                   f"{args.fault}_min": min(readings[args.fault].get(n, [float("nan")]))}
               for n, v in readings["program"].items()}
    if rank == 0:
        print(json.dumps({"summary": summary, "limits": limits, "wrong_verdicts": wrong}),
              flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
