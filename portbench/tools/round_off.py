"""How far rounding alone carries a training cell's three followed steps:
second witnesses for the gaps that ``portbench/check.py`` compares.

    python3 portbench/tools/round_off.py --workload <training cell> --seeds 1,2,...

For each seed, on the same weights and rows, in one process on the chip:

- the program as the cell runs it (the fused attention backward, K2);
- the program with the split backward (K3a + K3b, whose dq is summed in
  another order), the same precision;
- the fp32 reference (TF32 off), and the reference with every product's
  inputs rounded to bfloat16, forward and backward.

One JSON line a seed and pair: each followed step's relative loss gap and
the ``grad_gap`` / ``update_gap`` of the first side against the second.
Where the program against its split self, or the bf16 reference against
the fp32 one, parts by as much at the third step as the program does
from the reference, rounding alone carries that far.

With ``--look``, one more line a seed: the leaves whose parameters part
most from the reference's after the first and the second step (their
distance over the reference's change; the leaves ``update_gap`` leaves
out are left out here too), for the program and the bf16 reference;
each of the program's steps against the reference's step taken from the
program's own parameters (the loss's relative gap, and the clipped
gradient's worst and median leaf distance, beside the bf16 reference's
at the same parameters); and the fp32 reference's third-step loss at its
own parameters after two steps, at the program's, with every leaf moved
as far as the program's in a random direction (three draws), and with
each group of leaves (an encoder's token table, value encoder or
projection; the blocks; the pool; the tokens; the temperature) swapped
between the two sides, with the losses that move most.
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
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--look", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--bench", default=str(CHECKOUT / "BENCHMARK.json"))
    p.add_argument("--data", default=str(CHECKOUT / "portbench"))
    args = p.parse_args(argv)

    import torch

    from portbench import check, harness
    from portbench.drivers import train_loop

    from mca_tpu_torch.ops import flash_attention

    bench = harness.load_json(Path(args.bench))
    cell = harness.find_cell(bench, args.workload)
    cfg = harness.config_of(bench, CHECKOUT, cell["config"])
    traffic = harness.load_json(Path(args.data) / "traffic" / f"{cell['traffic']}.json")
    if traffic["driver"] != "train_loop" or int(cell["chips"]) != 1:
        raise SystemExit("round_off reads a one-chip training cell")
    device = torch.device(args.device)

    def program(seed, bwd):
        flash_attention.default_bwd_impl = bwd
        try:
            run = harness.Run(cell=cell, cfg=cfg, traffic=traffic, limits={}, seed=seed,
                              seconds=args.seconds, trace=False, device=device)
            return train_loop.run(run).ctx["compared"]
        finally:
            flash_attention.default_bwd_impl = "fused"

    def pair(seed, name, a, b):
        numbers = dict(check.train_numbers(a, b))
        print(json.dumps({"seed": seed, "pair": name, "loss_gaps": check.loss_gaps(a, b),
                          "grad_gap": numbers["grad_gap"], "update_gap": numbers["update_gap"],
                          "worst": check.worst_leaves(a, b)}), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        snaps: list = []  # (parameters, exp_avg) after each followed step
        if args.look:
            import mca_tpu_torch.train as program_train

            whole = program_train.train_step

            def kept_step(model, optimizer, *a, **k):
                out = whole(model, optimizer, *a, **k)
                if len(snaps) < 3:
                    named = list(model.named_parameters())
                    snaps.append(({n: q.detach().float().cpu().clone() for n, q in named},
                                  {n: optimizer.state[q]["exp_avg"].float().cpu().clone()
                                   for n, q in named if q in optimizer.state}))
                return out

            program_train.train_step = kept_step
        try:
            fused = program(seed, "fused")
        finally:
            if args.look:
                program_train.train_step = whole
        split = program(seed, "split")
        ref = fused["ref"]
        bf16_snaps: list = []
        ref_bf16 = train_loop.reference_steps(
            dict(cfg, **traffic.get("config", {})), fused["start"], fused["batches"],
            fused["horizon"], int(traffic["reference_rows"]), device, precision="bf16",
            keep=bf16_snaps)
        pair(seed, "program (fused) vs fp32 reference", fused["prog"], ref)
        pair(seed, "program (split) vs fp32 reference", split["prog"], ref)
        pair(seed, "program (split) vs program (fused)", split["prog"], fused["prog"])
        pair(seed, "bf16 reference vs fp32 reference", ref_bf16, ref)
        if args.look:
            look(seed, dict(cfg, **traffic.get("config", {})), fused, snaps, bf16_snaps,
                 int(traffic["reference_rows"]), device)
    return 0


def look(seed, cfg, comp, snaps, bf16_snaps, block, device):
    """Where the program's parameters part from the reference's, and
    whether each of the program's steps is the reference's step taken
    from the program's own state."""
    import statistics

    import torch

    from portbench import check
    from portbench.drivers.train_loop import BETA1
    from portbench.reference import train as rt
    from portbench.reference.model import Reference

    torch.backends.cuda.matmul.allow_tf32 = False
    start, batches = comp["start"], comp["batches"]
    ref_snaps: list = []
    rt.train_steps(cfg, start, batches, comp["horizon"], block, device, keep=ref_snaps)
    params = [start] + [{n: sp[0][n] for n in start} for sp in snaps]  # entering each step
    still = set(check.still_leaves(comp["ref"]))  # as update_gap leaves them out
    R, R16 = Reference(cfg), Reference(cfg, "bf16")

    def parting(k, side):
        d = {n: float((side[k][n] - ref_snaps[k][n]).norm())
             / max(float((ref_snaps[k][n] - start[n]).norm()), 1e-30)
             for n in start if n not in still}
        return sorted(d.items(), key=lambda kv: -kv[1])[:5]

    def loss_at(P, rows):
        P = {n: v.to(device) for n, v in P.items()}
        with torch.no_grad():
            pooled, present = rt.pooled_all(R, P, rows, block, device)
            losses = R.losses(pooled, present, P["loss.loss_fn.logit_scale"])
            return float(R.total(losses)), {n: float(v) for n, v in losses.items()}

    def clipped(ref_model, P, rows):
        """A step's gradient as the optimizer gets it, after the clip."""
        P = {n: v.to(device) for n, v in P.items()}
        g = {n: x.cpu() for n, x in rt.gradients(ref_model, P, rows, block, device)[2].items()}
        norm = float(torch.stack([x.square().sum() for x in g.values()]).sum().sqrt())
        clip = float(cfg["clip"] or 0.0)
        scale = clip / norm if clip and norm > clip else 1.0
        return {n: x * scale for n, x in g.items()}

    def distances(g, want):
        d = {n: float((g[n] - want[n]).norm()) / max(float(want[n].norm()), 1e-30)
             for n in want if n in g and n not in still}
        worst = max(d, key=d.get)
        return {"worst": [worst, d[worst]], "median": statistics.median(d.values())}

    stepwise = []
    for k in range(len(snaps)):
        m = snaps[k][1]
        g_prog = {n: (m[n] - BETA1 * snaps[k - 1][1][n] if k else m[n]) / (1 - BETA1) for n in m}
        want = clipped(R, params[k], batches[k])
        ref_loss = loss_at(params[k], batches[k])[0]
        stepwise.append({
            "step": k + 1,
            "loss_gap": abs(comp["prog"]["losses"][k] - ref_loss) / abs(ref_loss),
            "program_gradient": distances(g_prog, want),
            "bf16_reference_gradient": distances(clipped(R16, params[k], batches[k]), want),
        })

    own, own_losses = loss_at(ref_snaps[1], batches[2])
    at_prog, prog_losses = loss_at(params[2], batches[2])
    moved = sorted(own_losses, key=lambda n: -abs(prog_losses[n] - own_losses[n]))[:5]
    gen = torch.Generator().manual_seed(seed % 2**63)

    def parted_at_random(n):
        """The reference's parameters after two steps, each leaf moved in a
        random direction by as far as the program's parts from them."""
        d = params[2][n] - ref_snaps[1][n]
        r = torch.randn(d.shape, generator=gen)
        return ref_snaps[1][n] + r * (d.norm() / r.norm().clamp(min=1e-30))

    at_random = [loss_at({n: parted_at_random(n) for n in start}, batches[2])[0]
                 for _ in range(3)]

    def group(n):
        if n in still:
            return "left out of update_gap"
        parts = n.split(".")
        return ".".join(parts[:3]) if parts[0] == "encoders" else parts[0]

    by_group = {}
    for g in sorted({group(n) for n in start}):
        names = [n for n in start if group(n) == g]
        by_group[g] = {
            "reference with the program's": loss_at(
                dict(ref_snaps[1], **{n: params[2][n] for n in names}), batches[2])[0],
            "program with the reference's": loss_at(
                dict(params[2], **{n: ref_snaps[1][n] for n in names}), batches[2])[0],
        }
    print(json.dumps({
        "seed": seed, "look": True,
        "parting_after_step_1": parting(0, [p[0] for p in snaps]),
        "parting_after_step_2": parting(1, [p[0] for p in snaps]),
        "bf16_reference_parting_after_step_1": parting(0, bf16_snaps),
        "bf16_reference_parting_after_step_2": parting(1, bf16_snaps),
        "each_step_from_the_programs_state": stepwise,
        "step3_loss": {"program": comp["prog"]["losses"][2], "reference": own,
                       "reference at the program's parameters": at_prog,
                       "reference with each leaf parted as far at random": at_random},
        "step3_loss_with_one_group_swapped": by_group,
        "losses_that_move": {n: [own_losses[n], prog_losses[n]] for n in moved},
    }), flush=True)


if __name__ == "__main__":
    sys.exit(main())
