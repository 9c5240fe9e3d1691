"""Parallelism planner for the port, ported from ``mca_tpu/tools/plan_parallel.py``.

    python -m mca_tpu_torch.tools.plan_parallel cfg.yaml --devices 8
        [--hbm-gb 80] [--topk 5] [--exact] [--no-pp] [--max-grad-accum 16]
        [--json] [--device cpu] [--reading-jobs N]

It answers "how should this config be spread over N H100s?":

1. **enumerates** the JAX tool's plans (``dp * tp * pp == devices``, the
   batch divisible by ``dp * grad_accum``, ``heads % tp == 0``, ``layers
   % pp == 0``, fsdp only with ``dp > 1``, ``seq_shard`` with ``tp >
   1``) and keeps those the port's trainer accepts
   (:func:`enumerate_plans` names the ones it refuses);
2. **screens**: a rank's state bytes are exact, counted on the port's
   own sharding rules (:func:`_sharded_bytes`) from the model built on
   the ``meta`` device; what a step adds at its peak comes from ``c0 +
   c1 * rows`` plus, under ``grad_accum`` > 1, the gradient an earlier
   microbatch left, all three read from
   :mod:`~mca_tpu_torch.tools.memory_report` steps on the card
   (:func:`fit_activation_model`) at the fewest rows any plan gives a
   microbatch and at the config's batch, so that no plan reads the line
   below its readings, each step in a process of its own, as a plan's
   ranks take theirs (:func:`fresh_step_memory`);
3. **ranks** the plans that fit by an estimated step time, with the JAX
   tool's formulas over a :class:`Hardware` model, the H100's
   (:data:`H100`) by default;
4. with ``--exact``, **measures** the top plans without a pipe: the
   plan's ``dp * tp`` ranks each take one ``memory_report`` step
   (:func:`exact_plan_memory`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import torch

from mca_tpu_torch.parallel.sharding import FSDP_MIN_SIZE, expert_parallel, tp_layout

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@dataclass(frozen=True)
class Hardware:
    """The step-time model's figures for one device."""

    #: dense bf16 tensor-core peak, FLOP/s
    peak_flops: float
    #: one device's collective bandwidth to the others, bytes/s
    link_bytes_per_s: float
    #: the step's model FLOPs over its wall time at peak
    mfu: float
    #: a ``remat`` step's time over the plain step's
    remat_cost: float
    #: the share of the device's memory a plan may fill
    hbm_safety: float = 0.92


#: NVIDIA H100 SXM (80 GB HBM3, 700 W): 989 TFLOP/s dense bf16 and NVLink
#: 450 GB/s each way, from the data sheet.  ``mfu`` and ``remat_cost`` are
#: the port's own readings at TCGA_config1 (batch 8, bf16) on an H100 80GB
#: HBM3 at a 700.00 W power limit, printed by ``chip_smoke.py`` phase 16
#: (b) from three steps under ``torch.profiler``: ``6 * parameters *
#: tokens * batch`` (2.26e12 FLOPs) over the plain step's 103.8 ms wall at
#: 989 TFLOP/s; and the remat step's device time over the plain step's
#: (39.6 / 33.6 ms; the host-bound walls read 114.9 / 103.8)
H100 = Hardware(peak_flops=989e12, link_bytes_per_s=450e9, mfu=0.022, remat_cost=1.18)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclass
class Plan:
    dp: int
    tp: int
    pp: int = 1
    fsdp: bool = False
    grad_accum: int = 1
    remat: bool = False
    seq_shard: bool = False
    # filled by the scorer
    state_bytes: int = 0
    act_bytes: int = 0
    batch_bytes: int = 0
    peak_bytes: int = 0
    fits: bool = False
    est_step_ms: float = 0.0
    exact: Optional[List[Dict[str, Any]]] = field(default=None)

    def config_stanza(self) -> Dict[str, Any]:
        """The YAML keys that realise this plan in ``mca_tpu_torch.train``."""
        out: Dict[str, Any] = {"mesh_data": self.dp, "mesh_model": self.tp}
        if self.pp > 1:
            out["mesh_pipe"] = self.pp
        if self.fsdp:
            out["fsdp"] = True
        if self.grad_accum > 1:
            out["grad_accum"] = self.grad_accum
        if self.remat:
            out["remat"] = True
        if self.seq_shard:
            out["seq_shard"] = True
        return out


def _plan_config(config, plan: Plan):
    cfg = type(config)(config)
    for k, v in plan.config_stanza().items():
        cfg[k] = v
    return cfg


def _meta_model(config) -> torch.nn.Module:
    """The config's training model on the ``meta`` device: shapes, no
    weights."""
    from mca_tpu_torch.config import get_model_config
    from mca_tpu_torch.models import build_model

    with torch.device("meta"):
        return build_model(get_model_config(config), fused_ff=False)


def _sharded_bytes(config, dp: int, tp: int, fsdp: bool,
                   fsdp_min_size: int = FSDP_MIN_SIZE, model=None) -> int:
    """A rank's exact bytes of parameters and AdamW moments (at
    ``moment_dtype``) under the port's rules
    (:mod:`mca_tpu_torch.parallel.sharding`): attention projections split
    over ``tp`` by heads, a MoE block's experts where ``tp`` divides them,
    and under ``fsdp`` each leaf of at least ``FSDP_MIN_SIZE`` whole
    elements sliced to ``ceil(n / dp)`` entries.  It differs from the JAX
    tool's where the rules do: the GEGLU feed-forward stays replicated
    under tensor parallelism (the port cannot compute on the JAX split of
    its ``w_in``), and a leaf no dimension of which divides ``dp`` is
    still sliced (padded), where JAX's ``_fsdp_extend`` leaves it whole.
    The moments' step counters live on the host and are not counted.
    ``model``: the config's :func:`_meta_model`, if already built."""
    moment = 2 if str(config.get("moment_dtype", "fp32")) == "bf16" else 4
    total = 0
    for name, p in (model or _meta_model(config)).named_parameters():
        n = p.numel()
        layout = tp_layout(name) if tp > 1 else None
        if layout == "experts" and not expert_parallel(p.shape[0], tp):
            layout = None
        local = n // tp if layout else n
        held = -(-local // dp) if fsdp and dp > 1 and n >= fsdp_min_size else local
        total += held * (p.element_size() + 2 * moment)
    return total


def _buffer_bytes(model: torch.nn.Module) -> int:
    """The model's buffers (masks), which every rank holds whole."""
    return sum(b.numel() * b.element_size() for b in model.buffers())


def _param_bytes(model: torch.nn.Module) -> int:
    """The whole parameters' bytes."""
    return sum(p.numel() * p.element_size() for p in model.parameters())


def _model_facts(config) -> Dict[str, Any]:
    mods = config.modality_config.to_plain()
    # the modality tokens of a sample (the fusion tokens left out, as in
    # the JAX tool): the tensor-parallel traffic estimate reads it
    tokens = sum(int(c.get("pad_len", 0)) for c in mods.values())
    return {"layers": int(config.layers), "heads": int(config.heads),
            "dim": int(config.hidden_size), "tokens_per_sample": tokens,
            "batch": int(config.batch_size)}


def flops_per_step(config) -> float:
    """``6 * parameters * tokens * batch`` (forward 2, backward 4), as the
    JAX tool counts it."""
    facts = _model_facts(config)
    n_params = sum(p.numel() for p in _meta_model(config).parameters())
    return 6.0 * n_params * facts["tokens_per_sample"] * facts["batch"]


# ---------------------------------------------------------------------------
# activation model, per remat mode: c0 + c1 * rows, and the gradient a
# microbatch leaves for the next
# ---------------------------------------------------------------------------


def step_reading(report: Dict[str, Any]) -> float:
    """What one :func:`~mca_tpu_torch.tools.memory_report.step_memory` step
    adds to its state and batch at its peak: ``peak_estimate_bytes`` less
    ``state_bytes`` and ``batch_bytes`` (activations and gradients, and
    what else the allocator holds then: cuBLAS's workspace, the flash
    schedules, its rounding of every block)."""
    return report["peak_estimate_bytes"] - report["state_bytes"] - report["batch_bytes"]


def probe_rows(config, plans: List[Plan]) -> Tuple[int, int]:
    """The two microbatch sizes the activation line is read at: the fewest
    rows any of ``plans`` gives a microbatch (``batch / (dp * grad_accum)``),
    and the config's batch (twice the batch where the two meet)."""
    b = int(config.batch_size)
    lo = min((b // (p.dp * p.grad_accum) for p in plans), default=b)
    return (lo, b) if lo < b else (b, 2 * b)


def _config_file(config, tmp: str) -> str:
    """``config`` written as YAML under ``tmp``, for a ``memory_report``
    process to load."""
    import yaml

    path = os.path.join(tmp, "plan.yaml")
    with open(path, "w") as f:  # unsorted: the modalities' order is the model's
        yaml.safe_dump(config.to_plain(), f, sort_keys=False)
    return path


def _memory_report_cmd(path: str, device: str) -> List[str]:
    return [sys.executable, "-m", "mca_tpu_torch.tools.memory_report", path, "--json",
            "--device", device]


def _report(out: str) -> Dict[str, Any]:
    """The JSON report a ``memory_report --json`` process printed last."""
    return json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1])


def fresh_step_memory(config, grad_accum: int = 1, remat: bool = False, device: str = "cuda",
                      timeout: float = 600.0) -> Dict[str, Any]:
    """:func:`~mca_tpu_torch.tools.memory_report.step_memory` of
    ``config`` (``grad_accum``, ``remat``) in a process of its own, as
    each of a plan's ranks takes its step (:func:`exact_plan_memory`).
    The allocator's peak counts whole blocks, and a cached block may
    serve a request larger than it asks; so a step read after other work
    in one process reads what that work left cached, where a rank starts
    with nothing cached."""
    cfg = type(config)(config)
    cfg.grad_accum = int(grad_accum)
    cfg.remat = bool(remat)
    env = {k: v for k, v in os.environ.items() if k not in ("MCA_COORDINATOR", "MCA_MULTIHOST")}
    env["PYTHONPATH"] = ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory(prefix="plan_reading_") as tmp:
        res = subprocess.run(_memory_report_cmd(_config_file(cfg, tmp), device),
                             capture_output=True, text=True, timeout=timeout, env=env)
    if res.returncode != 0:
        raise RuntimeError(f"memory_report exited {res.returncode}: {res.stderr[-2000:]}")
    return _report(res.stdout)


def fit_activation_model(config, remat: bool, rows: Tuple[int, int],
                         device: str = "cuda") -> Tuple[float, float, float]:
    """``(c0, c1, accum)`` from one-process steps on ``device``, each in a
    process of its own (:func:`fresh_step_memory`; the allocator's peak:
    the CPU keeps none, so this raises): the line through
    :func:`step_reading` at the two microbatch sizes ``rows``
    (:func:`probe_rows`), and ``accum``, what ``grad_accum: 2`` over
    microbatches of the fewer rows adds to one such microbatch's reading:
    the gradient the first microbatch leaves while the second runs (a
    rank's own buffer under ``grad_accum`` > 1)."""
    return fit_activation_models(config, rows, device=device, remats=(remat,))[remat]


def fit_activation_models(config, rows: Tuple[int, int], device: str = "cuda",
                          remats: Tuple[bool, ...] = (False, True),
                          jobs: int = 1) -> Dict[bool, Tuple[float, float, float]]:
    """:func:`fit_activation_model` for each of ``remats``, its readings
    run ``jobs`` processes at a time (each process holds its own step's
    memory on the card; a process's peak is its own, so the readings do
    not depend on ``jobs``)."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("the activation model is measured on the card: pass "
                           "act_models to plan on the CPU")
    lo = min(rows)
    asks = [(r, int(n), 1) for r in remats for n in rows] + [(r, lo, 2) for r in remats]

    def reading(ask) -> float:
        remat, n, accum = ask
        cfg = type(config)(config)
        cfg.batch_size = n * accum
        return step_reading(fresh_step_memory(cfg, grad_accum=accum, remat=remat, device=device))

    with ThreadPoolExecutor(max_workers=max(1, int(jobs))) as pool:
        got = dict(zip(asks, pool.map(reading, asks)))
    out = {}
    for r in remats:
        readings = {int(n): got[(r, int(n), 1)] for n in rows}
        out[r] = (*activation_model(readings), max(got[(r, lo, 2)] - readings[lo], 0.0))
    return out


def activation_model(temps: Dict[int, float]) -> Tuple[float, float]:
    """``(c0, c1)`` of the line through two ``{rows: bytes}`` readings."""
    (b1, t1), (b2, t2) = sorted(temps.items())
    c1 = (t2 - t1) / float(b2 - b1)
    return max(t1 - c1 * b1, 0.0), max(c1, 0.0)


# ---------------------------------------------------------------------------
# enumeration + scoring
# ---------------------------------------------------------------------------


def port_refusal(config, plan: Plan) -> Optional[str]:
    """Why the port's trainer refuses ``plan`` for ``config`` (its
    ``check_training_keys``, ``check_mesh_keys`` and per-rank
    ``grad_accum`` check), or None.  Of the JAX tool's plans it refuses
    two kinds: ``seq_shard`` (every ``tp > 1`` plan) beside ``mesh_pipe >
    1``, and a pipe whose microbatches (one a stage) do not divide
    ``batch_size / grad_accum``."""
    from mca_tpu_torch.train import check_mesh_keys, check_training_keys

    cfg = _plan_config(config, plan)
    try:
        check_training_keys(cfg)
        check_mesh_keys(cfg)
        if (int(cfg.batch_size) // plan.dp) % plan.grad_accum:
            raise ValueError(f"grad_accum={plan.grad_accum} must divide the per-rank batch")
    except ValueError as e:
        return str(e)
    return None


def enumerate_plans(config, n_devices: int, max_grad_accum: int = 16,
                    allow_pp: bool = True) -> List[Plan]:
    """The JAX tool's plans, in its order, less those the port refuses
    (:func:`port_refusal`)."""
    facts = _model_facts(config)
    batch = facts["batch"]
    plans: List[Plan] = []
    for dp in _divisors(n_devices):
        if batch % dp:
            continue
        for tp in _divisors(n_devices // dp):
            if facts["heads"] % tp:
                continue
            for pp in _divisors(n_devices // (dp * tp)):
                if dp * tp * pp != n_devices:
                    continue  # never leave chips idle
                if pp > 1 and (not allow_pp or facts["layers"] % pp):
                    continue
                per_dp = batch // dp
                for ga in (g for g in (1, 2, 4, 8, 16) if g <= max_grad_accum and per_dp % g == 0):
                    for remat in (False, True):
                        for fsdp in ((False, True) if dp > 1 else (False,)):
                            plans.append(Plan(dp=dp, tp=tp, pp=pp, fsdp=fsdp, grad_accum=ga,
                                              remat=remat, seq_shard=tp > 1))
    return [p for p in plans if port_refusal(config, p) is None]


def score_plans(
    plans: List[Plan],
    config,
    *,
    hbm_bytes: float,
    act_models: Dict[bool, Tuple[float, ...]],
    batch_bytes_full: int,
    flops_per_step: float,
    hardware: Hardware = H100,
    param_bytes: Optional[int] = None,
) -> List[Plan]:
    """Fill memory and step-time estimates in place (the JAX tool's
    formulas over ``hardware``); return the plans best first (those that
    fit first, then the fastest estimate).  ``act_models``: ``{remat:
    (c0, c1)}``, the JAX tool's activation line, or ``(c0, c1, accum)``
    from :func:`fit_activation_model`, whose ``accum`` a plan with
    ``grad_accum`` > 1 adds to its activations.  ``param_bytes`` (the
    whole parameters' bytes, which an fsdp step gathers) defaults to the
    config's."""
    facts = _model_facts(config)
    tokens, layers = facts["tokens_per_sample"], facts["layers"]
    model = _meta_model(config)
    if param_bytes is None:
        param_bytes = _param_bytes(model)
    state = {}
    for p in plans:
        key = (p.dp, p.tp, p.fsdp)
        if key not in state:
            state[key] = _sharded_bytes(config, p.dp, p.tp, p.fsdp, model=model) \
                + _buffer_bytes(model)
        p.state_bytes = state[key]
        c0, c1, *accum = act_models[p.remat]
        rows = facts["batch"] // (p.dp * p.grad_accum)
        act = c0 + c1 * rows
        if p.pp > 1:
            # a stage holds 1/pp of the blocks; with M = S microbatches of
            # rows/M each, S are live at the bubble's peak: ~act/pp
            act = act / p.pp
        if p.seq_shard and p.tp > 1:
            # sequence shards between blocks; the attention's workspace
            # does not shrink: halve the linear term's share
            act = c0 + (c1 * rows) * (0.5 + 0.5 / p.tp)
        if accum and p.grad_accum > 1:
            act += accum[0]
        p.act_bytes = int(act)
        p.batch_bytes = batch_bytes_full // p.dp
        p.peak_bytes = p.state_bytes + p.act_bytes + p.batch_bytes
        p.fits = p.peak_bytes <= hbm_bytes * hardware.hbm_safety

        # step-time estimate (relative ranking, not a promise)
        compute_s = flops_per_step / (p.dp * p.tp * p.pp * hardware.peak_flops * hardware.mfu)
        if p.remat:
            compute_s *= hardware.remat_cost
        if p.pp > 1:
            micro = max(p.pp, 1)  # pipeline_microbatches default: S
            compute_s *= (micro + p.pp - 1) / micro
        comm_s = 0.0
        if p.tp > 1:
            # 2 all-reduces a layer (forward and backward double it) of
            # the rank's activation block [rows * tokens, dim] in bf16
            bytes_ar = 4 * layers * (facts["batch"] // p.dp) * tokens * facts["dim"] * 2
            comm_s += bytes_ar * (p.tp - 1) / p.tp / hardware.link_bytes_per_s
        if p.fsdp:
            # the parameters gathered (forward) and the gradient
            # reduce-scattered (backward) against DP's all-reduce: about
            # the same bytes; count the gather once
            comm_s += param_bytes / hardware.link_bytes_per_s
        p.est_step_ms = (compute_s + comm_s) * 1e3
    plans.sort(key=lambda p: (not p.fits, p.est_step_ms, p.peak_bytes))
    return plans


# ---------------------------------------------------------------------------
# measured: the plan's ranks, one memory_report step each
# ---------------------------------------------------------------------------


def exact_plan_memory(config, plan: Plan, device: str = "cuda", timeout: float = 600.0,
                      log_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Run ``plan``'s ``dp * tp`` ranks (``mca_tpu_torch.parallel.launch``),
    each taking one :func:`~mca_tpu_torch.tools.memory_report.step_memory`
    step of its share; returns each rank's report, in rank order.  On
    CUDA the ranks talk over NCCL, one a card, where the host has a card a
    rank, and over gloo on the cards there are otherwise (a rank on card
    ``rank`` modulo their count).  Plans with a pipe are not measured
    here, as in the JAX tool."""
    from mca_tpu_torch.parallel import launch as launch_lib

    if plan.pp != 1:
        raise ValueError("exact verification covers dp / tp / fsdp plans")
    n = plan.dp * plan.tp
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda and torch.cuda.device_count() >= n else "gloo"
    with tempfile.TemporaryDirectory(prefix="plan_exact_") as tmp:
        outs = launch_lib.launch(
            _memory_report_cmd(_config_file(_plan_config(config, plan), tmp), device), n,
            timeout=timeout, log_dir=log_dir,
            env={"MCA_DIST_BACKEND": backend,
                 "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")})
    return [{**_report(out), "dist_backend": backend} for out in outs]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def plan(
    config,
    n_devices: int,
    hbm_gb: float = 80.0,
    topk: int = 5,
    exact: bool = False,
    max_grad_accum: int = 16,
    allow_pp: bool = True,
    act_models: Optional[Dict[bool, Tuple[float, ...]]] = None,
    device: str = "cuda",
    hardware: Hardware = H100,
    reading_jobs: int = 1,
) -> List[Plan]:
    """Rank parallelism plans for ``config`` on ``n_devices`` cards with
    ``hbm_gb`` each.  ``act_models`` (``{remat: (c0, c1[, accum])}``)
    defaults to :func:`fit_activation_models` on ``device``, the card, at
    the plans' :func:`probe_rows`, ``reading_jobs`` readings at a time;
    ``exact`` measures the top plans without a pipe
    (:func:`exact_plan_memory`)."""
    from mca_tpu_torch.tools.memory_report import synthetic_batch

    plans = enumerate_plans(config, n_devices, max_grad_accum=max_grad_accum,
                            allow_pp=allow_pp)
    if act_models is None:
        if torch.device(device).type != "cuda":
            raise RuntimeError("plan_parallel measures its activation model on the card "
                               "(an H100); on the CPU pass act_models")
        act_models = fit_activation_models(config, probe_rows(config, plans), device=device,
                                           jobs=reading_jobs)
    batch = synthetic_batch(config)
    batch_bytes = sum(int(v.nbytes) for f in batch.values() for v in f.values())
    plans = score_plans(plans, config, hbm_bytes=hbm_gb * 2**30, act_models=act_models,
                        batch_bytes_full=batch_bytes, flops_per_step=flops_per_step(config),
                        hardware=hardware)
    if exact:
        for p in plans[:topk]:
            if p.pp == 1:
                p.exact = exact_plan_memory(config, p, device=device)
    return plans


def _fmt_gb(n: float) -> str:
    for div, unit in ((2**30, "G"), (2**20, "M"), (2**10, "K")):
        if n >= div:
            return f"{n / div:.2f}{unit}"
    return f"{int(n)}B"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("--devices", type=int, default=8, help="total cards to plan for")
    p.add_argument("--hbm-gb", type=float, default=80.0, help="memory per card (H100: 80)")
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--exact", action="store_true",
                   help="measure the top plans without a pipe: each plan's ranks take one "
                        "memory_report step")
    p.add_argument("--no-pp", action="store_true", help="exclude pipeline-parallel plans")
    p.add_argument("--max-grad-accum", type=int, default=16)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--reading-jobs", type=int, default=1,
                   help="memory_report processes the activation model runs at once (each "
                        "holds its own step's memory on the card)")
    args = p.parse_args(argv)

    from mca_tpu_torch.config import training_config

    config = training_config(args.config, make_output_dir=False)
    plans = plan(config, args.devices, hbm_gb=args.hbm_gb, topk=args.topk, exact=args.exact,
                 max_grad_accum=args.max_grad_accum, allow_pp=not args.no_pp,
                 device=args.device, reading_jobs=args.reading_jobs)
    top = plans[: args.topk]
    if args.json:
        print(json.dumps([dict(asdict(t), config_stanza=t.config_stanza()) for t in top]))
        return
    print(f"plans for {args.devices} devices x {args.hbm_gb}G (batch {config.batch_size}); "
          f"{len(plans)} enumerated, {sum(p.fits for p in plans)} fit")
    print(f"{'rank':>4} {'dp':>3} {'tp':>3} {'pp':>3} {'fsdp':>5} {'ga':>3} {'remat':>6} "
          f"{'state':>8} {'acts':>8} {'peak':>8} {'fits':>5} {'est ms':>8}")
    for i, t in enumerate(top):
        print(f"{i:>4} {t.dp:>3} {t.tp:>3} {t.pp:>3} {str(t.fsdp):>5} {t.grad_accum:>3} "
              f"{str(t.remat):>6} {_fmt_gb(t.state_bytes):>8} {_fmt_gb(t.act_bytes):>8} "
              f"{_fmt_gb(t.peak_bytes):>8} {str(t.fits):>5} {t.est_step_ms:>8.1f}")
        for r, rep in enumerate(t.exact or []):
            print(f"     rank {r} measured: resident {_fmt_gb(rep['resident_bytes'])} "
                  f"(state {_fmt_gb(rep['state_bytes'])}) temp "
                  f"{_fmt_gb(rep['temp_size_in_bytes'])} peak "
                  f"{_fmt_gb(rep['peak_estimate_bytes'])}")
    best = next((t for t in top if t.fits), None)
    if best is None:
        print("no plan fits: raise grad_accum / remat limits, add cards, or shrink the batch")
        return
    print("recommended config stanza:")
    for k, v in best.config_stanza().items():
        print(f"  {k}: {v}")


if __name__ == "__main__":
    main()
