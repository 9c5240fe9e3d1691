"""MCA pretraining steps on the GPU, ported from the core of ``mca_tpu/train.py``.

    python -m mca_tpu_torch.train configs/tcga_mca.yaml --synthetic 64 \\
        --steps 10 [--device cpu] [--metrics out.jsonl]

One step is the JAX package's ``_step_body``: the MCA forward with the
loss graph, backward (through the flash-attention backward kernels on
CUDA), the global gradient norm, optional global-norm clipping with
optax's semantics, AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01
on every parameter) under the HF learning-rate schedule, then the
clamp of ``logit_scale`` to ``[LOGIT_SCALE_MIN, LOGIT_SCALE_MAX]``.  It
returns the JAX step's metrics: ``total_loss``, the per-pair losses
whose names have no ``|``, ``fcl_loss``, ``no-fcl_loss``, ``param_norm``
(after the update), ``grad_norm`` (before clipping) and ``lr``.

The model is built with the unfused, differentiable feed-forward, as
the JAX package trains (``MCA_FUSED_FF=0``).  Parameters and optimizer
state are fp32; ``precision: bf16`` runs the transformer blocks in
bf16.  The entry point runs on ``cuda`` and raises without one; pass
``--device cpu`` for the plain versions.

Data: ``--synthetic N`` trains on N TCGA-shaped rows from
:func:`mca_tpu_torch.data.synthetic.make_tcga_like` (p_missing 0.25),
cycled in batches of ``batch_size``.  The HF on-disk dataset loader,
checkpointing / ``--restart``, the eval loop, gradient accumulation
(``grad_accum``) and half-width moments (``moment_dtype: bf16``) are not
ported yet: a config that asks for the last two is refused.

``halt_on_nan`` (default true) stops :func:`train` with
:class:`DivergenceError` at the first step whose ``total_loss`` or
``grad_norm`` is not finite, as the JAX package does.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mca_tpu_torch.config import get_model_config
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.synthetic import make_tcga_like
from mca_tpu_torch.losses import LOGIT_SCALE_MAX, LOGIT_SCALE_MIN
from mca_tpu_torch.models import MCA, build_model


class DivergenceError(RuntimeError):
    """Raised by the ``halt_on_nan`` guard when ``total_loss`` or
    ``grad_norm`` goes non-finite (``mca_tpu.train.DivergenceError``):
    from that step on every gradient and parameter is NaN.  The JAX
    package also saves the diverged state for inspection; that waits for
    the port of checkpointing."""


def check_training_keys(config) -> None:
    """Refuse the training keys the port does not honour yet, rather
    than train something other than the config asks for: ``grad_accum``
    other than 1 (the JAX package takes microbatch-local losses) and
    ``moment_dtype: bf16`` raise ``NotImplementedError``; a
    ``moment_dtype`` other than fp32 or bf16 raises ``ValueError``, as
    the JAX package does."""
    grad_accum = int(config.get("grad_accum", 1) or 1)
    if grad_accum != 1:
        raise NotImplementedError(
            f"grad_accum: {grad_accum}: gradient accumulation over "
            "microbatch-local losses is not ported yet"
        )
    moment_dtype = str(config.get("moment_dtype", "fp32"))
    if moment_dtype == "bf16":
        raise NotImplementedError(
            "moment_dtype: bf16: half-width AdamW moments are not ported yet"
        )
    if moment_dtype != "fp32":
        raise ValueError(f"moment_dtype must be fp32 or bf16, got {moment_dtype!r}")


def check_finite(metrics: Mapping[str, float], step: int) -> None:
    """The ``halt_on_nan`` guard: raises :class:`DivergenceError` when
    ``total_loss`` or ``grad_norm`` is not finite.  ``grad_norm`` is the
    signal to trust: once the parameters are NaN the NaN-safe pair
    averaging reports a total_loss of 0.0."""
    for name in ("total_loss", "grad_norm"):
        val = float(metrics[name])
        if not math.isfinite(val):
            raise DivergenceError(
                f"{name} is {val} at step {step} — diverged "
                "(halt_on_nan: false to disable this guard)"
            )


def hf_lr_factor(
    kind: str, num_warmup_steps: int, num_training_steps: int
) -> Callable[[int], float]:
    """The multiplier of ``lr`` at a step (``transformers.get_scheduler``
    semantics: linear warmup, then cosine / linear / constant decay)."""
    if kind not in ("cosine", "linear", "constant_with_warmup", "constant"):
        raise ValueError(f"unknown lr_scheduler_type {kind!r}")

    def factor(step: int) -> float:
        if kind == "constant":
            return 1.0
        if step < num_warmup_steps:
            return step / max(num_warmup_steps, 1)
        progress = (step - num_warmup_steps) / max(
            num_training_steps - num_warmup_steps, 1
        )
        progress = min(max(progress, 0.0), 1.0)
        if kind == "cosine":
            return 0.5 * (1.0 + math.cos(math.pi * progress))
        if kind == "linear":
            return 1.0 - progress
        return 1.0

    return factor


def hf_lr_schedule(
    kind: str, lr: float, num_warmup_steps: int, num_training_steps: int
) -> Callable[[int], float]:
    """``step -> lr * factor(step)`` (``mca_tpu.train.hf_lr_schedule``)."""
    factor = hf_lr_factor(kind, num_warmup_steps, num_training_steps)
    return lambda step: lr * factor(step)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


def clip_by_global_norm(
    grads: Sequence[torch.Tensor], max_norm: float, norm: torch.Tensor
) -> None:
    """optax's ``clip_by_global_norm`` in place: the gradients are
    scaled by ``max_norm / norm`` only where ``norm`` exceeds
    ``max_norm`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(factor)


@torch.no_grad()
def clamp_logit_scale(model: torch.nn.Module) -> None:
    """Post-update clamp of every ``logit_scale*`` parameter."""
    for name, p in model.named_parameters():
        if "logit_scale" in name:
            p.clamp_(LOGIT_SCALE_MIN, LOGIT_SCALE_MAX)


def make_optimizer(
    model: torch.nn.Module, config, num_training_steps: int
):
    """AdamW with the torch defaults the JAX package copies (weight decay
    0.01 on every parameter) and the HF schedule as a ``LambdaLR``:
    ``schedule.get_last_lr()[0]`` is the rate of the next step."""
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=float(config.lr), betas=(0.9, 0.999),
        eps=1e-8, weight_decay=0.01,
    )
    schedule = torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        hf_lr_factor(
            config.lr_scheduler_type, int(config.num_warmup_steps),
            num_training_steps,
        ),
    )
    return optimizer, schedule


def scalar_losses(out: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``total_loss``, the per-pair losses whose names have no ``|`` (the
    reference's logging filter) and the FCL aggregates."""
    scal = {"total_loss": out["loss"]}
    scal.update({k: v for k, v in out["losses"].items() if "|" not in k})
    for k in ("fcl_loss", "no-fcl_loss"):
        if k in out:
            scal[k] = out[k]
    return scal


def forward_backward(model: MCA, batch) -> Dict[str, Any]:
    """The loss forward and its backward: every parameter ends with a
    ``.grad`` (zeros where the loss does not reach it, so AdamW decays
    it as optax does).  Returns the model's output dict."""
    for p in model.parameters():
        p.grad = None
    out = model(batch, no_loss=False)
    out["loss"].backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return out


def train_step(
    model: MCA,
    optimizer: torch.optim.Optimizer,
    schedule,
    batch,
    clip: float = 0.0,
) -> Dict[str, float]:
    """One training step (``mca_tpu.train._step_body``); returns the
    step's metrics as floats."""
    lr = schedule.get_last_lr()[0]
    out = forward_backward(model, batch)
    grads = [p.grad for p in model.parameters()]
    grad_norm = global_norm(grads)
    if clip:
        clip_by_global_norm(grads, float(clip), grad_norm)
    optimizer.step()
    schedule.step()
    clamp_logit_scale(model)
    with torch.no_grad():
        param_norm = global_norm(list(model.parameters()))
    scal = scalar_losses(out)
    names = list(scal) + ["param_norm", "grad_norm"]
    values = torch.stack(
        [v.detach().float() for v in scal.values()] + [param_norm, grad_norm]
    ).tolist()
    return {**dict(zip(names, values)), "lr": lr}


def require_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port trains on the GPU; pass "
            "device='cpu' to run the plain versions on the CPU"
        )
    return dev


def build_trainer(
    config,
    device: str = "cuda",
    num_training_steps: int = 1000,
    seed: int = 0,
    params: Optional[Mapping[str, Any]] = None,
):
    """``(model, optimizer, schedule)`` on ``device``: the model built
    for training (unfused feed-forward) with random weights from
    ``seed``, or ``params`` (a state dict under the port's names).
    Refuses the keys :func:`check_training_keys` names."""
    check_training_keys(config)
    dev = require_device(device)
    model = build_model(get_model_config(config), fused_ff=False)
    if params is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(
            {k: torch.as_tensor(v) for k, v in params.items()}, strict=True
        )
    model.to(dev).train()
    optimizer, schedule = make_optimizer(model, config, num_training_steps)
    return model, optimizer, schedule


def synthetic_rows(config, n: int, seed: int = 0) -> List[Dict[str, Any]]:
    """``n`` TCGA-shaped rows at the config's modality widths, with a
    quarter of the modalities missing (what ``bench.py`` trains on)."""
    widths = {m: int(c["pad_len"]) for m, c in config.modality_config.items()}
    return make_tcga_like(n, widths=widths, p_missing=0.25, seed=seed)


def batches(config, rows: Sequence[Dict[str, Any]], device) -> Iterator[dict]:
    """Full batches of ``batch_size`` rows in order, cycling, collated
    and on ``device``."""
    bs = int(config.batch_size)
    if len(rows) < bs:
        raise ValueError(f"{len(rows)} rows make no batch of {bs}")
    modalities = config.modality_config
    collate = MultimodalCollator(
        modalities.to_plain() if hasattr(modalities, "to_plain") else dict(modalities)
    )
    while True:
        for i in range(0, len(rows) - bs + 1, bs):
            yield to_device(collate(rows[i : i + bs]), device)


def to_device(batch: Mapping[str, Mapping[str, np.ndarray]], device) -> dict:
    return {
        m: {k: torch.from_numpy(v).to(device) for k, v in fields.items()}
        for m, fields in batch.items()
    }


def train(
    config,
    device: str = "cuda",
    steps: Optional[int] = None,
    rows: Optional[Sequence[Dict[str, Any]]] = None,
    seed: int = 0,
    log: Optional[Callable[[Dict[str, float]], None]] = None,
) -> List[Dict[str, float]]:
    """Train on ``rows`` for ``steps`` steps (default: ``epochs`` passes
    over the rows); ``log`` gets each step's metrics.  Returns them.

    With ``halt_on_nan`` (the default) a step whose ``total_loss`` or
    ``grad_norm`` is not finite is logged, then :class:`DivergenceError`
    is raised.  The metrics are floats already (one ``.tolist()`` a
    step), so the guard adds no device sync."""
    dev = require_device(device)
    if rows is None:
        raise NotImplementedError(
            f"dataset {config.get('dataset')!r}: the HF on-disk dataset "
            "loader (mca_tpu.data.dataset.setup_data, datasets."
            "load_from_disk) is not ported yet; pass synthetic rows "
            "(--synthetic N)"
        )
    if steps is None:
        steps = int(config.epochs) * (len(rows) // int(config.batch_size))
    model, optimizer, schedule = build_trainer(
        config, device, num_training_steps=steps, seed=seed
    )
    halt_on_nan = bool(config.get("halt_on_nan", True))
    history = []
    data = batches(config, rows, dev)
    for step in range(steps):
        metrics = train_step(
            model, optimizer, schedule, next(data), clip=float(config.clip or 0.0)
        )
        metrics["step"] = step
        history.append(metrics)
        if log is not None:
            log(metrics)
        if halt_on_nan:
            check_finite(metrics, step)
    return history


def main(argv=None) -> None:
    from mca_tpu_torch.config import training_config

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", help="train yaml")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic TCGA-shaped rows")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--metrics", default=None,
                   help="JSONL file for the per-step metrics (default: stdout)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    config = training_config(args.config)
    rows = synthetic_rows(config, args.synthetic) if args.synthetic else None
    sink = open(args.metrics, "w") if args.metrics else sys.stdout
    try:
        train(
            config, device=args.device, steps=args.steps, rows=rows,
            seed=args.seed,
            log=lambda m: print(json.dumps(m), file=sink, flush=True),
        )
    finally:
        if sink is not sys.stdout:
            sink.close()


if __name__ == "__main__":
    main()
