"""MCA pretraining on the GPU, ported from ``mca_tpu/train.py``.

    python -m mca_tpu_torch.train cfg.yaml [--device cpu] [--synthetic N]

:func:`train` is ``mca_tpu.train.train``: the HF on-disk dataset
(``dataset:``) split by ``split`` / ``ds_seed``, batches reshuffled
every epoch from ``seed``, ``epochs`` passes with an eval pass after
each (``run_eval_loop``), a checkpoint per epoch under
``output_dir/<epoch>`` (the newest ``checkpoint_keep`` kept) and every
``n_step_checkpoint`` steps under ``output_dir``, ``restart:`` from
either (a step inside an epoch resumes there, skipping the batches
already trained), the final parameters under ``output_dir/model`` and
``output_dir/model.safetensors``, and every record in
``output_dir/metrics.jsonl``.  ``--synthetic N`` trains on N rows made
from ``seed`` instead of ``dataset:``, TCGA-shaped or CMU-MOSEI-shaped
as the config's modalities are (:func:`synthetic_rows`).

One step is the JAX package's ``_step_body``: the MCA forward with the
loss graph, backward (through the flash-attention backward kernels on
CUDA), the global gradient norm, optional global-norm clipping with
optax's semantics, AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 0.01
on every parameter) under the HF learning-rate schedule, then the
clamp of ``logit_scale`` to ``[LOGIT_SCALE_MIN, LOGIT_SCALE_MAX]``.
``grad_accum: N`` splits the batch into N strided microbatches (rows
``i, i+N, ...``), each with its own contrastive loss, and averages their
gradients; ``moment_dtype: bf16`` stores AdamW's moments in bf16
(:class:`AdamW`); ``remat: true`` recomputes each block's activations
in the backward.  The model is built with the unfused, differentiable
feed-forward, as the JAX package trains (``MCA_FUSED_FF=0``).
Parameters are fp32; ``precision: bf16`` runs the blocks in bf16.
``stage_dtype: fp16 | bf16`` narrows each training batch's float
columns on the host before the copy to the device and restores fp32
there (:func:`narrow_for_staging`, :func:`to_device`).  Encoder dropout
draws from one ``torch.Generator`` a step (and microbatch) derived from
``seed`` (:func:`dropout_generator`); eval, ``infer`` and ``serve``
never draw.

Guards: ``halt_on_nan`` (default true) saves the diverged state to
``output_dir/diverged`` and raises :class:`DivergenceError` at the
first step whose ``total_loss`` or ``grad_norm`` is not finite;
``preempt_save`` (default true) turns SIGTERM into a checkpoint under
``output_dir``, a ``preempted.json`` marker and :class:`PreemptedError`
at the next step boundary (the CLI exits 75).

Several ranks (:mod:`mca_tpu_torch.parallel`; the CLI joins them with
``init_multihost``, from ``MCA_COORDINATOR`` / ``MCA_NUM_PROCESSES`` /
``MCA_PROCESS_ID`` or ``torchrun``'s ``MCA_MULTIHOST=auto``) train on a
``mesh_data x mesh_model x mesh_pipe`` mesh as the JAX package trains on
its device mesh: every rank runs the same loader and keeps its block of
each global batch; the contrastive loss is computed on the global batch
(gathered over ``data``); the gradient is averaged over ``data``; the
attention is tensor-parallel by heads over ``model``, with the residual
stream sharded over ``model`` under ``seq_shard``, and a MoE block's
experts are split over ``model`` where they divide by it; ``mesh_pipe >
1`` runs the MCA block stack as a GPipe pipeline of
``pipeline_microbatches`` over ``pipe`` (EAO ignores it, as in the JAX
package, and runs whole on every stage); ``fsdp`` is ZeRO-3: the large
leaves and their AdamW moments live on a rank only as its ``1 / data``
slice, each module group gathers its weights for its forward and again
for its backward, and reduce-scatters its gradient
(:class:`~mca_tpu_torch.parallel.sharding.ShardedOptimizer`).  The
global norms, clipping and the logit-scale clamp see the whole set, so
a step is the single-process step up to summation order.  Rank 0 writes
the log and whole-state checkpoints (in the single-process format, so a
run restarts at any world size and layout); ``halt_on_nan`` and
preemption stop every rank together.  Encoder dropout draws per data
rank.

``steps_per_call``, ``flat_state`` and ``fuse_optimizer`` choose how
the JAX package dispatches XLA, not what is trained; they have no
counterpart here and are ignored.  ``trace_dir`` wraps the second step
of the run in a ``torch.profiler`` window, as the JAX package traces its
second launch, and writes it there as a Chrome trace
(``step<N>.rank<r>.json``, :func:`~mca_tpu_torch.utils.trace.trace_context`), where the
recorder's spans show as ``mca.*`` ranges (:mod:`mca_tpu_torch.utils.trace`:
``data.collate``, ``data.copy``, ``train.step``, ``train.forward``,
``train.backward``, ``train.grad_reduce``, ``train.optimizer``,
``train.readback``).
A mesh larger than the world, a depth that
does not divide by ``mesh_pipe``, a batch that does not divide by the
microbatches and ``seq_shard`` with ``mesh_pipe > 1`` raise
``ValueError``, as the JAX package's asserts refuse them.  The entry
point runs on ``cuda`` and raises without one; pass ``--device cpu`` for
the plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import shutil
import signal
import sys
import threading
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from mca_tpu_torch import checkpoint
from mca_tpu_torch.config import get_model_config
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.dataset import BatchedLoader, setup_data
from mca_tpu_torch.data.synthetic import make_cmu_like, make_tcga_like
from mca_tpu_torch.eval_metrics import epoch_metrics
from mca_tpu_torch.losses import LOGIT_SCALE_MAX, LOGIT_SCALE_MIN
from mca_tpu_torch.models import MCA, build_model
from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel.mesh import Mesh, make_mesh
from mca_tpu_torch.parallel.multihost import (init_multihost, is_primary, make_stager,
                                              process_index, require_output_dir)
from mca_tpu_torch.parallel.pipeline import check_pipeline
from mca_tpu_torch.parallel.sharding import ShardedOptimizer, shard_state_dict
from mca_tpu_torch.utils import trace
from mca_tpu_torch.utils.logging import JSONLLogger, NullLogger, ThroughputMeter

logger = logging.getLogger(__name__)


class DivergenceError(RuntimeError):
    """Raised by the ``halt_on_nan`` guard when ``total_loss`` or
    ``grad_norm`` goes non-finite (``mca_tpu.train.DivergenceError``):
    from that step on every gradient and parameter is NaN.  The state
    at that step is saved to ``output_dir/diverged`` first."""


class PreemptedError(RuntimeError):
    """Raised after SIGTERM at a step boundary, once the train state is
    saved under ``output_dir`` (``restart: <output_dir>`` continues the
    same trajectory) and ``preempted.json`` is written."""

    def __init__(self, step: int, path: str):
        super().__init__(
            f"preempted at step {step}; state saved to {path} "
            f"(resume with restart: {path})"
        )
        self.step = step
        self.path = path


def plain(c) -> Dict[str, Any]:
    return c.to_plain() if hasattr(c, "to_plain") else dict(c)


#: ``stage_dtype`` values: fp32 copies the batches as collated
STAGE_DTYPES = ("fp32", "", None, "fp16", "bf16")
_NARROW = {"fp16": torch.float16, "bf16": torch.bfloat16}
# the reference's pad / missing marker, where a modality_config names none
_DEFAULT_PAD_TOKEN = -10000.0


def check_mesh_keys(config) -> None:
    """Refuse, before anything is read, what the JAX package's pipeline
    asserts refuse where ``mesh_pipe > 1`` pipelines an MCA stack
    (:func:`mca_tpu_torch.parallel.pipeline.check_pipeline`): ``layers``
    not divisible by ``mesh_pipe``, ``batch_size`` (over ``grad_accum``,
    which :func:`check_training_keys` has seen divide it) not divisible by
    ``pipeline_microbatches`` (0 = one a stage), and ``seq_shard`` beside
    it, each a ``ValueError``.  :func:`training_mesh` runs it after the
    mesh, in the JAX package's order."""
    pipe = int(config.get("mesh_pipe", 1) or 1)
    if pipe > 1 and not config.get("eao", False):
        if config.get("seq_shard", False):
            raise ValueError("seq_shard and mesh_pipe > 1 (pipeline stages) are "
                             "mutually exclusive")
        bs, n_accum = int(config.batch_size), int(config.get("grad_accum", 1) or 1)
        # the pipeline sees one accumulation microbatch at a time
        check_pipeline(int(config.layers), bs // n_accum, pipe,
                       int(config.get("pipeline_microbatches", 0) or 0))


def training_mesh(config, device) -> Mesh:
    """The ``mesh_data x mesh_model x mesh_pipe`` mesh over the process
    group's ranks (:func:`mca_tpu_torch.parallel.mesh.make_mesh`,
    ``mesh_data: 0`` = every rank the other axes leave); one process gets
    the single mesh.  A mesh larger than the world raises ``ValueError``,
    then :func:`check_mesh_keys` refuses what the pipeline cannot run."""
    mesh = make_mesh(config.get("mesh_data", 0), config.get("mesh_model", 1),
                     batch_size=int(config.batch_size), pipe=config.get("mesh_pipe", 1),
                     device=torch.device(device).type)
    check_mesh_keys(config)
    return mesh


def check_training_keys(config) -> None:
    """Refuse what the port cannot train as asked, as the JAX package
    does: ``grad_accum`` that does not divide ``batch_size``, a
    ``moment_dtype`` other than fp32 or bf16, a ``stage_dtype`` other
    than fp32, fp16 or bf16 raise ``ValueError``.  The mesh and the
    pipeline are checked next (:func:`training_mesh`)."""
    n_accum = int(config.get("grad_accum", 1) or 1)
    if n_accum < 1 or int(config.batch_size) % n_accum:
        raise ValueError(
            f"grad_accum={n_accum} must divide batch_size={config.batch_size}"
        )
    moment_dtype = str(config.get("moment_dtype", "fp32"))
    if moment_dtype not in ("fp32", "bf16"):
        raise ValueError(f"moment_dtype must be fp32 or bf16, got {moment_dtype!r}")
    stage_dtype = config.get("stage_dtype", "fp32")
    if stage_dtype not in STAGE_DTYPES:
        raise ValueError(f"stage_dtype must be fp32, fp16 or bf16, got {stage_dtype!r}")


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


class AdamW(torch.optim.Optimizer):
    """AdamW with optax's arithmetic (``optax.adamw``: moments, bias
    correction, ``m / (sqrt(v) + eps) + wd * p`` scaled by ``-lr``) whose
    moments are stored in ``moment_dtype``: each update upcasts them to
    fp32, computes in fp32 from the unrounded new moments, and rounds
    the new moments back for storage (``mca_tpu.train._with_state_dtype``).
    ``torch.optim.AdamW`` keeps its moments in the parameters' dtype, so
    the port uses it for ``moment_dtype: fp32`` and this for bf16."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01, moment_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay))
        self.moment_dtype = moment_dtype

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            lr, (b1, b2) = group["lr"], group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p, dtype=self.moment_dtype)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=self.moment_dtype)
                st["step"] += 1
                t = int(st["step"])
                g = p.grad.float()
                mu = g * (1 - b1) + st["exp_avg"].float() * b1
                nu = g.square() * (1 - b2) + st["exp_avg_sq"].float() * b2
                u = (mu / (1 - b1**t)) / ((nu / (1 - b2**t)).sqrt() + group["eps"])
                p.add_((u + group["weight_decay"] * p) * -lr)
                st["exp_avg"].copy_(mu)
                st["exp_avg_sq"].copy_(nu)

    def load_state_dict(self, state_dict):
        # the base class casts floating state to the parameters' dtype
        super().load_state_dict(state_dict)
        for st in self.state.values():
            for k in ("exp_avg", "exp_avg_sq"):
                st[k] = st[k].to(self.moment_dtype)


def make_adamw(params, config) -> torch.optim.Optimizer:
    """AdamW with the torch defaults the JAX package copies (weight decay
    0.01 on every parameter; ``moment_dtype: bf16`` takes :class:`AdamW`)
    over ``params``."""
    kwargs = dict(lr=float(config.lr), betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    if str(config.get("moment_dtype", "fp32")) == "bf16":
        return AdamW(params, moment_dtype=torch.bfloat16, **kwargs)
    return torch.optim.AdamW(params, **kwargs)


def make_optimizer(
    model: torch.nn.Module, config, num_training_steps: int
):
    """:func:`make_adamw` over the model's parameters and the HF schedule
    as a ``LambdaLR``: ``schedule.get_last_lr()[0]`` is the rate of the
    next step."""
    optimizer = make_adamw(model.parameters(), config)
    return optimizer, make_schedule(optimizer, config, num_training_steps)


def make_schedule(optimizer: torch.optim.Optimizer, config, num_training_steps: int):
    """The HF learning-rate schedule of ``config`` as a ``LambdaLR``."""
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer,
        hf_lr_factor(
            config.lr_scheduler_type, int(config.num_warmup_steps),
            num_training_steps,
        ),
    )


def scalar_losses(out: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``total_loss``, the per-pair losses whose names have no ``|`` (the
    reference's logging filter) and the FCL aggregates."""
    scal = {"total_loss": out["loss"]}
    scal.update({k: v for k, v in out["losses"].items() if "|" not in k})
    for k in ("fcl_loss", "no-fcl_loss"):
        if k in out:
            scal[k] = out[k]
    return scal


def staging_sentinels(config) -> Dict[str, Optional[float]]:
    """Per modality, the float value that the model re-detects by exact
    equality on the device (so narrowing must keep it and must not round
    a live value onto it), or None where narrowing is always safe
    (``mca_tpu.train.staging_sentinels``): a ``matrix`` modality's
    ``pad_token`` (the PatchEncoder's patch mask); a ``sequence``
    modality's ``float(padding_idx)`` under a Tabular (-1) or
    SparseTabular (0) encoder (the value encoder's zeroing); None for
    ``embedded_sequence`` (an explicit attention mask) and token-id
    sequences."""
    enc = plain(config.encoder_configs)
    out: Dict[str, Optional[float]] = {}
    for m, c in plain(config.modality_config).items():
        typ, e = c.get("type"), enc.get(m, {})
        if typ == "matrix":
            out[m] = float(e.get("pad_token", c.get("pad_token", _DEFAULT_PAD_TOKEN)))
        elif typ == "sequence" and e.get("type") == "TabularEncoder":
            out[m] = float(e.get("padding_idx", -1))
        elif typ == "sequence" and e.get("type") == "SparseTabularEncoder":
            out[m] = float(e.get("padding_idx", 0))
        else:
            out[m] = None
    return out


def _narrowed(x: float, dtype: torch.dtype) -> float:
    """``x`` as fp32, rounded to ``dtype`` and back."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype).float())


def _pad_representable(pad: float, dtype: torch.dtype) -> bool:
    return _narrowed(pad, dtype) == float(np.float32(pad))


def _nearest_distinct(pad: float, dtype: torch.dtype) -> float:
    """The closest ``dtype`` value that is not ``pad``, toward zero and of
    its sign: where a live value that narrowing rounds onto the sentinel
    is moved to."""
    p32 = np.float32(pad)
    if p32 == 0:
        return float(torch.finfo(dtype).smallest_normal)
    pn = _narrowed(p32, dtype)
    for k in range(12, 5, -1):  # finest first: the nearest distinct value
        c = _narrowed(p32 * np.float32(1 - 2.0**-k), dtype)
        if c != pn:
            return c
    raise ValueError(f"no {dtype} neighbour for pad {pad}")


def narrow_for_staging(batch, stage_dtype, sentinels=None):
    """The host's narrowing of a collated batch before its copy to the
    device (``mca_tpu.train.narrow_for_staging``); :func:`to_device`
    restores fp32 there.  ``fp32`` (or empty) returns ``batch`` as it is.

    ``fp16`` / ``bf16``: float32 columns become that type and int64
    columns int32 (torch tensors on the host); other columns pass.
    ``sentinels`` maps a modality to the float its device path detects
    by equality, or None (:func:`staging_sentinels`); without it every
    modality gets the reference's -10000.  Per modality, and the same
    for every batch: where the narrow type cannot hold the sentinel
    exactly (bf16 rounds -10000 to -9984), its float columns stay fp32;
    otherwise a live value that rounds onto the sentinel is moved one
    step toward zero (:func:`_nearest_distinct`), so no live entry
    becomes padding."""
    if stage_dtype in ("fp32", "", None):
        return batch
    nd = _NARROW[stage_dtype]
    out = {}
    for mod, cols in batch.items():
        pad = _DEFAULT_PAD_TOKEN if sentinels is None else sentinels.get(mod)
        if pad is None:
            pad_ok, bump = True, None  # no float equality on the device
        else:
            pad = float(np.float32(pad))
            pad_ok = _pad_representable(pad, nd)
            bump = _nearest_distinct(pad, nd) if pad_ok else None
        ncols = {}
        for name, x in cols.items():
            x = np.asarray(x)
            if x.dtype == np.float32:
                if not pad_ok:
                    ncols[name] = x  # never narrows
                    continue
                xt = torch.from_numpy(x)
                xn = xt.to(nd)
                if bump is not None:
                    collided = (xn.float() == pad) & (xt != pad)
                    if bool(collided.any()):
                        xn[collided] = bump
                ncols[name] = xn
            elif x.dtype == np.int64:
                ncols[name] = torch.from_numpy(x).to(torch.int32)
            else:
                ncols[name] = x
        out[mod] = ncols
    return out


def dropout_generator(seed: int, step: int, micro: Optional[int], device,
                      rank: Optional[int] = None) -> torch.Generator:
    """The encoders' dropout generator for one step (and microbatch) on
    ``device``, seeded from ``(seed, step[, micro])`` as the JAX package
    folds ``step`` (then ``micro``) into its dropout key, so a restarted
    run draws what the straight run drew; a data rank's ``rank`` enters
    too, so that the ranks' rows draw apart."""
    # micro None and micro 0 must differ: a SeedSequence ignores
    # trailing zero words, so the microbatch enters as micro + 1
    entropy = [int(seed) % 2**32, int(step), 0 if micro is None else int(micro) + 1]
    if rank is not None:
        entropy.append(int(rank) + 1)
    hi, lo = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed((int(hi) << 31) ^ int(lo))
    return gen


def forward_backward(model: MCA, batch, n_accum: int = 1, dropout_seed: int = 0,
                     step: int = 0, dropout_rank: Optional[int] = None,
                     leaves: Optional[Sequence[torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The loss forward and its backward; returns the step's scalar
    losses (:func:`scalar_losses`).  Every leaf that takes a gradient
    (``leaves``, default the model's parameters; a
    :class:`ShardedOptimizer`'s ``opt_params``, slices included) ends with
    a ``.grad`` (zeros where the loss does not reach it, so AdamW decays
    it as optax does).

    ``n_accum > 1`` (``mca_tpu.train._accum_grads``): microbatch ``i``
    is rows ``i, i + n_accum, ...``, each with its own contrastive loss
    (on several data ranks, each rank's block strided so: together the
    global microbatch ``i``, in order, when the block divides by
    ``n_accum``);
    the gradients of the backward passes are summed, then scaled by
    ``1 / n_accum``; each metric is the mean over the microbatches where
    it is finite (a pair absent from one microbatch is NaN there), NaN
    where none had it.  Each forward's encoder dropout draws from
    :func:`dropout_generator` of ``(dropout_seed, step[, microbatch])``."""
    device = next(model.parameters()).device
    leaves = list(model.parameters()) if leaves is None else list(leaves)
    for p in leaves:
        p.grad = None
    if n_accum == 1:
        with trace.span("train.forward", step=step):
            out = model(batch, no_loss=False,
                        generator=dropout_generator(dropout_seed, step, None, device, dropout_rank))
        with trace.span("train.backward", step=step):
            out["loss"].backward()
        scal = {k: v.detach().float() for k, v in scalar_losses(out).items()}
    else:
        total = count = names = None
        for i in range(n_accum):
            with trace.span("train.forward", step=step, micro=i):
                micro = {m: {k: v[i::n_accum] for k, v in f.items()} for m, f in batch.items()}
                out = model(micro, no_loss=False,
                            generator=dropout_generator(dropout_seed, step, i, device,
                                                        dropout_rank))
            with trace.span("train.backward", step=step, micro=i):
                out["loss"].backward()
            s = scalar_losses(out)
            names = list(s)
            v = torch.stack([x.detach().float() for x in s.values()])
            finite = torch.isfinite(v)
            v = torch.where(finite, v, torch.zeros_like(v))
            total = v if total is None else total + v
            count = finite.float() if count is None else count + finite.float()
        mean = torch.where(count > 0, total / count, torch.full_like(total, math.nan))
        scal = dict(zip(names, mean.unbind()))
        for p in leaves:
            if p.grad is not None:
                p.grad.mul_(1.0 / n_accum)
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return scal


def train_step(
    model: MCA,
    optimizer: torch.optim.Optimizer,
    schedule,
    batch,
    clip: float = 0.0,
    n_accum: int = 1,
    dropout_seed: int = 0,
) -> Dict[str, float]:
    """One training step (``mca_tpu.train._step_body``); returns the
    step's metrics as floats.  The step's index for the dropout
    generator is the steps ``schedule`` has taken (restored with it).
    A :class:`ShardedOptimizer` (several ranks) reduces the gradients
    over the mesh first, takes the norms over the whole set and drops
    the gradients after its step.

    Recorded (:mod:`mca_tpu_torch.utils.trace`): ``train.step`` with the
    step's index, timed on a CUDA device from its first launch to the
    launch before the readback; inside it ``train.forward`` and
    ``train.backward`` (one each a microbatch), ``train.optimizer`` (from
    the reduced gradients to the metrics' stack) and ``train.readback``
    (the host's wait for the device)."""
    lr = schedule.get_last_lr()[0]
    sharded = isinstance(optimizer, ShardedOptimizer)
    k = schedule.last_epoch
    with trace.span("train.step", step=k) as sp:
        sp.device_start(next(model.parameters()).device)
        scal = forward_backward(model, batch, n_accum, dropout_seed, k,
                                optimizer.mesh.data_rank if sharded else None,
                                optimizer.opt_params if sharded else None)
        if sharded:
            optimizer.reduce_gradients()
        with trace.span("train.optimizer", step=k):
            if sharded:
                grads = optimizer.gradients()
                norm = optimizer.global_norm
            else:
                grads = [p.grad for p in model.parameters()]
                norm = global_norm
            grad_norm = norm(grads)
            if clip:
                clip_by_global_norm(grads, float(clip), grad_norm)
            optimizer.step()
            schedule.step()
            clamp_logit_scale(model)
            with torch.no_grad():
                param_norm = norm(optimizer.opt_params if sharded else list(model.parameters()))
            names = list(scal) + ["param_norm", "grad_norm"]
            stacked = torch.stack(list(scal.values()) + [param_norm, grad_norm])
        sp.device_end()
        with trace.span("train.readback", step=k):
            values = stacked.tolist()
        trace.RECORDER.settle()
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
    params: Optional[Mapping[str, Any]] = None,
    mesh: Optional[Mesh] = None,
):
    """``(model, optimizer, schedule)`` on ``device``: the model built
    for training (unfused feed-forward) with random weights from
    ``config.seed``, or ``params`` (a state dict under the port's
    names).  Refuses the keys :func:`check_training_keys` names.

    On a mesh of several ranks (``mesh``, else :func:`training_mesh`)
    the model is this rank's part (tensor-parallel attention and its
    experts, the loss gathered over ``data``, ``seq_shard`` where the
    model axis is above 1, the pipelined stack over ``pipe``), loaded
    with its shards of the same whole weights, and the
    optimizer a :class:`ShardedOptimizer` (``fsdp`` on a data axis above
    1: ZeRO-3, the large leaves leave the model for the rank's slices,
    cut on the host before anything moves to ``device``); ``schedule``
    steps the optimizer it wraps."""
    check_training_keys(config)
    dev = require_device(device)
    mesh = mesh if mesh is not None else training_mesh(config, dev)
    n_accum = int(config.get("grad_accum", 1) or 1)
    per_rank = int(config.batch_size) // mesh.data
    if n_accum > 1 and per_rank % n_accum:
        raise ValueError(
            f"grad_accum={n_accum} must divide the per-rank batch {per_rank} "
            f"(batch_size {config.batch_size} over {mesh.data} data ranks)"
        )
    mc = get_model_config(config)
    with trace.span("build.model"):
        model = build_model(mc, fused_ff=False)
    with trace.span("build.weights"):
        if params is None:
            model.init_weights(torch.Generator().manual_seed(int(config.seed)))
        else:
            model.load_state_dict(
                {k: torch.as_tensor(v) for k, v in params.items()}, strict=True
            )
    if mesh.size == 1:
        with trace.span("build.move"):
            model.to(dev).train()
        with trace.span("build.optimizer"):
            optimizer, schedule = make_optimizer(model, config, num_training_steps)
        return model, optimizer, schedule
    seq_shard = bool(mc.get("seq_shard")) and mesh.model > 1
    with trace.span("build.model"):
        whole = model.state_dict()
        model = build_model(dict(mc, data_group=mesh.data_group, model_group=mesh.model_group,
                                 pipe_group=mesh.pipe_group, seq_shard=seq_shard),
                            fused_ff=False)
    with trace.span("build.weights"):
        model.load_state_dict(shard_state_dict(whole, mesh), strict=True)
        del whole
    # sliced on the host, then moved: no whole large leaf reaches the card
    with trace.span("build.optimizer"):
        optimizer = ShardedOptimizer(model, mesh, lambda ps: make_adamw(ps, config),
                                     fsdp=bool(config.get("fsdp", False)), seq_shard=seq_shard,
                                     device=dev)
        model.train()
        schedule = make_schedule(optimizer.inner, config, num_training_steps)
    return model, optimizer, schedule


def load_train_state(saved: Mapping[str, Any], model: MCA, optimizer, schedule) -> None:
    """A saved train state (:func:`mca_tpu_torch.checkpoint.load_state`)
    into a trainer from :func:`build_trainer`, as ``restart:`` loads it.
    The learning rate is this run's schedule at the restored step: a
    state written under another horizon (``tools/import_checkpoint``'s)
    takes this run's rate, as the JAX package computes it from the step;
    for a state this run's schedule wrote, that is the saved rate."""
    if isinstance(optimizer, ShardedOptimizer):
        optimizer.load_model_state_dict(saved["model"])
    else:
        model.load_state_dict(saved["model"])
    optimizer.load_state_dict(saved["optimizer"])
    schedule.load_state_dict(saved["schedule"])
    lrs = [base * fn(schedule.last_epoch)
           for base, fn in zip(schedule.base_lrs, schedule.lr_lambdas)]
    for group, lr in zip(schedule.optimizer.param_groups, lrs):
        group["lr"] = lr
    schedule._last_lr = lrs


def synthetic_rows(config, n: int, seed: int = 0) -> List[Dict[str, Any]]:
    """``n`` rows shaped as the config's modalities, with a quarter of the
    modalities missing (what ``bench.py`` trains on): CMU-MOSEI-shaped
    (:func:`make_cmu_like` at each encoder's ``input_size`` x
    ``max_tokens``) when every modality is ``embedded_sequence``,
    TCGA-shaped (:func:`make_tcga_like` at each ``pad_len``) when every
    modality is ``sequence``."""
    mods = plain(config.modality_config)
    types = {c["type"] for c in mods.values()}
    if types == {"embedded_sequence"}:
        enc = plain(config.encoder_configs)
        shapes = {m: (int(enc[m]["input_size"]), int(enc[m]["max_tokens"])) for m in mods}
        return make_cmu_like(n, shapes=shapes, p_missing=0.25, seed=seed)
    if types == {"sequence"}:
        widths = {m: int(c["pad_len"]) for m, c in mods.items()}
        return make_tcga_like(n, widths=widths, p_missing=0.25, seed=seed)
    raise ValueError(f"no synthetic rows for modality types {sorted(types)}")


def to_device(batch: Mapping[str, Mapping[str, Any]], device) -> dict:
    """A collated batch (numpy arrays, or the tensors of
    :func:`narrow_for_staging`) on ``device``; fp16 / bf16 columns are
    copied narrow and become fp32 there.  Recorded as ``data.copy``."""
    out = {}
    with trace.span("data.copy"):
        for m, fields in batch.items():
            out[m] = {}
            for k, v in fields.items():
                t = torch.as_tensor(v).to(device)
                out[m][k] = t.float() if t.dtype in (torch.float16, torch.bfloat16) else t
    return out


def make_wandb_config(config) -> Optional[Dict[str, Any]]:
    """``wandb.init`` kwargs for the run, or None when wandb is off
    (``mca_tpu.train.make_wandb_config``): ``wandb_restart: <id>``
    resumes that run (``resume="must"``); otherwise a ``restart:`` from
    a preempted run's directory resumes the run its ``preempted.json``
    names (``resume="allow"``)."""
    if not config.wandb:
        return None
    wandb_cfg = {
        "project": config.wandb_name,
        "entity": config.wandb_account_name or None,
        "config": config.to_plain(),
    }
    if config.get("wandb_restart", ""):
        wandb_cfg["id"] = config.wandb_restart
        wandb_cfg["resume"] = "must"
    elif config.restart:
        try:
            with open(os.path.join(config.restart, "preempted.json")) as f:
                wandb_id = json.load(f).get("wandb_id")
        except (OSError, ValueError):
            wandb_id = None
        if wandb_id:
            wandb_cfg["id"] = wandb_id
            wandb_cfg["resume"] = "allow"
    return wandb_cfg


def run_eval_epoch(model: MCA, eval_dl, record: Callable, step: int, device) -> None:
    """The eval pass (``mca_tpu.train.run_eval_epoch``): the training
    model in ``eval()`` under ``no_grad`` over ``eval_dl``; per batch a
    ``val_step_*`` record of the total and per-pair losses, then one
    ``val_epoch_*`` record with their means and uniformity / alignment,
    raw and ``norm_``, for the modalities present in at least one row
    (with the reference's ``unformity_avg`` spelling).  Everything stays
    on the device until one copy to the host at the end."""
    mask_names = tuple(sorted(model.modality_types))
    fusion = not model.no_fusion
    emb_names = mask_names + (("fusion",) if fusion else ())
    emb, msk, losses, lvs, loss_names = [], [], [], [], None
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            for batch in eval_dl:
                out = model(to_device(batch, device), no_loss=False)
                loss_names = loss_names or tuple(sorted(out["losses"]))
                emb.append(torch.stack([out[k] for k in emb_names]))
                msk.append(torch.stack([out["modality_sample_mask"][k] for k in mask_names]))
                losses.append(out["loss"].float())
                lvs.append(torch.stack([out["losses"][k].float() for k in loss_names]))
            if not emb:
                return
            unif, align, counts = epoch_metrics(
                emb, msk, emb_names=emb_names, mask_names=mask_names, fusion=fusion
            )
            named = ([(("unif", k, v), unif[k][v]) for k in unif for v in ("raw", "norm")]
                     + [(("align", k, v), align[k][v]) for k in align for v in ("raw", "norm")]
                     + [(("count", k), counts[k].float()) for k in counts])
            n, n_loss = len(losses), len(loss_names)
            host = torch.cat([torch.stack(losses), torch.stack(lvs).reshape(-1),
                              torch.stack([t for _, t in named])]).cpu()
    finally:
        model.train(was_training)
    step_losses = host[:n].tolist()
    pair = host[n : n + n * n_loss].reshape(n, n_loss).numpy()
    scal = dict(zip((name for name, _ in named), host[n + n * n_loss :].tolist()))
    plain_loss = [(j, k) for j, k in enumerate(loss_names) if "|" not in k]
    for i in range(n):
        step_log = {"val_step_total_loss": step_losses[i]}
        for j, k in plain_loss:
            step_log["val_step_" + k] = float(pair[i, j])
        record(step_log, step)
    epoch_log = {"val_epoch_total_loss": float(np.mean(step_losses))}
    for j, k in plain_loss:
        epoch_log["val_epoch_" + k] = float(pair[:, j].mean())
    for variant, prefix in (("raw", ""), ("norm", "norm_")):
        u = {f"val_epoch_{prefix}uniformity_{k}": scal[("unif", k, variant)]
             for k in unif if scal[("count", k)] > 0}
        epoch_log.update(u)
        if u:
            epoch_log[f"val_epoch_{prefix}unformity_avg"] = float(np.mean(list(u.values())))
        a = {f"val_epoch_{prefix}alignment_{k}": scal[("align", k, variant)]
             for k in align if scal[("count", k)] > 0}
        epoch_log.update(a)
        if a:
            epoch_log[f"val_epoch_{prefix}alignment_avg"] = float(np.mean(list(a.values())))
    record(epoch_log, step)


def _prune_checkpoints(output_dir: str, epoch: int, keep: int) -> None:
    """Keep only the newest ``keep`` per-epoch checkpoint directories."""
    for old in range(epoch - keep + 1):
        path = os.path.join(output_dir, str(old))
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)


def train(
    config,
    device: str = "cuda",
    params: Optional[Mapping[str, Any]] = None,
    rows: Optional[Sequence[Dict[str, Any]]] = None,
    log: Optional[Callable[[Dict[str, Any]], None]] = None,
) -> str:
    """Run pretraining (``mca_tpu.train.train``); returns ``output_dir``.

    ``params``: initial weights (a state dict under the port's names)
    in place of random ones from ``config.seed``.  ``rows``: row dicts
    held in memory in place of ``dataset:``, split as the HF split
    would split them.  ``log``: called with every record written to
    ``metrics.jsonl`` (its ``step`` included), before the guards act."""
    dev = require_device(device)
    check_training_keys(config)
    mesh = training_mesh(config, dev)
    output_dir = config.output_dir
    if not output_dir:
        raise ValueError("output_dir is empty: set it, or load the config with "
                         "training_config(..., make_output_dir=True)")
    if rows is None and not config.dataset:
        raise ValueError("no data: set dataset: to a save_to_disk directory, or pass rows")
    modalities = plain(config.modality_config)
    data = setup_data(
        config.dataset if rows is None else rows,
        split=config.split, ds_frac=config.ds_frac, ds_seed=config.ds_seed,
        predrop=config.predrop, predrop_config=modalities,
    )
    collator = MultimodalCollator(modalities)
    bs = int(config.batch_size)
    stage = make_stager(mesh, bs)  # every rank loads the global batch, keeps its rows
    preload = bool(config.get("preload_dataset", True))
    prefetch = int(config.get("prefetch_batches", 0))
    train_dl = BatchedLoader(data["train"], collator, bs, shuffle=True,
                             seed=int(config.seed), preload=preload, prefetch=prefetch)
    eval_dl = BatchedLoader(data["test"], collator, bs, preload=preload, prefetch=prefetch)
    n_accum = int(config.get("grad_accum", 1) or 1)
    steps_per_epoch = len(train_dl)
    model, optimizer, schedule = build_trainer(
        config, device, num_training_steps=int(config.epochs) * steps_per_epoch,
        params=params, mesh=mesh,
    )
    sharded = isinstance(optimizer, ShardedOptimizer)
    primary = is_primary()
    saver = checkpoint.Checkpointer()
    step = 0

    def model_state() -> Dict[str, torch.Tensor]:
        return optimizer.model_state_dict() if sharded else model.state_dict()

    def state(epoch: int) -> Dict[str, Any]:
        # on several ranks: the whole state (collectives on every rank)
        return {"model": model_state(), "optimizer": optimizer.state_dict(),
                "schedule": schedule.state_dict(), "step": step, "epoch": epoch}

    def save(epoch: int, directory: str, asynchronous: bool = False) -> None:
        st = state(epoch)
        if primary:
            saver.save_state(st, directory, asynchronous=asynchronous)

    start_epoch, resume_skip = int(config.start_epoch), 0
    if config.restart:
        logger.info("Loading saved state from %s", config.restart)
        saved = checkpoint.load_state(config.restart)
        load_train_state(saved, model, optimizer, schedule)
        step = int(saved["step"])
        full_epochs, into_epoch = divmod(step, steps_per_epoch) if steps_per_epoch else (0, 0)
        if start_epoch == 0 and full_epochs > 0:
            logger.info("restored step %d implies start_epoch %d", step, full_epochs)
            start_epoch = full_epochs
        if into_epoch:
            if full_epochs == start_epoch:
                resume_skip = into_epoch
                logger.info("mid-epoch resume: skipping %d batches of epoch %d",
                            into_epoch, full_epochs)
            else:
                logger.warning("restored step %d sits inside epoch %d but start_epoch=%d: "
                               "the batches of this epoch are trained again",
                               step, full_epochs, start_epoch)

    sink = (JSONLLogger(output_dir, wandb_config=make_wandb_config(config)) if primary
            else NullLogger())

    def record(rec: Dict[str, Any], at: int) -> None:
        sink.log(rec, step=at)
        if log is not None:
            log({**rec, "step": at})

    meter = ThroughputMeter(bs * (
        sum(int(e["max_tokens"]) for e in config.encoder_configs.values())
        + int(config.num_fusion_tokens)
    ))
    halt_on_nan = bool(config.get("halt_on_nan", True))
    log_every = max(int(config.get("log_every", 1) or 1), 1)
    n_step = int(config.n_step_checkpoint or 0)
    keep = int(config.get("checkpoint_keep", 0) or 0)
    clip = float(config.clip or 0.0)
    stage_dtype = config.get("stage_dtype", "fp32")
    sentinels = staging_sentinels(config)
    trace_dir = config.get("trace_dir", "") or ""
    steps_run = 0  # this run's steps: the second is traced
    logger.info("Number of training samples: %d, batches per epoch: %d",
                len(data["train"]), steps_per_epoch)

    # SIGTERM only sets a flag; the loop saves and stops at the next step
    # boundary.  A handler can be installed from the main thread only.
    preempted = [False]
    old_sigterm = None
    if bool(config.get("preempt_save", True)) and (
        threading.current_thread() is threading.main_thread()
    ):
        def on_sigterm(signum, frame):
            preempted[0] = True

        old_sigterm = signal.signal(signal.SIGTERM, on_sigterm)

    try:
        for epoch in range(start_epoch, int(config.epochs)):
            train_dl.set_epoch(epoch)
            nb_done = resume_skip
            if resume_skip:
                train_dl.skip_batches(resume_skip)
                resume_skip = 0
            last_bucket = nb_done // n_step if n_step else 0
            stream = iter(train_dl)
            try:
                for batch in stream:
                    staged = narrow_for_staging(stage(batch), stage_dtype, sentinels)
                    steps_run += 1
                    with trace.trace_context(trace_dir if steps_run == 2 else None,
                                       f"step{step + 1}.rank{process_index()}"):
                        metrics = train_step(model, optimizer, schedule, to_device(staged, dev),
                                             clip=clip, n_accum=n_accum,
                                             dropout_seed=int(config.seed))
                    step += 1
                    meter.step()
                    if step % log_every == 0:
                        record({**metrics, "tokens_per_sec": meter.tokens_per_sec,
                                "epoch": epoch}, step)
                    if halt_on_nan:
                        try:
                            check_finite(metrics, step)
                        except DivergenceError:
                            # every rank sees the same metrics, so every
                            # rank halts here
                            st = state(epoch)
                            if primary:
                                _forensic_save(saver, st, output_dir)
                            raise
                    nb_done += 1
                    if mesh.size > 1:  # a signal to one rank stops them all
                        preempted[0] = coll.any_rank(preempted[0], dev)
                    if preempted[0]:
                        saver.wait_for_saves()
                        save(epoch, output_dir)
                        if primary:
                            with open(os.path.join(output_dir, "preempted.json"), "w") as f:
                                json.dump({"step": step, "epoch": epoch, "signal": "SIGTERM",
                                           "wandb_id": sink.wandb_id}, f)
                        logger.warning("preempted at step %d; state saved, resume with "
                                       "restart: %s", step, output_dir)
                        raise PreemptedError(step, output_dir)
                    if n_step and nb_done // n_step != last_bucket:
                        last_bucket = nb_done // n_step
                        save(epoch, output_dir, asynchronous=True)
            finally:
                close = getattr(stream, "close", None)
                if close is not None:  # stops a prefetch thread on every exit
                    close()
            save(epoch, os.path.join(output_dir, str(epoch)), asynchronous=True)
            if keep and primary:
                saver.wait_for_saves()  # no directory is pruned mid-write
                _prune_checkpoints(output_dir, epoch, keep)
            if config.run_eval_loop:
                run_eval_epoch(model, map(stage, eval_dl), record, step, dev)
        saver.wait_for_saves()
        final = model_state()
        if not primary:
            return output_dir
        checkpoint.save_params(final, output_dir)
        if config.get("export_safetensors", True):
            try:
                checkpoint.export_safetensors(final, os.path.join(output_dir, "model.safetensors"))
            except Exception:  # the model/ save above holds the same weights
                logger.exception("safetensors export failed (non-fatal)")
        try:
            # the marker means "preempted and unfinished"
            os.remove(os.path.join(output_dir, "preempted.json"))
        except FileNotFoundError:
            pass
    finally:
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        sink.close()
    return output_dir


def _forensic_save(saver: checkpoint.Checkpointer, state: Dict[str, Any],
                   output_dir: str) -> None:
    """The diverged state (NaN parameters and moments included) under
    ``output_dir/diverged`` for inspection; a failure is logged, so the
    :class:`DivergenceError` still reaches the caller."""
    try:
        saver.wait_for_saves()
        saver.save_state(state, os.path.join(output_dir, "diverged"))
        logger.error("training diverged; state saved to %s/diverged", output_dir)
    except Exception:
        logger.exception("forensic checkpoint failed")


def main(argv=None) -> None:
    from mca_tpu_torch.config import load_yaml, training_config

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="train yaml")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic rows (TCGA- or CMU-shaped, as the "
                        "config's modalities are) made from the config's seed "
                        "instead of dataset:")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    # an env-gated no-op on one process; several ranks need one output_dir
    init_multihost(device=args.device)
    require_output_dir(load_yaml(args.config))
    config = training_config(args.config, make_output_dir=is_primary())
    rows = synthetic_rows(config, args.synthetic, seed=int(config.seed)) if args.synthetic else None
    try:
        train(config, device=args.device, rows=rows)
    except PreemptedError as e:
        # EX_TEMPFAIL: reschedule with restart: <output_dir>
        logger.warning("%s", e)
        sys.exit(75)


if __name__ == "__main__":
    main()
