"""Linear / MLP probe on the GPU, ported from ``mca_tpu/probe.py``.

    python -m mca_tpu_torch.probe eval.yaml [--device cpu]

:func:`probe` reads the six files that :mod:`mca_tpu_torch.infer` (or
``mca_tpu.infer``, or the reference's inference script) writes into
``embedding_dir``, logs retrieval rank metrics and uniformity /
alignment per modality (``rank_metrics``), then trains a head on one
embedding (``embedding_key``: ``fusion``, or ``combo:i,j`` for a family
without a fusion stream, such as EAO) and writes one record per epoch
to ``output_dir/metrics.jsonl``:

- ``task`` picks the label column (``-1``: all of them);
- ``loss_type`` L1, MSE, BCE or CE, with the matching metric suite
  (:mod:`mca_tpu_torch.metrics`, numpy, on the host);
- ``model_type`` ``linear``, an MLP (anything else but ``ridge``), or
  ``ridge`` (a closed-form float64 solve on the host, one record);
- global-norm clipping (``clip``), then AdamW (weight decay 0.01 on
  every parameter) under the HF learning-rate schedule.

The head is the JAX package's ``ProbeHead`` with flax's initialisers:
Linear weights U(+-1/sqrt(fan_in)), biases zero.  Its MLP never drops
out: the JAX package applies it with ``deterministic=True`` in both
loops, so ``dropout`` is read and has no effect.

Two epoch loops, as in the JAX package:

- the host loop (default): each epoch's order from
  ``np.random.default_rng(seed).permutation``, exactly the JAX
  package's, each batch gathered on the host and copied to the device,
  one copy back per epoch;
- the device loop (``scan_epochs: true``, the port of the scanned
  loop): embeddings and labels stay on the device, each epoch's order
  is a ``torch.randperm`` from a device generator seeded ``seed + 1``
  (not JAX's bits: only a full-batch run, where order cannot matter,
  matches the host loop), a remainder batch is padded with rows of
  weight zero, and the logits, losses and norms of the epochs that get
  a record (every ``metrics_every``-th and the last) stay on the device
  until one copy per ``scan_epochs_chunk`` epochs.  It is kept for
  parity with the JAX package's option: on an H100 it measured no
  faster than the host loop, since both are bound by their launches.

The ``train_uniformity_*`` / ``test_uniformity_*`` keys name the
embedding probed (``fusion`` or the ``combo:i,j`` readout); the JAX
package names them ``*_fusion`` whatever it probed.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Any, Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mca_tpu_torch.infer import (
    combo_str_to_frozenset,
    load_embedding_file,
    load_label_file,
)
from mca_tpu_torch.losses import combo_key
from mca_tpu_torch.metrics import (
    alignment,
    binary_metrics,
    multiclass_metrics,
    pearson_r,
    rank_metrics,
    uniformity,
)
from mca_tpu_torch.train import (
    AdamW,
    clip_by_global_norm,
    global_norm,
    hf_lr_schedule,
    require_device,
)
from mca_tpu_torch.utils.logging import JSONLLogger

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class ProbeHead(nn.Module):
    """A Linear head (``dense_0``) or a two-layer ReLU MLP (``dense_0``,
    ``dense_1``); flax's ``Dense_{i}`` carry over with
    :func:`mca_tpu_torch.interop.probe_head_state_from_jax`."""

    def __init__(
        self,
        in_dim: int,
        num_labels: int,
        model_type: str = "linear",
        hidden_size: int = 256,
    ):
        super().__init__()
        self.linear = model_type == "linear"
        self.num_labels = num_labels
        self.dense_0 = nn.Linear(in_dim, num_labels if self.linear else hidden_size)
        if not self.linear:
            self.dense_1 = nn.Linear(hidden_size, num_labels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.linear:
            return self.dense_0(x)
        return self.dense_1(torch.relu(self.dense_0(x)))

    def init_weights(self, generator: Optional[torch.Generator] = None) -> "ProbeHead":
        """Weights U(+-1/sqrt(fan_in)) from ``generator``, biases zero."""
        with torch.no_grad():
            for layer in self.children():
                bound = layer.weight.shape[1] ** -0.5
                layer.weight.copy_(
                    torch.empty(layer.weight.shape).uniform_(-bound, bound, generator=generator)
                )
                layer.bias.zero_()
        return self


def make_loss_fn(loss_type: str) -> LossFn:
    """The batch-mean loss of ``mca_tpu.probe.make_loss_fn``."""
    if loss_type == "L1":
        return lambda pred, y: (pred.squeeze() - y).abs().mean()
    if loss_type == "MSE":
        return lambda pred, y: (pred.squeeze() - y).square().mean()
    if loss_type == "BCE":
        return lambda pred, y: F.binary_cross_entropy_with_logits(pred.squeeze(), y)
    if loss_type == "CE":
        return lambda pred, y: F.cross_entropy(pred, y.long())
    raise ValueError(f"unknown loss_type {loss_type!r}")


def _per_sample_loss(loss_type: str) -> LossFn:
    """Per-row losses ``[B]`` of :func:`make_loss_fn`'s mean, for the
    device loop's remainder batch, whose padding rows weigh zero."""

    def tail_mean(x):
        return x.reshape(x.shape[0], -1).mean(dim=1)

    def sq(pred, y):
        # the batch mean's pred.squeeze(): only the label dim can be 1
        if pred.shape[-1] == 1 and y.dim() == pred.dim() - 1:
            return pred[..., 0]
        return pred

    if loss_type == "L1":
        return lambda pred, y: tail_mean((sq(pred, y) - y).abs())
    if loss_type == "MSE":
        return lambda pred, y: tail_mean((sq(pred, y) - y).square())
    if loss_type == "BCE":
        return lambda pred, y: tail_mean(
            F.binary_cross_entropy_with_logits(sq(pred, y), y, reduction="none")
        )
    if loss_type == "CE":
        return lambda pred, y: F.cross_entropy(pred, y.long(), reduction="none")
    raise ValueError(f"unknown loss_type {loss_type!r}")


def compute_suite(loss_type: str, logits: np.ndarray, labels: np.ndarray) -> Dict[str, Any]:
    if loss_type in ("L1", "MSE"):
        return {"PCC": pearson_r(logits.squeeze(), labels)}
    if loss_type == "BCE":
        return binary_metrics(logits, labels)
    if loss_type == "CE":
        return multiclass_metrics(logits, labels, num_classes=logits.shape[-1])
    raise ValueError(loss_type)


def select_task(labels: np.ndarray, task: int) -> np.ndarray:
    labels = np.asarray(labels).squeeze()
    if task == -1 or labels.ndim == 1:
        return labels
    return labels[:, task]


def resolve_embedding_key(config, embeddings: Mapping[Any, Any]):
    """The key of the embedding probed: ``'fusion'`` (default) or, for
    ``embedding_key: "combo:i,j,..."``, that combo's frozenset."""
    spec = str(config.get("embedding_key", "fusion"))
    key = combo_str_to_frozenset(spec) if spec.startswith("combo:") else spec
    if key not in embeddings:
        raise KeyError(
            f"embedding_key {spec!r} not in the embedding file "
            f"(keys: {sorted(embeddings, key=str)})"
        )
    return key


def log_rank_metrics(e_train, m_train, e_test, m_test, log, target_key="fusion") -> None:
    """Per modality: retrieval of the probed embedding of its own sample
    and uniformity / alignment, on each split; then the probed
    embedding's uniformity (``{split}_uniformity_<its name>``)."""
    modality_keys = [
        k for k in e_train.keys()
        if isinstance(k, str) and k != "fusion" and k != target_key
    ]
    for k in modality_keys:
        metrics = {}
        for split, e, m in (("train", e_train, m_train), ("test", e_test, m_test)):
            mask = np.asarray(m[k]).astype(bool)
            rm = rank_metrics(e[k], e[target_key], mask=mask)
            metrics.update({f"{split}_{name}": v for name, v in rm.items()})
            metrics[f"{split}_uniformity"] = uniformity(np.asarray(e[k])[mask])
            metrics[f"{split}_alignment"] = alignment(
                np.asarray(e[k])[mask], np.asarray(e[target_key])[mask]
            )
        log.log({f"{k}_{n}": v for n, v in metrics.items()})
    name = combo_key(target_key) if isinstance(target_key, frozenset) else target_key
    log.log({
        f"train_uniformity_{name}": uniformity(np.asarray(e_train[target_key])),
        f"test_uniformity_{name}": uniformity(np.asarray(e_test[target_key])),
    })


def ridge_probe(x_train: np.ndarray, y_train: np.ndarray, x_test: np.ndarray,
                lam: float = 1e-3) -> tuple:
    """Closed-form regularised least squares in float64 on the host (the
    normal equations square the condition number, and fp32 loses the
    low-variance directions that carry the class signal); returns the
    fp32 predictions for both splits."""
    y2d = y_train if y_train.ndim > 1 else y_train[:, None]
    xb = np.concatenate([x_train, np.ones((len(x_train), 1))], axis=1).astype(np.float64)
    w = np.linalg.solve(
        xb.T @ xb + lam * np.eye(xb.shape[1]), xb.T @ y2d.astype(np.float64)
    )

    def predict(x):
        xb = np.concatenate([x, np.ones((len(x), 1))], axis=1).astype(np.float64)
        return (xb @ w).astype(np.float32)

    return predict(x_train), predict(x_test)


def _record(loss_type: str, train_loss: float, eval_loss: float, lr: float,
            param_norm: float, grad_norm: float, train_logits, train_y,
            eval_logits, eval_y) -> Dict[str, Any]:
    """One epoch's JSONL record: losses, lr, norms and both suites."""
    record = {"train_loss": train_loss, "eval_loss": eval_loss, "lr": lr,
              "param_norm": param_norm, "grad_norm": grad_norm}
    for split, lg, y in (("train", train_logits, train_y), ("eval", eval_logits, eval_y)):
        met = compute_suite(loss_type, lg, y)
        record.update({f"{split}_{k}": v for k, v in met.items() if k != "cm"})
    return record


def _split(row: np.ndarray, *sizes: int) -> List[np.ndarray]:
    """``row`` cut into consecutive pieces of ``sizes``."""
    ends = np.cumsum(sizes)
    return [row[e - n : e] for n, e in zip(sizes, ends)]


class _Trainer:
    """The head, its optimizer and schedule, and one training step."""

    def __init__(self, head: ProbeHead, config, steps_per_epoch: int):
        self.head = head
        self.params = list(head.parameters())
        self.loss = make_loss_fn(config.loss_type)
        self.per_sample = _per_sample_loss(config.loss_type)
        self.clip = float(config.clip or 0.0)
        self.schedule = hf_lr_schedule(
            config.lr_scheduler_type, float(config.lr), int(config.num_warmup_steps),
            int(config.epochs) * steps_per_epoch,
        )
        # optax.adamw's arithmetic, moments in fp32
        self.opt = AdamW(self.params, lr=float(config.lr), weight_decay=0.01,
                         moment_dtype=torch.float32)
        self.step_count = 0

    def step(self, x: torch.Tensor, y: torch.Tensor, weight: Optional[torch.Tensor] = None):
        """One update on ``(x, y)``; ``weight`` (per row) makes the loss
        the weighted mean of :func:`_per_sample_loss`'s rows.  Returns
        ``(loss, logits, grad_norm)`` on the device, the norm before the
        clip."""
        for p in self.params:
            p.grad = None
        logits = self.head(x)
        if weight is None:
            loss = self.loss(logits, y)
        else:
            loss = (self.per_sample(logits, y) * weight).sum() / weight.sum().clamp(min=1.0)
        loss.backward()
        grads = [p.grad for p in self.params]
        gn = global_norm(grads)
        if self.clip:
            clip_by_global_norm(grads, self.clip, gn)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.step_count)
        self.opt.step()
        self.step_count += 1
        return loss.detach(), logits.detach(), gn.detach()

    def param_norm(self) -> torch.Tensor:
        with torch.no_grad():
            return global_norm(self.params)


def _host_loop(config, trainer: _Trainer, x_train, y_train, x_test, y_test,
               steps_per_epoch: int, log, dev) -> Dict[str, Any]:
    bs = int(config.batch_size)
    n_train = len(x_train)
    xe, ye = torch.from_numpy(x_test).to(dev), torch.from_numpy(y_test).to(dev)
    rng = np.random.default_rng(config.seed)
    final: Dict[str, Any] = {}
    for epoch in range(int(config.epochs)):
        order = rng.permutation(n_train)
        losses, logits, targs, gn = [], [], [], None
        for s in range(steps_per_epoch):
            idx = order[s * bs : (s + 1) * bs]
            loss, lg, gn = trainer.step(torch.from_numpy(x_train[idx]).to(dev),
                                        torch.from_numpy(y_train[idx]).to(dev))
            losses.append(loss)
            logits.append(lg)
            targs.append(y_train[idx])
        with torch.no_grad():
            ev = trainer.head(xe)
            eval_loss = trainer.loss(ev, ye)
        host = torch.cat([torch.stack(losses), torch.stack([gn, eval_loss, trainer.param_norm()]),
                          torch.cat(logits).reshape(-1), ev.reshape(-1)]).cpu().numpy()
        c = trainer.head.num_labels
        step_losses, (gn_, eval_loss_, pn), lg, ev_ = _split(
            host, steps_per_epoch, 3, n_train * c, len(x_test) * c)
        final = _record(
            config.loss_type, float(np.sum(step_losses, dtype=np.float64)) / steps_per_epoch,
            float(eval_loss_), trainer.schedule(epoch * steps_per_epoch), float(pn), float(gn_),
            lg.reshape(n_train, c), np.concatenate(targs), ev_.reshape(-1, c), y_test,
        )
        log.log(final, step=epoch)
    return final


def _device_loop(config, trainer: _Trainer, x_train, y_train, x_test, y_test,
                 steps_per_epoch: int, log, dev) -> Dict[str, Any]:
    n_train = len(x_train)
    bsz = min(int(config.batch_size), n_train)
    n_steps = max(-(-n_train // bsz), 1)
    pad = n_steps * bsz - n_train
    epochs = int(config.epochs)
    chunk = max(1, int(config.get("scan_epochs_chunk", 256)))
    metrics_every = max(1, int(config.get("metrics_every", 1)))
    xt, yt = torch.from_numpy(x_train).to(dev), torch.from_numpy(y_train).to(dev)
    xe, ye = torch.from_numpy(x_test).to(dev), torch.from_numpy(y_test).to(dev)
    gen = torch.Generator(device=dev).manual_seed(int(config.seed) + 1)
    no_row = torch.full((pad,), -1, dtype=torch.long, device=dev)
    valid_pos = np.arange(n_steps * bsz) < n_train
    final: Dict[str, Any] = {}
    pending: List[tuple] = []  # (epoch, packed device tensor)

    def flush() -> None:
        nonlocal final
        if not pending:
            return
        host = torch.stack([t for _, t in pending]).cpu().numpy()  # the chunk's copy
        c, nb = trainer.head.num_labels, n_steps * bsz
        for (epoch, _), row in zip(pending, host):
            step_losses, (gn_, eval_loss_, pn), lg, ev, idx = _split(
                row, n_steps, 3, nb * c, len(x_test) * c, nb)
            final = _record(
                config.loss_type, float(step_losses.mean()), float(eval_loss_),
                trainer.schedule(epoch * steps_per_epoch), float(pn), float(gn_),
                lg.reshape(nb, c)[valid_pos], y_train[idx.astype(np.int64)[valid_pos]],
                ev.reshape(-1, c), y_test,
            )
            log.log(final, step=epoch)
        pending.clear()

    for epoch in range(epochs):
        perm = torch.randperm(n_train, generator=gen, device=dev)
        idx = torch.cat([perm, no_row]).view(n_steps, bsz)
        losses, logits, gn = [], [], None
        for ib in idx:
            weight = (ib >= 0).float()
            safe = ib.clamp(min=0)
            loss, lg, gn = trainer.step(xt[safe], yt[safe], weight)
            losses.append(loss)
            logits.append(lg)
        if (epoch + 1) % metrics_every == 0 or epoch == epochs - 1:
            with torch.no_grad():
                ev = trainer.head(xe)
                eval_loss = trainer.loss(ev, ye)
            pending.append((epoch, torch.cat([
                torch.stack(losses), torch.stack([gn, eval_loss, trainer.param_norm()]),
                torch.cat(logits).reshape(-1), ev.reshape(-1), idx.reshape(-1).float(),
            ])))
        if (epoch + 1) % chunk == 0:
            flush()
    flush()
    return final


def probe(config, device: str = "cuda",
          params: Optional[Mapping[str, Any]] = None) -> Dict[str, Any]:
    """Train the probe head (module docstring); returns the last
    epoch's record.  ``params``: the head's initial weights (a state dict
    of :class:`ProbeHead`) in place of random ones from ``config.seed``."""
    dev = require_device(device)
    if not config.output_dir:
        raise ValueError("output_dir is empty: set it, or load the config with "
                         "embedding_eval_config(..., make_output_dir=True)")
    d = config.embedding_dir
    e_train = load_embedding_file(f"{d}/train_embeddings")
    m_train = load_embedding_file(f"{d}/train_masks")
    s_train = select_task(load_label_file(f"{d}/train_labels"), config.task)
    e_test = load_embedding_file(f"{d}/eval_embeddings")
    m_test = load_embedding_file(f"{d}/eval_masks")
    s_test = select_task(load_label_file(f"{d}/eval_labels"), config.task)
    log = JSONLLogger(config.output_dir)
    try:
        emb_key = resolve_embedding_key(config, e_train)
        if config.rank_metrics:
            log_rank_metrics(e_train, m_train, e_test, m_test, log, target_key=emb_key)

        x_train = np.asarray(e_train[emb_key], np.float32)
        x_test = np.asarray(e_test[emb_key], np.float32)
        y_train = np.asarray(s_train, np.float32)
        y_test = np.asarray(s_test, np.float32)
        num_labels = 1 if y_train.ndim == 1 else y_train.shape[1]
        if config.loss_type == "CE":
            # integer class ids (one-hot labels -> argmax); the head is
            # sized from the data, so a 0/1 column is a 2-class head
            if y_train.ndim > 1:
                y_train = y_train.argmax(-1).astype(np.float32)
                y_test = y_test.argmax(-1).astype(np.float32)
            num_labels = max(int(max(y_train.max(), y_test.max())) + 1, 2)

        if config.model_type == "ridge":
            return _ridge(config, x_train, y_train, x_test, y_test, num_labels, log)

        head = ProbeHead(x_train.shape[1], num_labels, config.model_type,
                         int(config.hidden_size))
        if params is None:
            head.init_weights(torch.Generator().manual_seed(int(config.seed)))
        else:
            head.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                                 strict=True)
        head.to(dev)
        n_train = len(x_train)
        # ceil: the reference's DataLoader keeps the remainder batch
        steps_per_epoch = max(-(-n_train // int(config.batch_size)), 1)
        trainer = _Trainer(head, config, steps_per_epoch)
        loop = _device_loop if bool(config.get("scan_epochs", False)) else _host_loop
        return loop(config, trainer, x_train, y_train, x_test, y_test,
                    steps_per_epoch, log, dev)
    finally:
        log.close()


def _ridge(config, x_train, y_train, x_test, y_test, num_labels, log) -> Dict[str, Any]:
    y_fit = (np.eye(num_labels, dtype=np.float32)[y_train.astype(np.int64)]
             if config.loss_type == "CE" else y_train)
    tr, te = ridge_probe(x_train, y_fit, x_test, lam=float(config.get("ridge_lambda", 1e-3)))
    loss = make_loss_fn(config.loss_type)
    record = {
        "train_loss": float(loss(torch.from_numpy(tr), torch.from_numpy(y_train))),
        "eval_loss": float(loss(torch.from_numpy(te), torch.from_numpy(y_test))),
    }
    for split, lg, y in (("train", tr, y_train), ("eval", te, y_test)):
        met = compute_suite(config.loss_type, lg, y)
        record.update({f"{split}_{k}": v for k, v in met.items() if k != "cm"})
    log.log(record, step=0)
    return record


def main(argv=None) -> None:
    from mca_tpu_torch.config import embedding_eval_config

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="probe yaml")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    probe(embedding_eval_config(args.config), device=args.device)


if __name__ == "__main__":
    main()
