"""Device memory of one training step, ported from ``mca_tpu/tools/memory_report.py``.

    python -m mca_tpu_torch.tools.memory_report cfg.yaml [--batch B]
        [--grad-accum N] [--remat] [--json] [--device cpu]

The JAX tool compiles one step and prints XLA's memory analysis of the
executable.  PyTorch has no compile-time analysis; the allocator reads
what a step takes instead.  :func:`step_memory` builds the trainer
(:func:`mca_tpu_torch.train.build_trainer`) on one synthetic batch at the
config's ``batch_size`` (:func:`mca_tpu_torch.train.synthetic_rows`),
takes one warm-up step, resets the allocator's peak and takes one
measured step.  Under a process group (``torchrun``, or the
``MCA_COORDINATOR`` environment) each rank reports its own share of the
config's mesh.  On the CPU the allocator keeps no peak: the report then
counts the state and the batch from the tensors and gives the
activation fields as null.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from typing import Any, Dict, List, Optional

import torch

from mca_tpu_torch import train as train_lib
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.staging import to_device
from mca_tpu_torch.parallel.multihost import init_multihost, make_stager
from mca_tpu_torch.parallel.sharding import ShardedOptimizer

CPU_NOTE = ("the CPU allocator keeps no peak: temp and peak are not measured, "
            "argument_size_in_bytes is counted from the state's and the batch's tensors")


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def state_tensors(model: torch.nn.Module, optimizer) -> List[torch.Tensor]:
    """The tensors a trainer holds between steps: the leaves the optimizer
    steps (a rank's slices under ``fsdp``), the model's other parameters
    and its buffers, and the optimizer's moments (its step counters live
    on the host)."""
    sharded = isinstance(optimizer, ShardedOptimizer)
    inner = optimizer.inner if sharded else optimizer
    leaves = list(optimizer.opt_params) if sharded else list(model.parameters())
    seen = {id(p) for p in leaves}
    others = [p for p in model.parameters() if id(p) not in seen]
    moments = [v for st in inner.state.values() for k, v in st.items()
               if torch.is_tensor(v) and k != "step"]
    return leaves + others + list(model.buffers()) + moments


#: how long :func:`requested_bytes` waits for the count to settle
SETTLE_S, SETTLE_POLL_S = 5.0, 0.1


def requested_bytes(device) -> int:
    """The bytes the live tensors on CUDA ``device`` asked the caching
    allocator for, once the device is idle and every freed block is back:
    ``memory_allocated`` less its rounding (a block that a large tensor
    reuses may be up to 1 MiB larger than the tensor).  A tensor that a
    collective used on another stream stays counted after its last
    reference goes until the allocator processes its events (gloo's CUDA
    path records the stream; ``empty_cache`` processes them), or until
    the process group lets go of the tensors it kept for a finished
    collective (NCCL's watchdog): the count is read until two readings
    ``SETTLE_POLL_S`` apart agree, for at most ``SETTLE_S``."""
    def read() -> int:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_stats(device)["requested_bytes.all.current"]

    last, deadline = read(), time.monotonic() + SETTLE_S
    while time.monotonic() < deadline:
        time.sleep(SETTLE_POLL_S)
        now = read()
        if now == last:
            break
        last = now
    return last


def synthetic_batch(config) -> dict:
    """One collated batch of ``batch_size`` synthetic rows (seed 0)."""
    rows = train_lib.synthetic_rows(config, int(config.batch_size), seed=0)
    return MultimodalCollator(config.modality_config.to_plain())(rows)


def step_memory(config, batch=None, grad_accum: int = 1, remat: Optional[bool] = None,
                device: str = "cuda") -> Dict[str, Any]:
    """One measured training step's memory on ``device`` (module
    docstring), as a plain dict of bytes under the JAX tool's field names
    where their meaning holds:

    - ``argument_size_in_bytes``: what is resident when the step starts:
      ``resident_bytes`` (parameters, buffers, optimizer state) and the
      batch; on the CPU, ``state_bytes`` and the batch;
    - ``temp_size_in_bytes``: the step's peak less what was allocated when
      it started (activations, gradients, workspace); null on the CPU;
    - ``peak_estimate_bytes``: ``torch.cuda.max_memory_allocated`` over the
      step, everything allocated included (the batch, cuBLAS's workspace,
      the flash schedules); null on the CPU;
    - ``resident_bytes``: what deleting the trainer after the step frees
      (its gradients dropped first), in the bytes its tensors asked the
      allocator for (:func:`requested_bytes`): the trainer's own share of
      the device; null on the CPU;
    - ``state_bytes``: the exact bytes of the parameters, buffers and
      moments, and ``state_tensors`` their count (:func:`state_tensors`);
    - ``batch_bytes``: this rank's rows of the batch;
    - ``step_ms``: the measured step's wall time (host clock, ending in a
      synchronise);
    - ``backend``: ``"cuda"`` or ``"cpu"``.

    ``batch`` defaults to :func:`synthetic_batch`; ``remat`` overrides the
    config's flag, ``grad_accum`` the config's."""
    dev = train_lib.require_device(device)
    cfg = type(config)(config)
    cfg.grad_accum = int(grad_accum)
    if remat is not None:
        cfg.remat = bool(remat)
    cuda = dev.type == "cuda"
    model, opt, sched = train_lib.build_trainer(cfg, device, num_training_steps=2)
    sharded = isinstance(opt, ShardedOptimizer)
    stage = make_stager(opt.mesh, int(cfg.batch_size)) if sharded else (lambda b: b)
    local = to_device(stage(batch if batch is not None else synthetic_batch(cfg)), dev)
    batch_bytes = tensor_bytes(t for f in local.values() for t in f.values())
    leaves = list(opt.opt_params) if sharded else list(model.parameters())

    def step():
        train_lib.train_step(model, opt, sched, local, clip=float(cfg.clip or 0.0),
                             n_accum=int(grad_accum))
        for p in leaves:
            p.grad = None

    step()  # warm-up: the kernels' schedules, cuBLAS's workspace, the moments
    gc.collect()
    out: Dict[str, Any] = {"backend": dev.type}
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    step()  # train_step reads its metrics on the host: it ends synchronised
    out["step_ms"] = 1e3 * (time.perf_counter() - t0)
    held = state_tensors(model, opt)
    out.update(state_bytes=tensor_bytes(held), state_tensors=len(held), batch_bytes=batch_bytes)
    del held
    if cuda:
        out["peak_estimate_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["temp_size_in_bytes"] = out["peak_estimate_bytes"] - start
        gc.collect()
        before = requested_bytes(dev)
        del model, opt, sched, leaves, step
        gc.collect()
        out["resident_bytes"] = before - requested_bytes(dev)
        out["argument_size_in_bytes"] = out["resident_bytes"] + batch_bytes
    else:
        out.update(argument_size_in_bytes=out["state_bytes"] + batch_bytes,
                   temp_size_in_bytes=None, peak_estimate_bytes=None, resident_bytes=None,
                   note=CPU_NOTE)
    return out


def _fmt(n) -> str:
    if n is None:
        return "not measured"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.2f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n}"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config")
    p.add_argument("--batch", type=int, default=0, help="override batch_size")
    p.add_argument("--grad-accum", type=int, default=0, help="override grad_accum")
    p.add_argument("--remat", action="store_true", help="force remat on")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    from mca_tpu_torch.config import training_config

    init_multihost(device=args.device)  # a no-op without a rank environment
    # pure inspection: never create a training_output_* dir
    config = training_config(args.config, make_output_dir=False)
    if args.batch:
        config.batch_size = args.batch
    n_accum = args.grad_accum or int(config.get("grad_accum", 1) or 1)
    out = step_memory(config, grad_accum=n_accum, remat=True if args.remat else None,
                      device=args.device)
    out["batch_size"] = int(config.batch_size)
    out["grad_accum"] = n_accum
    if args.json:
        print(json.dumps(out), flush=True)
        return
    print(f"backend: {out['backend']}  batch: {out['batch_size']}  grad_accum: {n_accum}")
    for k, v in out.items():
        if k.endswith("_bytes"):
            print(f"  {k:32s} {_fmt(v):>14s}")
    print(f"  {'step_ms':32s} {out['step_ms']:>14.1f}")
    if "note" in out:
        print(f"  ({out['note']})")


if __name__ == "__main__":
    main()
