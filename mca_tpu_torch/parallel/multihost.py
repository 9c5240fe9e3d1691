"""Multi-process runs, ported from ``mca_tpu/parallel/multihost.py``.

One process (rank) drives one device.  :func:`init_multihost` joins the
ranks into one ``torch.distributed`` process group from the environment
the JAX package reads: ``MCA_COORDINATOR`` (``host:port``, or an
``init_method`` URL such as ``file:///shared/rdzv``), ``MCA_NUM_PROCESSES``
and ``MCA_PROCESS_ID``; ``MCA_MULTIHOST=auto`` takes ``torchrun``'s
rendezvous (``init_method="env://"``), the counterpart of
``jax.distributed.initialize()``'s auto-discovery.  The backend is NCCL
for a CUDA device and gloo for the CPU; ``MCA_DIST_BACKEND=gloo`` runs
several ranks on one card (NCCL refuses two ranks on one device).
Without that environment it is a no-op, and every single-process path
stays as it is.

Every rank runs the same loader with the same shuffle seed and keeps its
contiguous block of each global batch (:func:`local_rows`, through
:func:`make_stager`); host IO (the JSONL log, wandb, checkpoint and
embedding files) is rank 0's (:func:`is_primary`).
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

__all__ = [
    "init_multihost",
    "is_primary",
    "process_count",
    "process_index",
    "local_rows",
    "check_mesh_alignment",
    "make_stager",
    "require_output_dir",
]

#: how long a rank waits for the others in the rendezvous and in any
#: collective before it raises (a rank that died leaves the rest waiting)
TIMEOUT_S = 600


def _init_method(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_multihost(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: str = "cuda",
) -> bool:
    """Join the process group when the environment configures a
    multi-process run; returns whether a group is up.  Arguments default
    to ``MCA_COORDINATOR`` / ``MCA_NUM_PROCESSES`` / ``MCA_PROCESS_ID``
    (``mca_tpu.parallel.multihost.init_multihost``); ``MCA_MULTIHOST=auto``
    reads ``torchrun``'s ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
    ``WORLD_SIZE`` instead, a world of 1 included.  On CUDA each rank
    takes device ``LOCAL_RANK`` (else its rank) modulo the devices there
    are.  The backend is ``MCA_DIST_BACKEND``, else NCCL on CUDA and gloo
    on the CPU.  Idempotent: a group already up is kept."""
    if dist.is_available() and dist.is_initialized():
        return True
    dev = torch.device(device)
    backend = os.environ.get("MCA_DIST_BACKEND") or ("nccl" if dev.type == "cuda" else "gloo")
    timeout = timedelta(seconds=TIMEOUT_S)
    if os.environ.get("MCA_MULTIHOST", "") == "auto":
        rank = int(os.environ.get("RANK", "0"))
        _set_device(dev, int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
        return True
    coordinator = coordinator or os.environ.get("MCA_COORDINATOR", "")
    if num_processes is None:
        num_processes = int(os.environ.get("MCA_NUM_PROCESSES", "0"))
    if process_id is None:
        process_id = int(os.environ.get("MCA_PROCESS_ID", "-1"))
    if not coordinator or num_processes <= 1:
        return False
    if not 0 <= int(process_id) < int(num_processes):
        raise ValueError(
            f"MCA_PROCESS_ID={process_id} must be set to a rank in "
            f"[0, {num_processes}) when MCA_COORDINATOR/"
            "MCA_NUM_PROCESSES are configured"
        )
    _set_device(dev, int(os.environ.get("LOCAL_RANK", process_id)))
    dist.init_process_group(
        backend, init_method=_init_method(coordinator), rank=int(process_id),
        world_size=int(num_processes), timeout=timeout,
    )
    return True


def _set_device(dev: torch.device, local_rank: int) -> None:
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a CPU rank")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side IO (rank 0)."""
    return process_index() == 0


def local_rows(n_global: int, mesh: Any) -> slice:
    """This rank's contiguous row block of a global batch: block
    ``mesh.data_rank`` of ``mesh.data`` (the ranks of one ``model`` group
    share their rows)."""
    n, i = mesh.data, mesh.data_rank
    if n_global % n:
        raise ValueError(f"global batch {n_global} not divisible by {n} data ranks")
    per = n_global // n
    return slice(i * per, (i + 1) * per)


def check_mesh_alignment(mesh: Any, global_batch_size: int) -> None:
    """Fail fast where contiguous row blocks cannot feed the mesh: on a
    multi-process run the mesh must span every rank (a clamped auto data
    axis leaves ranks idle, which the row blocks cannot express), and the
    batch must split evenly over the data axis."""
    n_proc = process_count()
    if n_proc == 1:
        return
    problems = []
    if mesh.size != n_proc:
        problems.append(f"mesh uses {mesh.size} of {n_proc} ranks (clamped/partial mesh)")
    if global_batch_size % mesh.data:
        problems.append(f"batch {global_batch_size} not divisible by data axis {mesh.data}")
    if problems:
        raise ValueError(
            "multi-process mesh/batch misalignment: " + "; ".join(problems)
            + " — pick batch_size divisible by the number of data ranks"
        )


def make_stager(mesh: Any, global_batch_size: Optional[int] = None) -> Callable:
    """``stage(batch) -> this rank's rows`` of a collated host batch
    (``{modality: {field: array}}``, every leaf with the batch first);
    the identity on one process.  ``global_batch_size`` enables the
    alignment check (:func:`check_mesh_alignment`)."""
    if global_batch_size:
        check_mesh_alignment(mesh, int(global_batch_size))
    if process_count() == 1 or mesh.data == 1:
        return lambda batch: batch

    def stage(batch):
        rows = local_rows(len(next(iter(next(iter(batch.values())).values()))), mesh)
        return {m: {k: v[rows] for k, v in f.items()} for m, f in batch.items()}

    return stage


def require_output_dir(raw_config: dict) -> None:
    """Multi-process runs need an explicit ``output_dir``: each rank would
    derive its own timestamped directory otherwise."""
    if process_count() > 1 and not raw_config.get("output_dir"):
        raise ValueError(
            "multi-process runs must set an explicit output_dir "
            "(auto-timestamped dirs race across ranks)"
        )
