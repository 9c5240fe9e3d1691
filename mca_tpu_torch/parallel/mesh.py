"""The ``('data', 'model')`` rank mesh, ported from ``mca_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``data x model`` grid,
data-major; here the ranks of the process group take the same places
(rank ``r`` sits at ``(r // model, r % model)``) and
``torch.distributed.device_mesh.init_device_mesh`` makes one process
group per row (``model``: the ranks that share a batch block and split
the attention heads) and per column (``data``: the ranks that split the
batch).  ``data: 0`` takes every rank the model axis leaves, clamped to
a divisor of the batch, with the JAX package's warnings; a mesh larger
than the world raises, as the JAX ``assert`` does.  ``mesh_pipe > 1``
(GPipe over the layer stack) is not ported yet and raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import torch.distributed as dist

from mca_tpu_torch.parallel.multihost import process_count

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Mesh:
    """Where this rank sits: axis sizes, its coordinates, and the process
    group of each axis (None where the axis has one rank)."""

    data: int = 1
    model: int = 1
    data_rank: int = 0
    model_rank: int = 0
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.data * self.model


SINGLE = Mesh()


def make_mesh(
    data: int = 0,
    model: int = 1,
    batch_size: Optional[int] = None,
    pipe: int = 1,
    device: str = "cpu",
) -> Mesh:
    """``data x model`` over the process group's ranks (module docstring);
    :data:`SINGLE` on one process.  ``device`` is the ranks' device type
    (``cpu`` or ``cuda``), for the device mesh."""
    pipe = max(int(pipe or 1), 1)
    if pipe > 1:
        raise NotImplementedError(
            f"mesh_pipe={pipe}: GPipe pipelining over the layer stack "
            "(mca_tpu/parallel/pipeline.py) is not ported yet (ROADMAP.md "
            "Queue A item 9, the next parallelism slice)"
        )
    world = process_count()
    data, model = int(data or 0), max(int(model or 1), 1)
    if data == 0:
        full_data = max(world // model, 1)
        data = full_data
        if batch_size is not None:
            while int(batch_size) % data:
                data -= 1
        if data * model < world:
            reason = (
                f"batch {batch_size} not divisible by the full data axis {full_data}"
                if data < full_data
                else f"{world} ranks not divisible by the model axis {model}"
            )
            logger.warning("auto mesh clamped to %dx%d on %d ranks (%s) — %d ranks idle",
                           data, model, world, reason, world - data * model)
    if data * model > world:
        raise ValueError(
            f"mesh_data={data} x mesh_model={model} needs {data * model} ranks; "
            f"the world has {world}"
        )
    if world == 1:
        return SINGLE
    if data * model != world:
        raise ValueError(
            f"multi-process mesh {data}x{model} leaves {world - data * model} of "
            f"{world} ranks idle; pick mesh_data x mesh_model = {world}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device, (data, model), mesh_dim_names=("data", "model"))
    d_rank, m_rank = dm.get_coordinate()
    return Mesh(
        data=data, model=model, data_rank=int(d_rank), model_rank=int(m_rank),
        data_group=dm.get_group("data") if data > 1 else None,
        model_group=dm.get_group("model") if model > 1 else None,
    )
