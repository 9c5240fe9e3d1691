"""The ``('data', 'model', 'pipe')`` rank mesh, ported from ``mca_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``data x model`` grid,
data-major, and appends a ``pipe`` axis when ``mesh_pipe > 1``
(``reshape(data, model, pipe)``, row-major); here the ranks of the
process group take the same places: rank ``r`` sits at ``(r // (model
* pipe), (r // pipe) % model, r % pipe)``.
``torch.distributed.device_mesh.init_device_mesh`` makes one process
group per axis: ``model`` (the ranks that share a batch block and
pipeline stage and split the attention heads or the experts), ``data``
(the ranks that split the batch) and ``pipe`` (the GPipe stages of one
batch block, :mod:`mca_tpu_torch.parallel.pipeline`).  ``data: 0``
takes every rank the other axes leave, clamped to a divisor of the
batch, with the JAX package's warnings; a mesh larger than the world
raises ``ValueError``, as the JAX ``assert`` does.  With ``pipe == 1``
the ``data`` and ``model`` groups are those of the two-axis grid.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional, Tuple

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
    pipe: int = 1
    pipe_rank: int = 0
    pipe_group: Optional[dist.ProcessGroup] = None

    @property
    def size(self) -> int:
        return self.data * self.model * self.pipe


SINGLE = Mesh()


def coordinates(rank: int, model: int, pipe: int) -> Tuple[int, int, int]:
    """``(data, model, pipe)`` coordinates of ``rank`` in the row-major
    ``data x model x pipe`` grid."""
    return rank // (model * pipe), (rank // pipe) % model, rank % pipe


def mesh_shape(data: int, model: int, pipe: int, batch_size: Optional[int],
               world: int) -> Tuple[int, int, int]:
    """The axis sizes ``make_mesh`` lays over ``world`` ranks (the JAX
    package's ``make_mesh`` rules): ``data`` 0 takes what the other axes
    leave, clamped to a divisor of ``batch_size``; raises ``ValueError``
    where the mesh needs more ranks than the world has."""
    data, model, pipe = int(data or 0), max(int(model or 1), 1), max(int(pipe or 1), 1)
    if data == 0:
        full_data = max(world // (model * pipe), 1)
        data = full_data
        if batch_size is not None:
            while int(batch_size) % data:
                data -= 1
        if data * model * pipe < world:
            reason = (
                f"batch {batch_size} not divisible by the full data axis {full_data}"
                if data < full_data
                else f"{world} ranks not divisible by the model x pipe axes {model * pipe}"
            )
            logger.warning("auto mesh clamped to %dx%dx%d on %d ranks (%s) — %d ranks idle",
                           data, model, pipe, world, reason, world - data * model * pipe)
    if data * model * pipe > world:
        axes = f"mesh_data={data} x mesh_model={model}"
        if pipe > 1:
            axes += f" x mesh_pipe={pipe}"
        raise ValueError(f"{axes} needs {data * model * pipe} ranks; the world has {world}")
    return data, model, pipe


def make_mesh(
    data: int = 0,
    model: int = 1,
    batch_size: Optional[int] = None,
    pipe: int = 1,
    device: str = "cpu",
) -> Mesh:
    """``data x model [x pipe]`` over the process group's ranks (module
    docstring); :data:`SINGLE` on one process.  ``device`` is the ranks'
    device type (``cpu`` or ``cuda``), for the device mesh."""
    world = process_count()
    data, model, pipe = mesh_shape(data, model, pipe, batch_size, world)
    if world == 1:
        return SINGLE
    if data * model * pipe != world:
        raise ValueError(
            f"multi-process mesh {data}x{model}x{pipe} leaves "
            f"{world - data * model * pipe} of {world} ranks idle; pick mesh_data x "
            f"mesh_model x mesh_pipe = {world}"
        )
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(device, (data, model, pipe), mesh_dim_names=("data", "model", "pipe"))
    d_rank, m_rank, p_rank = dm.get_coordinate()
    assert (d_rank, m_rank, p_rank) == coordinates(dist.get_rank(), model, pipe)
    return Mesh(
        data=data, model=model, data_rank=int(d_rank), model_rank=int(m_rank),
        data_group=dm.get_group("data") if data > 1 else None,
        model_group=dm.get_group("model") if model > 1 else None,
        pipe=pipe, pipe_rank=int(p_rank),
        pipe_group=dm.get_group("pipe") if pipe > 1 else None,
    )
