"""Data, tensor, expert and pipeline parallelism for the port, ported
from ``mca_tpu/parallel``.

- :mod:`~mca_tpu_torch.parallel.multihost`: the process group from the
  JAX package's environment, row blocks, rank-0 IO;
- :mod:`~mca_tpu_torch.parallel.mesh`: the ``('data', 'model', 'pipe')``
  rank mesh;
- :mod:`~mca_tpu_torch.parallel.collectives`: every cross-rank operation
  (the differentiable batch gather, Megatron's pair, sequence shards,
  GPipe's ring shift and last-stage broadcast);
- :mod:`~mca_tpu_torch.parallel.sharding`: the tensor- and
  expert-parallel layout, the gradient sums each layout needs and the
  ZeRO-3 optimizer (``fsdp``: parameters and AdamW's moments sharded
  over ``data``, each module group gathered for its forward and
  backward);
- :mod:`~mca_tpu_torch.parallel.pipeline`: GPipe over the block stack
  (``mesh_pipe``, ``pipeline_microbatches``);
- :mod:`~mca_tpu_torch.parallel.launch`: N ranks of one command on a host
  with a hard timeout (the tests' and ``chip_smoke.py``'s helper).
"""
