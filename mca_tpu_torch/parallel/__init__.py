"""Data and tensor parallelism for the port, ported from ``mca_tpu/parallel``.

- :mod:`~mca_tpu_torch.parallel.multihost`: the process group from the
  JAX package's environment, row blocks, rank-0 IO;
- :mod:`~mca_tpu_torch.parallel.mesh`: the ``('data', 'model')`` rank mesh;
- :mod:`~mca_tpu_torch.parallel.collectives`: every cross-rank operation
  (the differentiable batch gather, Megatron's pair, sequence shards);
- :mod:`~mca_tpu_torch.parallel.sharding`: the tensor-parallel layout
  and the FSDP optimizer (AdamW's moments sharded over ``data``);
- :mod:`~mca_tpu_torch.parallel.launch`: N ranks of one command on a host
  with a hard timeout (the tests' and ``chip_smoke.py``'s helper).

Not ported yet (they raise ``NotImplementedError``): GPipe pipelining
(``mesh_pipe``) and expert parallelism (``moe_experts`` with
``mesh_model > 1``).
"""
