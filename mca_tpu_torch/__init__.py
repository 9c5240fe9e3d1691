"""mca_tpu_torch — the PyTorch / CUDA port of ``mca_tpu`` for NVIDIA Hopper.

A package of its own beside the JAX reference: it imports torch, numpy
and yaml, never JAX or ``mca_tpu``.  Plain tensor code is PyTorch; each
Pallas TPU kernel on a ported path is a hand-written CUDA kernel for
``sm_90a`` under ``csrc/``, built at first use (``_build``), with a
plain PyTorch version beside it that CPU tensors take.

Ported so far: the MCA embedding-serving path (``serve``; with int8
weights, ``ops.quant``, and from an exported program,
``tools.export_aot``), the pretraining run (``train``: loader, eval
pass, checkpoints and restart), and the measurement tools (``tools``),
with the block-sparse flash-attention forward and backward, the fused
GEGLU feed-forward and the tools' microkernels.
"""

__version__ = "0.1.0"
