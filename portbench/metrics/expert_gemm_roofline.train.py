"""The routed experts' grouped products (``torch._grouped_mm``: one
launch a held-expert matrix a layer and direction) against their
roofline: the work the profiled steps' held assignments ask for (the
program's counter ``moe.held_tokens``; :mod:`portbench.moonlight_counts`),
over the device time of the grouped-GEMM kernels."""

from portbench import moe_readers

PATTERNS = ("GroupProblemShape",)


def read(ctx):
    return moe_readers.expert_gemm_roofline(ctx, PATTERNS, "expert_gemm_roofline.train")
