"""The masked attention backward (K2 today) against its roofline at the
training batch: five products over the live entries of the mask, q, k,
v, o, dO read and dq, dk, dv written, over the device time of the
matching kernels."""

from portbench import counts, readers

PATTERNS = ("flash_bwd_kv_kernel<true>",)


def read(ctx):
    return readers.roofline(ctx, PATTERNS, counts.attn_bwd_work, "attn_bwd_roofline.train")
