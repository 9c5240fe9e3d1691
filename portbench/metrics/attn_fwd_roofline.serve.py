"""The masked attention forward (K1 today) against its roofline at the
padded serving batch: two products over the live entries of the mask, q, k,
v read and o written, over the device time of the matching kernels."""

from portbench import counts, readers

PATTERNS = ("flash_fwd_kernel",)


def read(ctx):
    return readers.roofline(ctx, PATTERNS, counts.attn_fwd_work, "attn_fwd_roofline.serve")
