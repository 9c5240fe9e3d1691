"""The GEGLU feed-forward (K5 today) against its roofline at the padded
serving batch: both products over every token, x and the weights read
and the output written, over the device time of the matching kernels."""

from portbench import counts, readers

PATTERNS = ("geglu_ff_kernel",)


def read(ctx):
    return readers.roofline(ctx, PATTERNS, counts.geglu_ff_work, "geglu_ff_roofline.serve")
