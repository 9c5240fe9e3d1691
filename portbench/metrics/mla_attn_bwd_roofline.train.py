"""Latent attention's backward (K2 at head dims 192 / 128) against its
roofline at the training batch: five products over the live entries of
the mask, of depth 192, 128, 128, 192 and 192; q, k read and dq, dk
written at 192, v, o, dO read and dv written at 128, over the device
time of the matching kernels."""

from portbench import moonlight_counts, readers

PATTERNS = ("flash_bwd_mla_kernel",)


def read(ctx):
    return readers.roofline(ctx, PATTERNS, moonlight_counts.mla_attn_bwd_work,
                            "mla_attn_bwd_roofline.train")
