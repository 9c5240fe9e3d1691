"""Latent attention's forward (K1 at head dims 192 / 128) against its
roofline at the training batch: two products over the live entries of
the mask, of depth 192 and 128, q and k read at 192, v read and o
written at 128, over the device time of the matching kernels."""

from portbench import moonlight_counts, readers

PATTERNS = ("flash_fwd_mla_kernel",)


def read(ctx):
    return readers.roofline(ctx, PATTERNS, moonlight_counts.mla_attn_fwd_work,
                            "mla_attn_fwd_roofline.train")
