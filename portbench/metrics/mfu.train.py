"""Model operations of the window's training steps (forward times 3,
at the cell's shapes) over the chip's bf16 peak in the window's wall
time, on one chip, in percent."""

from portbench import readers


def read(ctx):
    host = ctx["host"]
    return readers.mfu(ctx, host["flops_per_step"] * host["steps"], "mfu.train")
