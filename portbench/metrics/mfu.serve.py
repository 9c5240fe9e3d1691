"""Forward operations of the rows the window answered (padded rows do
not count) over the chip's bf16 peak from the window's start to its
last answer, in percent."""

from portbench import readers


def read(ctx):
    host = ctx["host"]
    return readers.mfu(ctx, host["flops_per_row"] * host["rows"], "mfu.serve")
