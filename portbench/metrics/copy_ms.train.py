"""Host milliseconds a step the program spends copying the batch to the
device (``train.to_device``'s ``data.copy`` spans), over the window's
steps."""

from portbench import spans


def read(ctx):
    return spans.loader_ms(ctx, "data.copy")
