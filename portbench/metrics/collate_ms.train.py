"""Host milliseconds a step the program's loader spends collating (its
``data.collate`` spans), over the window's steps."""

from portbench import spans


def read(ctx):
    return spans.loader_ms(ctx, "data.collate")
