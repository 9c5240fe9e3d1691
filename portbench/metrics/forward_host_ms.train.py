"""Host milliseconds a step in the model's forward and loss (the
``train.forward`` spans, one a microbatch), over the window's steps."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "train.forward")
