"""Host milliseconds a step in ``loss.backward()`` (the
``train.backward`` spans, one a microbatch), over the window's steps."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "train.backward")
