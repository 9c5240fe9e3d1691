"""Host milliseconds a step waiting for the device at the ``.tolist()``
that ends the step (the ``train.readback`` spans), over the window's
steps."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "train.readback")
