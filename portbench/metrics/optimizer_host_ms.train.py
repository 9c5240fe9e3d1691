"""Host milliseconds a step from the reduced gradients to the metrics'
stack: norm, clip, AdamW, schedule, clamp, parameter norm (the
``train.optimizer`` spans), over the window's steps."""

from portbench import spans


def read(ctx):
    return spans.phase_ms(ctx, "train.optimizer")
