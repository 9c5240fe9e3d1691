"""Device milliseconds of a step from its first launch to the launch
before its readback (the CUDA events of ``train.step``), the mean over
the window's unprofiled steps; nothing off the card."""

from portbench import spans


def read(ctx):
    return spans.step_device_ms(ctx)
