"""Device milliseconds a step inside the program's ``moe.*`` spans
(route, dispatch, experts, combine; the forward's, each timed by a CUDA
event pair), over the window's unprofiled steps."""

from portbench import moe_readers


def read(ctx):
    return moe_readers.device_ms(ctx)
