"""Device milliseconds a step in the gradients' reduction over the ranks
(the CUDA events of ``ShardedOptimizer.reduce_gradients``'s
``train.grad_reduce`` span) on rank 0, over the window's unprofiled
steps; nothing off the card or on one rank."""

from portbench import spans


def read(ctx):
    return spans.child_device_ms(ctx, "train.grad_reduce")
