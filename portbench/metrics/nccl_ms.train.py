"""Device milliseconds a step of collective kernels (NCCL) on rank 0, in
the profiled steps."""

PATTERNS = ("nccl",)


def read(ctx):
    trace = ctx.get("trace")
    if ctx["device_type"] != "cuda" or trace is None:
        return None
    n, seconds = trace.device_seconds(PATTERNS)
    steps = ctx["host"].get("traced_steps")
    return 1e3 * seconds / steps if n and steps else None
