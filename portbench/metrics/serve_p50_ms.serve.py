"""The median latency of every request due in the window, from its due
time to its answer."""


def read(ctx):
    return ctx["host"]["p50_ms"]
