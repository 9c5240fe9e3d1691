"""Host milliseconds a step spends in the loader, stager and copy (the
benchmark's span around them), over the window's steps."""


def read(ctx):
    host = ctx["host"]
    return 1e3 * host["loader_s"] / host["steps"]
