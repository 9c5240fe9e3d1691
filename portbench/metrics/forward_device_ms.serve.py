"""Median device milliseconds of the window's forwards (the CUDA events
around the service's forward in each ``serve.batch`` span that carried
a window's request); nothing off the card."""

import numpy as np

from portbench import spans


def read(ctx):
    if ctx["device_type"] != "cuda":
        return None
    b = spans.window_batches(ctx)
    if b is None or len(b["seq"]) == 0 or (b["value"] < 0).any():
        return None
    return float(np.median(b["value"])) / 1e6
