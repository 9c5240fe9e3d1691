"""95th percentile over the window's requests of the milliseconds from
``submit`` to the start of the forward that carries the request (the
service's request records)."""

import numpy as np

from portbench import spans


def read(ctx):
    r = spans.window_requests(ctx)
    if r is None:
        return None
    return float(np.percentile((r["dispatch"] - r["submit"]) / 1e6, 95))
