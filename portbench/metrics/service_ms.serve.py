"""95th percentile over the window's requests of the milliseconds from
the start of the forward that carries the request to its answer (the
service's request records)."""

import numpy as np

from portbench import spans


def read(ctx):
    r = spans.window_requests(ctx)
    if r is None:
        return None
    return float(np.percentile((r["answer"] - r["dispatch"]) / 1e6, 95))
