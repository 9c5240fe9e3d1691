"""Padded rows as a share of all rows the window's forwards ran (the
counters ``serve.rows`` and ``serve.padded_rows`` inside the
``serve.batch`` spans that carried the window's requests), in percent."""

from portbench import spans


def read(ctx):
    b = spans.window_batches(ctx)
    if b is None or len(b["seq"]) == 0:
        return None
    rows = spans.counted("serve.rows", b["seq"])
    padded = spans.counted("serve.padded_rows", b["seq"])
    return 100.0 * padded / (rows + padded) if rows + padded else None
