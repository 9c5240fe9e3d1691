"""Bytes copied to the device from pinned host blocks as a share of all
bytes the batch copies moved (the counters ``data.pinned_bytes`` and
``data.copied_bytes`` inside the window's ``data.copy`` spans), in
percent."""

from portbench import spans


def read(ctx):
    rec = spans.recorder()
    if rec is None:
        return None
    t = spans._last_unprofiled(rec.records("data.copy"), int(ctx["host"]["steps"]))
    if t is None:
        return None
    copied = spans.counted("data.copied_bytes", t["seq"])
    pinned = spans.counted("data.pinned_bytes", t["seq"])
    return 100.0 * pinned / copied if copied else None
