"""The share of a segment recorded with the card's activity alone (no
host operations, which slow the host) in which no operation ran on the
card: one less the union of device intervals over the same segment's
wall time, in percent."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
