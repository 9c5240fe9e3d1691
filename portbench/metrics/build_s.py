"""Seconds the program spends building what the cell runs (its
``build.*`` spans: the model, the weights made or loaded, the move to
the card, then the optimizer or the service's warm-up forward)."""

from portbench import spans


def read(ctx):
    return spans.build_s(ctx)
