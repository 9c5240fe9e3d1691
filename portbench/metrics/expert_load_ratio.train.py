"""The most token assignments on one held routed expert over the held
experts' mean (the program's counters ``moe.held_max`` and
``moe.held_tokens``), averaged over the window's steps and routed
layers: 1 is a balanced share; the slowest expert's group sets the
grouped products' tail."""

from portbench import moe_readers


def read(ctx):
    return moe_readers.load_ratio(ctx)
