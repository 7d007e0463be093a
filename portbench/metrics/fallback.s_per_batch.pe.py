"""Seconds a batch spends in the pooled retry and the pooled beam."""

from portbench import readers


def read(win):
    return readers.span_s_per_batch(win, "retry", "beam")
