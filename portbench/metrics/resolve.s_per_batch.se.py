"""Seconds a batch spends in host finalisation and record resolution to SAM."""

from portbench import readers


def read(win):
    return readers.span_s_per_batch(win, "finish", "resolve")
