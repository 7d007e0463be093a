"""Seconds a pair batch spends in host finalisation, pairing, mate rescue and SAM."""

from portbench import readers


def read(win):
    return readers.span_s_per_batch(win, "finish", "resolve")
