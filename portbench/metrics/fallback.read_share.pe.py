"""Percent of the reads (ends) sent to the retry or the beam fallback."""

from portbench import readers


def read(win):
    return readers.escalated_share(win)
