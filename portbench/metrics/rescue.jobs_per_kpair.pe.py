"""Mate-rescue jobs a thousand pairs."""

from portbench import readers


def read(win):
    return readers.rescue_jobs_per_kunit(win)
