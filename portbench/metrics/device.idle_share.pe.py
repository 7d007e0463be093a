"""Percent of the profiled sub-window in which no operation ran on the device."""

from portbench import readers


def read(win):
    return readers.idle_share(win)
