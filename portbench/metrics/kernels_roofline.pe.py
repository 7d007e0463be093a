"""Percent: the hand kernels' least times over their device times in the profiled sub-window."""

from portbench import readers


def read(win):
    return readers.kernels_roofline(win)
