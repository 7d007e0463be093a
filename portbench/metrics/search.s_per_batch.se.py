"""Seconds a batch spends in the device search: pack, search and result fetch, on the stream's worker threads."""

from portbench import readers


def read(win):
    return readers.span_s_per_batch(win, "search")
