"""Seconds a batch spends on the stream's main thread outside the layers
below it: waiting for the worker threads' searches and the reader, the
pooled flush's bookkeeping and the splice (the window's time less the main
thread's spans in finalisation, resolution, retry and beam)."""

from portbench import readers


def read(win):
    return readers.stream_self_s_per_batch(win)
