"""The reference's searches spread over worker processes (``spawn``), each
holding the index once: the suffix arrays and occ tables are memory-mapped
from the cache, so the workers share them through the page cache.

``Refs(paths, rname, opts, workers)``: ``align(which, items)`` gives
``oracle.Reference.align`` of each ``(read, name, qual, ordinal)`` and
``occurrences(which, reads, max_occ)`` each read's occurrences, under
``opts[which]``; ``repeats(reads, k, over)`` ``oracle.Reference.repeat`` of
each, and ``beam_repeats(reads, over)`` ``oracle.Reference.beam_repeat``.
With ``workers`` 0 everything runs in this process.
"""

from __future__ import annotations

import multiprocessing

import numpy as np

from . import oracle

_REFS: list = []


def load(paths, rname, opts):
    """One Reference per option set over the cached arrays."""
    g = np.load(paths["genome"])
    base = oracle.Reference(
        g, rname, np.load(paths["sa_fwd"], mmap_mode="r"),
        np.load(paths["sa_rev"], mmap_mode="r"), opts[0],
        (np.load(paths["cum_fwd"], mmap_mode="r"),
         np.load(paths["cum_rev"], mmap_mode="r")))
    return [base] + [base.with_opt(o) for o in opts[1:]]


def _init(paths, rname, opts):
    _REFS[:] = load(paths, rname, opts)


def _align(task):
    which, read, name, qual, ordinal = task
    return _REFS[which].align(read, name, qual, ordinal)


def _occurrences(task):
    which, read, max_occ = task
    return _REFS[which].occurrences(read, max_occ)


def _repeat(task):
    read, k, over = task
    return _REFS[0].repeat(read, k, over)


def _beam_repeat(task):
    read, over = task
    return _REFS[0].beam_repeat(read, over)


class Refs:
    def __init__(self, paths, rname, opts, workers: int):
        self.refs = load(paths, rname, opts)
        self.pool = None
        if workers > 0:
            ctx = multiprocessing.get_context("spawn")
            self.pool = ctx.Pool(workers, initializer=_init,
                                 initargs=(paths, rname, opts))

    def _map(self, fn, tasks):
        if self.pool is None:
            _REFS[:] = self.refs
            return [fn(t) for t in tasks]
        return self.pool.map(fn, tasks, chunksize=1)

    def align(self, which, items):
        return self._map(_align, [(which, *it) for it in items])

    def occurrences(self, which, reads, max_occ):
        return self._map(_occurrences, [(which, r, max_occ) for r in reads])

    def repeats(self, reads, k, over):
        return self._map(_repeat, [(r, k, over) for r in reads])

    def beam_repeats(self, reads, over):
        return self._map(_beam_repeat, [(r, over) for r in reads])

    def close(self):
        if self.pool is not None:
            self.pool.close()
            self.pool.join()
            self.pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
