"""Batched exact-match backward search (torch).

Counterpart of ``hsa_tpu/search/exact.py``: all reads of a batch advance
their SA interval one base per step, in lockstep, with masks for finished
and dead lanes.  The reference's ``lax.scan`` over read columns is a Python
loop here (the pigeonhole engine, the only caller on the main path, scans 4
to 18 columns).

Input layout: reads are *reversed* into processing order (backward search
consumes the read 3'->5') and padded with PAD=5 to a static length.
Code 4 (N) kills the lane (N never matches); PAD lanes carry state through.

Types follow :mod:`hsa_tpu_torch.search.fm`: ranks and intervals are
``int64`` tensors holding values in ``[0, 2^32)``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fm

PAD = 5
NO_POS = 0xFFFFFFFE      # locate_all's sentinel: no genome position


def pack_reads(reads, max_len: int):
    """Host-side: list of int8 code arrays -> (reads_rev uint8[B,max_len], lens int32[B]).

    Each row is the read reversed (processing order), padded with PAD.
    """
    B = len(reads)
    out = np.full((B, max_len), PAD, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, r in enumerate(reads):
        L = min(len(r), max_len)
        out[i, :L] = np.asarray(r, dtype=np.uint8)[::-1][:L]
        lens[i] = L
    return out, lens


def as_wide(x, device):
    """numpy array or tensor -> int64 tensor on ``device`` (unsigned numpy
    types keep their values)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


def exact_search(idx, reads_rev, lens, init=None):
    """(k, l, matched): SA intervals of each full read; matched=False if absent.

    reads_rev: integer [B, Lmax] in processing order, PAD-padded.
    ``init``: optional (k0, l0, alive0) seed state, e.g. K-mer-table
    intervals for the already-consumed prefix (see :func:`kmer_table`).
    """
    reads_rev = as_wide(reads_rev, idx.device)
    B = reads_rev.shape[0]
    if init is None:
        k = torch.zeros(B, dtype=torch.int64, device=idx.device)
        l = torch.full_like(k, idx.n)
        alive = as_wide(lens, idx.device) > 0
    else:
        k, l, alive = init
    for t in range(reads_rev.shape[1]):
        col = reads_rev[:, t]
        is_pad = col >= PAD
        k2, l2 = fm.extend(idx, col, k, l)
        ok = (k2 <= l2) & (col != 4)
        upd = alive & ~is_pad
        k = torch.where(upd, k2, k)
        l = torch.where(upd, l2, l)
        alive = alive & (is_pad | ok)
    return k, l, alive & (k <= l)


def kmer_table(idx, K: int, chunk: int = 1 << 22):
    """SA intervals of every K-mer: (tk, tl) int64[4^K] on the index's device.

    Index convention matches backward-search consumption order: a pattern
    consumed as c_0, c_1, ... (rightmost character first) has index
    p = sum_t c_t * 4^(K-1-t); empty intervals are the self-propagating
    sentinel (1, 0).  Seeding a segment search with ``tk[p], tl[p]``
    replaces the first K scan steps with one table gather per end.

    Level-by-level BFS; the big final levels run in chunks of ``chunk``
    children, so the FM step's int64 row intermediates (64 bytes a lane,
    two lanes a child) stay bounded whatever K is.
    """
    dev = idx.device

    def level(k, l):
        ks = k.repeat_interleave(4)
        ls = l.repeat_interleave(4)
        a = torch.arange(ks.shape[0], device=dev) & 3
        k2, l2 = fm.extend(idx, a, ks, ls)
        empty = k2 > l2
        return torch.where(empty, 1, k2), torch.where(empty, 0, l2)

    k = torch.zeros(1, dtype=torch.int64, device=dev)
    l = torch.full_like(k, idx.n)
    step_in = chunk // 4
    for _ in range(K):
        if k.shape[0] <= step_in:
            k, l = level(k, l)
        else:
            outs = [level(k[i:i + step_in], l[i:i + step_in])
                    for i in range(0, k.shape[0], step_in)]
            k = torch.cat([o[0] for o in outs])
            l = torch.cat([o[1] for o in outs])
    return k, l


def locate_all(idx, k, l, matched, cap: int):
    """Positions of up to ``cap`` occurrences per read: (pos int64[B,cap], cnt int64[B]).

    Occurrences beyond ``cap`` are dropped (cnt still reports the true total).
    Unmatched lanes report cnt=0; slots past a read's count hold NO_POS.
    """
    cnt_full = torch.where(matched, l - k + 1, 0)
    take = cnt_full.clamp(max=cap)
    offs = torch.arange(cap, device=k.device)[None, :]
    valid = offs < take[:, None]
    ranks = torch.where(valid, k[:, None] + offs, 0)
    pos = fm.locate(idx, ranks.reshape(-1)).reshape(ranks.shape)
    return torch.where(valid, pos, NO_POS), cnt_full
