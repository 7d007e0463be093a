"""Mate rescue on a torch device, bound into the shared paired resolver.

Counterpart of ``hsa_tpu/resolve/sampe.py:_rescue_batch`` (:756-847).  A
pair whose one end maps (or maps discordantly) and whose other end does not
gets the missing mate aligned glocally inside the window that the insert
size implies.  :func:`rescue_batch` does it as screen then traceback, the
design of ``sampe.py:803-847``:

1. the windows from the shared ``_rescue_window``;
2. one :func:`~hsa_tpu_torch.kernels.sw.glocal_screen` over every job on
   the device, at the jobs' exact shapes (nothing recompiles in PyTorch);
3. a job is dropped when its window is shorter than its read or its cost
   is above ``max(diff_budget(L), round(0.15 L)) * s_mm``;
4. the native ``glocal_batch`` traces back only the jobs that are left;
5. the shared ``_rescue_accept`` / ``_cigar_from_ops`` build the
   occurrences.

The screen's cost equals the native DP's (both are ``fit_in_window``'s
twins), so the jobs dropped in step 3 are exactly those the reference's
``_rescue_accept`` rejects, and the records cannot differ from the
reference's, which traces back every job natively.

The shared ``resolve_pe_from_occ_arrays`` (:903) calls the module-level
``_rescue_batch`` and takes no parameter for it; :func:`bind_rescue` makes
a copy of that function whose globals name the port's rescue instead.  The
reference's own function is left as it is (both run in one test process),
and the port never reaches the ``jax.numpy`` fallback at ``sampe.py:803``.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from hsa_tpu import alphabet
from hsa_tpu.resolve.sampe import (_cigar_from_ops, _rescue_accept,
                                   _rescue_window)

from .. import refpack
from ..index.layout import resolve_device
from ..kernels.sw import glocal_screen


def rescue_batch(text, meta, jobs, rlim, opt, device):
    """Every rescue job screened in one device DP; yields
    ``(pair_idx, missing_end, Occurrence | None)`` in job order, as
    ``sampe._rescue_batch`` does.

    ``jobs``: ``[(pair_idx, missing_end, anchor, read, L)]``.
    """
    if not jobs:
        return
    R = len(jobs)
    prepped = []
    for j, missing, anchor, read, L in jobs:
        lo, hi, strand = _rescue_window(text, meta, anchor, L, rlim)
        target = alphabet.revcomp(read) if strand == 1 else np.asarray(read)
        prepped.append((j, missing, lo, hi, strand, target, L))
    lens = np.fromiter((p[6] for p in prepped), np.int32, R)
    lo = np.fromiter((p[2] for p in prepped), np.int64, R)
    wlens = np.fromiter((p[3] - p[2] for p in prepped), np.int32, R)
    reads = np.zeros((R, int(lens.max())), np.int32)
    for i, p in enumerate(prepped):
        reads[i, :p[6]] = p[5]
    text = np.asarray(text)
    # window columns past wlens are never read: clamp them into the text
    cols = np.arange(max(int(wlens.max()), 1))
    wins = text[np.minimum(lo[:, None] + cols, len(text) - 1)].astype(np.int32)

    dev = resolve_device(device)
    cost, _end = glocal_screen(*(torch.from_numpy(a).to(dev)
                                 for a in (reads, lens, wins, wlens)),
                               opt.s_mm, opt.s_gapo, opt.s_gape)
    cost = cost.cpu().numpy()
    budget = {L: max(opt.diff_budget(L), round(0.15 * L)) * opt.s_mm
              for L in set(lens.tolist())}
    keep = np.flatnonzero((wlens >= lens) & (cost <= np.fromiter(
        (budget[L] for L in lens.tolist()), np.int64, R)))

    found = {}
    if keep.size:
        Lmax = reads.shape[1]
        c2, start, ops = refpack.glocal_batch(
            reads[keep].astype(np.uint8), np.arange(keep.size) * Lmax,
            lens[keep], text, lo[keep], wlens[keep], opt.s_mm, opt.s_gapo,
            opt.s_gape)
        for k, i in enumerate(keep.tolist()):
            _, _, lo_i, hi_i, strand, target, L = prepped[i]
            found[i] = _rescue_accept(text, lo_i, hi_i, strand, target, L,
                                      int(c2[k]), int(start[k]),
                                      _cigar_from_ops(ops[k]), opt)
    for i, p in enumerate(prepped):
        yield p[0], p[1], found.get(i)


def bind_rescue(f, rescue):
    """A copy of the shared function ``f`` whose global ``_rescue_batch``
    is ``rescue``; ``f`` itself is not changed.  Raises when ``f`` does not
    name ``_rescue_batch`` (a rename in the reference would otherwise leave
    its own rescue in place)."""
    if "_rescue_batch" not in f.__code__.co_names:
        raise RuntimeError(f"{f.__qualname__} does not call _rescue_batch")
    g = types.FunctionType(f.__code__,
                           {**f.__globals__, "_rescue_batch": rescue},
                           f.__name__, f.__defaults__, f.__closure__)
    g.__kwdefaults__ = f.__kwdefaults__
    g.__doc__ = f.__doc__
    return g
