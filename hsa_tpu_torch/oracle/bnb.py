"""Branch-and-bound inexact search oracle (lineage: ``bwtgap.c:bwt_match_gap``).

The port's copy of ``hsa_tpu/oracle/bnb.py``: a host search, as there.

Best-first search over SA-interval states, with the budgets/pruning of
SURVEY.md Appendix A.3.  Documented deviations from the strict lineage
(chosen to make the accepted hit set order-independent, hence reproducible
by a depth-synchronous device beam — see SURVEY.md §7.3.1):

1. ``max_entries`` / ``max_top2`` early-stops are NOT applied during the
   search; the full score-window hit set is enumerated and caps are applied
   at resolution.  (Affects only highly repetitive reads, whose MAPQ is 0.)
2. ``gap_shadow`` interval shadowing is replaced by exact position-level
   deduplication at resolution (same intent: count each genome occurrence
   once even when multiple gap placements reach it).

State machine: affine transitions M->{M,I,D}, I->{I,M}, D->{D,M}.
An insertion consumes a read base, a deletion consumes a genome base.
A diff made from a state with ``i`` unmatched read bases is a *seed* diff
iff ``i > len - seed_len`` (the seed is the 3' end of the read, which the
backward search processes first).
Indels are forbidden within ``indel_end_skip`` bases of either read end:
require ``len - i >= skip`` and ``i >= skip``.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from ..config import AlnOpt
from ..fmcore import FMIndex, cal_width

M, I, D = 0, 1, 2  # last-operation state


@dataclass(frozen=True)
class Hit:
    """One recorded hit: an SA interval plus the path budgets that reached it."""

    score: int
    nmm: int
    ngapo: int
    ngape: int
    k: int
    l: int

    @property
    def width(self) -> int:
        return self.l - self.k + 1


def match_gap(fm: FMIndex, read: np.ndarray, D_arr: np.ndarray, opt: AlnOpt,
              max_diff: int | None = None) -> list[Hit]:
    """All hits of ``read`` with score within ``s_mm`` of the best.

    ``D_arr`` is the prefix lower-bound array from :func:`hsa_tpu_torch.fmcore.cal_width`
    (pass zeros to disable pruning; pruning never changes the hit set, only
    the work).  Returns [] if the read has no alignment within budgets.
    """
    L = len(read)
    if max_diff is None:
        max_diff = opt.diff_budget(L)
    seed_start = L - opt.seed_len  # read positions >= seed_start are in the seed
    skip = opt.indel_end_skip

    best_score = None
    hits: dict[tuple, Hit] = {}
    # heap entries: (score, tiebreak, k, l, i, nmm, ngapo, ngape, state, seed_mm)
    counter = 0
    heap = [(0, 0, 0, fm.n, L, 0, 0, 0, M, 0)]

    def push(score, k, l, i, nmm, ngapo, ngape, state, seed_mm):
        nonlocal counter
        ndiff = nmm + ngapo + ngape
        if ndiff > max_diff:
            return
        lb = int(D_arr[i - 1]) if i > 0 else 0
        if ndiff + lb > max_diff:
            return
        if seed_mm > opt.max_seed_diff:
            return
        if best_score is not None and score > best_score + opt.s_mm:
            return
        counter += 1
        heapq.heappush(heap, (score, counter, k, l, i, nmm, ngapo, ngape, state, seed_mm))

    while heap:
        score, _, k, l, i, nmm, ngapo, ngape, state, seed_mm = heapq.heappop(heap)
        if best_score is not None and score > best_score + opt.s_mm:
            break  # best-first: nothing better remains
        if i == 0:
            if best_score is None:
                best_score = score
            key = (k, l, nmm, ngapo, ngape)
            if key not in hits or hits[key].score > score:
                hits[key] = Hit(score, nmm, ngapo, ngape, k, l)
            continue

        in_seed = i > seed_start
        p = i - 1
        b = int(read[p])
        consumed = L - i

        indel_ok = consumed >= skip and i >= skip

        # deletions: extend interval with a genome base, keep i
        if indel_ok and (state == M and ngapo < opt.max_gapo
                         or state == D and ngape < opt.max_gape):
            open_ = state == M
            for a in range(4):
                k2, l2 = fm.extend(a, k, l)
                if k2 <= l2:
                    push(score + (opt.s_gapo if open_ else opt.s_gape),
                         int(k2), int(l2), i, nmm,
                         ngapo + open_, ngape + (not open_), D, seed_mm + in_seed)

        # insertions: consume a read base, keep interval
        if indel_ok and (state == M and ngapo < opt.max_gapo
                         or state == I and ngape < opt.max_gape):
            open_ = state == M
            push(score + (opt.s_gapo if open_ else opt.s_gape),
                 k, l, i - 1, nmm,
                 ngapo + open_, ngape + (not open_), I, seed_mm + in_seed)

        # match / mismatch: consume a read base, extend interval
        for a in range(4):
            k2, l2 = fm.extend(a, k, l)
            if k2 <= l2:
                if a == b:
                    push(score, int(k2), int(l2), i - 1, nmm, ngapo, ngape, M, seed_mm)
                else:
                    push(score + opt.s_mm, int(k2), int(l2), i - 1, nmm + 1, ngapo,
                         ngape, M, seed_mm + in_seed)

    if best_score is None:
        return []
    out = [h for h in hits.values() if h.score <= best_score + opt.s_mm]
    out.sort(key=lambda h: (h.score, h.k, h.l, h.nmm, h.ngapo, h.ngape))
    return out


def align_read(fm: FMIndex, fm_rev: FMIndex, read: np.ndarray, opt: AlnOpt) -> list[Hit]:
    """Search one strand of one read: width pass then branch-and-bound."""
    D_arr = cal_width(fm_rev, read)
    max_diff = opt.diff_budget(len(read))
    if D_arr[-1] > max_diff:
        return []
    return match_gap(fm, read, D_arr, opt, max_diff)
