"""Numpy reference FM-index: the port's copy of ``hsa_tpu/fmcore.py``.

The index behind the CPU oracle (:mod:`hsa_tpu_torch.oracle.bnb`), held
bit-equal to the reference's module in the tests.  Host numpy only: the
search engines run on the port's blocked layout (``index.layout``) and the
native SA-IS (``refpack``); this module is the semantics those are tested
against.  The conventions mirror the BWA-0.5.x lineage (reference:
``bwt.c``):

Text & suffix array
  Text ``T`` has length ``n`` over codes {0,1,2,3}.  The suffix array ``SA``
  is over ``T + $`` (sentinel smaller than every base), so it has ``n+1``
  entries and ``SA[0] == n`` always.  "Ranks" r are rows of the sorted
  rotation matrix, 0..n inclusive.

BWT & primary
  ``bwt_full[r] = T[SA[r]-1]`` for ``SA[r] > 0``; the row with ``SA[r] == 0``
  would hold the sentinel and is *removed* from the stored BWT (length n);
  its rank is ``primary`` (lineage: ``bwt_t.primary``).

occ / C / backward extension
  ``occ(a, r)`` = number of occurrences of base ``a`` among bwt_full rows
  ``0..r`` excluding the primary row, defined for r in [-1, n].
  ``C[a] = 1 + #{i : T[i] < a}`` (the +1 is the sentinel's rank).
  A pattern with SA interval [k, l] (inclusive; empty pattern -> [0, n])
  extends on the left with base ``a`` to::

      k' = C[a] + occ(a, k-1)
      l' = C[a] + occ(a, l) - 1        (non-empty iff k' <= l')

  (Equivalent to the lineage's ``bwt_2occ4``-driven update.)

LF & locate
  ``LF(r) = C[c] + occ(c, r) - 1`` with ``c = bwt_full[r]``; ``LF(primary)
  = 0``.  Locate uses *text-position sampling*: ranks whose SA value is a
  multiple of ``sa_intv`` are marked, so an LF-walk reaches a marked rank in
  at most ``sa_intv - 1`` steps — a static bound, which is what makes the
  device-side locate a fixed-trip-count masked loop.  (The lineage samples
  by rank — ``bwt_sa``'s walk is only *expected* O(intv) there; the sampling
  strategy is invisible in the output, so we choose the bounded one.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array of ``t + $`` via prefix doubling (O(n log^2 n), numpy).

    Good to ~1e6 for tests; production index builds use the native SA-IS in
    ``hsa_tpu_torch.refpack``.
    """
    n1 = len(t) + 1
    rank = np.concatenate([t.astype(np.int64), [-1]])
    k = 1
    while True:
        key2 = np.concatenate([rank[k:], np.full(min(k, n1), -2, dtype=np.int64)])
        sa = np.lexsort((key2, rank))
        new = np.ones(n1, dtype=bool)
        new[1:] = (rank[sa[1:]] != rank[sa[:-1]]) | (key2[sa[1:]] != key2[sa[:-1]])
        r = np.cumsum(new) - 1
        rank = np.empty(n1, dtype=np.int64)
        rank[sa] = r
        if r[-1] == n1 - 1:
            return sa.astype(np.int64)
        k *= 2


def bwt_from_sa(t: np.ndarray, sa: np.ndarray) -> tuple[np.ndarray, int]:
    """(stored_bwt, primary): BWT with the sentinel row removed."""
    primary = int(np.nonzero(sa == 0)[0][0])
    prev = sa - 1
    keep = sa != 0
    bwt = t[prev[keep]].astype(np.int8)
    return bwt, primary


@dataclass
class FMIndex:
    """Numpy FM-index (full occ table — reference/testing implementation)."""

    n: int
    primary: int
    bwt: np.ndarray          # stored BWT, int8, length n
    C: np.ndarray            # int64[5]; C[4] = n+1 sentinel-inclusive total
    cum: np.ndarray          # int64[(n+1), 4]; cum[i,a] = # a in bwt[0:i]
    sa_intv: int
    marks: np.ndarray        # bool[n+1] over ranks: SA[r] % sa_intv == 0
    mark_rank: np.ndarray    # int64[n+1]: # marked ranks < r
    samples: np.ndarray      # int64[n_marks]: SA values of marked ranks (rank order)
    sa: np.ndarray | None = None  # full SA (testing only)

    @classmethod
    def build(cls, t: np.ndarray, sa_intv: int = 32, keep_sa: bool = True) -> "FMIndex":
        t = np.asarray(t, dtype=np.int8)
        if t.size and (t.min() < 0 or t.max() > 3):
            raise ValueError("text must be over codes 0..3 (substitute ambiguous first)")
        sa = suffix_array(t)
        bwt, primary = bwt_from_sa(t, sa)
        n = len(t)
        counts = np.bincount(t, minlength=4).astype(np.int64)
        # C[0]=1 (sentinel occupies rank 0), C[a] = 1 + #{chars < a}, C[4] = n+1
        C = np.concatenate([[1], 1 + np.cumsum(counts)])
        onehot = np.zeros((n + 1, 4), dtype=np.int64)
        if n:
            onehot[1:][np.arange(n), bwt.astype(np.int64)] = 1
        cum = np.cumsum(onehot, axis=0)
        marks = (sa % sa_intv) == 0
        mark_rank = np.concatenate([[0], np.cumsum(marks)[:-1]])
        samples = sa[marks]
        return cls(n=n, primary=primary, bwt=bwt, C=C, cum=cum, sa_intv=sa_intv,
                   marks=marks, mark_rank=mark_rank, samples=samples,
                   sa=sa if keep_sa else None)

    # -- occ ----------------------------------------------------------------
    def occ(self, a: int, r) -> np.ndarray:
        """# of base ``a`` in bwt_full[0..r] excluding primary; r in [-1, n]."""
        r = np.asarray(r, dtype=np.int64)
        stored = np.where(r < self.primary, r + 1, r)  # # stored rows among full rows 0..r
        stored = np.clip(stored, 0, self.n)
        return self.cum[stored, a]

    def bwt_char(self, r: int) -> int:
        """bwt_full[r]; undefined (returns -1) at r == primary."""
        if r == self.primary:
            return -1
        j = r if r < self.primary else r - 1
        return int(self.bwt[j])

    # -- backward extension -------------------------------------------------
    def extend(self, a: int, k, l):
        """Left-extend interval [k,l] with base a. Empty iff k' > l'."""
        k2 = self.C[a] + self.occ(a, np.asarray(k) - 1)
        l2 = self.C[a] + self.occ(a, l) - 1
        return k2, l2

    def exact_interval(self, pattern: np.ndarray):
        """SA interval of pattern (right-to-left); (k, l) with k>l if absent."""
        k, l = 0, self.n
        for a in pattern[::-1]:
            if a > 3:
                return 1, 0
            k, l = self.extend(int(a), k, l)
            if k > l:
                return 1, 0
        return int(k), int(l)

    # -- LF / locate ---------------------------------------------------------
    def lf(self, r: int) -> int:
        if r == self.primary:
            return 0
        c = self.bwt_char(r)
        return int(self.C[c] + self.occ(c, r) - 1)

    def locate(self, r: int) -> int:
        """Text position of rank r; walk is bounded by sa_intv - 1 steps."""
        steps = 0
        while not self.marks[r]:
            r = self.lf(r)
            steps += 1
        return int(self.samples[self.mark_rank[r]] + steps)

    def locate_interval(self, k: int, l: int) -> np.ndarray:
        return np.array(sorted(self.locate(r) for r in range(k, l + 1)), dtype=np.int64)


def cal_width(rev_index: FMIndex, read: np.ndarray) -> np.ndarray:
    """Lower-bound array D(i) (lineage: ``bwtaln.c:bwt_cal_width``).

    D[i] = lower bound on the number of differences needed to match the
    prefix ``read[0..i]`` anywhere in the text.  Computed by greedy exact
    extension with resets on the *reverse-text* index (extending the prefix
    on the right = backward extension on the reversed text).  Read code 4
    (N) always breaks the match.
    """
    D = np.zeros(len(read), dtype=np.int32)
    z = 0
    k, l = 0, rev_index.n
    for i, c in enumerate(read):
        ok = False
        if c <= 3:
            k2, l2 = rev_index.extend(int(c), k, l)
            if k2 <= l2:
                k, l = int(k2), int(l2)
                ok = True
        if not ok:
            z += 1
            k, l = 0, rev_index.n
        D[i] = z
    return D
