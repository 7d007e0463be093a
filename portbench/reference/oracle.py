"""The plain reference of the single-end record: a frozen copy of the port's
oracle (``fmcore.py``, ``oracle/bnb.py``, ``resolve/mapq.py``, the numpy
DP of ``resolve/cigar.py`` and the list resolver of ``resolve/samse.py``),
numpy only, importing nothing of the port.

What is changed from the copied code: the suffix array is built here by
prefix doubling from 16-base keys (the port's own build is native), the FM
index keeps the whole suffix array so that locate is a lookup (the oracle's
walk to a sampled rank gives the same position), and the reference holds one
sequence (the configurations' genomes have one record and no ambiguous
bases).  The search semantics are those of ``bwtgap.c:bwt_match_gap`` with the
port's two documented deviations (hits enumerated to the score window, not
cut by ``max_entries``; duplicate positions removed at resolution), and with
``bwtaln.c``'s seeding, where the port's oracle departs from bwa: the seed is
the last ``seed_len`` bases of a read longer than ``seed_len``, and a read of
``seed_len`` bases or fewer has none, so that ``max_seed_diff`` bounds
nothing there (the port counts the whole read as its seed).
"""

from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np

_HASH = 2654435761
BIG = 1 << 28


# -- options (config.py) -------------------------------------------------------
def cal_max_diff(length: int, err: float = 0.02, thres: float = 0.04) -> int:
    lam = length * err
    elam = math.exp(-lam)
    y, x, s = 1.0, 1, elam
    for k in range(1, 1000):
        y *= lam
        x *= k
        s += elam * y / x
        if 1.0 - s < thres:
            return k
    return 2


@dataclass
class Opt:
    """``bwa aln``'s options (the port's ``AlnOpt`` fields the search and
    the resolver read)."""

    max_diff: int = -1
    fnr: float = 0.04
    max_gapo: int = 1
    max_gape: int = 6
    seed_len: int = 32
    max_seed_diff: int = 2
    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    indel_end_skip: int = 5
    n_multi: int = 3

    def diff_budget(self, read_len: int) -> int:
        if self.max_diff >= 0:
            return self.max_diff
        return cal_max_diff(read_len, 0.02, self.fnr)


# -- the index (fmcore.py) -------------------------------------------------------
def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array (int32) of ``t + $`` (``$`` below every base) by prefix
    doubling, starting from ranks of the first 16 symbols."""
    t = np.asarray(t, np.int8)
    n1 = len(t) + 1
    K = 16
    x = np.zeros(n1 + K, np.int64)
    x[:len(t)] = t.astype(np.int64) + 1
    key = np.zeros(n1, np.int64)
    for j in range(K):
        key = (key << 3) | x[j:j + n1]
    del x
    k = K
    while True:
        order = np.argsort(key, kind="stable")
        sk = key[order]
        new = np.ones(n1, bool)
        new[1:] = sk[1:] != sk[:-1]
        del sk
        r = np.cumsum(new) - 1
        rank = np.empty(n1, np.int64)
        rank[order] = r
        if r[-1] == n1 - 1:
            return order.astype(np.int32)
        del order, r, new
        nxt = np.zeros(n1, np.int64)
        nxt[:n1 - k] = rank[k:] + 1
        key = rank * (n1 + 1) + nxt
        del rank, nxt
        k *= 2


def occ_table(t, sa):
    """``cum[i, a]``: base ``a`` among the first ``i`` rows of the stored
    BWT (the sentinel's row removed), int32."""
    sa = np.asarray(sa)
    bwt = np.asarray(t, np.int8)[sa[sa != 0].astype(np.int64) - 1]
    cum = np.zeros((len(t) + 1, 4), np.int32)
    for a in range(4):
        cum[1:, a] = np.cumsum(bwt == a)
    return cum


class FMIndex:
    """The oracle's FM index of one text: ``occ``, ``extend`` and ``locate``
    as in ``fmcore.FMIndex`` (full occ table, the whole suffix array)."""

    def __init__(self, t: np.ndarray, sa: np.ndarray, cum=None):
        t = np.asarray(t, np.int8)
        self.n = len(t)
        self.sa = sa
        self.primary = int(np.argmin(sa))
        counts = np.bincount(t, minlength=4).astype(np.int64)
        self.C = np.concatenate([[1], 1 + np.cumsum(counts)])
        self.cum = occ_table(t, sa) if cum is None else cum

    def occ(self, a: int, r: int) -> int:
        stored = r + 1 if r < self.primary else r
        stored = min(max(stored, 0), self.n)
        return int(self.cum[stored, a])

    def extend(self, a: int, k: int, l: int):
        c = int(self.C[a])
        return c + self.occ(a, k - 1), c + self.occ(a, l) - 1

    def locate(self, r: int) -> int:
        return int(self.sa[r])


def cal_width(rev: FMIndex, read: np.ndarray) -> np.ndarray:
    """Prefix lower bounds D(i) (``bwtaln.c:bwt_cal_width``)."""
    D = np.zeros(len(read), np.int32)
    z = 0
    k, l = 0, rev.n
    for i, c in enumerate(read):
        ok = False
        if c <= 3:
            k2, l2 = rev.extend(int(c), k, l)
            if k2 <= l2:
                k, l = k2, l2
                ok = True
        if not ok:
            z += 1
            k, l = 0, rev.n
        D[i] = z
    return D


# -- the search (oracle/bnb.py) --------------------------------------------------
M, I, D = 0, 1, 2


@dataclass(frozen=True)
class Hit:
    score: int
    nmm: int
    ngapo: int
    ngape: int
    k: int
    l: int


def seed_start(L: int, opt: Opt) -> int:
    """The seed of an ``L``-base read is its bases ``i > seed_start``: the
    last ``seed_len``, or none where ``seed_len`` is at or over ``L``
    (``bwtaln.c`` then passes ``bwt_match_gap`` no seed widths; the manual:
    "If INT is larger than the query sequence, seeding will be disabled")."""
    return L - opt.seed_len if opt.seed_len < L else L


def _children(fm: FMIndex, read, opt: Opt, start: int, s):
    """The states one step of the search reaches from state ``s`` = (score,
    k, l, i, nmm, ngapo, ngape, state, seed_mm), in ``bwt_match_gap``'s
    order: a deletion by each base, an insertion, a match or mismatch by
    each base.  Their budgets are :func:`_admissible`'s to check."""
    score, k, l, i, nmm, ngapo, ngape, state, seed_mm = s
    in_seed = i > start
    ext = [fm.extend(a, k, l) for a in range(4)]
    out = []
    skip = opt.indel_end_skip
    if (len(read) - i) >= skip and i >= skip:
        open_ = state == M
        cost = opt.s_gapo if open_ else opt.s_gape
        gapo, gape = ngapo + open_, ngape + (not open_)
        if open_ and ngapo < opt.max_gapo or state == D and \
                ngape < opt.max_gape:
            out += [(score + cost, k2, l2, i, nmm, gapo, gape, D,
                     seed_mm + in_seed) for k2, l2 in ext if k2 <= l2]
        if open_ and ngapo < opt.max_gapo or state == I and \
                ngape < opt.max_gape:
            out.append((score + cost, k, l, i - 1, nmm, gapo, gape, I,
                        seed_mm + in_seed))
    b = int(read[i - 1])
    for a, (k2, l2) in enumerate(ext):
        if k2 <= l2:
            mm = a != b
            out.append((score + opt.s_mm * mm, k2, l2, i - 1, nmm + mm,
                        ngapo, ngape, M, seed_mm + in_seed * mm))
    return out


def _admissible(s, D_arr, opt: Opt, max_diff: int) -> bool:
    """Whether state ``s`` keeps to the difference budget (with the lower
    bound ``D_arr`` of what its unread bases still cost) and the seed's."""
    i = s[3]
    lb = int(D_arr[i - 1]) if i > 0 else 0
    return s[4] + s[5] + s[6] + lb <= max_diff and s[8] <= opt.max_seed_diff


def match_gap(fm: FMIndex, read, D_arr, opt: Opt, max_diff: int):
    """All hits of ``read`` with score within ``s_mm`` of the best: a
    best-first search whose states beyond that window are never taken."""
    start = seed_start(len(read), opt)
    best_score = None
    hits: dict = {}
    counter = 0
    heap = [(0, 0, (0, 0, fm.n, len(read), 0, 0, 0, M, 0))]
    while heap:
        score, _, s = heapq.heappop(heap)
        if best_score is not None and score > best_score + opt.s_mm:
            break
        if s[3] == 0:
            if best_score is None:
                best_score = score
            _, k, l, _, nmm, ngapo, ngape, _, _ = s
            key = (k, l, nmm, ngapo, ngape)
            if key not in hits or hits[key].score > score:
                hits[key] = Hit(score, nmm, ngapo, ngape, k, l)
            continue
        for c in _children(fm, read, opt, start, s):
            if _admissible(c, D_arr, opt, max_diff) and (
                    best_score is None or c[0] <= best_score + opt.s_mm):
                counter += 1
                heapq.heappush(heap, (c[0], counter, c))
    if best_score is None:
        return []
    out = [h for h in hits.values() if h.score <= best_score + opt.s_mm]
    out.sort(key=lambda h: (h.score, h.k, h.l, h.nmm, h.ngapo, h.ngape))
    return out


def buffer_hits(fm: FMIndex, read, D_arr, opt: Opt, max_diff: int,
                cap: int) -> int:
    """The hits of ``read`` that the port's beam stores in its hit buffer,
    counted until the count passes ``cap``.  The beam takes every state one
    step a round (a deletion is a step), stores every completion within the
    budget, one a path and the score window aside, and from the first
    completion on keeps only the live states within ``s_mm`` of the best
    completion so far.  Here its width is unbounded: every state it could
    keep is kept.

    The first round that completes takes every deletion-free path within
    the budget, whatever its score, so a depth-first count of those decides
    first where it passes ``cap`` (a low-complexity read has thousands of
    them, and a frontier of 10^5 states before they complete)."""
    start = seed_start(len(read), opt)
    root = (0, 0, fm.n, len(read), 0, 0, 0, M, 0)
    stack, n = [root], 0
    while stack and n <= cap:
        for c in _children(fm, read, opt, start, stack.pop()):
            if c[7] != D and _admissible(c, D_arr, opt, max_diff):
                if c[3]:
                    stack.append(c)
                else:
                    n += 1
    if n > cap:
        return n
    front, best, n = [root], None, 0
    while front:
        live = []
        for s in front:
            for c in _children(fm, read, opt, start, s):
                if not _admissible(c, D_arr, opt, max_diff):
                    continue
                if c[3]:
                    live.append(c)
                else:
                    n += 1
                    best = c[0] if best is None else min(best, c[0])
        if n > cap:
            break
        front = (live if best is None
                 else [c for c in live if c[0] <= best + opt.s_mm])
    return n


def revcomp(codes):
    out = np.asarray(codes)[::-1].copy()
    m = out < 4
    out[m] = 3 - out[m]
    return out


def align_read(fm, fm_rev, read, opt: Opt):
    D_arr = cal_width(fm_rev, read)
    max_diff = opt.diff_budget(len(read))
    if D_arr[-1] > max_diff:
        return []
    return match_gap(fm, read, D_arr, opt, max_diff)


# -- resolution (resolve/samse.py, mapq.py, cigar.py) ------------------------------
@dataclass
class Occurrence:
    pos: int
    strand: int
    score: int
    nmm: int
    ngapo: int
    ngape: int


def collect_occurrences(hits_fwd, hits_rc, fm: FMIndex, max_occ: int = 512):
    """One read's deduplicated occurrences (``collect_occurrences_ref``):
    the budget ``max_occ`` spent across both strands in hit order, the
    lowest score kept per (pos, strand)."""
    budget, trunc, best = max_occ, False, {}
    for strand, hits in ((0, hits_fwd), (1, hits_rc)):
        for h in hits:
            w = h.l - h.k + 1
            take = min(w, budget)
            trunc |= take < w
            for r in range(h.k, h.k + take):
                key = (fm.locate(r), strand)
                cur = best.get(key)
                if cur is None or cur.score > h.score:
                    best[key] = Occurrence(key[0], strand, h.score, h.nmm,
                                           h.ngapo, h.ngape)
            budget -= take
    lst = sorted(best.values(), key=lambda o: (o.score, o.strand, o.pos))
    return lst, trunc


def g_log_n(n: int) -> int:
    return int(4.343 * math.log(n) + 0.5) if n > 0 else 0


def approx_mapq(c1, c2, nmm, max_diff):
    if c1 == 0:
        return 23
    if c1 > 1:
        return 0
    if nmm == max_diff:
        return 25
    if c2 == 0:
        return 37
    return max(23 - g_log_n(min(c2, 255)), 0)


def banded_global(read, ref, s_mm, s_gapo, s_gape, band):
    """(cost, cigar, ref bases consumed): the read aligned whole from the
    window's first base, the window's end free; ties M > D > I."""
    L, G = len(read), len(ref)
    band = max(band, 1)
    m = np.full((L + 1, G + 1), BIG, np.int64)
    ins = np.full((L + 1, G + 1), BIG, np.int64)
    dele = np.full((L + 1, G + 1), BIG, np.int64)
    m[0, 0] = 0
    for j in range(1, min(G, L + band) + 1):
        dele[0, j] = s_gapo + (j - 1) * s_gape
    for i in range(1, min(L, band) + 1):
        ins[i, 0] = s_gapo + (i - 1) * s_gape
    for i in range(1, L + 1):
        jlo, jhi = max(1, i - band), min(G, i + band)
        if jlo > jhi:
            continue
        js = np.arange(jlo, jhi + 1)
        sub = np.where(read[i - 1] == ref[js - 1], 0, s_mm)
        if read[i - 1] > 3:
            sub[:] = s_mm
        m[i, js] = np.minimum(np.minimum(m[i - 1, js - 1], ins[i - 1, js - 1]),
                              dele[i - 1, js - 1]) + sub
        ins[i, js] = np.minimum(m[i - 1, js] + s_gapo, ins[i - 1, js] + s_gape)
        row_m, row_d = m[i], dele[i]
        for j in js:
            row_d[j] = min(row_m[j - 1] + s_gapo, row_d[j - 1] + s_gape)
    totals = np.minimum(np.minimum(m[L], ins[L]), dele[L])
    jend = int(np.argmin(totals))
    cost = int(totals[jend])
    ops = []
    i, j = L, jend
    state = int(np.argmin([m[L, jend], dele[L, jend], ins[L, jend]]))
    while i > 0 or j > 0:
        if i == 0:
            ops.append("D"); j -= 1; continue
        if j == 0:
            ops.append("I"); i -= 1; continue
        if state == 0:
            sub = s_mm if (read[i - 1] > 3 or read[i - 1] != ref[j - 1]) else 0
            prev = [m[i - 1, j - 1], dele[i - 1, j - 1], ins[i - 1, j - 1]]
            target = m[i, j] - sub
            for s_, p_ in enumerate(prev):
                if p_ == target:
                    state = s_
                    break
            ops.append("M"); i -= 1; j -= 1
        elif state == 1:
            state = 0 if m[i, j - 1] + s_gapo == dele[i, j] else 1
            ops.append("D"); j -= 1
        else:
            state = 0 if m[i - 1, j] + s_gapo == ins[i, j] else 2
            ops.append("I"); i -= 1
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return cost, [(op, ln) for op, ln in cigar], jend


def cigar_stats(cigar, read, ref):
    """(NM, MD) of an alignment."""
    nm, parts, run, i, j = 0, [], 0, 0, 0
    for op, ln in cigar:
        if op == "M":
            for _ in range(ln):
                if read[i] <= 3 and read[i] == ref[j]:
                    run += 1
                else:
                    nm += 1
                    parts += [str(run), "ACGTN"[min(int(ref[j]), 4)]]
                    run = 0
                i += 1
                j += 1
        elif op == "I":
            nm += ln
            i += ln
        elif op == "D":
            nm += ln
            parts += [str(run), "^" + "".join(
                "ACGTN"[min(int(ref[j + t]), 4)] for t in range(ln))]
            run = 0
            j += ln
    parts.append(str(run))
    return nm, "".join(parts)


def decode(codes) -> str:
    return np.frombuffer(b"ACGTN", np.uint8)[
        np.clip(np.asarray(codes), 0, 4)].tobytes().decode()


@dataclass
class Record:
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    seq: str
    qual: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    tags: dict = field(default_factory=dict)

    def to_sam(self) -> str:
        tags = []
        for t in ("XT", "X0", "X1", "XN", "XM", "XO", "XG", "NM", "MD", "XA"):
            if t in self.tags:
                v = self.tags[t]
                tags.append(f"{t}:{'i' if isinstance(v, int) else 'Z'}:{v}")
        return "\t".join([self.qname, str(self.flag), self.rname, str(self.pos),
                          str(self.mapq), self.cigar, self.rnext,
                          str(self.pnext), str(self.tlen), self.seq,
                          self.qual or "*"] + tags)


def make_record(text, rname, read, name, qual, o: Occurrence, mapq, opt: Opt):
    L = len(read)
    if o.strand:
        aln = revcomp(read)
        q = qual[::-1] if qual and qual != "*" else qual
        flag = 16
    else:
        aln, q, flag = np.asarray(read), qual, 0
    ngap = o.ngapo + o.ngape
    if ngap == 0:
        cigar = [("M", L)]
        ref_win = text[o.pos:o.pos + L]
    else:
        ref_win = text[o.pos:o.pos + min(L + ngap, len(text) - o.pos)]
        _, cigar, _ = banded_global(aln, ref_win, opt.s_mm, opt.s_gapo,
                                    opt.s_gape, band=ngap + 1)
    nm, md = cigar_stats(cigar, aln, ref_win)
    rec = Record(name, flag, rname, o.pos + 1, mapq,
                 "".join(f"{ln}{op}" for op, ln in cigar), decode(aln), q)
    rec.tags.update(NM=nm, MD=md, XM=o.nmm, XO=o.ngapo,
                    XG=sum(ln for op, ln in cigar if op in ("I", "D")))
    return rec


def resolve_read(text, rname, read, name, qual, occs, truncated, opt: Opt,
                 ordinal: int):
    """One read's record from its occurrences (``resolve_from_occurrences``):
    the equal-best pick hashed by the read's ordinal in the stream."""
    L = len(read)
    # the boundary filter (``_span_possible``): the least span a hit can
    # have must fit before the sequence's end
    lst = [o for o in occs
           if o.pos + (max(L - o.ngapo - o.ngape, 1) if o.ngapo + o.ngape
                       else L) <= len(text)]
    if not lst:
        return Record(name, 4, "*", 0, 0, "*", decode(read), qual), lst
    best = lst[0].score
    window = [o for o in lst if o.score <= best + opt.s_mm]
    c1 = min(sum(1 for o in window if o.score == best), 256)
    c2 = min(len(window) - c1, 256)
    bests = [o for o in window if o.score == best]
    pick = bests[(ordinal * _HASH) % (1 << 32) % len(bests)]
    mapq = approx_mapq(c1, c2, pick.nmm, opt.diff_budget(L))
    rec = make_record(text, rname, read, name, qual, pick, mapq, opt)
    rec.tags["XT"] = "U" if c1 == 1 else "R"
    rec.tags["X0"] = c1
    if not truncated:
        rec.tags["X1"] = c2
    if 1 < len(window) <= opt.n_multi + 1 or (c1 == 1 and 0 < c2 <= opt.n_multi):
        parts = []
        for o in [o for o in window if o is not pick][:opt.n_multi]:
            a = make_record(text, rname, read, name, qual, o, 0, opt)
            parts.append(f"{a.rname},{'-' if o.strand else '+'}{a.pos},"
                         f"{a.cigar},{a.tags['NM']}")
        if parts:
            rec.tags["XA"] = ";".join(parts) + ";"
    return rec, lst


class Reference:
    """The oracle over one genome: ``align(read, name, qual, ordinal)`` gives
    the read's SAM line, its best score (None when unmapped) and the
    (pos, strand) set of its best-scoring occurrences."""

    def __init__(self, text, rname, sa_fwd, sa_rev, opt: Opt, cum=(None,
                                                                  None)):
        self.text = np.asarray(text, np.int8)
        self.rname = rname
        self.fm = FMIndex(self.text, sa_fwd, cum[0])
        self.fm_rev = FMIndex(self.text[::-1].copy(), sa_rev, cum[1])
        self.opt = opt

    def with_opt(self, opt: Opt) -> "Reference":
        """The same index under other options."""
        r = Reference.__new__(Reference)
        r.__dict__.update(self.__dict__)
        r.opt = opt
        return r

    def occurrences(self, read, max_occ: int = 512):
        """The read's occurrences on both strands (``collect_occurrences``
        with its budget ``max_occ``) and whether the budget cut them."""
        read = np.asarray(read, np.int8)
        hf = align_read(self.fm, self.fm_rev, read, self.opt)
        hr = align_read(self.fm, self.fm_rev, revcomp(read), self.opt)
        return collect_occurrences(hf, hr, self.fm, max_occ)

    def beam_repeat(self, read, over: int) -> bool:
        """Whether the port's beam could have cut the read's hits: on either
        strand :func:`buffer_hits` counts more than ``over``."""
        read = np.asarray(read, np.int8)
        budget = self.opt.diff_budget(len(read))
        for seq in (read, revcomp(read)):
            D_arr = cal_width(self.fm_rev, seq)
            if D_arr[-1] <= budget and buffer_hits(
                    self.fm, seq, D_arr, self.opt, budget, over) > over:
                return True
        return False

    def repeat(self, read, k: int, over: int) -> bool:
        """Whether some ``k`` bases of the read, on either strand, occur
        more than ``over`` times in the text."""
        read = np.asarray(read, np.int8)
        fm, top = self.fm, self.fm.n
        for seq in (read, revcomp(read)):
            for i in range(len(seq) - k + 1):
                lo, hi = 0, top
                for a in seq[i + k - 1:i - 1 if i else None:-1]:
                    if a > 3:
                        break
                    lo, hi = fm.extend(int(a), lo, hi)
                    if hi - lo + 1 <= over:
                        break
                else:
                    return True
        return False

    def align(self, read, name, qual, ordinal):
        read = np.asarray(read, np.int8)
        occs, trunc = self.occurrences(read)
        rec, lst = resolve_read(self.text, self.rname, read, name, qual,
                                occs, trunc, self.opt, ordinal)
        if not lst:
            return rec.to_sam(), None, set(), trunc
        best = lst[0].score
        return (rec.to_sam(), best,
                {(o.pos, o.strand) for o in lst if o.score == best}, trunc)
