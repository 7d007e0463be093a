"""The plain reference of the paired record: a frozen copy of the port's
list resolver for pairs (``resolve/sampe.py``: ``infer_isize``,
``_best_pair``, ``pair_mapq``, ``fit_in_window``, the rescue window and its
acceptance, ``resolve_pe_from_occurrences``) over the single-end reference
of :mod:`oracle`, numpy only.

What is changed from the copied code: the rescue's DP is the numpy
``fit_in_window`` for every job (the port screens on the card and traces back
natively: both twins of this DP), record cores are built one by one, and the
reference holds one sequence.  The insert-size model is given by the caller
(``models``), one a pair; without it, it is inferred, as the port infers it
over a batch, from the unique pairs of the pairs resolved together.
"""

from __future__ import annotations

import math

import numpy as np

from .oracle import (Occurrence, Record, _HASH, approx_mapq, cigar_stats,
                     decode, make_record, revcomp)

F_PAIRED, F_PROPER, F_UNMAP, F_MUNMAP = 0x1, 0x2, 0x4, 0x8
F_REV, F_MREV, F_READ1, F_READ2 = 0x10, 0x20, 0x40, 0x80
BIG = 1 << 28


def window_occs(lst, s_mm):
    if not lst:
        return []
    best = lst[0].score
    return [o for o in lst if o.score <= best + s_mm]


def _isize(o_f, L_f, o_r, L_r):
    return (o_r.pos + L_r + o_r.ngapo + o_r.ngape) - o_f.pos


def infer_isize(pairs_occs, lens1, lens2, max_isize):
    """(mean, std, n) from unique-unique FR pairs."""
    inserts = []
    for (occ1, occ2), L1, L2 in zip(pairs_occs, lens1, lens2):
        if len(occ1) != 1 or len(occ2) != 1:
            continue
        o1, o2 = occ1[0], occ2[0]
        if o1.strand == o2.strand:
            continue
        of, Lf, orv, Lr = (o1, L1, o2, L2) if o1.strand == 0 else \
            (o2, L2, o1, L1)
        ins = _isize(of, Lf, orv, Lr)
        if 0 < ins <= max_isize:
            inserts.append(ins)
    if len(inserts) < 8:
        return None, None, len(inserts)
    return (*model_of(inserts, max_isize), len(inserts))


def model_of(inserts, max_isize):
    """(mean, std) of ``inserts`` as :func:`infer_isize` reduces them."""
    a = np.asarray(inserts, np.float64)
    a = a[(a > 0) & (a <= max_isize)]
    q25, q75 = np.percentile(a, [25, 75])
    iqr = q75 - q25
    keep = a[(a >= q25 - 2 * iqr) & (a <= q75 + 2 * iqr)]
    return float(keep.mean()), float(max(keep.std(), 1.0))


def best_pair(occ1, occ2, L1, L2, mean, std, max_isize):
    """(key, o1, o2, ins, n_best, subo) of the best proper FR combination,
    or None."""
    limit = (mean + 4 * std) if mean is not None else max_isize
    lo = max(0.0, (mean - 4 * std)) if mean is not None else 0.0
    best, n_best, subo = None, 0, None
    for o1 in occ1:
        for o2 in occ2:
            if o1.strand == o2.strand:
                continue
            of, Lf, orv, Lr = (o1, L1, o2, L2) if o1.strand == 0 else \
                (o2, L2, o1, L1)
            ins = _isize(of, Lf, orv, Lr)
            if ins <= 0 or ins > limit or ins < lo:
                continue
            sc = o1.score + o2.score
            dev = abs(ins - mean) if mean is not None else 0.0
            key = (sc, dev, of.pos)
            if best is None or sc < best[0][0]:
                if best is not None and best[0][0] != sc:
                    subo = best[0][0]
                best = (key, o1, o2, ins)
                n_best = 1
            elif sc == best[0][0]:
                n_best += 1
                if key < best[0]:
                    best = (key, o1, o2, ins)
            elif subo is None or sc < subo:
                subo = sc
    return best if best is None else best + (n_best, subo)


def pair_mapq(mapq1, mapq2, n_best, subo, best_sc, s_mm):
    if n_best > 1:
        mapq_p = 0
    elif subo is None:
        mapq_p = 29
    else:
        mapq_p = min(23, int(4.343 * math.log1p((subo - best_sc) / s_mm)) + 17)
    if mapq1 > 0 and mapq2 > 0:
        return min(mapq1 + mapq_p, 60), min(mapq2 + mapq_p, 60)
    q1 = mapq1 if mapq1 > 0 else min(mapq_p + 7, mapq2)
    q2 = mapq2 if mapq2 > 0 else min(mapq_p + 7, mapq1)
    return q1, q2


def fit_in_window(read, window, s_mm, s_gapo, s_gape):
    """Glocal DP: the whole read at any placement in the window: (cost,
    start offset, cigar); ties M > D > I."""
    L, G = len(read), len(window)
    m = np.full((L + 1, G + 1), BIG, np.int64)
    ins = np.full((L + 1, G + 1), BIG, np.int64)
    dele = np.full((L + 1, G + 1), BIG, np.int64)
    m[0, :] = 0
    kk = np.arange(G, dtype=np.int64)
    for i in range(1, L + 1):
        sub = np.where((read[i - 1] <= 3) & (read[i - 1] == window), 0, s_mm)
        m[i, 1:] = np.minimum(np.minimum(m[i - 1, :-1], ins[i - 1, :-1]),
                              dele[i - 1, :-1]) + sub
        ins[i, :] = np.minimum(m[i - 1, :] + s_gapo, ins[i - 1, :] + s_gape)
        a = m[i, :G] + s_gapo - kk * s_gape
        dele[i, 1:] = np.minimum(np.minimum.accumulate(a) + kk * s_gape,
                                 BIG + (kk + 1) * s_gape)
    totals = np.minimum(np.minimum(m[L], ins[L]), dele[L])
    jend = int(np.argmin(totals))
    cost = int(totals[jend])
    if cost >= BIG:
        return cost, -1, []
    ops = []
    i, j = L, jend
    state = int(np.argmin([m[L, jend], dele[L, jend], ins[L, jend]]))
    while i > 0:
        if j == 0:
            ops.append("I"); i -= 1; continue
        if state == 0:
            sub = s_mm if (read[i - 1] > 3 or read[i - 1] != window[j - 1]) \
                else 0
            target = m[i, j] - sub
            prev = [m[i - 1, j - 1], dele[i - 1, j - 1], ins[i - 1, j - 1]]
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
    return cost, j, [(op, ln) for op, ln in cigar]


def rescue(text, anchor, read, L, rlim, opt):
    """The missing mate glocally aligned in the window the anchor implies
    (FR orientation, ``rlim`` bases); an Occurrence or None."""
    n = len(text)
    if anchor.strand == 0:
        lo = anchor.pos
        hi = min(n, anchor.pos + max(rlim, L + 8))
        strand = 1
    else:
        hi = min(n, anchor.pos + L + 8)
        lo = max(0, hi - max(rlim, L + 8))
        strand = 0
    target = revcomp(read) if strand == 1 else np.asarray(read)
    if hi - lo < L:
        return None
    window = np.asarray(text[lo:hi])
    cost, start, cigar = fit_in_window(target, window, opt.s_mm, opt.s_gapo,
                                       opt.s_gape)
    budget = max(opt.diff_budget(L), round(0.15 * L))
    if start < 0 or cost > budget * opt.s_mm:
        return None
    n_ins = sum(ln for op, ln in cigar if op == "I")
    n_del = sum(ln for op, ln in cigar if op == "D")
    n_opens = sum(1 for op, ln in cigar if op in ("I", "D"))
    nm, _ = cigar_stats(cigar, target, window[start:start + L + n_del])
    return Occurrence(lo + start, strand, cost, nm - n_ins - n_del, n_opens,
                      max(n_ins + n_del - n_opens, 0))


def cigar_ref_span(cigar: str) -> int:
    span = num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch in "MD":
                span += num
            num = 0
    return span


def _span_ok(o, L, n):
    ngap = o.ngapo + o.ngape
    return o.pos + (max(L - ngap, 1) if ngap else L) <= n


class PairedReference:
    """``resolve(pairs)``: the SAM lines of ``[(read1, read2, name, qual1,
    qual2, ordinal)]`` resolved together as one batch.  ``occurrences``
    maps a list of reads to their ``(occurrences, cut)`` on both strands
    (``oracle.Reference.occurrences`` at a budget of 256, the paired
    resolver's, here or in worker processes)."""

    MAX_OCC = 256

    def __init__(self, text, rname, opt, occurrences, max_isize, n_multi=3,
                 N_multi=10):
        self.text = np.asarray(text, np.int8)
        self.rname = rname
        self.opt = opt
        self.occurrences = occurrences
        self.max_isize = max_isize
        self.n_multi = n_multi
        self.N_multi = N_multi

    def resolve(self, pairs, models=None):
        """The pairs' SAM lines, two a pair; ``models`` gives each pair's
        insert-size model ``(mean, std)``, else it is inferred from
        ``pairs``."""
        return self.resolve_ends(pairs, models)[0]

    def resolve_ends(self, pairs, models=None):
        """:meth:`resolve`'s lines and each end's ``(occurrences, cut)``."""
        opt, text, rname = self.opt, self.text, self.rname
        found = self.occurrences([p[e] for p in pairs for e in (0, 1)])
        ends = []
        for k, p in enumerate(pairs):
            ends.append(tuple(
                ([o for o in found[2 * k + e][0]
                  if _span_ok(o, len(p[e]), len(text))], found[2 * k + e][1])
                for e in (0, 1)))
        occs1 = [e[0][0] for e in ends]
        occs2 = [e[1][0] for e in ends]
        lens1 = [len(p[0]) for p in pairs]
        lens2 = [len(p[1]) for p in pairs]
        w1 = [window_occs(x, opt.s_mm)[:64] for x in occs1]
        w2 = [window_occs(x, opt.s_mm)[:64] for x in occs2]
        if models is None:
            mean, std, _n = infer_isize(list(zip(w1, w2)), lens1, lens2,
                                        self.max_isize)
            models = [(mean, std)] * len(pairs)
        out = []
        for j, (r1, r2, name, q1, q2, ordinal) in enumerate(pairs):
            mean, std = models[j]
            rlim = int((mean + 4 * std) if mean is not None
                       else self.max_isize)
            out.extend(self._pair(j, r1, r2, name, q1, q2, ordinal, occs1[j],
                                  occs2[j], ends[j][0][1], ends[j][1][1],
                                  w1[j], w2[j], mean, std, rlim, text, rname,
                                  opt))
        return out, [e for pair in ends for e in pair]

    def _pair(self, j, r1, r2, name, q1, q2, ordinal, oc1, oc2, tr1, tr2,
              w1, w2, mean, std, rlim, text, rname, opt):
        L1, L2 = len(r1), len(r2)
        o1 = o2 = None
        proper = False
        stats = None
        pair = (best_pair(w1, w2, L1, L2, mean, std, self.max_isize)
                if w1 and w2 else None)
        job = None
        if pair is not None:
            _, o1, o2, _, n_best, subo = pair
            stats = (n_best, subo, o1.score + o2.score)
            proper = True
        else:
            for occ, sel in ((oc1, 1), (oc2, 2)):
                if occ:
                    bests = [o for o in occ if o.score == occ[0].score]
                    pick = bests[(ordinal * _HASH) % (1 << 32) % len(bests)]
                    if sel == 1:
                        o1 = pick
                    else:
                        o2 = pick
            if (o1 is None) != (o2 is None):
                job = (o1, 2, L2, r2) if o2 is None else (o2, 1, L1, r1)
            elif o1 is not None and o2 is not None:
                u1 = bool(w1) and sum(1 for x in w1
                                      if x.score == w1[0].score) == 1
                u2 = bool(w2) and sum(1 for x in w2
                                      if x.score == w2[0].score) == 1
                if u1 and (not u2 or o1.score <= o2.score):
                    job = (o1, 2, L2, r2)
                elif u2:
                    job = (o2, 1, L1, r1)
        rescued = [False, False]
        if job is not None:
            anchor, missing, Lm, rm = job
            res = rescue(text, anchor, rm, Lm, rlim, opt)
            if res is not None:
                if missing == 1:
                    o1 = res
                else:
                    o2 = res
                rescued[missing - 1] = True
                proper = True
        end_mapq = [0, 0]
        end_cc = [(0, 0, []), (0, 0, [])]
        for e, (L, o, occ) in enumerate(((L1, o1, oc1), (L2, o2, oc2))):
            if o is None:
                continue
            window = window_occs(occ, opt.s_mm) if occ else []
            c1 = min(sum(1 for x in window
                         if x.score == (occ[0].score if occ else 0)), 256)
            c2 = min(len(window) - c1 if occ else 0, 256)
            end_cc[e] = (c1, c2, window)
            if not rescued[e]:
                end_mapq[e] = approx_mapq(c1 if occ else 1, c2, o.nmm,
                                          opt.diff_budget(L))
        if proper and stats is not None and not any(rescued):
            end_mapq[0], end_mapq[1] = pair_mapq(end_mapq[0], end_mapq[1],
                                                 *stats, opt.s_mm)
        recs = []
        for e, (read, qual, o, o_mate, occ, trunc) in enumerate((
                (r1, q1, o1, o2, oc1, tr1), (r2, q2, o2, o1, oc2, tr2))):
            flag = F_PAIRED | (F_READ1 if e == 0 else F_READ2)
            if o is None:
                flag |= F_UNMAP
                if o_mate is not None:
                    flag |= F_MREV if o_mate.strand else 0
                rec = Record(name, flag, "*", 0, 0, "*", decode(read), qual)
                if o_mate is not None:
                    rec.rname = rname
                    rec.pos = o_mate.pos + 1
                    rec.rnext = "="
                    rec.pnext = o_mate.pos + 1
                recs.append(rec)
                continue
            if proper:
                flag |= F_PROPER
            if o.strand:
                flag |= F_REV
            if o_mate is None:
                flag |= F_MUNMAP
            elif o_mate.strand:
                flag |= F_MREV
            c1, c2, window = end_cc[e]
            rec = make_record(text, rname, read, name, qual, o,
                              0 if rescued[e] else end_mapq[e], opt)
            rec.flag = flag
            if occ and not rescued[e]:
                rec.tags["XT"] = "U" if c1 == 1 else "R"
                rec.tags["X0"] = c1
                if not trunc:
                    rec.tags["X1"] = c2
                cap = self.n_multi if proper else self.N_multi
                alts = [x for x in window if x is not o][:cap]
                if alts and len(window) - 1 <= cap:
                    parts = []
                    for x in alts:
                        a = make_record(text, rname, read, name, qual, x, 0,
                                        opt)
                        parts.append(f"{a.rname},{'-' if x.strand else '+'}"
                                     f"{a.pos},{a.cigar},{a.tags['NM']}")
                    rec.tags["XA"] = ";".join(parts) + ";"
            if rescued[e]:
                rec.tags["XT"] = "M"
            recs.append(rec)
        a, b = recs
        for rec, mate, o, o_mate in ((a, b, o1, o2), (b, a, o2, o1)):
            if o is None or o_mate is None:
                continue
            rec.rnext = "="
            rec.pnext = mate.pos
            span_self = cigar_ref_span(rec.cigar)
            span_mate = cigar_ref_span(mate.cigar)
            left = min(rec.pos, mate.pos)
            right = max(rec.pos + span_self, mate.pos + span_mate)
            t = right - left
            rec.tlen = t if (rec.pos, span_self) <= (mate.pos, span_mate) \
                else -t
            if rec.pos == mate.pos and span_self == span_mate:
                rec.tlen = t if rec.flag & F_READ1 else -t
        return [r.to_sam() for r in recs]
