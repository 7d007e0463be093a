"""Paired-end resolution -> SAM records (lineage: ``bwape.c``).

Pipeline (SURVEY.md §3.4): per-end occurrence collection (shared with
samse) -> insert-size inference from unique-unique proper-orientation
pairs -> best-pair selection -> mate rescue via glocal DP -> records with
mate fields / proper-pair flags.

Documented deterministic semantics (reference behavior could not be read —
empty mount; these rules are shared by the oracle pipeline so internal
record parity holds):

- orientation: proper pairs are FR (the forward-strand end leftmost);
- insert stats: median/IQR outlier rejection (keep within q25-2*IQR ..
  q75+2*IQR, inserts capped at ``max_isize``), then mean/std of the kept;
- pairing objective: minimize (score1+score2, |insert-mean|, pos);
  accepted iff orientation is FR and insert <= mean+4*std (or
  ``max_isize`` when stats are unavailable);
- mate rescue: when one end has no hits and the other a unique best, the
  missing mate is glocally aligned (full read, free ref ends) in the
  window implied by FR orientation and ``mean+4*std``; accepted iff its
  DP cost <= its aln diff budget * s_mm.  Rescued records carry XT:A:M
  and MAPQ 0.

Counterpart of ``hsa_tpu/resolve/sampe.py``.  The one part that differs is
the mate rescue, :func:`_rescue_batch`: it screens every job in one glocal
DP on a torch device (:mod:`hsa_tpu_torch.kernels.sw`), traces back only
the accepted jobs natively and counts their mismatches and gaps in array
passes over all of them; the records are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import alphabet, metrics, refpack
from ..config import AlnOpt, PEOpt
from ..index.layout import resolve_device
from ..kernels.sw import glocal_screen
from .mapq import approx_mapq, trunc_capped_mapq
from .samse import (_DECODE_LUT, _HASH, AlnRecord, Occurrence,
                    _make_record, _span_possible, collect_occurrences)

F_PAIRED, F_PROPER, F_UNMAP, F_MUNMAP = 0x1, 0x2, 0x4, 0x8
F_REV, F_MREV, F_READ1, F_READ2 = 0x10, 0x20, 0x40, 0x80


def fit_in_window(read: np.ndarray, window: np.ndarray, s_mm: int, s_gapo: int,
                  s_gape: int):
    """Glocal DP: full read vs any placement in window (free ref start/end).

    Returns (cost, start_offset, cigar).  The semantics of the mate rescue
    (the ``bwa_paired_sw``/``stdaln.c`` analog): :func:`_rescue_batch`
    screens with :mod:`hsa_tpu_torch.kernels.sw` and traces back with the
    native ``glocal_batch``, both twins of this DP.
    """
    L, G = len(read), len(window)
    BIG = 1 << 28
    m = np.full((L + 1, G + 1), BIG, dtype=np.int64)
    ins = np.full((L + 1, G + 1), BIG, dtype=np.int64)
    dele = np.full((L + 1, G + 1), BIG, dtype=np.int64)
    m[0, :] = 0  # free start anywhere in the window
    kk = np.arange(G, dtype=np.int64)
    for i in range(1, L + 1):
        sub = np.where((read[i - 1] <= 3) & (read[i - 1] == window), 0, s_mm)
        best_prev = np.minimum(np.minimum(m[i - 1, :-1], ins[i - 1, :-1]),
                               dele[i - 1, :-1])
        m[i, 1:] = best_prev + sub
        ins[i, :] = np.minimum(m[i - 1, :] + s_gapo, ins[i - 1, :] + s_gape)
        # dele row: dele[j] = min(m[j-1]+s_gapo, dele[j-1]+s_gape) unrolls
        # to a min-plus prefix scan — min_{k<j}(m[k]+s_gapo+(j-1-k)*ge)
        # plus the BIG-seed chain; exact integer equality with the
        # scalar recurrence (the traceback tests equalities), ~50x
        # faster (this loop dominated repeat-genome PE resolution)
        a = m[i, :G] + s_gapo - kk * s_gape
        dele[i, 1:] = np.minimum(np.minimum.accumulate(a) + kk * s_gape,
                                 BIG + (kk + 1) * s_gape)
    totals = np.minimum(np.minimum(m[L], ins[L]), dele[L])
    jend = int(np.argmin(totals))
    cost = int(totals[jend])
    if cost >= BIG:
        return cost, -1, []
    # traceback (M > D > I preference), mirroring cigar.banded_global
    ops = []
    i, j = L, jend
    state = int(np.argmin([m[L, jend], dele[L, jend], ins[L, jend]]))
    while i > 0:
        if j == 0:
            ops.append("I"); i -= 1; continue
        if state == 0:
            sub = s_mm if (read[i - 1] > 3 or read[i - 1] != window[j - 1]) else 0
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
    start = j
    return cost, start, [(op, ln) for op, ln in cigar]


def _window_occs(lst, s_mm):
    if not lst:
        return []
    best = lst[0].score
    return [o for o in lst if o.score <= best + s_mm]


def _glen(o, L):
    return L + o.ngapo + o.ngape


def _isize(o_f, L_f, o_r, L_r):
    """Insert size for an FR pair (forward end o_f leftmost)."""
    return (o_r.pos + _glen(o_r, L_r)) - o_f.pos


def infer_isize(pairs_occs, lens1, lens2, max_isize: int):
    """(mean, std, n) from unique-unique FR pairs (lineage: ``infer_isize``)."""
    inserts = []
    for (occ1, occ2), L1, L2 in zip(pairs_occs, lens1, lens2):
        if len(occ1) != 1 or len(occ2) != 1:
            continue
        o1, o2 = occ1[0], occ2[0]
        if o1.strand == o2.strand:
            continue
        of, Lf, orv, Lr = (o1, L1, o2, L2) if o1.strand == 0 else (o2, L2, o1, L1)
        ins = _isize(of, Lf, orv, Lr)
        if 0 < ins <= max_isize:
            inserts.append(ins)
    if len(inserts) < 8:
        return None, None, len(inserts)
    a = np.asarray(inserts, dtype=np.float64)
    q25, q75 = np.percentile(a, [25, 75])
    iqr = q75 - q25
    keep = a[(a >= q25 - 2 * iqr) & (a <= q75 + 2 * iqr)]
    return float(keep.mean()), float(max(keep.std(), 1.0)), len(keep)


def _best_pair(occ1, occ2, L1, L2, mean, std, max_isize):
    """Best proper FR combo or None; deterministic objective.

    Returns (key, o1, o2, ins, n_best, subo_score): ``n_best`` counts
    FR-consistent combos at the best combined score and ``subo_score`` is
    the second-best combined score (None if no other combo) — the inputs
    of the paired-MAPQ adjustment (lineage: ``bwape.c:pairing``'s
    ``o_n``/``subo_score``; docs/PARITY.md #11).
    """
    limit = (mean + 4 * std) if mean is not None else max_isize
    lo = max(0.0, (mean - 4 * std)) if mean is not None else 0.0
    best = None
    n_best = 0
    subo = None
    for o1 in occ1:
        for o2 in occ2:
            if o1.strand == o2.strand:
                continue
            of, Lf, orv, Lr = (o1, L1, o2, L2) if o1.strand == 0 else (o2, L2, o1, L1)
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


_PAIR_W = 16     # matrix width of the vectorized pairing; wider windows
                 # (repeat-heavy ends) take the loop twin


def _best_pair_batch(w1, w2, lens1, lens2, mean, std, max_isize):
    """Vectorized :func:`_best_pair` over all pairs of a batch.

    Returns a list of per-pair results with IDENTICAL semantics to the
    loop twin (tested equal): None, or (key, o1, o2, ins, n_best, subo).
    Pairs where either window exceeds _PAIR_W entries fall back to the
    loop (rare: such ends are repeat-heavy and MAPQ-0 anyway).  The
    combo matrices are [B, W, W] masked numpy ops — the per-pair Python
    O(n1*n2) loop dominated paired resolution beyond ~10K pairs/s
    (VERDICT r3 weak #5).
    """
    B = len(w1)
    out = [None] * B
    W = _PAIR_W
    mat_ids = [j for j in range(B)
               if w1[j] and w2[j] and len(w1[j]) <= W and len(w2[j]) <= W]
    for j in range(B):
        if (w1[j] and w2[j]
                and (len(w1[j]) > W or len(w2[j]) > W)):
            out[j] = _best_pair(w1[j], w2[j], lens1[j], lens2[j],
                                mean, std, max_isize)
    if not mat_ids:
        return out
    M = len(mat_ids)
    BIG = np.int64(1 << 60)
    pos = np.zeros((2, M, W), np.int64)
    sc = np.zeros((2, M, W), np.int64)
    st = np.zeros((2, M, W), np.int8)
    gl = np.zeros((2, M, W), np.int64)
    ok = np.zeros((2, M, W), bool)
    for e, (ws, lens) in enumerate(((w1, lens1), (w2, lens2))):
        for i, j in enumerate(mat_ids):
            lst = ws[j]
            n = len(lst)
            pos[e, i, :n] = [o.pos for o in lst]
            sc[e, i, :n] = [o.score for o in lst]
            st[e, i, :n] = [o.strand for o in lst]
            gl[e, i, :n] = [lens[j] + o.ngapo + o.ngape for o in lst]
            ok[e, i, :n] = True
    p1, p2 = pos[0][:, :, None], pos[1][:, None, :]
    s1, s2 = st[0][:, :, None], st[1][:, None, :]
    g1, g2 = gl[0][:, :, None], gl[1][:, None, :]
    limit = (mean + 4 * std) if mean is not None else float(max_isize)
    lo = max(0.0, mean - 4 * std) if mean is not None else 0.0
    of_pos = np.where(s1 == 0, p1, p2)
    rv_end = np.where(s1 == 0, p2 + g2, p1 + g1)
    ins = rv_end - of_pos
    valid = (ok[0][:, :, None] & ok[1][:, None, :] & (s1 != s2)
             & (ins > 0) & (ins <= limit) & (ins >= lo))
    csc = np.where(valid, sc[0][:, :, None] + sc[1][:, None, :], BIG)
    flat = csc.reshape(M, W * W)
    best_sc = flat.min(axis=1)
    has = best_sc < BIG
    isbest = csc == best_sc[:, None, None]
    n_best = (valid & isbest).reshape(M, W * W).sum(axis=1)
    sub_sc = np.where(valid & ~isbest, csc, BIG).reshape(M, W * W).min(axis=1)
    # pick: among best-score combos, min (dev, of_pos, iteration order)
    dev = (np.abs(ins - mean) if mean is not None
           else np.zeros_like(ins, np.float64))
    dev_m = np.where(valid & isbest, dev, np.inf).reshape(M, W * W)
    dmin = dev_m.min(axis=1)
    pmask = valid & isbest & (dev_m.reshape(M, W, W) == dmin[:, None, None])
    pos_m = np.where(pmask, of_pos, BIG).reshape(M, W * W)
    pmin = pos_m.min(axis=1)
    first = np.argmax((pos_m == pmin[:, None])
                      & pmask.reshape(M, W * W), axis=1)
    a_i, b_i = first // W, first % W
    ins_f = ins.reshape(M, W * W)
    for i in np.nonzero(has)[0]:
        j = mat_ids[i]
        a, b = int(a_i[i]), int(b_i[i])
        o1, o2 = w1[j][a], w2[j][b]
        of = o1 if o1.strand == 0 else o2
        key = (int(best_sc[i]), float(dmin[i]), of.pos)
        subo = int(sub_sc[i]) if sub_sc[i] < BIG else None
        out[j] = (key, o1, o2, int(ins_f[i, first[i]]),
                  int(n_best[i]), subo)
    return out


def pair_mapq(mapq1, mapq2, n_best, subo, best_sc, s_mm):
    """Paired-MAPQ adjustment for a proper pair (docs/PARITY.md #11).

    Pair quality ``mapQ_p``: 0 when the best pair is ambiguous; 29 when
    no alternative pair exists; else scaled by the score margin to the
    second-best pair.  Application rule (lineage ``bwape.c:pairing``
    behavior, reconstructed from its documented OUTPUT property — SE
    MAPQ caps at 37 but proper pairs from the lineage reach 60): a
    confident end gains the pair quality, capped at 60; a repetitive
    (MAPQ 0) end is boosted to min(mapQ_p + 7, mate's qual) — a
    uniquely-paired end with a repetitive single-end hit set gets
    paired quality.  Constants are lineage-style but unverifiable
    against the empty mount; registered as deviation #11.
    """
    if n_best > 1:
        mapq_p = 0
    elif subo is None:
        mapq_p = 29
    else:
        import math
        mapq_p = min(23, int(4.343 * math.log1p((subo - best_sc) / s_mm)) + 17)
    if mapq1 > 0 and mapq2 > 0:
        return min(mapq1 + mapq_p, 60), min(mapq2 + mapq_p, 60)
    q1 = mapq1 if mapq1 > 0 else min(mapq_p + 7, mapq2)
    q2 = mapq2 if mapq2 > 0 else min(mapq_p + 7, mapq1)
    return q1, q2


def resolve_batch_pe(text, meta, reads1, reads2, names, quals1, quals2,
                     hits1, hits2, locate_fn, opt: AlnOpt,
                     peopt: PEOpt | None = None, read_offset: int = 0,
                     max_occ: int = 256, *, rescue):
    """Resolve paired batches -> interleaved [rec1, rec2, ...] records.

    hits1/hits2: (hits_fwd, hits_rc) tuples per end from the search engine.
    ``rescue`` as in :func:`resolve_pe_from_occurrences`.
    """
    peopt = peopt or PEOpt()
    cap = min(peopt.max_occ, max_occ)  # -o, bounded by the locate-cost cap
    occs1, trunc1 = collect_occurrences(hits1[0], hits1[1], locate_fn, cap)
    occs2, trunc2 = collect_occurrences(hits2[0], hits2[1], locate_fn, cap)
    return resolve_pe_from_occurrences(text, meta, reads1, reads2, names,
                                       quals1, quals2, occs1, occs2, opt,
                                       peopt, read_offset=read_offset,
                                       trunc1=trunc1, trunc2=trunc2,
                                       rescue=rescue)


def _bulk_ungapped_cores(text, meta, jobs, opt):
    """Vectorized record cores for ungapped occurrences.

    jobs: list of (key, read int8[L], qual|None, Occurrence).  Returns
    dict key -> AlnRecord with flag 0/16 (strand only), byte-equal to
    :func:`hsa_tpu_torch.resolve.samse._make_record` for ngap == 0 — the
    per-record numpy calls it replaces dominated paired-end resolution.
    """
    out = {}
    if not jobs:
        return out
    n_text = len(text)
    t_arr = np.asarray(text)
    Lmax = max(len(r) for _k, r, _q, _o in jobs)
    NJ = len(jobs)
    # vectorized job prep (the per-job revcomp/asarray loop was ~40% of
    # paired-end core building at 16K+ jobs/batch)
    rd = np.full((NJ, Lmax), 4, np.uint8)
    pos = np.empty(NJ, np.int64)
    lens = np.empty(NJ, np.int64)
    strands = np.empty(NJ, bool)
    for i, (_k, r, _q, o) in enumerate(jobs):
        rd[i, :len(r)] = r
        pos[i] = o.pos
        lens[i] = len(r)
        strands[i] = bool(o.strand)
    if strands.any():
        t0 = np.arange(Lmax)
        cols = np.clip(lens[:, None] - 1 - t0[None, :], 0, Lmax - 1)
        rc = np.take_along_axis(rd, cols, axis=1)
        rc = np.where(rc <= 3, 3 - rc, rc).astype(np.uint8)
        rc[t0[None, :] >= lens[:, None]] = 4
        rd = np.where(strands[:, None], rc, rd)
    t = np.arange(Lmax)
    win = t_arr[np.minimum(pos[:, None] + t[None, :], n_text - 1)]
    mm = ((rd != win) | (rd > 3)) & (t[None, :] < lens[:, None])
    rows, cs = np.nonzero(mm)
    splits = np.searchsorted(rows, np.arange(NJ + 1))
    chars = _DECODE_LUT[np.minimum(rd, 5)]
    has_amb = bool(meta.amb_runs)
    md_lut = "ACGTN"
    starts_a = np.asarray(meta.starts, np.int64)
    si = np.searchsorted(starts_a, pos, side="right") - 1
    # callers span-filter occurrences (samse._span_possible), so every
    # position maps inside a sequence; raise rather than silently
    # assigning the nearest name (ADVICE r4; not a bare assert — it
    # must survive python -O)
    if si.min(initial=0) < 0 or not (
            pos - starts_a[np.maximum(si, 0)]
            < np.asarray(meta.lengths, np.int64)[np.maximum(si, 0)]).all():
        raise ValueError(
            "unfiltered out-of-range occurrence reached record building")
    off1 = (pos - starts_a[si] + 1).tolist()
    si_l = si.tolist()
    lens_l = lens.tolist()
    for i, (key, r, qual, o) in enumerate(jobs):
        L = lens_l[i]
        mmp = cs[splits[i]:splits[i + 1]]
        parts = []
        prev = 0
        for p in mmp.tolist():
            parts.append(str(p - prev))
            parts.append(md_lut[min(int(win[i, p]), 4)])
            prev = p + 1
        parts.append(str(L - prev))
        seq = chars[i, :L].tobytes().decode()
        q = (qual[::-1] if (o.strand and qual and qual != "*") else qual) \
            or "*"
        rec = AlnRecord("", 16 if o.strand else 0,
                        meta.names[si_l[i]], off1[i], 0,
                        f"{L}M", seq, q)
        rec.tags.update(NM=len(mmp), MD="".join(parts), XM=o.nmm,
                        XO=0, XG=0)
        rec.ref_span = L              # skip the CIGAR re-parse in tlen
        if has_amb:
            xn = meta.count_amb(o.pos, L)
            if xn:
                rec.tags["XN"] = xn
        out[key] = rec
    return out


def _bulk_gapped_cores(text, meta, jobs, opt):
    """Batched banded-DP record cores for GAPPED occurrences — the PE
    analog of samse's batched pick/alternate cores: one native
    ``rp_banded_batch`` call replaces per-record ctypes round trips.
    Byte-equal to :func:`hsa_tpu_torch.resolve.samse._make_record` for
    ngap > 0 (flag carries strand only; qname/mapq set by the caller).
    """
    out = {}
    if not jobs:
        return out
    t_arr = np.asarray(text)
    Lmax = max(len(r) for _k, r, _q, _o in jobs)
    NJ = len(jobs)
    rd = np.full((NJ, Lmax), 4, np.uint8)
    pos = np.empty(NJ, np.int64)
    lens_ = np.empty(NJ, np.int64)
    ngap_ = np.empty(NJ, np.int64)
    for i, (_k, r, _q, o) in enumerate(jobs):
        a = np.asarray(r, np.uint8)
        if o.strand:
            a = np.where(a <= 3, 3 - a, a)[::-1].astype(np.uint8)
        rd[i, :len(r)] = a
        pos[i] = o.pos
        lens_[i] = len(r)
        ngap_[i] = o.ngapo + o.ngape
    starts_a = np.asarray(meta.starts, np.int64)
    lengths_a = np.asarray(meta.lengths, np.int64)
    si = np.clip(np.searchsorted(starts_a, pos, side="right") - 1,
                 0, len(starts_a) - 1)
    glen_w = np.minimum(lens_ + ngap_, starts_a[si] + lengths_a[si] - pos)
    cigs, mds, nm, gln, gapb = refpack.banded_batch(
        rd, np.arange(NJ, dtype=np.int64) * Lmax, lens_.astype(np.int32),
        t_arr, pos, glen_w.astype(np.int32), opt.s_mm, opt.s_gapo,
        opt.s_gape, (ngap_ + 1).astype(np.int32))
    chars = _DECODE_LUT[np.minimum(rd, 5)]
    has_amb = bool(meta.amb_runs)
    for i, (key, r, qual, o) in enumerate(jobs):
        L = int(lens_[i])
        seq = chars[i, :L].tobytes().decode()
        q = (qual[::-1] if (o.strand and qual and qual != "*") else qual) \
            or "*"
        ri = int(si[i])
        rec = AlnRecord("", 16 if o.strand else 0, meta.names[ri],
                        int(pos[i] - starts_a[ri]) + 1, 0, cigs[i], seq, q)
        rec.tags.update(NM=int(nm[i]), MD=mds[i], XM=o.nmm, XO=o.ngapo,
                        XG=int(gapb[i]))
        rec.ref_span = int(gln[i])
        if has_amb:
            xn = meta.count_amb(o.pos, int(gln[i]))
            if xn:
                rec.tags["XN"] = xn
        out[key] = rec
    return out


def resolve_pe_from_occurrences(text, meta, reads1, reads2, names, quals1,
                                quals2, occs1, occs2, opt: AlnOpt,
                                peopt: PEOpt | None = None,
                                read_offset: int = 0, trunc1=None,
                                trunc2=None, c2x1=None, c2x2=None, *, rescue):
    """Core paired resolution over per-read Occurrence lists (from
    collect_occurrences or the pigeon engine directly).

    ``c2x1/c2x2`` (optional): per-end unenumerated-candidate counts of
    truncation-capped reads; they inflate the end's c2 and cap its MAPQ
    (mapq.trunc_capped_mapq) exactly like the single-end resolver.
    ``rescue`` (required) runs the mate rescue, as in
    :func:`resolve_pe_from_occ_arrays`: :func:`_rescue_batch` bound to a
    device, so nothing here chooses one.
    """
    peopt = peopt or PEOpt()
    B = len(reads1)
    trunc1 = trunc1 if trunc1 is not None else [False] * B
    trunc2 = trunc2 if trunc2 is not None else [False] * B

    def bfilter(lst, L):
        return [o for o in lst if _span_possible(meta, o, L)]

    lens1 = [len(r) for r in reads1]
    lens2 = [len(r) for r in reads2]
    occs1 = [bfilter(l_, L) for l_, L in zip(occs1, lens1)]
    occs2 = [bfilter(l_, L) for l_, L in zip(occs2, lens2)]

    w1 = [_window_occs(l_, opt.s_mm)[:64] for l_ in occs1]
    w2 = [_window_occs(l_, opt.s_mm)[:64] for l_ in occs2]
    mean, std, n_used = infer_isize(list(zip(w1, w2)), lens1, lens2,
                                    peopt.max_isize)

    # ---- phase A: pairing decisions; defer rescues into a batch ----------
    choices = []       # per pair: [o1, o2, proper]
    pair_stats = [None] * B   # (n_best, subo, best_sc) for proper pairs
    jobs = []          # (pair_idx, missing_end, anchor, read, L)
    rlim = int((mean + 4 * std) if mean is not None else peopt.max_isize)
    pairs_all = _best_pair_batch(w1, w2, lens1, lens2, mean, std,
                                 peopt.max_isize)
    for j in range(B):
        r1, r2 = reads1[j], reads2[j]
        L1, L2 = lens1[j], lens2[j]
        o1 = o2 = None
        proper = False
        pair = pairs_all[j]
        if pair is not None:
            _, o1, o2, _, n_best, subo = pair
            pair_stats[j] = (n_best, subo, o1.score + o2.score)
            proper = True
        else:
            for occ, sel in ((occs1[j], 1), (occs2[j], 2)):
                if occ:
                    bests = [o for o in occ if o.score == occ[0].score]
                    pick = bests[((read_offset + j) * _HASH) % (1 << 32) % len(bests)]
                    if sel == 1:
                        o1 = pick
                    else:
                        o2 = pick
            if peopt.is_sw and (o1 is None) != (o2 is None):
                anchor, missing, Lm, rm = ((o1, 2, L2, r2) if o2 is None
                                           else (o2, 1, L1, r1))
                jobs.append((j, missing, anchor, rm, Lm))
            elif peopt.is_sw and o1 is not None and o2 is not None:
                # discordant pair: both ends map but no FR-consistent
                # combo exists (SVs, far-multi-mapped mates).  The
                # lineage's bwa_paired_sw also rescues here (SURVEY
                # §3.4): anchor on a UNIQUE-best end and SW the other
                # into its FR window; acceptance uses the same cost rule
                # as one-end rescue, so a genuinely distant mate fails
                # the screen and the pair stays discordant.
                u1 = bool(w1[j]) and sum(
                    1 for x in w1[j] if x.score == w1[j][0].score) == 1
                u2 = bool(w2[j]) and sum(
                    1 for x in w2[j] if x.score == w2[j][0].score) == 1
                if u1 and (not u2 or o1.score <= o2.score):
                    jobs.append((j, 2, o1, r2, L2))
                elif u2:
                    jobs.append((j, 1, o2, r1, L1))
        choices.append([o1, o2, proper])

    # ---- phase B: batched device rescue screen, host traceback on accepts -
    rescued_flags = [[False, False] for _ in range(B)]
    for j, missing, res in rescue(text, meta, jobs, rlim, opt):
        if res is None:
            continue
        if missing == 1:
            choices[j][0] = res
            rescued_flags[j][0] = True
        else:
            choices[j][1] = res
            rescued_flags[j][1] = True
        choices[j][2] = True

    # ---- phase C prep: bulk record cores (ungapped + batched gapped) -----
    jobs = []
    gjobs = []
    for j in range(B):
        o1, o2, proper = choices[j]
        for endno, (o, reads_s, quals_s, occ) in enumerate((
                (o1, reads1, quals1, occs1[j]), (o2, reads2, quals2, occs2[j]))):
            if o is not None:
                (jobs if o.ngapo + o.ngape == 0 else gjobs).append(
                    ((j, endno),
                     reads_s[j], quals_s[j] if quals_s else "*", o))
            # XA alternates of this end (window members, both kinds)
            if o is not None and occ:
                window = _window_occs(occ, opt.s_mm)
                for x in window:
                    if x is not o:
                        (jobs if x.ngapo + x.ngape == 0 else gjobs).append(
                            ((j, endno, id(x)), reads_s[j],
                             quals_s[j] if quals_s else "*", x))
    cores = _bulk_ungapped_cores(text, meta, jobs, opt)
    cores.update(_bulk_gapped_cores(text, meta, gjobs, opt))

    # ---- phase C: record building ----------------------------------------
    records = []
    for j in range(B):
        r1, r2 = reads1[j], reads2[j]
        L1, L2 = lens1[j], lens2[j]
        name = names[j]
        q1 = quals1[j] if quals1 else "*"
        q2 = quals2[j] if quals2 else "*"
        o1, o2, proper = choices[j]
        rescued = rescued_flags[j]

        # single-end MAPQs for both ends, then the paired adjustment
        # (docs/PARITY.md #11) for non-rescued proper pairs
        end_mapq = [0, 0]
        end_cc = [(0, 0, []), (0, 0, [])]
        for endno, (L, o, occ, c2x) in enumerate((
                (L1, o1, occs1[j], c2x1), (L2, o2, occs2[j], c2x2))):
            if o is None:
                continue
            window = _window_occs(occ, opt.s_mm) if occ else []
            c1 = min(sum(1 for x in window
                         if x.score == (occ[0].score if occ else 0)), 256)
            extra = int(c2x[j]) if c2x is not None else 0
            c2 = min((len(window) - c1 if occ else 0) + min(extra, 255), 256)
            end_cc[endno] = (c1, c2, window)
            if not rescued[endno]:
                end_mapq[endno] = trunc_capped_mapq(
                    approx_mapq(c1 if occ else 1, c2, o.nmm,
                                opt.diff_budget(L)), c2, extra)
        if proper and pair_stats[j] is not None and not any(rescued):
            n_best, subo, best_sc = pair_stats[j]
            end_mapq[0], end_mapq[1] = pair_mapq(
                end_mapq[0], end_mapq[1], n_best, subo, best_sc, opt.s_mm)

        for endno, (read, L, qual, o, o_mate, L_mate, occ, trunc) in enumerate((
                (r1, L1, q1, o1, o2, L2, occs1[j], trunc1[j]),
                (r2, L2, q2, o2, o1, L1, occs2[j], trunc2[j]))):
            flag = F_PAIRED | (F_READ1 if endno == 0 else F_READ2)
            if o is None:
                flag |= F_UNMAP
                if o_mate is not None:
                    flag |= F_MREV if o_mate.strand else 0
                rec = AlnRecord(name, flag, "*", 0, 0, "*",
                                alphabet.decode(read), qual)
                if o_mate is not None:
                    ri, off_m = meta.pos_to_ref(o_mate.pos)
                    rec.rname = meta.names[ri]
                    rec.pos = off_m + 1  # SAM: unmapped-with-mapped-mate convention
                    rec.rnext = "="
                    rec.pnext = off_m + 1
                records.append(rec)
                continue
            if proper:
                flag |= F_PROPER
            if o.strand:
                flag |= F_REV
            if o_mate is None:
                flag |= F_MUNMAP
            elif o_mate.strand:
                flag |= F_MREV

            c1, c2, window = end_cc[endno]
            was_rescued = rescued[endno]
            mapq = 0 if was_rescued else end_mapq[endno]
            rec = cores.get((j, endno))
            if rec is not None:
                rec.qname = name
                rec.mapq = mapq
            else:
                rec = _make_record(text, meta, read, name, qual, o, mapq, opt)
            rec.flag = flag  # replaces _make_record's 0/16 (strand folded in)
            if occ and not was_rescued:
                rec.tags["XT"] = "U" if c1 == 1 else "R"
                rec.tags["X0"] = c1
                if not trunc:
                    rec.tags["X1"] = c2
                # XA alternates (lineage: sampe -n/-N caps)
                xa_cap = peopt.n_multi if proper else peopt.N_multi
                alts = [x for x in window if x is not o][:xa_cap]
                if alts and len(window) - 1 <= xa_cap:
                    parts = []
                    for x in alts:
                        arec = cores.get((j, endno, id(x)))
                        if arec is None:
                            arec = _make_record(text, meta, read, name, qual,
                                                x, 0, opt)
                        parts.append(
                            f"{arec.rname},{'-' if x.strand else '+'}{arec.pos},"
                            f"{arec.cigar},{arec.tags['NM']}")
                    rec.tags["XA"] = ";".join(parts) + ";"
            if was_rescued:
                rec.tags["XT"] = "M"
            records.append(rec)

        # mate fields from the ACTUAL reference spans of the built records
        a, b = records[-2], records[-1]
        for rec, mate, o, o_mate in ((a, b, o1, o2), (b, a, o2, o1)):
            if o is None or o_mate is None:
                continue
            same = rec.rname == mate.rname
            rec.rnext = "=" if same else mate.rname
            rec.pnext = mate.pos
            if same:
                span_self = getattr(rec, "ref_span", None)
                if span_self is None:
                    span_self = _cigar_ref_span(rec.cigar)
                span_mate = getattr(mate, "ref_span", None)
                if span_mate is None:
                    span_mate = _cigar_ref_span(mate.cigar)
                left = min(rec.pos, mate.pos)
                right = max(rec.pos + span_self, mate.pos + span_mate)
                t = right - left
                rec.tlen = t if (rec.pos, span_self) <= (mate.pos, span_mate) \
                    else -t
                if rec.pos == mate.pos and span_self == span_mate:
                    # same start/span: sign by read number (deterministic)
                    rec.tlen = t if rec.flag & F_READ1 else -t
    return records


def _cigar_ref_span(cigar_str: str) -> int:
    """Reference bases consumed by a CIGAR string (M and D ops)."""
    span = 0
    num = 0
    for ch in cigar_str:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            if ch in ("M", "D", "=", "X", "N"):
                span += num
            num = 0
    return span


def _rescue_windows(text, meta, apos, astrand, lens, rlim: int):
    """(lo, hi, strand) arrays of the FR-implied rescue windows of the
    missing mates, for anchors at ``apos`` on ``astrand`` and mates of
    ``lens`` bases.

    Each window is clamped to its anchor's own reference sequence so a
    rescued mate can never be placed across (or inside) a different
    chromosome of the concatenated text.
    """
    starts = np.asarray(meta.starts, np.int64)
    ends = starts + np.asarray(meta.lengths, np.int64)
    ri = np.searchsorted(starts, apos, side="right") - 1
    ric = np.maximum(ri, 0)
    inside = (ri >= 0) & (apos < ends[ric])
    seq_lo = np.where(inside, starts[ric], 0)
    seq_hi = np.where(inside, ends[ric], len(text))
    reach = np.maximum(rlim, lens + 8)
    fwd = astrand == 0
    hi = np.minimum(seq_hi, apos + np.where(fwd, reach, lens + 8))
    lo = np.where(fwd, apos, np.maximum(seq_lo, hi - reach))
    return lo, hi, fwd.astype(np.int64)


def _trace_counts(ops, start, lo, reads, text):
    """Per job: mismatches, inserted bases, deleted bases and gap opens of
    the tracebacks ``ops`` (uint8 op codes 0=M 1=I 2=D, one array a job),
    in array passes over every job at once.

    Job k aligns row k of ``reads`` to ``text`` from ``lo[k] + start[k]``.
    A mismatch is an M op whose read base is above 3 or differs from the
    text's: the rule of ``cigar.cigar_stats``, whose NM is the mismatches
    plus the gap bases.  A gap open is the first op of an I or D run.
    """
    K = len(ops)
    n = np.fromiter(map(len, ops), np.int64, K)
    op = np.concatenate(ops) if K else np.zeros(0, np.uint8)
    job = np.repeat(np.arange(K), n)
    n_ins = np.bincount(job[op == 1], minlength=K)
    n_del = np.bincount(job[op == 2], minlength=K)
    # read and window index at each op: exclusive running counts of the
    # ops that consume each, restarted at every job's first op
    eat_r = (op != 2).astype(np.int64)
    eat_w = (op != 1).astype(np.int64)
    n_r = n - n_del
    n_w = n - n_ins
    ri = np.cumsum(eat_r) - eat_r - np.repeat(np.cumsum(n_r) - n_r, n)
    wi = np.cumsum(eat_w) - eat_w - np.repeat(np.cumsum(n_w) - n_w, n)
    m = op == 0
    jm = job[m]
    rb = reads[jm, ri[m]]
    tb = text[lo[jm] + start[jm] + wi[m]]
    n_mm = np.bincount(jm[(rb > 3) | (rb != tb)], minlength=K)
    first = np.ones(op.size, bool)
    first[1:] = op[1:] != op[:-1]
    first[(np.cumsum(n) - n)[n > 0]] = True
    n_open = np.bincount(job[first & (op != 0)], minlength=K)
    return n_mm, n_ins, n_del, n_open


def _rescue_batch(text, meta, jobs, rlim, opt: AlnOpt, device):
    """All rescue jobs screened in one device DP; yields
    ``(pair_idx, missing_end, Occurrence | None)`` in job order.

    ``jobs``: ``[(pair_idx, missing_end, anchor, read, L)]``.  Screen, then
    traceback, each step in array passes over every job:

    1. the windows from :func:`_rescue_windows`;
    2. one :func:`~hsa_tpu_torch.kernels.sw.glocal_screen` over every job
       on ``device`` (required: ``"cuda"``, or ``"cpu"`` when the caller
       asks for the plain version), at the jobs' exact shapes (nothing
       recompiles in PyTorch);
    3. a job is dropped when its window is shorter than its read or its
       cost is above ``max(diff_budget(L), round(0.15 L)) * s_mm``;
    4. the native ``glocal_batch`` traces back only the jobs that are left;
    5. :func:`_trace_counts` counts the mismatches and gaps of every
       traceback, and a job whose traceback starts in its window at a cost
       within its budget becomes ``Occurrence(lo + start, strand, cost,
       mismatches, gap opens, max(gap bases - opens, 0))``.

    The screen's cost equals the native DP's (both are twins of the
    reference's ``fit_in_window``), so the jobs dropped in step 3 are
    exactly those that step 5 would reject, and the records equal those of
    ``hsa_tpu/resolve/sampe.py:_rescue_batch``, which traces back every job
    natively and counts each with ``cigar_stats``.
    """
    if not jobs:
        return
    R = len(jobs)
    apos = np.fromiter((a.pos for _j, _e, a, _r, _L in jobs), np.int64, R)
    astr = np.fromiter((a.strand for _j, _e, a, _r, _L in jobs), np.int64, R)
    lens = np.fromiter((L for *_x, L in jobs), np.int32, R)
    lo, hi, strand = _rescue_windows(text, meta, apos, astr, lens, rlim)
    wlens = (hi - lo).astype(np.int32)
    Lmax = int(lens.max())
    reads = np.zeros((R, Lmax), np.int32)
    for i, (_j, _e, _a, read, L) in enumerate(jobs):
        reads[i, :L] = read
    t = np.arange(Lmax)
    live = t[None, :] < lens[:, None]
    if strand.any():      # the reverse mates' reverse complements
        rc = np.take_along_axis(
            reads, np.clip(lens[:, None] - 1 - t[None, :], 0, Lmax - 1), 1)
        rc = np.where(live, np.where(rc <= 3, 3 - rc, rc), 0)
        reads = np.where(strand[:, None] == 1, rc, reads)
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
    bound = np.fromiter((budget[L] for L in lens.tolist()), np.int64, R)
    keep = np.flatnonzero((wlens >= lens) & (cost <= bound))

    found = [None] * R
    if keep.size:
        c2, start, ops = refpack.glocal_batch(
            reads[keep].astype(np.uint8), np.arange(keep.size) * Lmax,
            lens[keep], text, lo[keep], wlens[keep], opt.s_mm, opt.s_gapo,
            opt.s_gape)
        sel = np.flatnonzero((start >= 0) & (c2 <= bound[keep]))
        acc = keep[sel]
        n_mm, n_ins, n_del, n_open = _trace_counts(
            [ops[k] for k in sel.tolist()], start[sel], lo[acc], reads[acc],
            text)
        for i, *fields in zip(
                acc.tolist(), (lo[acc] + start[sel]).tolist(),
                strand[acc].tolist(), c2[sel].tolist(), n_mm.tolist(),
                n_open.tolist(),
                np.maximum(n_ins + n_del - n_open, 0).tolist()):
            found[i] = Occurrence(*fields)
    for (j, missing, *_x), occ in zip(jobs, found):
        yield j, missing, occ


# ---------------------------------------------------------------------------
# Array-native paired resolution (the PE twin of
# samse.resolve_from_occ_arrays).  The per-pair loop above
# (resolve_pe_from_occurrences) is its semantics oracle, tested record-equal.
# ---------------------------------------------------------------------------

_WCAP = 64          # pairing window width (the [:64] cap of the loop twin)


def _pair_matrix(posm, scm, stm, glm, okm, mean, std, max_isize):
    """Best proper FR combination per pair, over dense window matrices.

    posm/scm/stm/glm/okm: [2, M, W] window fields of both ends.  Returns
    (has, a_i, b_i, ins, n_best, subo, best_sc) arrays over the M pairs,
    with the semantics of :func:`_best_pair`: valid combos are FR pairs with
    0 < insert <= limit (and >= lo); objective min (sc, dev, of_pos)
    with first-iteration-order tie-break; ``subo`` is the second-best
    DISTINCT combined score (BIGSC when none).
    """
    M, W = posm.shape[1], posm.shape[2]
    BIGSC = np.int64(1 << 60)
    p1, p2 = posm[0][:, :, None], posm[1][:, None, :]
    s1, s2 = stm[0][:, :, None], stm[1][:, None, :]
    g1, g2 = glm[0][:, :, None], glm[1][:, None, :]
    limit = (mean + 4 * std) if mean is not None else float(max_isize)
    lo = max(0.0, mean - 4 * std) if mean is not None else 0.0
    of_pos = np.where(s1 == 0, p1, p2)
    rv_end = np.where(s1 == 0, p2 + g2, p1 + g1)
    ins = rv_end - of_pos
    valid = (okm[0][:, :, None] & okm[1][:, None, :] & (s1 != s2)
             & (ins > 0) & (ins <= limit) & (ins >= lo))
    csc = np.where(valid, scm[0][:, :, None] + scm[1][:, None, :], BIGSC)
    flat = csc.reshape(M, W * W)
    best_sc = flat.min(axis=1)
    has = best_sc < BIGSC
    isbest = csc == best_sc[:, None, None]
    n_best = (valid & isbest).reshape(M, W * W).sum(axis=1)
    subo = np.where(valid & ~isbest, csc, BIGSC).reshape(M, W * W).min(axis=1)
    dev = (np.abs(ins - mean) if mean is not None
           else np.zeros_like(ins, np.float64))
    dev_m = np.where(valid & isbest, dev, np.inf).reshape(M, W * W)
    dmin = dev_m.min(axis=1)
    pmask = valid & isbest & (dev_m.reshape(M, W, W) == dmin[:, None, None])
    pos_m = np.where(pmask, of_pos, BIGSC).reshape(M, W * W)
    pmin = pos_m.min(axis=1)
    first = np.argmax((pos_m == pmin[:, None])
                      & pmask.reshape(M, W * W), axis=1)
    a_i, b_i = first // W, first % W
    ins_sel = ins.reshape(M, W * W)[np.arange(M), first]
    return has, a_i, b_i, ins_sel, n_best, subo, best_sc


@metrics.traced("resolve")
def resolve_pe_from_occ_arrays(text, meta, reads1, reads2, names, quals1,
                               quals2, occ, opt: AlnOpt,
                               peopt: PEOpt | None = None,
                               read_offset: int = 0, trunc=None, c2x=None,
                               emit: str = "records", *, rescue):
    """Vectorized paired resolution over ONE flat occurrence dict.

    ``occ``: arrays ``rid, pos, strand, score, nmm, ngapo, ngape`` with
    rid in [0, 2B) — end-1 reads occupy [0, B), end-2 reads [B, 2B) —
    deduped per (rid, strand, pos) and sorted by (rid, score, strand,
    pos).  ``trunc`` bool[2B] / ``c2x`` int[2B] follow the same space.
    Record-equal to :func:`resolve_pe_from_occurrences` (the loop twin;
    tested equal); all numeric work — span filter, windows, insert-size inference, pairing,
    MAPQ incl. the paired adjustment, ungapped NM/MD, batched gapped
    cores, XA — is vectorized, and the per-pair Python that remains is
    string assembly only.  ``emit="sam"`` returns (lines, flags) with
    records formatted directly (lineage: ``bwape.c`` record emission,
    SURVEY.md §3.4).  ``rescue`` (required) runs the mate rescue: it is
    called with :func:`_rescue_batch`'s first five parameters, and an
    aligner passes :func:`_rescue_batch` bound to its device, so nothing
    here chooses a device.

    Traced as ``resolve`` with the stages ``resolve.pair`` (matrices, span
    filter, groups, pairing windows, insert size, pairing, non-proper
    picks), ``resolve.rescue`` (the mate rescue and the rescued ends'
    records; attributes ``jobs``, and of them ``rescued`` accepted and
    ``gapped`` accepted with a gap), ``resolve.cores`` (MAPQ, pick cores,
    XA) and ``resolve.emit``.
    """
    metrics.stage("resolve.pair")
    peopt = peopt or PEOpt()
    B = len(reads1)
    N = 2 * B
    trunc = (np.asarray(trunc, bool) if trunc is not None
             else np.zeros(N, bool))
    c2x_a = (np.asarray(c2x, np.int64) if c2x is not None
             else np.zeros(N, np.int64))

    def read_mat(reads):
        if hasattr(reads, "mat") and hasattr(reads, "lens"):
            return np.asarray(reads.mat, np.uint8), \
                np.asarray(reads.lens, np.int64)
        lens = np.fromiter((len(r) for r in reads), np.int64, len(reads))
        Lm = max(int(lens.max()) if len(reads) else 1, 1)
        m = np.full((len(reads), Lm), 4, np.uint8)
        for j, r in enumerate(reads):
            m[j, :lens[j]] = np.asarray(r, np.uint8)
        return m, lens

    m1, l1 = read_mat(reads1)
    m2, l2 = read_mat(reads2)
    Lmax = max(m1.shape[1], m2.shape[1], 1)

    def padw(m):
        if m.shape[1] < Lmax:
            m = np.pad(m, ((0, 0), (0, Lmax - m.shape[1])),
                       constant_values=4)
        return m

    lens = np.concatenate([l1, l2])
    t = np.arange(Lmax)
    rdmat = np.vstack([padw(m1), padw(m2)])
    rdmat = np.where(t[None, :] < lens[:, None], rdmat, 4).astype(np.uint8)
    cols = np.clip(lens[:, None] - 1 - t[None, :], 0, Lmax - 1)
    rcmat = np.take_along_axis(rdmat, cols, axis=1)
    rcmat = np.where(rcmat <= 3, 3 - rcmat, rcmat).astype(np.uint8)
    rcmat[t[None, :] >= lens[:, None]] = 4
    fwd_chars = _DECODE_LUT[np.minimum(rdmat, 5)]
    rc_chars = _DECODE_LUT[np.minimum(rcmat, 5)]

    rid = np.asarray(occ["rid"], np.int64)
    pos = np.asarray(occ["pos"], np.int64)
    strand = np.asarray(occ["strand"], np.int8)
    score = np.asarray(occ["score"], np.int64)
    nmm = np.asarray(occ["nmm"], np.int64)
    ngapo = np.asarray(occ["ngapo"], np.int64)
    ngape = np.asarray(occ["ngape"], np.int64)

    starts_a = np.asarray(meta.starts, np.int64)
    lengths_a = np.asarray(meta.lengths, np.int64)

    # ---- span filter (as in samse.resolve_from_occ_arrays) ---------------
    if rid.size:
        ngap = ngapo + ngape
        Locc = lens[rid]
        min_span = np.where(ngap == 0, Locc, np.maximum(Locc - ngap, 1))
        si = np.searchsorted(starts_a, pos, side="right") - 1
        sis = np.clip(si, 0, len(starts_a) - 1)
        ok = (si >= 0) & (pos - starts_a[sis] + min_span <= lengths_a[sis])
        if not ok.all():
            rid, pos, strand, score, nmm, ngapo, ngape, ngap = (
                a[ok] for a in (rid, pos, strand, score, nmm, ngapo,
                                ngape, ngap))
    else:
        ngap = ngapo

    # ---- group stats (occ sorted by rid, score, strand, pos) ------------
    NO = rid.size
    grp_first = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]]) \
        if NO else np.zeros(0, np.int64)
    grp_rid = rid[grp_first] if NO else np.zeros(0, np.int64)
    grp_cnt = np.diff(np.r_[grp_first, NO]) if NO else grp_first
    gi_of = np.repeat(np.arange(grp_first.size), grp_cnt)
    best = score[grp_first] if NO else grp_first
    wmask = score <= best[gi_of] + opt.s_mm if NO else np.zeros(0, bool)
    isbest = score == best[gi_of] if NO else wmask
    if NO:
        nbest = np.add.reduceat(isbest.astype(np.int64), grp_first)
        nwin = np.add.reduceat(wmask.astype(np.int64), grp_first)
    else:
        nbest = nwin = np.zeros(0, np.int64)

    g_of = np.full(N, -1, np.int64)          # group index per end
    g_of[grp_rid] = np.arange(grp_rid.size)
    nw_end = np.zeros(N, np.int64)           # capped window count per end
    nwin_end = np.zeros(N, np.int64)         # uncapped window count
    nbest_end = np.zeros(N, np.int64)
    nw_end[grp_rid] = np.minimum(nwin, _WCAP)
    nwin_end[grp_rid] = nwin
    nbest_end[grp_rid] = nbest

    # ---- dense pairing windows [N, WCAP] ---------------------------------
    rank = np.arange(NO) - grp_first[gi_of] if NO else np.zeros(0, np.int64)
    wsel = wmask & (rank < _WCAP) if NO else np.zeros(0, bool)
    w_pos = np.zeros((N, _WCAP), np.int64)
    w_sc = np.zeros((N, _WCAP), np.int64)
    w_st = np.zeros((N, _WCAP), np.int8)
    w_gl = np.zeros((N, _WCAP), np.int64)
    w_ok = np.zeros((N, _WCAP), bool)
    if NO:
        widx = rid[wsel] * _WCAP + rank[wsel]
        w_pos.reshape(-1)[widx] = pos[wsel]
        w_sc.reshape(-1)[widx] = score[wsel]
        w_st.reshape(-1)[widx] = strand[wsel]
        w_gl.reshape(-1)[widx] = lens[rid[wsel]] + ngap[wsel]
        w_ok.reshape(-1)[widx] = True

    # ---- insert-size inference (unique-unique FR pairs) ------------------
    uu = (nw_end[:B] == 1) & (nw_end[B:] == 1) \
        & (w_st[:B, 0] != w_st[B:, 0])
    if uu.any():
        s1u = w_st[:B, 0][uu]
        of_p = np.where(s1u == 0, w_pos[:B, 0][uu], w_pos[B:, 0][uu])
        rv_e = np.where(s1u == 0, w_pos[B:, 0][uu] + w_gl[B:, 0][uu],
                        w_pos[:B, 0][uu] + w_gl[:B, 0][uu])
        ins_u = rv_e - of_p
        ins_u = ins_u[(ins_u > 0) & (ins_u <= peopt.max_isize)]
    else:
        ins_u = np.zeros(0, np.int64)
    if ins_u.size < 8:
        mean = std = None
    else:
        a = ins_u.astype(np.float64)
        q25, q75 = np.percentile(a, [25, 75])
        iqr = q75 - q25
        keep = a[(a >= q25 - 2 * iqr) & (a <= q75 + 2 * iqr)]
        mean, std = float(keep.mean()), float(max(keep.std(), 1.0))

    # ---- pairing, bucketed by window class -------------------------------
    nw1, nw2 = nw_end[:B], nw_end[B:]
    pairable = (nw1 > 0) & (nw2 > 0)
    wclass = np.maximum(nw1, nw2)
    proper = np.zeros(B, bool)
    pick_slot = np.full(N, -1, np.int64)     # window slot of the pick
    pair_nbest = np.zeros(B, np.int64)
    pair_subo = np.full(B, 1 << 60, np.int64)
    pair_bsc = np.zeros(B, np.int64)
    lo_c = 0
    for W in (1, 4, 16, _WCAP):
        sel = np.flatnonzero(pairable & (wclass > lo_c) & (wclass <= W))
        lo_c = W
        if not sel.size:
            continue
        pm = np.stack([w_pos[sel, :W], w_pos[B + sel, :W]])
        sm = np.stack([w_sc[sel, :W], w_sc[B + sel, :W]])
        tm = np.stack([w_st[sel, :W], w_st[B + sel, :W]])
        gm = np.stack([w_gl[sel, :W], w_gl[B + sel, :W]])
        om = np.stack([w_ok[sel, :W], w_ok[B + sel, :W]])
        has, a_i, b_i, _ins_s, n_b, subo, bsc = _pair_matrix(
            pm, sm, tm, gm, om, mean, std, peopt.max_isize)
        hj = sel[has]
        proper[hj] = True
        pick_slot[hj] = a_i[has]
        pick_slot[B + hj] = b_i[has]
        pair_nbest[hj] = n_b[has]
        pair_subo[hj] = subo[has]
        pair_bsc[hj] = bsc[has]

    # ---- non-proper ends: deterministic hash pick among bests ------------
    jpair = np.arange(N) % B
    hk = (((read_offset + jpair).astype(np.uint64) * np.uint64(_HASH))
          % np.uint64(1 << 32)) % np.maximum(nbest_end, 1).astype(np.uint64)
    unpaired_pick = (g_of >= 0) & ~np.concatenate([proper, proper])
    pick_slot = np.where(unpaired_pick, hk.astype(np.int64), pick_slot)

    # pick entry index into the occ arrays (window is a PREFIX of the
    # rid-major group, so entry = grp_first + slot)
    has_pick = pick_slot >= 0
    pick_ent = np.full(N, -1, np.int64)
    pe_sel = np.flatnonzero(has_pick)
    if NO:
        pick_ent[pe_sel] = grp_first[g_of[pe_sel]] + pick_slot[pe_sel]

    metrics.stage("resolve.rescue")
    # ---- mate rescue (batched device screen) -----------------------------
    rescued = np.zeros(N, bool)
    rescue_occ: dict[int, Occurrence] = {}
    if peopt.is_sw:
        rlim = int((mean + 4 * std) if mean is not None else peopt.max_isize)
        # one end picked: rescue the other; both (discordant, no FR combo):
        # anchor a unique end, end 1 where both are unique and it scores
        # no worse, and rescue its mate
        h1, h2 = has_pick[:B], has_pick[B:]
        uniq = (nbest_end == 1) & (nw_end >= 1)
        p_sc = score[np.maximum(pick_ent, 0)] if NO else np.zeros(N, np.int64)
        from1 = h1 & (~h2 | (uniq[:B] & (~uniq[B:] | (p_sc[:B] <= p_sc[B:]))))
        from2 = h2 & ~from1 & (~h1 | uniq[B:])
        jj = np.flatnonzero(~proper & (from1 | from2))
        a_e = np.where(from1[jj], jj, B + jj)        # anchor end
        m_e = np.where(from1[jj], B + jj, jj)        # missing end
        a_i = pick_ent[a_e]
        jobs = [(j, 1 + fr, Occurrence(*occ), rdmat[e, :L], L)
                for j, fr, e, L, *occ in zip(
                    jj.tolist(), from1[jj].tolist(), m_e.tolist(),
                    lens[m_e].tolist(), *(a[a_i].tolist() for a in (
                        pos, strand, score, nmm, ngapo, ngape)))]
        metrics.note(jobs=len(jobs))
        for j, missing, res in rescue(text, meta, jobs, rlim, opt):
            if res is None:
                continue
            e = j if missing == 1 else B + j
            rescue_occ[e] = res
            rescued[e] = True
            proper[j] = True
        n_gapped = sum(o.ngapo > 0 for o in rescue_occ.values())
        metrics.note(rescued=len(rescue_occ), gapped=n_gapped)

    # ---- rescued-end records: the batched cores (MAPQ 0, the quality
    # reversed on the reverse strand), then the name.  The cores write an
    # empty quality as "*", which is how to_sam writes it too ---------------
    core_jobs: tuple[list, list] = ([], [])
    for e, o in rescue_occ.items():
        qsrc = quals1 if e < B else quals2
        core_jobs[o.ngapo > 0].append(
            (e, rdmat[e, :lens[e]], qsrc[e % B] if qsrc else None, o))
    rescue_rec: dict[int, AlnRecord] = _bulk_ungapped_cores(
        text, meta, core_jobs[0], opt)
    rescue_rec.update(_bulk_gapped_cores(text, meta, core_jobs[1], opt))
    for e, rec in rescue_rec.items():
        rec.qname = names[e % B]

    metrics.stage("resolve.cores")
    # ---- per-end c1/c2 + MAPQ (vector approx_mapq + paired adjust) -------
    c1_end = np.minimum(nbest_end, 256)
    x_end = np.minimum(c2x_a, 255)
    c2_end = np.minimum(nwin_end - c1_end + x_end, 256)
    budg = {int(L): opt.diff_budget(int(L)) for L in np.unique(lens)}
    maxdiff = np.fromiter((budg[int(L)] for L in lens), np.int64, N)
    p_nmm_e = np.where(pick_ent >= 0, nmm[np.maximum(pick_ent, 0)], 0) \
        if NO else np.zeros(N, np.int64)
    n_c2 = np.minimum(c2_end, 255)
    glog = np.where(n_c2 > 0,
                    (4.343 * np.log(np.maximum(n_c2, 1)) + 0.5)
                    .astype(np.int64), 0)
    mapq_e = np.where(c1_end > 1, 0,
                      np.where(p_nmm_e == maxdiff, 25,
                               np.where(c2_end == 0, 37,
                                        np.maximum(23 - glog, 0))))
    mapq_e = np.where(x_end > 0,
                      np.minimum(mapq_e, np.maximum(23 - glog, 0)), mapq_e)
    mapq_e = np.where(has_pick & ~rescued, mapq_e, 0)
    # paired adjustment for proper, non-rescued pairs with pair stats
    padj = proper & (pair_nbest > 0) & ~rescued[:B] & ~rescued[B:]
    if padj.any():
        nb_p = pair_nbest[padj]
        subo_p = pair_subo[padj]
        bsc_p = pair_bsc[padj]
        BIGSC = 1 << 60
        with np.errstate(divide="ignore", invalid="ignore"):
            mq_sc = np.minimum(
                23, (4.343 * np.log1p((subo_p - bsc_p) / opt.s_mm))
                .astype(np.int64) + 17)
        mapq_p = np.where(nb_p > 1, 0,
                          np.where(subo_p >= BIGSC, 29, mq_sc))
        q1 = mapq_e[:B][padj]
        q2 = mapq_e[B:][padj]
        both = (q1 > 0) & (q2 > 0)
        nq1 = np.where(both, np.minimum(q1 + mapq_p, 60),
                       np.where(q1 > 0, q1, np.minimum(mapq_p + 7, q2)))
        nq2 = np.where(both, np.minimum(q2 + mapq_p, 60),
                       np.where(q2 > 0, q2, np.minimum(mapq_p + 7, q1)))
        mapq_e[:B][padj] = nq1
        mapq_e[B:][padj] = nq2
    mapq_l = mapq_e.tolist()

    # ---- pick record cores: ungapped via window gather, gapped batched ---
    p_pos_e = np.where(pick_ent >= 0, pos[np.maximum(pick_ent, 0)], 0) \
        if NO else np.zeros(N, np.int64)
    p_str_e = np.where(pick_ent >= 0,
                       strand.astype(np.int64)[np.maximum(pick_ent, 0)], 0) \
        if NO else np.zeros(N, np.int64)
    p_go_e = np.where(pick_ent >= 0, ngapo[np.maximum(pick_ent, 0)], 0) \
        if NO else np.zeros(N, np.int64)
    p_ge_e = np.where(pick_ent >= 0, ngape[np.maximum(pick_ent, 0)], 0) \
        if NO else np.zeros(N, np.int64)
    n_text = len(text)
    t_arr = np.asarray(text)
    ug_e = np.flatnonzero(has_pick & ~rescued & (p_go_e + p_ge_e == 0))
    mmrows_l: dict[int, list] = {}
    winmm_l: dict[int, list] = {}
    nm_of: dict[int, int] = {}
    if len(ug_e):
        wpos = p_pos_e[ug_e]
        widx2 = np.minimum(wpos[:, None] + t[None, :], n_text - 1)
        win = t_arr[widx2]
        aln = np.where(p_str_e[ug_e][:, None].astype(bool), rcmat[ug_e],
                       rdmat[ug_e])
        mm = ((aln != win) | (aln > 3)) & (t[None, :] < lens[ug_e][:, None])
        nms = mm.sum(axis=1)
        rows, cs = np.nonzero(mm)
        splits = np.searchsorted(rows, np.arange(len(ug_e) + 1))
        for i, e in enumerate(ug_e.tolist()):
            sl = cs[splits[i]:splits[i + 1]]
            mmrows_l[e] = sl.tolist()
            winmm_l[e] = win[i][sl].tolist()
            nm_of[e] = int(nms[i])

    # XN for ungapped picks (amb overlap; cheap two-searchsorted screen)
    xn_of: dict[int, int] = {}
    if len(ug_e) and meta.amb_runs:
        if not hasattr(meta, "_amb_starts"):
            meta._amb_starts = np.asarray([r[0] for r in meta.amb_runs],
                                          np.int64)
            meta._amb_ends = meta._amb_starts + np.asarray(
                [r[1] for r in meta.amb_runs], np.int64)
        lo2 = np.searchsorted(meta._amb_ends, p_pos_e[ug_e], side="right")
        hi2 = np.searchsorted(meta._amb_starts, p_pos_e[ug_e] + lens[ug_e],
                              side="left")
        for i, e in enumerate(ug_e.tolist()):
            if hi2[i] > lo2[i]:
                xn_of[e] = meta.count_amb(int(p_pos_e[ug_e[i]]),
                                          int(lens[ug_e[i]]))

    # rname / 1-based offset per pick
    psi = np.clip(np.searchsorted(starts_a, p_pos_e, side="right") - 1,
                  0, len(starts_a) - 1)
    p_off1 = p_pos_e - starts_a[psi] + 1

    # ---- XA alternates + gapped cores (ONE banded_batch call) ------------
    xa_of: dict[int, str] = {}
    pickgap: dict[int, tuple] = {}
    xa_cap_e = np.where(np.concatenate([proper, proper]),
                        peopt.n_multi, peopt.N_multi)
    if NO:
        alt_e: list[int] = []
        alt_oi: list[int] = []
        g_of_l = g_of.tolist()
        grp_first_l = grp_first.tolist()
        grp_cnt_l = grp_cnt.tolist()
        nwin_l = nwin.tolist()
        pick_ent_l = pick_ent.tolist()
        wmask_l = wmask.tolist()
        for e in np.flatnonzero(has_pick & ~rescued).tolist():
            gidx = g_of_l[e]
            nv = nwin_l[gidx]
            cap = int(xa_cap_e[e])
            if not (2 <= nv <= cap + 1):
                continue
            s0 = grp_first_l[gidx]
            s1_ = s0 + grp_cnt_l[gidx]
            pk = pick_ent_l[e]
            cnt = 0
            for oi in range(s0, s1_):
                if oi == pk or not wmask_l[oi]:
                    continue
                if cnt >= cap:
                    break
                alt_e.append(e)
                alt_oi.append(oi)
                cnt += 1
        aj = np.asarray(alt_e, np.int64)
        ao = np.asarray(alt_oi, np.int64)
        a_pos = pos[ao]
        a_str = strand[ao].astype(np.int64)
        a_ngap = ngap[ao]
        a_L = lens[aj]
        asi = np.clip(np.searchsorted(starts_a, a_pos, side="right") - 1,
                      0, len(starts_a) - 1)
        a_end = starts_a[asi] + lengths_a[asi]
        gp_e = np.flatnonzero(has_pick & ~rescued & (p_go_e + p_ge_e > 0))
        ga_idx = np.flatnonzero(a_ngap > 0)
        n_pk, n_ga = len(gp_e), len(ga_idx)
        cigs: list = []
        mds: list = []
        nmb = glb = gbb = None
        if n_pk + n_ga:
            reads_all = np.ascontiguousarray(
                np.concatenate([rdmat, rcmat], axis=0))
            j_roff = np.concatenate(
                [(p_str_e[gp_e] * N + gp_e) * Lmax,
                 (a_str[ga_idx] * N + aj[ga_idx]) * Lmax])
            j_rlen = np.concatenate([lens[gp_e], a_L[ga_idx]])
            j_goff = np.concatenate([p_pos_e[gp_e], a_pos[ga_idx]])
            j_ngap = np.concatenate([(p_go_e + p_ge_e)[gp_e],
                                     a_ngap[ga_idx]])
            ends = np.concatenate([starts_a[psi[gp_e]]
                                   + lengths_a[psi[gp_e]], a_end[ga_idx]])
            j_glen = np.minimum(j_rlen + j_ngap, ends - j_goff)
            j_band = (j_ngap + 1).astype(np.int32)
            cigs, mds, nmb, glb, gbb = refpack.banded_batch(
                reads_all, j_roff, j_rlen.astype(np.int32), t_arr, j_goff,
                j_glen.astype(np.int32), opt.s_mm, opt.s_gapo, opt.s_gape,
                j_band)
            for i, e in enumerate(gp_e.tolist()):
                pickgap[e] = (cigs[i], mds[i], int(nmb[i]), int(glb[i]),
                              int(gbb[i]))
        # ungapped alternates: NM via one window gather
        a_nm = np.zeros(len(ao), np.int64)
        ug_idx = np.flatnonzero(a_ngap == 0)
        if len(ug_idx):
            widx3 = np.minimum(a_pos[ug_idx][:, None] + t[None, :],
                               n_text - 1)
            win3 = t_arr[widx3]
            rows3 = np.where(a_str[ug_idx].astype(bool)[:, None],
                             rcmat[aj[ug_idx]], rdmat[aj[ug_idx]])
            mm3 = ((rows3 != win3) | (rows3 > 3)) \
                & (t[None, :] < a_L[ug_idx][:, None])
            a_nm[ug_idx] = mm3.sum(axis=1)
        if len(ao):
            gpos = np.full(len(ao), -1, np.int64)
            gpos[ga_idx] = n_pk + np.arange(n_ga)
            a_off1 = (a_pos - starts_a[asi] + 1).tolist()
            gpos_l = gpos.tolist()
            a_nm_l = a_nm.tolist()
            a_L_l = a_L.tolist()
            a_str_l = a_str.tolist()
            parts_of: dict[int, list] = {}
            for i, e in enumerate(alt_e):
                gi2 = gpos_l[i]
                cg = f"{a_L_l[i]}M" if gi2 < 0 else cigs[gi2]
                nm_i = a_nm_l[i] if gi2 < 0 else int(nmb[gi2])
                parts_of.setdefault(e, []).append(
                    f"{meta.names[asi[i]]},{'-' if a_str_l[i] else '+'}"
                    f"{a_off1[i]},{cg},{nm_i}")
            xa_of = {e: ";".join(p) + ";" for e, p in parts_of.items()}

    metrics.stage("resolve.emit")
    # ---- emit loop: string assembly only ---------------------------------
    emit_sam = emit == "sam"
    records: list = []
    flags_out: list = []
    md_lut = "ACGTN"
    has_amb = bool(meta.amb_runs)
    lens_l = lens.tolist()
    haspick_l = has_pick.tolist()
    rescued_l = rescued.tolist()
    proper_l = proper.tolist()
    p_str_l = p_str_e.tolist()
    p_nmm_l = p_nmm_e.tolist()
    p_go_l = p_go_e.tolist()
    off1_l = p_off1.tolist()
    rname_l = [meta.names[i] for i in psi.tolist()]
    c1_l = c1_end.tolist()
    c2_l = c2_end.tolist()
    trunc_l = trunc.tolist()

    for j in range(B):
        name = names[j]
        pair_fields = []    # (flag, rname, pos1, mapq, cigar, seq, q,
                            # tags_str_or_rec, span, mapped)
        for endno, e in ((0, j), (1, B + j)):
            L = lens_l[e]
            qsrc = quals1 if endno == 0 else quals2
            qual = qsrc[j] if qsrc else "*"
            flag = F_PAIRED | (F_READ1 if endno == 0 else F_READ2)
            e_mate = B + j if endno == 0 else j
            mate_mapped = haspick_l[e_mate] or rescued_l[e_mate]
            if not haspick_l[e] and not rescued_l[e]:
                flag |= F_UNMAP
                if mate_mapped and p_str_l[e_mate]:
                    flag |= F_MREV
                seq = fwd_chars[e, :L].tobytes().decode()
                pair_fields.append([flag, "*", 0, 0, "*", seq,
                                    qual or "*", None, 0, False])
                continue
            if proper_l[j]:
                flag |= F_PROPER
            if rescued_l[e]:
                st = rescue_rec[e].flag & 16
            else:
                st = p_str_l[e]
            if st:
                flag |= F_REV
            if not mate_mapped:
                flag |= F_MUNMAP
            elif rescued_l[e_mate]:
                if rescue_rec[e_mate].flag & 16:
                    flag |= F_MREV
            elif p_str_l[e_mate]:
                flag |= F_MREV
            if rescued_l[e]:
                rec = rescue_rec[e]
                rec.flag = flag
                rec.tags["XT"] = "M"
                span = vars(rec).pop("ref_span")   # the cores' CIGAR span
                pair_fields.append([flag, rec.rname, rec.pos, 0, rec.cigar,
                                    rec.seq, rec.qual, rec, span, True])
                continue
            if st:
                seq = rc_chars[e, :L].tobytes().decode()
                q = qual[::-1] if qual and qual != "*" else qual
            else:
                seq = fwd_chars[e, :L].tobytes().decode()
                q = qual
            mapq = mapq_l[e]
            xa = xa_of.get(e)
            nm_j = nm_of.get(e)
            if nm_j is not None:     # ungapped pick
                parts = []
                prev = 0
                for col, wc in zip(mmrows_l[e], winmm_l[e]):
                    parts.append(str(col - prev))
                    parts.append(md_lut[wc if wc < 4 else 4])
                    prev = col + 1
                parts.append(str(L - prev))
                mdstr = "".join(parts)
                cig = f"{L}M"
                xn = xn_of.get(e, 0)
                span = L
                xo = xg = 0
                nmv = nm_j
            else:                     # gapped pick (batched core)
                cig, mdstr, nmv, span, xg = pickgap[e]
                xo = p_go_l[e]
                xn = meta.count_amb(int(p_pos_e[e]), span) if has_amb else 0
            c1v = c1_l[e]
            # common case pre-joined (tag order = AlnRecord.to_sam):
            # one string instead of a tag list per record
            ts = (f"XT:Z:{'U' if c1v == 1 else 'R'}\tX0:i:{c1v}"
                  + (f"\tX1:i:{c2_l[e]}" if not trunc_l[e] else "")
                  + (f"\tXN:i:{xn}" if xn else "")
                  + f"\tXM:i:{p_nmm_l[e]}\tXO:i:{xo}\tXG:i:{xg}"
                  + f"\tNM:i:{nmv}\tMD:Z:{mdstr}"
                  + (f"\tXA:Z:{xa}" if xa else ""))
            pair_fields.append([flag, rname_l[e], off1_l[e], mapq, cig,
                                seq, q or "*", ts, span, True])

        # mate fields from the actual reference spans
        f1, f2 = pair_fields
        rnext1 = pnext1 = rnext2 = pnext2 = None
        tlen1 = tlen2 = 0
        if f1[9] and f2[9]:
            same = f1[1] == f2[1]
            rnext1 = "=" if same else f2[1]
            pnext1 = f2[2]
            rnext2 = "=" if same else f1[1]
            pnext2 = f1[2]
            if same:
                left = min(f1[2], f2[2])
                right = max(f1[2] + f1[8], f2[2] + f2[8])
                tl = right - left
                if f1[2] == f2[2] and f1[8] == f2[8]:
                    tlen1, tlen2 = tl, -tl       # READ1 positive
                else:
                    tlen1 = tl if (f1[2], f1[8]) <= (f2[2], f2[8]) else -tl
                    tlen2 = tl if (f2[2], f2[8]) <= (f1[2], f1[8]) else -tl
        elif f2[9]:     # end1 unmapped with mapped mate: SAM convention
            f1[1] = f2[1]
            f1[2] = f2[2]
            rnext1, pnext1 = "=", f2[2]
        elif f1[9]:
            f2[1] = f1[1]
            f2[2] = f1[2]
            rnext2, pnext2 = "=", f1[2]

        for fx, rnext, pnext, tlen in ((f1, rnext1, pnext1, tlen1),
                                       (f2, rnext2, pnext2, tlen2)):
            flag, rname, pos1, mapq, cig, seq, q, tags, _span, _m = fx
            rn = rnext if rnext is not None else "*"
            pn = pnext if pnext is not None else 0
            if emit_sam:
                if isinstance(tags, AlnRecord):     # rescued end
                    rec = tags
                    rec.rnext, rec.pnext, rec.tlen = rn, pn, tlen
                    records.append(rec.to_sam())
                elif tags is None:                  # unmapped end
                    records.append(f"{name}\t{flag}\t{rname}\t{pos1}\t0\t*"
                                   f"\t{rn}\t{pn}\t0\t{seq}\t{q}")
                else:
                    records.append(
                        f"{name}\t{flag}\t{rname}\t{pos1}\t{mapq}\t{cig}"
                        f"\t{rn}\t{pn}\t{tlen}\t{seq}\t{q}\t" + tags)
                flags_out.append(flag)
            else:
                if isinstance(tags, AlnRecord):
                    rec = tags
                    rec.rnext, rec.pnext, rec.tlen = rn, pn, tlen
                elif tags is None:
                    rec = AlnRecord(name, flag, rname, pos1, 0, "*", seq, q)
                    rec.rnext, rec.pnext = rn, pn
                else:
                    rec = AlnRecord(name, flag, rname, pos1, mapq, cig,
                                    seq, q)
                    rec.rnext, rec.pnext, rec.tlen = rn, pn, tlen
                    for tg in tags.split("\t"):
                        k2, ty, v = tg.split(":", 2)
                        rec.tags[k2] = int(v) if ty == "i" else v
                records.append(rec)
    if emit_sam:
        return records, flags_out
    return records
