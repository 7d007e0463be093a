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
DP on a torch device (:mod:`hsa_tpu_torch.kernels.sw`) and traces back
only the accepted jobs natively; the records are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import alphabet, refpack
from ..config import AlnOpt, PEOpt
from ..index.layout import resolve_device
from ..kernels.sw import glocal_screen
from .cigar import cigar_stats
from .samse import _DECODE_LUT, _HASH, AlnRecord, Occurrence, _make_record

F_PAIRED, F_PROPER, F_UNMAP, F_MUNMAP = 0x1, 0x2, 0x4, 0x8
F_REV, F_MREV, F_READ1, F_READ2 = 0x10, 0x20, 0x40, 0x80


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


def _rescue_window(text, meta, anchor: Occurrence, L: int, rlim: int):
    """(lo, hi, strand) of the FR-implied rescue window for the missing mate.

    Clamped to the anchor's own reference sequence so a rescued mate can
    never be placed across (or inside) a different chromosome of the
    concatenated text.
    """
    ri, _ = meta.pos_to_ref(anchor.pos)
    seq_lo = int(meta.starts[ri]) if ri >= 0 else 0
    seq_hi = (int(meta.starts[ri] + meta.lengths[ri]) if ri >= 0 else len(text))
    if anchor.strand == 0:
        lo = anchor.pos
        hi = min(seq_hi, anchor.pos + max(rlim, L + 8))
        strand = 1
    else:
        hi = min(seq_hi, anchor.pos + L + 8)
        lo = max(seq_lo, hi - max(rlim, L + 8))
        strand = 0
    return lo, hi, strand


def _cigar_from_ops(ops):
    """uint8 op codes (0=M 1=I 2=D) -> run-length cigar list."""
    cigar = []
    for op in ops:
        ch = "MID"[op]
        if cigar and cigar[-1][0] == ch:
            cigar[-1][1] += 1
        else:
            cigar.append([ch, 1])
    return [(op, ln) for op, ln in cigar]


def _rescue_accept(text, lo, hi, strand, target, L, cost, start, cigar,
                   opt: AlnOpt):
    """Shared acceptance rule + Occurrence construction for a rescue."""
    budget = max(opt.diff_budget(L), round(0.15 * L))
    if start < 0 or cost > budget * opt.s_mm:
        return None
    n_ins = sum(ln for op, ln in cigar if op == "I")
    n_del = sum(ln for op, ln in cigar if op == "D")
    n_opens = sum(1 for op, ln in cigar if op in ("I", "D"))
    window = np.asarray(text[lo:hi])
    nm, _ = cigar_stats(cigar, target, window[start:start + L + n_del])
    return Occurrence(lo + start, strand, cost, nm - n_ins - n_del,
                      n_opens, max(n_ins + n_del - n_opens, 0))


def _rescue_batch(text, meta, jobs, rlim, opt: AlnOpt, device):
    """All rescue jobs screened in one device DP; yields
    ``(pair_idx, missing_end, Occurrence | None)`` in job order.

    ``jobs``: ``[(pair_idx, missing_end, anchor, read, L)]``.  Screen, then
    traceback:

    1. the windows from :func:`_rescue_window`;
    2. one :func:`~hsa_tpu_torch.kernels.sw.glocal_screen` over every job
       on ``device`` (required: ``"cuda"``, or ``"cpu"`` when the caller
       asks for the plain version), at the jobs' exact shapes (nothing
       recompiles in PyTorch);
    3. a job is dropped when its window is shorter than its read or its
       cost is above ``max(diff_budget(L), round(0.15 L)) * s_mm``;
    4. the native ``glocal_batch`` traces back only the jobs that are left;
    5. :func:`_rescue_accept` / :func:`_cigar_from_ops` build the
       occurrences.

    The screen's cost equals the native DP's (both are twins of the
    reference's ``fit_in_window``), so the jobs dropped in step 3 are
    exactly those that :func:`_rescue_accept` would reject, and the records
    equal those of ``hsa_tpu/resolve/sampe.py:_rescue_batch``, which traces
    back every job natively.
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


# ---------------------------------------------------------------------------
# Array-native paired resolution (the PE twin of
# samse.resolve_from_occ_arrays).  The reference's per-pair loop resolver
# (``resolve_pe_from_occurrences``, its semantics oracle) is not part of the
# port: the tests hold this one against the reference package directly.
# ---------------------------------------------------------------------------

_WCAP = 64          # pairing window width (the reference loop's [:64] cap)


def _pair_matrix(posm, scm, stm, glm, okm, mean, std, max_isize):
    """Best proper FR combination per pair, over dense window matrices.

    posm/scm/stm/glm/okm: [2, M, W] window fields of both ends.  Returns
    (has, a_i, b_i, ins, n_best, subo, best_sc) arrays over the M pairs,
    with the semantics of the reference's loop: valid combos are FR pairs with
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
    Record-equal to ``hsa_tpu/resolve/sampe.py``'s resolver of the same
    name (tested equal); all numeric work — span filter, windows, insert-size inference, pairing,
    MAPQ incl. the paired adjustment, ungapped NM/MD, batched gapped
    cores, XA — is vectorized, and the per-pair Python that remains is
    string assembly only.  ``emit="sam"`` returns (lines, flags) with
    records formatted directly (lineage: ``bwape.c`` record emission,
    SURVEY.md §3.4).  ``rescue`` (required) runs the mate rescue: it is
    called with :func:`_rescue_batch`'s first five parameters, and an
    aligner passes :func:`_rescue_batch` bound to its device, so nothing
    here chooses a device.
    """
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

    # ---- mate rescue (batched device screen; rare) -----------------------
    rescued = np.zeros(N, bool)
    rescue_occ: dict[int, Occurrence] = {}
    if peopt.is_sw:
        rlim = int((mean + 4 * std) if mean is not None else peopt.max_isize)
        np_j = np.flatnonzero(~proper)
        jobs = []
        for j in np_j.tolist():
            h1, h2 = has_pick[j], has_pick[B + j]
            if not (h1 or h2):
                continue

            def _anchor(e):
                i = pick_ent[e]
                return Occurrence(int(pos[i]), int(strand[i]),
                                  int(score[i]), int(nmm[i]),
                                  int(ngapo[i]), int(ngape[i]))
            if h1 != h2:
                if h2:        # end 1 missing
                    jobs.append((j, 1, _anchor(B + j), rdmat[j, :lens[j]],
                                 int(lens[j])))
                else:
                    jobs.append((j, 2, _anchor(j), rdmat[B + j, :lens[B + j]],
                                 int(lens[B + j])))
            else:
                # discordant: both map, no FR combo — anchor a unique end
                u1 = nbest_end[j] == 1 and nw_end[j] >= 1
                u2 = nbest_end[B + j] == 1 and nw_end[B + j] >= 1
                sc1 = score[pick_ent[j]]
                sc2 = score[pick_ent[B + j]]
                if u1 and (not u2 or sc1 <= sc2):
                    jobs.append((j, 2, _anchor(j), rdmat[B + j, :lens[B + j]],
                                 int(lens[B + j])))
                elif u2:
                    jobs.append((j, 1, _anchor(B + j), rdmat[j, :lens[j]],
                                 int(lens[j])))
        for j, missing, res in rescue(text, meta, jobs, rlim, opt):
            if res is None:
                continue
            e = j if missing == 1 else B + j
            rescue_occ[e] = res
            rescued[e] = True
            proper[j] = True

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

    # ---- rescued-end records (rare; per-record twin keeps byte parity) ---
    rescue_rec: dict[int, AlnRecord] = {}
    for e, o in rescue_occ.items():
        qsrc = quals1 if e < B else quals2
        q = qsrc[e % B] if qsrc else "*"
        rec = _make_record(text, meta, rdmat[e, :lens[e]].astype(np.int8),
                           names[e % B], q, o, 0, opt)
        rescue_rec[e] = rec

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
                span = _cigar_ref_span(rec.cigar)
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
