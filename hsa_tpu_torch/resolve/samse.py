"""Single-end hit resolution -> SAM records (lineage: ``bwase.c``).

Pipeline per read (SURVEY.md §3.3): merge both-strand hit lists -> locate
all occurrences (batched device locate) -> position-level dedup (the exact
semantics the lineage's ``gap_shadow`` approximates) -> c1/c2 counting ->
primary selection -> MAPQ -> CIGAR/NM/MD via shared DP -> record.

Documented deviations from the strict lineage (mount empty; see
``hsa_tpu.oracle``):
- equal-best tie-break is a deterministic hash of the read ordinal instead
  of ``drand48`` (reference behavior is random; ours is reproducible).
- c1/c2 are counts of distinct (pos, strand) occurrences, clamped at 256.
- occurrences beyond ``max_occ_per_read`` are not located; such reads have
  c1 > 1 anyway (MAPQ 0) and report a located subset in XA.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import alphabet, metrics, refpack
from ..config import AlnOpt, SamseOpt
from .cigar import banded_global, cigar_stats, cigar_string
from .mapq import approx_mapq, trunc_capped_mapq

_HASH = 2654435761


@dataclass
class AlnRecord:
    qname: str
    flag: int
    rname: str
    pos: int          # 1-based; 0 for unmapped
    mapq: int
    cigar: str
    seq: str
    qual: str
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    tags: dict = field(default_factory=dict)

    def to_sam(self) -> str:
        tag_order = ["XT", "X0", "X1", "XN", "XM", "XO", "XG", "NM", "MD", "XA"]
        tags = []
        for t in tag_order:
            if t in self.tags:
                v = self.tags[t]
                ty = "i" if isinstance(v, (int, np.integer)) else "Z"
                tags.append(f"{t}:{ty}:{v}")
        fields = [self.qname, str(self.flag), self.rname, str(self.pos),
                  str(self.mapq), self.cigar, self.rnext, str(self.pnext),
                  str(self.tlen), self.seq, self.qual or "*"]
        return "\t".join(fields + tags)


@dataclass
class Occurrence:
    pos: int     # concat text coordinate (leftmost)
    strand: int  # 0 fwd, 1 rev
    score: int
    nmm: int
    ngapo: int
    ngape: int


def collect_occurrences(hits_fwd, hits_rc, locate_fn, max_occ: int = 512):
    """Per-read merged, deduped occurrence lists (vectorized).

    hits_fwd/hits_rc: list (per read) of Hit lists from either engine.
    locate_fn: callable(ranks_uint32_array) -> positions array (batched).
    Returns (occs_per_read, truncated_flags).  Semantics (shared with the
    loop reference implementation below, tested equal): the per-read
    occurrence budget ``max_occ`` is consumed across both strands in hit
    order; deduplication keeps the minimum-score hit per (pos, strand)
    with first-encountered winning ties.
    """
    B = len(hits_fwd)
    js, ss, ks, ws, sc, nm, go, ge = [], [], [], [], [], [], [], []
    for j in range(B):
        for strand, hits in ((0, hits_fwd[j]), (1, hits_rc[j])):
            for h in hits:
                js.append(j); ss.append(strand); ks.append(h.k)
                ws.append(h.l - h.k + 1); sc.append(h.score)
                nm.append(h.nmm); go.append(h.ngapo); ge.append(h.ngape)
    if not js:
        return [[] for _ in range(B)], [False] * B
    js = np.asarray(js, np.int64); ss = np.asarray(ss, np.int8)
    ks = np.asarray(ks, np.int64); ws = np.asarray(ws, np.int64)
    sc = np.asarray(sc, np.int64); nm = np.asarray(nm, np.int32)
    go = np.asarray(go, np.int32); ge = np.asarray(ge, np.int32)

    # per-read running budget over hits (arrays are grouped by read already)
    cum = np.cumsum(ws)
    first_of_read = np.ones(js.size, bool)
    first_of_read[1:] = js[1:] != js[:-1]
    read_base = np.maximum.accumulate(np.where(first_of_read, cum - ws, -1))
    used_before = (cum - ws) - read_base
    take = np.clip(max_occ - used_before, 0, ws)
    trunc_hit = take < ws
    truncated = [False] * B
    for j in np.unique(js[trunc_hit]):
        truncated[int(j)] = True

    total = int(take.sum())
    if total == 0:
        return [[] for _ in range(B)], truncated
    hid = np.repeat(np.arange(js.size), take)
    offs = np.arange(total) - np.repeat(np.cumsum(take) - take, take)
    ranks = ks[hid] + offs
    pos = np.asarray(locate_fn(ranks.astype(np.uint32))).astype(np.int64)

    # dedup per (read, strand, pos): min score, earliest wins ties
    order = np.lexsort((np.arange(total), sc[hid], pos, ss[hid], js[hid]))
    jo, so, po = js[hid][order], ss[hid][order], pos[order]
    first = np.ones(total, bool)
    first[1:] = (jo[1:] != jo[:-1]) | (so[1:] != so[:-1]) | (po[1:] != po[:-1])
    win = order[first]

    occs = [[] for _ in range(B)]
    for w_i in win:
        h = int(hid[w_i])
        occs[int(js[h])].append(Occurrence(int(pos[w_i]), int(ss[h]),
                                           int(sc[h]), int(nm[h]),
                                           int(go[h]), int(ge[h])))
    for j in range(B):
        occs[j].sort(key=lambda o: (o.score, o.strand, o.pos))
    return occs, truncated


def collect_occurrences_ref(hits_fwd, hits_rc, locate_fn, max_occ: int = 512):
    """Loop reference implementation (semantics oracle for the vectorized one)."""
    B = len(hits_fwd)
    ranks, owners = [], []
    truncated = [False] * B
    for j in range(B):
        budget = max_occ
        for strand, hits in ((0, hits_fwd[j]), (1, hits_rc[j])):
            for h in hits:
                w = h.l - h.k + 1
                take = min(w, budget)
                if take < w:
                    truncated[j] = True
                for r in range(h.k, h.k + take):
                    ranks.append(r)
                    owners.append((j, strand, h))
                budget -= take
        # NOTE: budget is shared across both strands in hit order
    if ranks:
        pos = np.asarray(locate_fn(np.asarray(ranks, dtype=np.uint32)))
    else:
        pos = np.zeros(0, np.int64)
    occs = [dict() for _ in range(B)]
    for (j, strand, h), p in zip(owners, pos):
        key = (int(p), strand)
        cur = occs[j].get(key)
        if cur is None or cur.score > h.score:
            occs[j][key] = Occurrence(int(p), strand, h.score, h.nmm, h.ngapo, h.ngape)
    out = []
    for j in range(B):
        lst = sorted(occs[j].values(), key=lambda o: (o.score, o.strand, o.pos))
        out.append(lst)
    return out, truncated


def _span_possible(meta, o: Occurrence, L: int) -> bool:
    """Boundary filter: can the alignment fit inside one reference sequence?

    The exact reference span is only known after the refinement DP, so the
    filter uses the MINIMUM possible span (every gap op taken as an
    insertion); ungapped hits have the exact span L.  The refinement window
    in _make_record is clamped to the sequence end, so accepted gapped hits
    can never produce CIGARs that cross a chromosome junction.
    """
    ngap = o.ngapo + o.ngape
    min_span = L if ngap == 0 else max(L - ngap, 1)
    return meta.span_ok(o.pos, min_span)


def resolve_batch_se(text, meta, reads, names, quals, hits_fwd, hits_rc,
                     locate_fn, opt: AlnOpt, sopt: SamseOpt | None = None,
                     read_offset: int = 0, max_occ: int = 512):
    """Resolve a batch of single-end reads into SAM records.

    text: int8 concatenated genome codes; meta: RefMeta; reads: list of code
    arrays (original 5'->3' orientation); locate_fn as in collect_occurrences.
    ``read_offset`` keeps the deterministic tie-break stable across batches.
    """
    occs, truncated = collect_occurrences(hits_fwd, hits_rc, locate_fn, max_occ)
    return resolve_from_occurrences(text, meta, reads, names, quals, occs,
                                    truncated, opt, sopt,
                                    read_offset=read_offset)


def resolve_from_occurrences(text, meta, reads, names, quals, occs, truncated,
                             opt: AlnOpt, sopt: SamseOpt | None = None,
                             read_offset: int = 0, c2_extra=None):
    """Core resolution over per-read Occurrence lists (position-space hit
    sets — produced by collect_occurrences or directly by the pigeon
    engine, whose candidates are already located).

    ``c2_extra[j]`` (optional int array): candidates the search engine
    did NOT enumerate for read j (capped repeat intervals).  They inflate
    c2 and cap MAPQ (mapq.trunc_capped_mapq) — the conservative
    confidence treatment of a truncated hit set.
    """
    sopt = sopt or SamseOpt()
    records = []
    for j, read in enumerate(reads):
        L = len(read)
        name = names[j]
        qual = quals[j] if quals else "*"
        seq_fwd = alphabet.decode(read)
        lst = [o for o in occs[j] if _span_possible(meta, o, L)]
        if not lst:
            records.append(AlnRecord(name, 4, "*", 0, 0, "*", seq_fwd, qual))
            continue
        best = lst[0].score
        window = [o for o in lst if o.score <= best + opt.s_mm]
        c1 = min(sum(1 for o in window if o.score == best), 256)
        extra = int(c2_extra[j]) if c2_extra is not None else 0
        c2 = min(len(window) - c1 + min(extra, 255), 256)
        bests = [o for o in window if o.score == best]
        pick = bests[((read_offset + j) * _HASH) % (1 << 32) % len(bests)]
        max_diff = opt.diff_budget(L)
        mapq = trunc_capped_mapq(approx_mapq(c1, c2, pick.nmm, max_diff),
                                 c2, extra)

        rec = _make_record(text, meta, read, name, qual, pick, mapq, opt)
        rec.tags["XT"] = "U" if c1 == 1 else "R"
        rec.tags["X0"] = c1
        if not truncated[j]:
            rec.tags["X1"] = c2
        # XA alternates
        if 1 < len(window) <= sopt.n_multi + 1 or (c1 == 1 and 0 < c2 <= sopt.n_multi):
            alts = [o for o in window if o is not pick][:sopt.n_multi]
            parts = []
            for o in alts:
                arec = _make_record(text, meta, read, name, qual, o, 0, opt)
                parts.append(f"{arec.rname},{'-' if o.strand else '+'}{arec.pos},"
                             f"{arec.cigar},{arec.tags['NM']}")
            if parts:
                rec.tags["XA"] = ";".join(parts) + ";"
        records.append(rec)
    return records


_DECODE_LUT = np.frombuffer(b"ACGTNN", dtype=np.uint8).copy()


@metrics.traced("resolve")
def resolve_from_occ_arrays(text, meta, reads, names, quals, occ, truncated,
                            opt: AlnOpt, sopt: SamseOpt | None = None,
                            read_offset: int = 0, emit: str = "records",
                            c2_extra=None, hash_ids=None):
    """Vectorized resolution over flat occurrence arrays.

    ``occ`` is the dict produced by
    :func:`hsa_tpu.search.pigeon.pigeon_occ_arrays` (or the
    ``occ_lists_to_arrays`` adapter): arrays ``rid, pos, strand, score,
    nmm, ngapo, ngape`` deduped per (rid, strand, pos) and sorted by
    (rid, score, strand, pos).  Record-equal to
    :func:`resolve_from_occurrences` (the loop twin; tested equal); all
    numeric work — span filter, window/c1/c2 counting, primary pick,
    MAPQ, ungapped NM/mismatch extraction — is numpy-vectorized, and the
    per-read Python that remains is string assembly only.

    Traced as ``resolve`` with the stages ``resolve.prep`` (span filter,
    matrices, groups, MAPQ, ungapped refinement), ``resolve.cores`` (the
    batched gapped cores and XA) and ``resolve.emit`` (the records).
    """
    metrics.stage("resolve.prep")
    sopt = sopt or SamseOpt()
    B = len(reads)
    is_rb = hasattr(reads, "mat") and hasattr(reads, "lens")  # ReadBatch
    lens = (np.asarray(reads.lens, np.int64) if is_rb
            else np.fromiter((len(r) for r in reads), np.int64, B))
    rid = np.asarray(occ["rid"], np.int64)
    pos = np.asarray(occ["pos"], np.int64)
    strand = np.asarray(occ["strand"], np.int8)
    score = np.asarray(occ["score"], np.int64)
    nmm = np.asarray(occ["nmm"], np.int64)
    ngapo = np.asarray(occ["ngapo"], np.int64)
    ngape = np.asarray(occ["ngape"], np.int64)

    # span filter (the vector form of _span_possible)
    if rid.size:
        ngap = ngapo + ngape
        Locc = lens[rid]
        min_span = np.where(ngap == 0, Locc, np.maximum(Locc - ngap, 1))
        si = np.searchsorted(meta.starts, pos, side="right") - 1
        sis = np.clip(si, 0, len(meta.starts) - 1)
        ok = (si >= 0) & (pos - meta.starts[sis] + min_span <= meta.lengths[sis])
        if not ok.all():
            rid, pos, strand, score, nmm, ngapo, ngape, ngap = (
                a[ok] for a in (rid, pos, strand, score, nmm, ngapo,
                                ngape, ngap))
    else:
        ngap = ngapo

    # read/strand matrices + decoded strings (one pass, C-speed per row)
    Lmax = max(int(lens.max()) if B else 1, 1)
    if is_rb:
        t = np.arange(Lmax)
        rdmat = np.where(t[None, :] < lens[:, None],
                         reads.mat[:, :Lmax], 4).astype(np.uint8)
    else:
        rdmat = np.full((B, Lmax), 4, np.uint8)
        for j, r in enumerate(reads):
            rdmat[j, :lens[j]] = np.asarray(r, np.uint8)
    t = np.arange(Lmax)
    cols = np.clip(lens[:, None] - 1 - t[None, :], 0, Lmax - 1)
    rcmat = np.take_along_axis(rdmat, cols, axis=1)
    rcmat = np.where(rcmat <= 3, 3 - rcmat, rcmat).astype(np.uint8)
    rcmat[t[None, :] >= lens[:, None]] = 4
    fwd_chars = _DECODE_LUT[np.minimum(rdmat, 5)]
    rc_chars = _DECODE_LUT[np.minimum(rcmat, 5)]

    # groups (rid-sorted): per-read window stats + primary pick
    grp_first = np.flatnonzero(np.r_[True, rid[1:] != rid[:-1]]) \
        if rid.size else np.zeros(0, np.int64)
    grp_rid = rid[grp_first] if rid.size else np.zeros(0, np.int64)
    grp_cnt = np.diff(np.r_[grp_first, rid.size]) if rid.size else grp_first
    gi_of = np.repeat(np.arange(grp_first.size), grp_cnt)
    best = score[grp_first] if rid.size else grp_first
    wmask = score <= best[gi_of] + opt.s_mm if rid.size else np.zeros(0, bool)
    isbest = score == best[gi_of] if rid.size else wmask
    if rid.size:
        nbest = np.add.reduceat(isbest.astype(np.int64), grp_first)
        nwin = np.add.reduceat(wmask.astype(np.int64), grp_first)
    else:
        nbest = nwin = np.zeros(0, np.int64)
    c1 = np.minimum(nbest, 256)
    # c2_extra: unenumerated candidates of truncated reads inflate c2
    # and cap MAPQ below (the loop twin applies trunc_capped_mapq)
    if c2_extra is not None and rid.size:
        x_grp = np.minimum(np.asarray(c2_extra, np.int64)[grp_rid], 255)
    else:
        x_grp = None
    c2 = np.minimum(nwin - nbest + (x_grp if x_grp is not None else 0), 256)
    # tie-break ids: read_offset + batch position by default; callers
    # resolving a NON-CONTIGUOUS read subset (the stream's fallback
    # patch pass) pass the global ids explicitly so the deterministic
    # pick matches a whole-batch resolution of the same reads
    hids = (np.asarray(hash_ids, np.int64)[grp_rid] if hash_ids is not None
            else read_offset + grp_rid) if rid.size else grp_rid
    k = ((hids.astype(np.uint64) * np.uint64(_HASH))
         % np.uint64(1 << 32)) % np.maximum(nbest, 1).astype(np.uint64)
    pick_idx = grp_first + k.astype(np.int64)

    # per-read pick fields (index by read for assembly)
    g_of_read = np.full(B, -1, np.int64)
    g_of_read[grp_rid] = np.arange(grp_rid.size)
    p_pos = pos[pick_idx] if rid.size else pick_idx
    p_str = strand[pick_idx] if rid.size else pick_idx
    p_nmm = nmm[pick_idx] if rid.size else pick_idx
    p_go = ngapo[pick_idx] if rid.size else pick_idx
    p_ge = ngape[pick_idx] if rid.size else pick_idx

    # MAPQ (vector approx_mapq; c1 >= 1 for every mapped read)
    budg = {int(L): opt.diff_budget(int(L)) for L in np.unique(lens)}
    maxdiff = np.fromiter((budg[int(L)] for L in lens), np.int64, B)
    n_c2 = np.minimum(c2, 255)
    glog = np.where(n_c2 > 0,
                    (4.343 * np.log(np.maximum(n_c2, 1)) + 0.5).astype(np.int64),
                    0)
    mq_g = grp_rid  # read ids of groups
    mapq_grp = np.where(c1 > 1, 0,
                        np.where(p_nmm == maxdiff[mq_g], 25,
                                 np.where(c2 == 0, 37,
                                          np.maximum(23 - glog, 0))))
    if x_grp is not None:
        # truncated enumeration: MAPQ cannot exceed the c2-branch value
        # for the inflated count (mapq.trunc_capped_mapq, vector form)
        mapq_grp = np.where(x_grp > 0,
                            np.minimum(mapq_grp, np.maximum(23 - glog, 0)),
                            mapq_grp)

    # vectorized ungapped pick refinement: NM + mismatch positions
    n_text = len(text)
    ugp = np.flatnonzero((g_of_read >= 0) & (p_go[g_of_read] + p_ge[g_of_read]
                                             == 0)) if rid.size else []
    mm_rows: dict[int, np.ndarray] = {}
    nm_of: dict[int, int] = {}
    win_of: dict[int, np.ndarray] = {}
    if len(ugp):
        gidx = g_of_read[ugp]
        wpos = p_pos[gidx]
        widx = np.minimum(wpos[:, None] + t[None, :], n_text - 1)
        win = np.asarray(text)[widx]
        aln = np.where(p_str[gidx][:, None].astype(bool), rcmat[ugp],
                       rdmat[ugp])
        mm = ((aln != win) | (aln > 3)) & (t[None, :] < lens[ugp][:, None])
        nms = mm.sum(axis=1)
        rows, cs = np.nonzero(mm)
        splits = np.searchsorted(rows, np.arange(len(ugp) + 1))
        for i, j in enumerate(ugp):
            mm_rows[j] = cs[splits[i]:splits[i + 1]]
            nm_of[j] = int(nms[i])
            win_of[j] = win[i]

    # vectorized XN (ambiguity overlap) for ungapped picks
    xn_of: dict[int, int] = {}
    if len(ugp) and meta.amb_runs:
        if not hasattr(meta, "_amb_starts"):
            meta._amb_starts = np.asarray([r[0] for r in meta.amb_runs],
                                          np.int64)
            meta._amb_ends = meta._amb_starts + np.asarray(
                [r[1] for r in meta.amb_runs], np.int64)
        gidx = g_of_read[ugp]
        lo = np.searchsorted(meta._amb_ends, p_pos[gidx], side="right")
        hi = np.searchsorted(meta._amb_starts, p_pos[gidx] + lens[ugp],
                             side="left")
        for i, j in enumerate(ugp):
            if hi[i] > lo[i]:
                xn_of[j] = meta.count_amb(int(p_pos[gidx[i]]), int(lens[ugp[i]]))
            else:
                xn_of[j] = 0

    # rname / 1-based offset per pick
    if rid.size:
        psi = np.searchsorted(meta.starts, p_pos, side="right") - 1
        p_off1 = p_pos - meta.starts[np.clip(psi, 0, len(meta.starts) - 1)] + 1

    # one-shot conversion to Python scalars: the record loop below runs
    # ~25 per-record indexings, and numpy scalar indexing is ~10x the
    # cost of list indexing (measured: dominates batch resolution time)
    lens_l = lens.tolist()
    g_of_l = g_of_read.tolist()
    if rid.size:
        p_str_l = p_str.tolist()
        mapq_l = mapq_grp.tolist()
        p_nmm_l = p_nmm.tolist()
        p_pos_l = p_pos.tolist()
        p_go_l = p_go.tolist()
        p_ge_l = p_ge.tolist()
        c1_l = c1.tolist()
        c2_l = c2.tolist()
        nwin_l = nwin.tolist()
        grp_first_l = grp_first.tolist()
        grp_cnt_l = grp_cnt.tolist()
        pick_idx_l = pick_idx.tolist()
        pick_sc_l = score[pick_idx].tolist()
        off1_l = p_off1.tolist()
        rname_l = [meta.names[i] for i in psi.tolist()]
        wmask_l = wmask.tolist()
    mmrows_l = {j: v.tolist() for j, v in mm_rows.items()}
    winmm_l = {j: win_of[j][mm_rows[j]].tolist() for j in mm_rows}

    metrics.stage("resolve.cores")
    # ---- gapped record cores + XA alternates, batched ------------------
    # ONE native rp_banded_batch call covers every gapped pick and every
    # gapped XA alternate (no per-record ctypes round trips); ungapped-alternate
    # NM counts ride a single window gather.  The emit loop below then
    # only assembles strings.
    xa_of: dict[int, str] = {}
    pickgap: dict[int, tuple] = {}
    n_multi = sopt.n_multi
    if rid.size:
        starts_a = np.asarray(meta.starts, np.int64)
        lengths_a = np.asarray(meta.lengths, np.int64)
        alt_j: list[int] = []
        alt_oi: list[int] = []
        for j in range(B):
            gidx = g_of_l[j]
            if gidx < 0:
                continue
            nw = nwin_l[gidx]
            if not (1 < nw <= n_multi + 1
                    or (c1_l[gidx] == 1 and 0 < c2_l[gidx] <= n_multi)):
                continue
            s0 = grp_first_l[gidx]
            s1 = s0 + grp_cnt_l[gidx]
            pk = pick_idx_l[gidx]
            cnt = 0
            for oi in range(s0, s1):
                if oi == pk or not wmask_l[oi]:
                    continue
                if cnt >= n_multi:
                    break
                alt_j.append(j)
                alt_oi.append(oi)
                cnt += 1
        aj = np.asarray(alt_j, np.int64)
        ao = np.asarray(alt_oi, np.int64)
        a_pos = pos[ao]
        a_str = strand[ao].astype(np.int64)
        a_ngap = ngap[ao]
        a_L = lens[aj]
        asi = np.clip(np.searchsorted(starts_a, a_pos, side="right") - 1,
                      0, len(starts_a) - 1)
        a_end = starts_a[asi] + lengths_a[asi]
        gj = np.maximum(g_of_read, 0)
        gpp = np.flatnonzero((g_of_read >= 0) & ((p_go + p_ge)[gj] > 0))
        gp_g = g_of_read[gpp]
        ga_idx = np.flatnonzero(a_ngap > 0)
        n_pk, n_ga = len(gpp), len(ga_idx)
        cigs: list = []
        nmb = glb = gbb = None
        mds: list = []
        if n_pk + n_ga:
            pk_si = np.clip(psi[gp_g], 0, len(starts_a) - 1)
            reads_all = np.ascontiguousarray(
                np.concatenate([rdmat, rcmat], axis=0))
            j_roff = np.concatenate(
                [(p_str[gp_g].astype(np.int64) * B + gpp) * Lmax,
                 (a_str[ga_idx] * B + aj[ga_idx]) * Lmax])
            j_rlen = np.concatenate([lens[gpp], a_L[ga_idx]])
            j_goff = np.concatenate([p_pos[gp_g], a_pos[ga_idx]])
            j_ngap = np.concatenate([(p_go + p_ge)[gp_g], a_ngap[ga_idx]])
            ends = np.concatenate([starts_a[pk_si] + lengths_a[pk_si],
                                   a_end[ga_idx]])
            j_glen = np.minimum(j_rlen + j_ngap, ends - j_goff)
            j_band = (j_ngap + 1).astype(np.int32)
            cigs, mds, nmb, glb, gbb = refpack.banded_batch(
                reads_all, j_roff, j_rlen.astype(np.int32), np.asarray(text),
                j_goff, j_glen.astype(np.int32), opt.s_mm, opt.s_gapo,
                opt.s_gape, j_band)
            for i, j in enumerate(gpp.tolist()):
                pickgap[j] = (cigs[i], mds[i], int(nmb[i]), int(glb[i]),
                              int(gbb[i]))
        # ungapped alternates: NM via one window gather
        a_nm = np.zeros(len(ao), np.int64)
        ug_idx = np.flatnonzero(a_ngap == 0)
        if len(ug_idx):
            n_text_i = len(text)
            t2 = np.arange(Lmax)
            widx = np.minimum(a_pos[ug_idx][:, None] + t2[None, :],
                              n_text_i - 1)
            win2 = np.asarray(text)[widx]
            rows2 = np.where(a_str[ug_idx].astype(bool)[:, None],
                             rcmat[aj[ug_idx]], rdmat[aj[ug_idx]])
            mm2 = ((rows2 != win2) | (rows2 > 3)) \
                & (t2[None, :] < a_L[ug_idx][:, None])
            a_nm[ug_idx] = mm2.sum(axis=1)
        if len(ao):
            gpos = np.full(len(ao), -1, np.int64)
            gpos[ga_idx] = n_pk + np.arange(n_ga)
            a_off1 = (a_pos - starts_a[asi] + 1).tolist()
            gpos_l = gpos.tolist()
            a_nm_l = a_nm.tolist()
            a_L_l = a_L.tolist()
            a_str_l = a_str.tolist()
            nm_parts: dict[int, list] = {}
            for i, j in enumerate(alt_j):
                gi = gpos_l[i]
                cg = f"{a_L_l[i]}M" if gi < 0 else cigs[gi]
                nm_i = a_nm_l[i] if gi < 0 else int(nmb[gi])
                nm_parts.setdefault(j, []).append(
                    f"{meta.names[asi[i]]},{'-' if a_str_l[i] else '+'}"
                    f"{a_off1[i]},{cg},{nm_i}")
            xa_of = {j: ";".join(p) + ";" for j, p in nm_parts.items()}

    metrics.stage("resolve.emit")
    emit_sam = emit == "sam"
    records = []
    flags_out = []
    md_lut = "ACGTN"
    has_amb = bool(meta.amb_runs)
    n_multi = sopt.n_multi
    for j in range(B):
        L = lens_l[j]
        name = names[j]
        qual = quals[j] if quals else "*"
        gidx = g_of_l[j]
        if gidx < 0:
            seq_fwd = fwd_chars[j, :L].tobytes().decode()
            if emit_sam:
                records.append(f"{name}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq_fwd}"
                               f"\t{qual or '*'}")
                flags_out.append(4)
            else:
                records.append(AlnRecord(name, 4, "*", 0, 0, "*", seq_fwd,
                                         qual))
            continue
        st = p_str_l[gidx]
        if st:
            seq = rc_chars[j, :L].tobytes().decode()
            q = qual[::-1] if qual and qual != "*" else qual
            flag = 16
        else:
            seq = fwd_chars[j, :L].tobytes().decode()
            q = qual
            flag = 0
        mapq = mapq_l[gidx]
        c1 = c1_l[gidx]
        # XA alternates: precomputed above (batched DP / window gather)
        xa = xa_of.get(j)
        nm_j = nm_of.get(j)
        if nm_j is not None:
            # ungapped: "LM" CIGAR, MD from mismatch positions
            parts = []
            prev = 0
            for col, wc in zip(mmrows_l[j], winmm_l[j]):
                parts.append(str(col - prev))
                parts.append(md_lut[wc if wc < 4 else 4])
                prev = col + 1
            parts.append(str(L - prev))
            mdstr = "".join(parts)
            xn = xn_of.get(j, 0) if has_amb else 0
            if emit_sam:
                # field/tag order mirrors AlnRecord.to_sam exactly
                line = (f"{name}\t{flag}\t{rname_l[gidx]}\t{off1_l[gidx]}"
                        f"\t{mapq}\t{L}M\t*\t0\t0\t{seq}\t{q or '*'}"
                        f"\tXT:Z:{'U' if c1 == 1 else 'R'}\tX0:i:{c1}")
                if not truncated[j]:
                    line += f"\tX1:i:{c2_l[gidx]}"
                if xn:
                    line += f"\tXN:i:{xn}"
                line += (f"\tXM:i:{p_nmm_l[gidx]}\tXO:i:0\tXG:i:0"
                         f"\tNM:i:{nm_j}\tMD:Z:{mdstr}")
                if xa:
                    line += f"\tXA:Z:{xa}"
                records.append(line)
                flags_out.append(flag)
                continue
            rec = AlnRecord(name, flag, rname_l[gidx], off1_l[gidx], mapq,
                            f"{L}M", seq, q)
            rec.tags.update(NM=nm_j, MD=mdstr,
                            XM=p_nmm_l[gidx], XO=0, XG=0)
            if xn:
                rec.tags["XN"] = xn
        else:
            pg = pickgap.get(j)
            if pg is not None:     # batched gapped pick core
                cig_s, md_s, nm_b, glen_b, gapb_b = pg
                rec = AlnRecord(name, flag, rname_l[gidx], off1_l[gidx],
                                mapq, cig_s, seq, q)
                rec.tags.update(NM=nm_b, MD=md_s, XM=p_nmm_l[gidx],
                                XO=p_go_l[gidx], XG=gapb_b)
                if has_amb:
                    xn = meta.count_amb(p_pos_l[gidx], glen_b)
                    if xn:
                        rec.tags["XN"] = xn
            else:                  # defensive twin (unreachable in practice)
                o = Occurrence(p_pos_l[gidx], st, pick_sc_l[gidx],
                               p_nmm_l[gidx], p_go_l[gidx], p_ge_l[gidx])
                rec = _make_record(text, meta, reads[j], name, qual, o, mapq,
                                   opt)
        rec.tags["XT"] = "U" if c1 == 1 else "R"
        rec.tags["X0"] = c1
        if not truncated[j]:
            rec.tags["X1"] = c2_l[gidx]
        if xa:
            rec.tags["XA"] = xa
        if emit_sam:
            records.append(rec.to_sam())
            flags_out.append(rec.flag)
        else:
            records.append(rec)
    if emit_sam:
        return records, flags_out
    return records


def _make_record(text, meta, read, name, qual, o: Occurrence, mapq, opt: AlnOpt):
    L = len(read)
    if o.strand:
        aln_read = alphabet.revcomp(read)
        seq = alphabet.decode(aln_read)
        q = qual[::-1] if qual and qual != "*" else qual
        flag = 16
    else:
        aln_read = read
        seq = alphabet.decode(read)
        q = qual
        flag = 0
    ngap = o.ngapo + o.ngape
    ref_i0, off0 = meta.pos_to_ref(o.pos)
    seq_end = (int(meta.starts[ref_i0] + meta.lengths[ref_i0])
               if ref_i0 >= 0 else len(text))
    if ngap == 0:
        glen = L
        ref_win = text[o.pos:o.pos + L]
        cigar = [("M", L)]
        # vectorized NM/MD (cigar_stats twin for the all-M case; the
        # per-base python walk dominated paired-end record building)
        rd = np.asarray(aln_read)
        mmp = np.nonzero((rd != ref_win) | (rd > 3))[0]
        nm = len(mmp)
        parts = []
        prev = 0
        for p in mmp.tolist():
            parts.append(str(p - prev))
            parts.append("ACGTN"[min(int(ref_win[p]), 4)])
            prev = p + 1
        parts.append(str(L - prev))
        md = "".join(parts)
    else:
        # clamp the refinement window to this sequence's end so the CIGAR
        # can never cross a chromosome junction in the concatenated text
        wlen = min(L + ngap, seq_end - o.pos)
        ref_win = text[o.pos:o.pos + wlen]
        _, cigar, glen = banded_global(aln_read, ref_win, opt.s_mm, opt.s_gapo,
                                       opt.s_gape, band=ngap + 1)
        nm, md = cigar_stats(cigar, aln_read, ref_win)
    ref_i, off = meta.pos_to_ref(o.pos)
    rname = meta.names[ref_i] if ref_i >= 0 else "*"
    rec = AlnRecord(name, flag, rname, off + 1, mapq, cigar_string(cigar), seq, q)
    n_gap_bases = sum(ln for op, ln in cigar if op in ("I", "D"))
    xn = meta.count_amb(o.pos, glen)
    rec.tags.update(NM=nm, MD=md, XM=o.nmm, XO=o.ngapo, XG=n_gap_bases)
    if xn:
        rec.tags["XN"] = xn
    return rec
