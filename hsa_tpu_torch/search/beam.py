"""Batched beam-search inexact alignment (torch).

Counterpart of ``hsa_tpu/search/beam.py``: thousands of reads advance
SA-interval frontiers in lockstep (lineage ``bwtgap.c`` ``gap_push`` /
``gap_pop`` / ``bwt_match_gap``).  Each read owns ``W`` frontier slots; a
step expands every live state into up to 9 children (4 match/mismatch, 1
insertion, 4 deletions), scores them with the Appendix-A budgets and keeps
the best ``W``.  Completed states (i == 0) merge into a per-read hit
buffer of ``H`` slots.  Both cross-row operations of a step go through
:func:`hsa_tpu_torch.kernels.select.select_topk`, the CUDA kernel on the
card:

- the hit merge: ``[H + 5W, 2B]`` candidates, K = H, three payloads;
- the frontier select: ``[9W, 2B]`` candidates, K = W, windowed at
  ``best + s_mm``.

The layout is the JAX engine's: states are ``[W, B]`` (slots on rows,
reads on the last axis), flattened w-major to ``[W*B]``; candidate
matrices are ``[rows, B]``.  The ``lax.scan`` over ``n_steps = Lmax +
max_gapo + max_gape`` steps is a Python loop that queues device work and
never waits on it.

Types: frontier ranks and packed meta are ``int64`` holding 32-bit values;
everything handed to or kept from the select kernel (keys, payloads, the
hit buffer, best score, drop counters) is ``int32`` holding the same bit
patterns.

Parity contract: as in the JAX engine, the hit set equals the
branch-and-bound oracle's provided no valid candidate is dropped; both drop
events are counted per read (``n_live_dropped`` / ``n_hits_dropped``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import metrics
from ..kernels.select import KEY_SH, SENT, select_topk
from . import fm
from .widths import cal_width_device

M32 = 0xFFFFFFFF
INF = 1 << 29
_SCORE_NOHIT = 0x10000  # score field values at/above this mean "no hit"
M_, I_, D_ = 0, 1, 2

# meta bit layout
_I_BITS = 9
_NMM_SH, _GAPO_SH, _GAPE_SH, _SEED_SH, _ST_SH = 9, 13, 16, 20, 24

@dataclass(frozen=True)
class Hit:
    """One recorded hit: an SA interval plus the path budgets that reached
    it (the dataclass of ``hsa_tpu/oracle/bnb.py``)."""

    score: int
    nmm: int
    ngapo: int
    ngape: int
    k: int
    l: int

    @property
    def width(self) -> int:
        return self.l - self.k + 1


def _pack(i, nmm, ngapo, ngape, seed_mm, st):
    return (i | (nmm << _NMM_SH) | (ngapo << _GAPO_SH) | (ngape << _GAPE_SH)
            | (seed_mm << _SEED_SH) | (st << _ST_SH)) & M32


def _unpack(meta):
    i = meta & 0x1FF
    nmm = (meta >> _NMM_SH) & 0xF
    ngapo = (meta >> _GAPO_SH) & 0x7
    ngape = (meta >> _GAPE_SH) & 0xF
    seed_mm = (meta >> _SEED_SH) & 0xF
    st = (meta >> _ST_SH) & 0x3
    return i, nmm, ngapo, ngape, seed_mm, st


class RawBeamResult(NamedTuple):
    """Device-side search output in kernel layout ([H, B], reads last);
    int32 tensors holding the JAX engine's uint32 values."""
    hkey: torch.Tensor       # [H, B]  score << KEY_SH | row
    hit_k: torch.Tensor      # [H, B]
    hit_l: torch.Tensor      # [H, B]
    hit_meta: torch.Tensor   # [H, B]  packed (nmm/ngapo/ngape/...)
    best_raw: torch.Tensor   # [B]     best score (>= 0x10000: none)
    n_live_dropped: torch.Tensor  # [B] max per-step beam overflow
    n_hits_dropped: torch.Tensor  # [B]


class BeamResult(NamedTuple):
    """Host-side (numpy) finalized result, read-major."""
    hit_score: object        # int32[B, H]
    hit_k: object            # uint32[B, H]
    hit_l: object            # uint32[B, H]
    hit_nmm: object          # int32[B, H]
    hit_ngapo: object        # int32[B, H]
    hit_ngape: object        # int32[B, H]
    hit_valid: object        # bool[B, H]
    best_score: object       # int32[B] (INF when no hit)
    n_live_dropped: object   # int32[B] beam-overflow parity alarms
    n_hits_dropped: object   # int32[B]


def _host_u32(x: torch.Tensor) -> np.ndarray:
    """int32 tensor of 32-bit patterns -> numpy uint32 (reads back)."""
    return x.cpu().numpy().view(np.uint32)


def finalize_result(raw: RawBeamResult, s_mm: int) -> BeamResult:
    """Host finalization (READS BACK): window filter + unpack + transpose.

    Copy of ``hsa_tpu.search.beam.finalize_result`` after the readback."""
    hkey = _host_u32(raw.hkey)
    hk = _host_u32(raw.hit_k)
    hl = _host_u32(raw.hit_l)
    hm = _host_u32(raw.hit_meta)
    best = _host_u32(raw.best_raw).astype(np.int64)
    ld = _host_u32(raw.n_live_dropped)
    hd = _host_u32(raw.n_hits_dropped)
    hscore = (hkey >> KEY_SH).astype(np.int64)
    hvalid = (hscore < _SCORE_NOHIT) & (hscore <= best[None, :] + s_mm)
    nmm = ((hm >> _NMM_SH) & 0xF).astype(np.int32)
    ngapo = ((hm >> _GAPO_SH) & 0x7).astype(np.int32)
    ngape = ((hm >> _GAPE_SH) & 0xF).astype(np.int32)
    best_i = np.where(best >= _SCORE_NOHIT, int(INF), best).astype(np.int32)
    score_i = np.where(hvalid, hscore, int(INF)).astype(np.int32)
    return BeamResult(hit_score=score_i.T, hit_k=hk.T, hit_l=hl.T,
                      hit_nmm=nmm.T, hit_ngapo=ngapo.T, hit_ngape=ngape.T,
                      hit_valid=hvalid.T, best_score=best_i,
                      n_live_dropped=ld.astype(np.int32),
                      n_hits_dropped=hd.astype(np.int32))


def beam_search(idx, reads_fwd, lens, D, max_diff, opt, *,
                beam_width: int | None = None,
                max_hits: int = 32) -> RawBeamResult:
    """Run the inexact search for a whole batch on ``idx.device``.

    reads_fwd: integer [B, Lmax] codes in 5'->3' order (PAD beyond len)
    lens:      integer [B]
    D:         integer [B, Lmax] width lower bounds (from cal_width_device);
               zeros disable pruning (hit set unchanged)
    max_diff:  integer [B] per-read diff budgets
    """
    W = beam_width or opt.beam_width
    H = max_hits
    B, Lmax = reads_fwd.shape
    if Lmax >= (1 << _I_BITS):
        raise ValueError("read length exceeds packed-state limit (511)")
    if opt.max_gapo > 7 or opt.max_gape > 15 or opt.max_seed_diff > 15:
        raise ValueError("gap or seed budget exceeds the packed-state fields")
    if 9 * W >= (1 << KEY_SH):
        raise ValueError("beam width exceeds selection-key row field")
    dev = reads_fwd.device
    i64, i32 = torch.int64, torch.int32
    reads_fwd = reads_fwd.long()
    lens = lens.long()
    # budgets above 15 cannot be represented in the 4-bit nmm packing
    max_diff = max_diff.long().clamp(max=15)
    s_mm, s_gapo, s_gape = opt.s_mm, opt.s_gapo, opt.s_gape
    skip = opt.indel_end_skip

    # combo[j] = read[j] | min(Dshift[j],31)<<3 | min(Dshift[j+1],31)<<8,
    # Dshift[b, j] = D[b, j-1], Dshift[b, 0] = 0: one gather per state gives
    # the base and both pruning bounds
    Dshift = torch.cat([torch.zeros((B, 1), dtype=i64, device=dev),
                        D.long()], dim=1)
    Dc = Dshift.clamp(max=31)
    combo = (reads_fwd | (Dc[:, :Lmax] << 3)
             | (Dc[:, 1:Lmax + 1] << 8)).reshape(-1)

    def bc(x):  # per-read value -> flat [W*B], w-major (last axis = read)
        return x[None, :].expand(W, B).reshape(-1)

    mdF = bc(max_diff)
    lensF = bc(lens)
    seedF = bc(lens - opt.seed_len)      # in_seed iff i > seed_start
    rowL = bc(torch.arange(B, dtype=i64, device=dev) * Lmax)

    with_gaps = opt.max_gapo > 0
    G = 9 if with_gaps else 4            # candidate groups
    HG = 5 if with_gaps else 4           # read-consuming groups (can complete)
    C = G * W
    HC = HG * W
    colC = torch.arange(C, dtype=i64, device=dev)[:, None]
    colM = torch.arange(H, H + HC, dtype=i32, device=dev)[:, None]
    rowH = torch.arange(H, dtype=i32, device=dev)[:, None]

    # frontier init: slot 0 (row 0) holds [0, n], i = len
    first = torch.zeros(B * W, dtype=torch.bool, device=dev)
    first[:B] = True                     # w-major: slot 0 of every read
    k = torch.zeros(B * W, dtype=i64, device=dev)
    l = torch.where(first, idx.n, 0)
    live = first & (lensF > 0)
    meta = torch.where(live, lensF, 0)
    score = torch.zeros_like(k)

    hkey = (SENT | rowH).expand(H, B).contiguous()   # invalid, unique rows
    hk = torch.zeros((H, B), dtype=i32, device=dev)
    hl = torch.zeros_like(hk)
    hm = torch.zeros_like(hk)
    best = torch.full((B,), _SCORE_NOHIT, dtype=i32, device=dev)
    ldrop = torch.zeros(B, dtype=i32, device=dev)
    hdrop = torch.zeros_like(ldrop)

    n_steps = Lmax + (opt.max_gapo + opt.max_gape if with_gaps else 0)

    def matT(xs):
        return torch.cat([x.reshape(W, B) for x in xs], dim=0)

    metrics.note(steps=n_steps)
    for _ in range(n_steps):
        i, nmm, ngapo, ngape, seed_mm, st = _unpack(meta)
        ndiff = nmm + ngapo + ngape
        expand = live & (i > 0)
        cw = combo[rowL + (i - 1).clamp(0, Lmax - 1)]
        b = cw & 7
        lb_im1 = (cw >> 3) & 31   # Dshift[i-1]: bound for the i-1 children
        in_seed = (i > seedF).long()

        # one fused occ pass for all 4 bases at both interval ends
        k4, l4 = fm.extend4_flat(idx, k, l)

        groups = []  # (valid, k, l, meta, score) flats, w-major
        zero = torch.zeros_like(i)
        for a in range(4):  # match/mismatch children (consume a read base)
            ismm = (b != a).long()
            seed_add = ismm * in_seed
            child_meta = _pack(i - 1, nmm + ismm, ngapo, ngape,
                               seed_mm + seed_add, zero)
            ok = (expand & (k4[a] <= l4[a])
                  & (ndiff + ismm + lb_im1 <= mdF)
                  & (seed_mm + seed_add <= opt.max_seed_diff))
            groups.append((ok, k4[a], l4[a], child_meta, score + ismm * s_mm))

        if with_gaps:
            consumed = lensF - i
            indel_ok = (consumed >= skip) & (i >= skip)
            lb_i = (cw >> 8) & 31  # Dshift[i]: bound for deletion children
            open_ = st == M_
            gap_cost = torch.where(open_, s_gapo, s_gape)
            d_gapo, d_gape = open_.long(), (~open_).long()
            ins_ok = indel_ok & ((open_ & (ngapo < opt.max_gapo))
                                 | ((st == I_) & (ngape < opt.max_gape)))
            del_ok = indel_ok & ((open_ & (ngapo < opt.max_gapo))
                                 | ((st == D_) & (ngape < opt.max_gape)))

            # insertion child (consume a read base, interval unchanged)
            child_meta = _pack(i - 1, nmm, ngapo + d_gapo, ngape + d_gape,
                               seed_mm + in_seed, zero + I_)
            ok = (expand & ins_ok
                  & (ndiff + 1 + lb_im1 <= mdF)
                  & (seed_mm + in_seed <= opt.max_seed_diff))
            groups.append((ok, k, l, child_meta, score + gap_cost))

            # 4 deletion children (consume a genome base, i unchanged)
            child_meta = _pack(i, nmm, ngapo + d_gapo, ngape + d_gape,
                               seed_mm + in_seed, zero + D_)
            for a in range(4):
                ok = (expand & del_ok & (k4[a] <= l4[a])
                      & (ndiff + 1 + lb_i <= mdF)
                      & (seed_mm + in_seed <= opt.max_seed_diff))
                groups.append((ok, k4[a], l4[a], child_meta, score + gap_cost))

        child_i = [g[3] & 0x1FF for g in groups]
        skey = [g[4] << KEY_SH for g in groups]
        live_key = (matT([torch.where(g[0] & (ci > 0), sk, SENT)
                          for g, ci, sk in zip(groups, child_i, skey)])
                    | colC).to(i32)
        kc = matT([g[1] for g in groups]).to(i32)
        lc = matT([g[2] for g in groups]).to(i32)
        mc = matT([g[3] for g in groups]).to(i32)
        hit_key = matT([torch.where(g[0] & (ci == 0), sk, SENT)
                        for g, ci, sk in zip(groups[:HG], child_i[:HG],
                                             skey[:HG])]).to(i32)

        # --- hit merge (kernel launch 1): old buffer + completions ---
        mkey = torch.cat([hkey, hit_key | colM], dim=0)
        mk = torch.cat([hk, kc[:HC]], dim=0)
        ml = torch.cat([hl, lc[:HC]], dim=0)
        mm_ = torch.cat([hm, mc[:HC]], dim=0)
        okeyd, (hk, hl, hm), _ = select_topk(mkey, (mk, ml, mm_), H)
        okey = okeyd[:H]
        # drop tracking: running max of per-step drop counts (>0 iff any
        # step overflowed, the parity-alarm semantics consumers rely on)
        hdrop = torch.maximum(hdrop, okeyd[H])
        best = torch.minimum(best, okey[0] >> KEY_SH)   # row 0 = best hit
        # re-key buffer rows so keys stay unique next step
        hkey = ((okey >> KEY_SH) << KEY_SH) | rowH

        # --- frontier selection (kernel launch 2), windowed at best + s_mm ---
        lkeyd, (k2, l2, m2), _ = select_topk(live_key, (kc, lc, mc), W,
                                             window=best + s_mm)
        lkey = lkeyd[:W]
        ldrop = torch.maximum(ldrop, lkeyd[W])
        valid = lkey < SENT
        live = valid.reshape(-1)
        score = torch.where(valid, lkey >> KEY_SH, 0).reshape(-1).long()
        k = k2.reshape(-1).long() & M32
        l = l2.reshape(-1).long() & M32
        meta = m2.reshape(-1).long() & M32

    return RawBeamResult(hkey=hkey, hit_k=hk, hit_l=hl, hit_meta=hm,
                         best_raw=best, n_live_dropped=ldrop,
                         n_hits_dropped=hdrop)


def pack_read_batch(reads, max_len=None):
    """Host-side packing: list of code arrays -> (fwd uint8[B,Lmax], lens).

    Copy of ``hsa_tpu.search.beam.pack_read_batch``."""
    Lmax = max_len or max(len(r) for r in reads)
    B = len(reads)
    too_long = max(len(r) for r in reads)
    if too_long > Lmax:
        raise ValueError(f"read length {too_long} exceeds max_len {Lmax}; "
                         f"truncating silently would misreport alignments")
    fwd = np.full((B, Lmax), 5, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for j, r in enumerate(reads):
        L = len(r)
        fwd[j, :L] = np.asarray(r, dtype=np.uint8)
        lens[j] = L
    return fwd, lens


def search_device(idx, fwd, lens, opt, *, beam_width=None, max_hits=32,
                  ladder=None):
    """Device-only search: packed batch -> RawBeamResult on ``idx.device``
    (a ``LadderRawResult`` when ``ladder`` names the widths of an adaptive
    beam, which then overrides ``beam_width``).

    Queues the width pass and the beam search and reads nothing back.
    ``fwd``/``lens`` are numpy arrays.
    """
    lens = np.asarray(lens)
    B, Lmax = fwd.shape
    budget = {int(L): opt.diff_budget(int(L)) for L in np.unique(lens)}
    md = np.array([budget[int(L)] for L in lens], dtype=np.int64)
    if md.size and md.max() > 15:
        raise ValueError("diff budget > 15 unsupported by the packed beam "
                         "state (and unrealistic for short-read budgets)")
    dev = idx.device
    fwd_t = torch.from_numpy(np.ascontiguousarray(fwd)).to(dev).long()
    lens_t = torch.from_numpy(lens.astype(np.int64)).to(dev)
    if idx.rev_occ_blocks is not None:
        D = cal_width_device(idx, fwd_t, lens_t)
    else:
        D = torch.zeros((B, Lmax), dtype=torch.int64, device=dev)
    md_t = torch.from_numpy(md).to(dev)
    if ladder:
        from .adaptive import AdaptiveBeam
        return AdaptiveBeam(idx, opt, ladder=ladder,
                            max_hits=max_hits)(fwd_t, lens_t, D, md_t)
    return beam_search(idx, fwd_t, lens_t, D, md_t, opt,
                       beam_width=beam_width, max_hits=max_hits)


def result_to_hits(res, s_mm: int = 3):
    """Host conversion (reads back!): result -> per-read sorted hit lists.

    Copy of ``hsa_tpu.search.beam.result_to_hits``; ``s_mm`` is only used
    when ``res`` is still a raw device result.
    """
    if not isinstance(res, BeamResult):
        from .adaptive import finalize_any
        res = finalize_any(res, s_mm)
    out = []
    hv = np.asarray(res.hit_valid)
    hs = np.asarray(res.hit_score)
    hk = np.asarray(res.hit_k)
    hl = np.asarray(res.hit_l)
    hm = np.asarray(res.hit_nmm)
    ho = np.asarray(res.hit_ngapo)
    he = np.asarray(res.hit_ngape)
    for j in range(hv.shape[0]):
        seen = {}
        for h in range(hv.shape[1]):
            if not hv[j, h]:
                continue
            key = (int(hk[j, h]), int(hl[j, h]), int(hm[j, h]), int(ho[j, h]), int(he[j, h]))
            sc = int(hs[j, h])
            if key not in seen or seen[key] > sc:
                seen[key] = sc
        hits = [Hit(sc, nmm, ngapo, ngape, k_, l_)
                for (k_, l_, nmm, ngapo, ngape), sc in seen.items()]
        hits.sort(key=lambda h: (h.score, h.k, h.l, h.nmm, h.ngapo, h.ngape))
        out.append(hits)
    return out


def align_batch(idx, reads, opt, *, beam_width=None, max_hits=32,
                max_len=None, ladder=None):
    """Host convenience wrapper: list of code arrays -> (per-read hit
    lists, finalized result)."""
    fwd, lens = pack_read_batch(reads, max_len)
    raw = search_device(idx, fwd, lens, opt, beam_width=beam_width,
                        max_hits=max_hits, ladder=ladder)
    from .adaptive import finalize_any
    res = finalize_any(raw, opt.s_mm)
    return result_to_hits(res), res
