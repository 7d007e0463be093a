"""Pigeonhole seed-and-verify engine: the fast path for diff-bounded
short-read alignment (torch; counterpart of ``hsa_tpu/search/pigeon.py``).

The reference's branch-and-bound stack (lineage: ``bwtgap.c``) explores
every <=k-diff pattern of the read suffix; on wide SA intervals that
frontier floods (hundreds of transient states), which is exactly what
overflows a lockstep beam and dominates its gather budget.  This engine
replaces the flood with the classic pigeonhole decomposition (row gathers
are the currency; flat elementwise lanes are nearly free):

1. **Anchor**: split each read into ``n_seg = k+1`` contiguous segments.
   Any alignment with <= k total diffs leaves at least one segment exact.
   Exact backward search of all segments is a tiny lockstep scan
   (``n_seg * B`` lanes, ~L/n_seg steps, 2 gathers/lane/step).
2. **Compact**: candidates (segment occurrences) are packed into a dense
   pool so dead slots pay nothing downstream.
3. **Locate**: walk each pooled candidate to a text position with the
   fused-row LF walk (1 gather/step, <= sa_intv steps).
4. **Verify (ungapped)**: fetch the 2-bit packed text window around each
   candidate (NR row gathers, NR in {2, 3} by read length) and count
   mismatches with flat XOR/popcount lanes, no gathers.
5. **Verify (gapped)**: candidates of reads whose best ungapped score
   could admit a gapped record (``best >= s_gapo - s_mm`` or no ungapped
   hit) are compacted into a second pool and screened for every one-run
   gap placement (the only gap shape ``max_gapo <= 1`` allows): for each
   gap length g and side, the minimum-mismatch split point is found with
   per-base prefix sums over the already-fetched window, with no row
   gathers beyond the verify fetch.

Per read this is about ten row gathers end-to-end against the beam's
thousands.  Capacity misses are handled in-engine (the lineage
max_entries-truncation analog; docs/PARITY.md #14): repetitive anchors
extend backward through their own segment, segments still wide after
full extension enumerate a capped sample, and slot/pool/gapped-screen
overflow shaves candidates fairly (slot-major pool priority); every
shortfall is COUNTED in ``n_missed`` so truncated reads report their
verified subset with conservatively capped MAPQ.  The ``fallback`` flag
is reserved for shape/budget misses (segment shorter than the K-mer
seed, md > n_seg-1, gap runs beyond the clamp) and for truncated reads
that end with no verified candidate (decided by the caller).

Parity contract (vs the branch-and-bound oracle): for ``max_gapo == 0`` the
enumerated occurrence set equals the oracle's (all <= md-mismatch
alignments).  For ``max_gapo == 1`` the one-run gap screen enumerates,
per candidate position, the minimum-score feasible alignment for every
distinct gapped start position (q-class), subject to the oracle's exact
constraints (nmm + ngapo + ngape <= md, ngape <= max_gape, seed-diff
cap, ``indel_end_skip``), so after position-level dedup the record set
matches the oracle's reporting window.  ``max_gapo >= 2`` is outside
the engine's shape (multi-run gaps); callers must route those configs
to the beam.  Reads whose budget exceeds ``n_seg - 1`` always fall
back; capacity misses (wide repeat intervals, pool or gapped-q-class
overflow) truncate with ``n_missed`` accounting instead (see above).

Shape limits: read length <= 160 (MAX_READ_LEN; window fetch is 2 rows
for reads <= 112bp and 3 rows above).

Types on the device follow :mod:`hsa_tpu_torch.search.fm`: what the
reference holds in ``uint32`` is an ``int64`` tensor with a value in
``[0, 2^32)``.  The reference leans on uint32 wrap-around in the
candidate's start (``ppos - psoff``), the window's start, the gapped start
positions and the left shifts of packed words; each of those is masked
back to 32 bits (``& M32``) at the same place here, so the in-text tests
(``fetch_ok``, ``pvalid``, ``q_ok``) decide as they do there.  The host
side (packing, the fused upload buffer, result finalization) is a copy of
the reference's numpy code, held bit-equal by the tests.

The verify stages (window + ungapped verify, the gapped screen) are the
``window_verify`` and ``gapped_screen`` kernels of ``kernels/verify.py``
on the card and their plain versions on the CPU; the FM steps of the
anchor scan and the extension loops are ``fm.extend``'s.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import metrics
from ..index.layout import words_to_device
from ..kernels import verify
# _expand_prefix: the gapped screen's prefix sums, kept under this name
from ..kernels.verify import GC_SLOTS, _expand_prefix  # noqa: F401
from . import fm
from .exact import as_wide, exact_search
from .fm import M32

PAD = 5
_PAT = verify.PAT
MAX_READ_LEN = 160
_BIGNMM = verify.BIGNMM
_BIGKEY = verify.BIGKEY


class PigeonResult(NamedTuple):
    """Search result: tensors as :func:`pigeon_search` returns it, numpy
    arrays after :func:`fetch_result`.  Ungapped candidates are
    POOL-indexed (dense compaction): entry i belongs to read-lane
    ``cidx[i] // cand_cap`` (``cidx`` is the read-major flat slot id; dead
    entries carry ``cidx == B*cand_cap``).  Pool form keeps the readback
    O(POOL) independent of cand_cap.  Gapped results are pool-2 indexed:
    lane i (< n_gate) belongs to read-lane g_read[i] and carries up to
    GC_SLOTS q-classes (g_key == _BIGKEY marks empties; key packs
    score<<8 | gap_len<<4 | nmm)."""
    pos: object        # uint32[POOL] candidate start positions
    nmm: object        # uint8[POOL] verified mismatch counts
    valid: object      # bool[POOL]
    cidx: object       # int32[POOL] read-major flat slot id
    fallback: object   # bool[B]  read needs the exhaustive beam
    n_cand: object     # int32[B] enumerated candidates (pre-dedup)
    g_q: object        # uint32[GPOOL, GC_SLOTS] gapped start positions
    g_key: object      # uint32[GPOOL, GC_SLOTS] packed score/g/nmm
    g_read: object     # int32[GPOOL] owning read lane
    n_gate: object     # int32[] live pool-2 lanes
    n_missed: object   # int32[B] candidates NOT enumerated (capped
                       # repeat intervals / slot / pool overflow);
                       # > 0 marks the lane's hit set TRUNCATED


def pack_text_rows(text: np.ndarray) -> np.ndarray:
    """uint32[nt, 8] rows of 128 packed 2-bit bases (for window fetches).

    Row 0 is an all-zero LEAD row (text base b lives in row ``1 + b//128``)
    so gapped verify windows that begin up to 128 bases before the text
    never index negatively; four all-zero tail rows cover the widest
    (3-row) fetch starting in the last data row.
    """
    t = np.asarray(text, dtype=np.uint8) & 3
    n = len(t)
    nt = n // 128 + 5
    padded = np.zeros(nt * 128, dtype=np.uint32)
    padded[128:128 + n] = t
    w = padded.reshape(nt * 8, 16)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (w << shifts).sum(axis=1, dtype=np.uint64).astype(np.uint32).reshape(nt, 8)


def auto_anchor_tail(n: int, kmer_k: int, lo: int = 3, hi: int = 8) -> int:
    """Anchor length so spurious candidates stay rare: 4^(K+tail) >= 64*n
    (expected spurious occurrences per anchor <= 1/64)."""
    import math
    need = math.ceil(math.log(max(64 * n, 4), 4)) - kmer_k
    return max(lo, min(hi, need))


MAX_GAP_RUN = 7       # diag shifts use 2*d bits with d <= 2G; G > 7 would
                      # shift a 32-bit word by 32 or more


def max_gap_run(opt, n_seg: int) -> int:
    """Static max one-run gap length G for this (opt, n_seg) compile.

    Non-fallback reads satisfy md <= n_seg - 1 and nmm + g <= md, so
    g <= 1 + min(max_gape, n_seg - 2); 0 when gaps are disabled.
    Clamped to MAX_GAP_RUN (= 7): the diagonal extractors shift packed
    words by 2*d with d up to 2G, and 2*2*8 = 32 would shift a 32-bit word
    out whole.  Reads whose budget admits a longer run than the clamp
    are routed to the beam inside :func:`pigeon_search` (``md > G`` when
    ``max_gape + 1 > G``).
    """
    if opt.max_gapo <= 0 or n_seg < 2:
        return 0
    g = 1 + min(opt.max_gape, n_seg - 2)
    assert 2 * 2 * MAX_GAP_RUN < 32
    return min(g, MAX_GAP_RUN)


def pack_pigeon_batch(reads, n_seg: int = 3, max_len: int | None = None,
                      seed_len: int = 32, kmer_k: int = 0,
                      anchor_tail: int = 6, device_masks: bool = False,
                      seg_phase: bool = False):
    """Host-side packing for the pigeon engine.

    reads: list of int8/uint8 code arrays (codes 0..4; 4 = N).

    With ``kmer_k`` > 0, each segment anchors on a SUB-segment: its last
    ``kmer_k + anchor_tail`` bases (K-mer-table seed + short exact tail).
    Completeness is unchanged — an alignment whose segment is exact also
    has that segment's suffix exact — and verification rejects the rare
    spurious anchor (expected extra candidates per anchor ≈
    n / 4^(kmer_k+anchor_tail)).  This caps the anchor scan at
    ``anchor_tail`` steps instead of the full segment length.

    Returns dict of numpy arrays:
      segs_rev uint8[n_seg*B, SL]  reversed anchor-tail bases (seg-major);
                                   with kmer_k > 0 the first kmer_k consumed
                                   bases are OMITTED (the K-mer table seeds
                                   them)
      seg_lens int32[n_seg*B]      remaining (tail) anchor lengths
      seg_off  int32[n_seg*B]      offset of the ANCHOR within the read
      kmer     int32[n_seg*B]      K-mer table index of the seeded prefix
      kmer_ok  uint8[n_seg*B]      1 = lane seeded (len >= K, no N in seed)
      seg_short uint8[n_seg*B]     1 = segment too short to seed (read must
                                   fall back; only when kmer_k > 0)
      rw       uint32[B, RW]       packed 2-bit read (N->0)
      nmask    uint32[B, RW]       PAT-patterned pair bits at N positions
      vmask    uint32[B, RW]       PAT-patterned pair bits at positions < len
      seedmask uint32[B, RW]       PAT-patterned pair bits in the 3' seed
      lens     int32[B]
    """
    K = kmer_k
    if isinstance(reads, tuple):
        B = len(reads[1])
        Lmax = max_len or (int(np.max(reads[1])) if B else 1)
    else:
        B = len(reads)
        Lmax = max_len or max((len(r) for r in reads), default=1)
    Lmax = max(Lmax, 1)
    if Lmax > MAX_READ_LEN:
        raise ValueError(f"pigeon engine handles reads <= {MAX_READ_LEN}bp "
                         f"(got {Lmax}); route longer reads to the beam")
    seg_max = (Lmax + n_seg - 1) // n_seg + 1
    if seg_phase:
        # the half-shifted partition's FIRST segment spans 3L/(2n)
        seg_max = max(seg_max, (3 * Lmax + 2 * n_seg - 1) // (2 * n_seg) + 1)
    SL = max(min(seg_max - K, anchor_tail) if K else seg_max, 1)
    RW = (Lmax + 15) // 16 + 1

    # read matrix (PAD-padded) — everything below is matrix-wise numpy
    R = np.full((B, RW * 16), PAD, dtype=np.uint8)
    if isinstance(reads, tuple):
        R0, lens = reads            # prepacked [B, >=Lmax] matrix + lens
        R[:, :R0.shape[1]] = R0[:, :RW * 16]
        lens = np.asarray(lens, np.int32)
    else:
        lens = np.zeros(B, dtype=np.int32)
        for j, r in enumerate(reads):
            L = len(r)
            R[j, :L] = np.asarray(r, dtype=np.uint8)
            lens[j] = L
    Lv = lens[:, None]

    # -- per-segment anchors ------------------------------------------------
    segs_rev = np.full((n_seg, B, SL), PAD, dtype=np.uint8)
    seg_lens = np.zeros((n_seg, B), dtype=np.int32)
    seg_off = np.zeros((n_seg, B), dtype=np.int32)
    kmer = np.zeros((n_seg, B), dtype=np.int32)
    kmer_ok = np.zeros((n_seg, B), dtype=np.uint8)
    seg_short = np.zeros((n_seg, B), dtype=np.uint8)
    pw = (4 ** np.arange(K - 1, -1, -1, dtype=np.int64))[None, :] if K else None
    def _bound(s):
        # seg_phase: interior boundaries shift by half a segment (ends
        # pinned) — an alternate partition for the repeat-retry pass;
        # pigeonhole completeness holds for ANY partition of the read
        if seg_phase and 0 < s < n_seg:
            return lens * (2 * s + 1) // (2 * n_seg)
        return lens * s // n_seg

    for s in range(n_seg):
        a = _bound(s)
        b = _bound(s + 1)
        w = b - a
        if K == 0:
            # full-segment anchor: reversed columns b-1-t
            t = np.arange(SL)[None, :]
            cols = np.clip(b[:, None] - 1 - t, 0, R.shape[1] - 1)
            seg = np.take_along_axis(R, cols, axis=1)
            valid_t = t < w[:, None]
            segs_rev[s] = np.where(valid_t, seg, PAD)
            seg_lens[s] = np.maximum(w, 0)
            seg_off[s] = a
        else:
            A = np.minimum(w, K + anchor_tail)
            t = np.arange(K + SL)[None, :]
            cols = np.clip(b[:, None] - 1 - t, 0, R.shape[1] - 1)
            seg = np.take_along_axis(R, cols, axis=1)   # [B, K+SL] reversed
            long_enough = w >= K
            head_ok = (seg[:, :K] <= 3).all(axis=1) & long_enough
            kmer[s] = np.where(head_ok,
                               (seg[:, :K].astype(np.int64) * pw).sum(axis=1),
                               0).astype(np.int32)
            kmer_ok[s] = head_ok.astype(np.uint8)
            seg_short[s] = ((w > 0) & ~long_enough).astype(np.uint8)
            tail_t = np.arange(SL)[None, :]
            tail_valid = head_ok[:, None] & (tail_t < (A - K)[:, None])
            segs_rev[s] = np.where(tail_valid, seg[:, K:K + SL], PAD)
            seg_lens[s] = np.where(head_ok, A - K, 0)
            seg_off[s] = np.where(head_ok, b - A, a)

    # -- packed verify words ------------------------------------------------
    t = np.arange(RW * 16)
    codes = R[:, :RW * 16].astype(np.uint32)
    isn = codes > 3
    inlen = t[None, :] < Lv
    codes = np.where(isn, 0, codes)
    sh = (2 * (t % 16)).astype(np.uint32)[None, :]

    def packbits(vals):
        return (vals << sh).reshape(B, RW, 16).sum(axis=2, dtype=np.uint64) \
                           .astype(np.uint32)

    rw = packbits(np.where(inlen, codes, 0))
    nmask = packbits((isn & inlen).astype(np.uint32))
    out = dict(segs_rev=segs_rev.reshape(n_seg * B, SL),
               seg_lens=seg_lens.reshape(-1), seg_off=seg_off.reshape(-1),
               kmer=kmer.reshape(-1), kmer_ok=kmer_ok.reshape(-1),
               seg_short=seg_short.reshape(-1),
               rw=rw, nmask=nmask, lens=lens)
    if not device_masks:
        # vmask/seedmask are pure functions of (lens, seed_len);
        # device_masks=True derives them on device instead (saves two
        # packbits passes here and two array uploads per batch)
        out["vmask"] = packbits(inlen.astype(np.uint32))
        out["seedmask"] = packbits(
            (inlen & (t[None, :] >=
                      np.maximum(Lv - seed_len, 0))).astype(np.uint32))
    return out


def pack_pigeon_upload(batch, md):
    """Fuse a pack_pigeon_batch dict (+ md) into ONE uint32 upload buffer.

    Every host array is a host-to-device copy of its own, so the whole
    batch rides in one contiguous buffer with a shape-static layout, the
    one the native packer (``refpack.pigeon_pack``) writes;
    :func:`unpack_pigeon_upload` splits it on the device.  Fields are
    bit-packed: segment anchor codes 8b x4/word,
    seg_off|seg_lens 16b+16b, kmer|ok<<24|short<<25, lens|md<<16.
    """
    segs = batch["segs_rev"]
    R, SL = segs.shape
    B2, RW = batch["rw"].shape
    # bit-field range checks: silent overflow here would
    # produce wrong alignments with no error — kmer gets 24 bits (K=12
    # fits exactly; K>=13 would corrupt), the 16-bit fields cover reads
    # <= MAX_READ_LEN with huge margin but guard against future edits.
    # Explicit raises (not asserts) so they survive python -O.
    if "kmer" in batch and batch["kmer"].max(initial=0) >= (1 << 24):
        raise ValueError(
            "kmer index overflows its 24-bit upload field (K too large)")
    for fld in ("seg_lens", "seg_off", "lens"):
        if batch[fld].max(initial=0) >= (1 << 16):
            raise ValueError(f"{fld} overflows its 16-bit upload field")
    if np.asarray(md).max(initial=0) >= (1 << 16):
        raise ValueError("md overflows its 16-bit upload field")
    S4 = (SL + 3) // 4
    segs4 = np.zeros((R, S4), np.uint32)
    sr = segs.astype(np.uint32)
    for t in range(SL):
        segs4[:, t // 4] |= sr[:, t] << np.uint32(8 * (t % 4))
    soff_len = (batch["seg_off"].astype(np.uint32)
                | (batch["seg_lens"].astype(np.uint32) << 16))
    if "kmer" in batch:
        kmer_fl = (batch["kmer"].astype(np.uint32)
                   | (batch["kmer_ok"].astype(np.uint32) << 24)
                   | (batch["seg_short"].astype(np.uint32) << 25))
    else:
        kmer_fl = np.zeros(R, np.uint32)
    lens_md = (batch["lens"].astype(np.uint32)
               | (np.asarray(md).astype(np.uint32) << 16))
    buf = np.concatenate([
        segs4.ravel(), soff_len, kmer_fl,
        batch["rw"].astype(np.uint32).ravel(),
        batch["nmask"].astype(np.uint32).ravel(), lens_md])
    return buf, (R, SL, B2, RW)


def unpack_pigeon_upload(buf, shape):
    """Device-side inverse of :func:`pack_pigeon_upload` (and of the native
    ``refpack.pigeon_pack``, whose buffer it reads unchanged).

    ``buf``: the buffer as ``words_to_device`` put it on the device (a
    numpy uint32 array is taken too and stays on the CPU).
    Returns (segs_rev [R,SL], seg_lens, seg_off, kmer, kmer_ok, seg_short,
    rw, nmask, lens, md), all int64."""
    if not isinstance(buf, torch.Tensor):
        buf = words_to_device(buf, "cpu")
    buf = buf.long() & M32
    R, SL, B2, RW = shape
    S4 = (SL + 3) // 4
    o = 0

    def take(n):
        nonlocal o
        out = buf[o:o + n]
        o += n
        return out

    segs4 = take(R * S4).reshape(R, S4)
    t = torch.arange(SL, device=buf.device)
    segs_rev = (segs4[:, t // 4] >> (8 * (t % 4))[None, :]) & 0xFF
    soff_len = take(R)
    seg_off = soff_len & 0xFFFF
    seg_lens = soff_len >> 16
    kmer_fl = take(R)
    kmer = kmer_fl & 0xFFFFFF
    kmer_ok = (kmer_fl >> 24) & 1
    seg_short = (kmer_fl >> 25) & 1
    rw = take(B2 * RW).reshape(B2, RW)
    nmask = take(B2 * RW).reshape(B2, RW)
    lens_md = take(B2)
    lens = lens_md & 0xFFFF
    md = lens_md >> 16
    return (segs_rev, seg_lens, seg_off, kmer, kmer_ok, seg_short,
            rw, nmask, lens, md)


def _nonzero_sized(mask, size: int, fill: int):
    """Ascending indices of the set entries of ``mask`` [N], cut or padded
    with ``fill`` to the static length ``size``: ``jnp.nonzero(mask,
    size=, fill_value=)``.  ``torch.nonzero`` has a data-dependent shape and
    waits for the device; this is a prefix sum and one scatter (entries
    past ``size`` and unset ones all land in a spare slot that is cut off)."""
    N = mask.shape[0]
    rank = torch.cumsum(mask, 0) - 1
    dest = torch.where(mask & (rank < size), rank, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(N, device=mask.device))
    return out[:size]


def _add_at(n: int, index, values):
    """zeros(n).at[index].add(values, mode="drop") where the only
    out-of-range index is ``n`` itself: one spare slot takes the drops."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=index.device)
    return out.index_add_(0, index, values)[:n]


def _set_at(x, index, values):
    """x.at[index].set(values, mode="drop") for indices that are unique
    except for the out-of-range fill ``len(x)``."""
    ext = torch.cat([x, x.new_zeros(1)])
    ext[index] = values
    return ext[:x.shape[0]]


def _pair_mask(k):
    """PAT-patterned pairs at positions < k (k int64 in [0, 16])."""
    sh = 2 * (16 - k.clamp(1, 16))
    return torch.where(k > 0, torch.full_like(sh, _PAT) >> sh, 0)


def pigeon_search(idx, text_rows, segs_rev, seg_lens, seg_off, rw, nmask,
                  vmask, seedmask, lens, md, opt, *, n_seg: int = 3,
                  seg_cap: int = 32, cand_cap: int = 32,
                  pool: int | None = None, gpool: int | None = None,
                  kmer_seed=None, seg_phase: bool = False) -> PigeonResult:
    """Device pigeonhole search (see module docstring), on ``idx.device``.

    Array arguments are tensors on that device or numpy arrays (copied
    there); ``text_rows`` is :func:`pack_text_rows`'s array, or its
    ``words_to_device`` tensor (int32 bit patterns).  md: [B] per-read
    diff budgets.
    ``pool``: dense candidate-pool capacity (default 4*B); ``gpool``:
    gapped pool-2 capacity (default pool // 4).  ``kmer_seed``: optional
    (tk, tl, kmer, kmer_ok, seg_short): K-mer-table seeding from
    :func:`hsa_tpu_torch.search.exact.kmer_table` + ``pack_pigeon_batch``'s
    kmer fields; replaces the first K scan steps of every segment with
    one table gather per interval end.

    The reference's two data-dependent extension loops stop when no lane
    is alive; here the host reads the count of wide anchors once (one
    wait for the device per batch) and skips both loops when it is 0, the
    common case; otherwise each step reads ``alive.any()``.

    Traced (:mod:`hsa_tpu_torch.metrics`) as the consecutive stages
    ``search.anchor``, ``search.extend``, ``search.order_slots``,
    ``search.compact``, ``search.locate``, ``search.verify`` and
    ``search.gapped``, each from where its host code begins; the device
    work a stage queues may run later.
    """
    metrics.stage("search.anchor")
    dev = idx.device
    i64 = torch.int64

    def wide(x):
        return None if x is None else as_wide(x, dev)

    segs_rev, seg_lens, seg_off, rw, nmask, vmask, seedmask, lens, md = (
        wide(x) for x in (segs_rev, seg_lens, seg_off, rw, nmask, vmask,
                          seedmask, lens, md))
    if not isinstance(text_rows, torch.Tensor):
        text_rows = words_to_device(text_rows, dev)

    def arange(n):
        return torch.arange(n, device=dev)

    B = lens.shape[0]
    CC = cand_cap
    RW = rw.shape[1]
    DW = RW - 1                      # packed words carrying read data
    POOL = pool or 4 * B
    GPOOL = gpool or max(POOL // 4, 8)
    G = max_gap_run(opt, n_seg)      # static max one-run gap length
    n = int(idx.n)

    if vmask is None or seedmask is None:
        # device-derived masks: pure functions of (lens, opt.seed_len);
        # bit-identical to pack_pigeon_batch's host packbits
        tw = arange(RW)[None, :]
        rem = (lens[:, None] - 16 * tw).clamp(0, 16)
        if vmask is None:
            vmask = _pair_mask(rem)
        if seedmask is None:
            sstart = (lens - opt.seed_len).clamp(min=0)
            lo = (sstart[:, None] - 16 * tw).clamp(0, 16)
            seedmask = _pair_mask(rem) & (~_pair_mask(lo) & M32)

    # 1. anchor: lockstep exact search of all segments
    short_fb = torch.zeros(B, dtype=torch.bool, device=dev)
    if kmer_seed is None:
        k, l, matched = exact_search(idx, segs_rev, seg_lens)
    else:
        tk, tl, kmer, kmer_ok, seg_short = (wide(x) for x in kmer_seed)
        kmer = kmer.clamp(0, tk.shape[0] - 1)
        okk = kmer_ok != 0
        k0 = torch.where(okk, tk[kmer], 1)
        l0 = torch.where(okk, tl[kmer], 0)
        alive0 = okk & (k0 <= l0)
        k, l, matched = exact_search(idx, segs_rev, seg_lens,
                                     init=(k0, l0, alive0))
        short_fb = (seg_short != 0).reshape(n_seg, B).any(dim=0)
    w = torch.where(matched, l - k + 1, 0)

    metrics.stage("search.extend")
    # 1b. wide-anchor rescue (repeat tolerance): anchors whose interval
    # exceeds seg_cap are extended backward through their OWN segment.
    # Completeness holds because an alignment whose segment is exact has
    # every suffix of the segment exact; if the extension empties (or
    # hits an N) the FULL segment occurs nowhere / cannot be exact, so
    # the lane is dropped outright.  Lanes exhausting the segment while
    # still wide are genuine repeats: enumeration below caps them at
    # seg_cap occurrences and counts the rest in ``n_missed`` instead of
    # falling back.
    R = k.shape[0]
    lane_id = arange(R) % B
    s_idx = arange(R) // B
    Lr = lens[lane_id]
    if seg_phase:    # half-shifted partition (pack_pigeon_batch seg_phase)
        a_start = torch.where(s_idx > 0,
                              (Lr * (2 * s_idx + 1)) // (2 * n_seg), 0)
    else:
        a_start = (Lr * s_idx) // n_seg
    rem = seg_off - a_start
    # any wide anchor with read bases to its left can narrow: within its
    # own segment (phase 1, completeness-sound) and/or past the segment
    # boundary (phase 2, heuristic); full-segment anchors (rem == 0,
    # e.g. kmer_k = 0 packing) skip phase 1 and go straight to phase 2
    wide0 = matched & (w > seg_cap) & (seg_off > 0)
    WPOOL = max(R // 4, 64)
    n_wide = wide0.sum()
    widx = _nonzero_sized(wide0, WPOOL, R)
    in_w = arange(WPOOL) < n_wide.clamp(max=WPOOL)
    gix = widx.clamp(max=R - 1)
    wlane = lane_id[gix]
    wa = a_start[gix]
    EXT = max((16 * DW + n_seg - 1) // n_seg + 1, 1)  # segment-length bound
    EXT2 = 16 * DW                                    # read-length bound
    rw_flat = rw.reshape(-1)
    nm_flat = nmask.reshape(-1)
    nwords = rw_flat.shape[0]

    def left_base(eoff):
        """(base, is N) of the read base left of offset ``eoff`` per lane."""
        p = eoff - 1
        flat = (wlane * RW + (p >> 4)).clamp(0, nwords - 1)
        sh_p = 2 * (p & 15)
        base = (rw_flat[flat] >> sh_p) & 3
        return base, ((nm_flat[flat] >> sh_p) & 1) == 1

    ek, el, eoff = k[gix], l[gix], seg_off[gix]
    killw = torch.zeros(WPOOL, dtype=torch.bool, device=dev)
    alive = in_w & (rem[gix] > 0)
    any_wide = int(n_wide) > 0         # the one wait for the device
    t = 0
    while any_wide and t < EXT and bool(alive.any()):
        base, is_n = left_base(eoff)   # alive => eoff > wa >= 0
        k2, l2 = fm.extend(idx, base, ek, el)
        bad = is_n | (k2 > l2)
        killw = killw | (alive & bad)
        good = alive & ~bad
        ek = torch.where(good, k2, ek)
        el = torch.where(good, l2, el)
        eoff = torch.where(good, eoff - 1, eoff)
        alive = good & (el - ek + 1 > seg_cap) & (eoff > wa)
        t += 1

    # 1c. over-extension (phase 2): lanes STILL wide after consuming their
    # whole segment are genuine repeats (the full segment occurs
    # > seg_cap times); enumerating seg_cap of thousands of copies rarely
    # samples the true locus, so keep extending LEFT past the segment
    # boundary through the read.  This is a heuristic narrowing, not a
    # completeness proof (the true alignment may hold a mismatch in the
    # extended span, and then the narrowed interval excludes it), so an
    # empty extension or an N FREEZES the lane at its last good interval
    # instead of killing it, and every position the over-extension
    # excludes is counted into ``n_missed`` (truncation -> conservative
    # MAPQ; a read left with no verifying candidate still re-runs on the
    # beam).  Candidates that survive match a strictly longer exact
    # substring of the read, which is what makes them likely to verify.
    w1 = el - ek + 1
    alive2 = in_w & ~killw & (w1 > seg_cap) & (eoff > 0)
    alive = alive2
    t = 0
    while any_wide and t < EXT2 and bool(alive.any()):
        base, is_n = left_base(eoff)   # alive => eoff > 0
        k2, l2 = fm.extend(idx, base, ek, el)
        good = alive & ~is_n & (k2 <= l2)
        ek = torch.where(good, k2, ek)
        el = torch.where(good, l2, el)
        eoff = torch.where(good, eoff - 1, eoff)
        alive = good & (el - ek + 1 > seg_cap) & (eoff > 0)
        t += 1
    # positions excluded by the over-extension are missed candidates
    w2 = el - ek + 1
    ext2_missed = torch.where(alive2, (w1 - w2).clamp(max=1 << 24), 0)
    extra_missed = _add_at(R, widx, ext2_missed)

    k = _set_at(k, widx, ek)
    l = _set_at(l, widx, el)
    seg_off = _set_at(seg_off, widx, eoff)
    matched = _set_at(matched, widx, ~killw)
    c_full = torch.where(matched, l - k + 1, 0)
    c = c_full.clamp(max=seg_cap).reshape(n_seg, B)
    n_missed = (c_full - c_full.clamp(max=seg_cap) + extra_missed) \
        .reshape(n_seg, B).sum(dim=0)
    kk = k.reshape(n_seg, B)
    soff = seg_off.reshape(n_seg, B)

    metrics.stage("search.order_slots")
    # 1d. narrowest-first per-read segment order: the narrowest matched
    # segment has the fewest repeat copies and so carries the most
    # information per slot, so it claims slots first.  Both the CC cap and
    # the slot-major pool compaction below then spend their budget on the
    # most specific candidates; in segment-index order a wide leading
    # repeat segment starves the narrow segment that actually localizes
    # the read.  The sort is stable: equal widths keep segment order.
    cf2 = c_full.reshape(n_seg, B)
    order = torch.argsort(torch.where(cf2 > 0, cf2, 0x7FFFFFFF), dim=0,
                          stable=True)
    c = c.gather(0, order)
    kk = kk.gather(0, order)
    soff = soff.gather(0, order)

    # 2. slot assignment (read-major flat [B*CC]: read j's slots contiguous)
    starts = [torch.zeros(B, dtype=i64, device=dev)]
    for s in range(1, n_seg):
        starts.append(starts[-1] + c[s - 1])
    total = starts[-1] + c[n_seg - 1]
    n_missed = n_missed + (total - CC).clamp(min=0)

    slot = arange(CC)[:, None].expand(CC, B)
    ranks = torch.zeros((CC, B), dtype=i64, device=dev)
    soff_m = torch.zeros((CC, B), dtype=i64, device=dev)
    filled = torch.zeros((CC, B), dtype=torch.bool, device=dev)
    for s in range(n_seg):
        st = starts[s][None, :]
        inseg = (slot >= st) & (slot < st + c[s][None, :])
        ranks = torch.where(inseg, kk[s][None, :] + (slot - st), ranks)
        soff_m = torch.where(inseg, soff[s][None, :], soff_m)
        filled = filled | inseg

    # read-major flattening: flat index = read*CC + slot
    ranks_f = ranks.T.reshape(-1)
    soff_f = soff_m.T.reshape(-1)

    metrics.stage("search.compact")
    # 3. dense pool compaction (dead slots pay nothing downstream).
    # Compaction priority is SLOT-MAJOR: every lane's first candidate
    # outranks any lane's second, so pool overflow shaves candidates
    # evenly across lanes instead of starving the batch tail (repeat-
    # dense batches overflow routinely; fairness keeps every lane's
    # best candidates so overflow degrades MAPQ, not mapping).
    filled_s = filled.reshape(-1)              # [CC*B] slot-major
    n_filled = filled_s.sum()
    sidx = _nonzero_sized(filled_s, POOL, CC * B)
    live = sidx < CC * B
    cidx = torch.where(live, (sidx % B) * CC + sidx // B, B * CC)
    in_pool = arange(POOL) < n_filled
    # candidates at/after the pool cutoff are lost; counted into
    # n_missed (truncation), not a fallback
    cutoff = torch.where(n_filled > POOL, sidx[POOL - 1], CC * B)
    lost = filled_s & (arange(CC * B) > cutoff)
    n_missed = n_missed + lost.reshape(CC, B).sum(dim=0)
    del ranks, soff_m, filled, filled_s, lost, slot

    cg = cidx.clamp(max=B * CC - 1)
    pranks = ranks_f[cg]                       # masked by in_pool below
    # the offset of a slot past the pool's end reads as the reference's
    # gather fill for int32 (its lowest value): every use is masked, but
    # the dead lanes of ``g_q`` are derived from it
    psoff = torch.where(live, soff_f[cg], -(1 << 31)) & M32
    pread = (cidx // CC).clamp(max=B - 1)
    # ALL per-read verify data in one matrix (4*RW packed words + lens|md),
    # which the verify stages read by each candidate's read
    lens_md = lens | (md << 16)
    combo = torch.cat([rw, vmask, nmask, seedmask, lens_md[:, None]], dim=1)
    plens = lens_md[pread] & 0xFFFF

    metrics.stage("search.locate")
    # 4. locate pooled candidates (fused-row LF walk, 1 gather/step)
    ppos = fm.locate(idx, torch.where(in_pool, pranks, 0))
    pstart = (ppos - psoff) & M32              # wraps when ppos < psoff
    # window fetch is valid whenever SOME (possibly gapped) alignment could
    # start in-text: ppos + G >= psoff keeps padded coords non-negative
    fetch_ok = in_pool & (((ppos + G) & M32) >= psoff)
    pvalid = (in_pool & (ppos >= psoff) & (((pstart + plens) & M32) <= n))

    metrics.stage("search.verify")
    # 5. window extraction and the ungapped verify on the central diagonal
    # (d = G), in one kernel: ``kernels/verify.py``.  Results stay in POOL
    # form: pos/nmm/valid/cidx are pool-indexed, cidx = read-major flat slot
    # id (lane = cidx // CC), so the readback is O(POOL) whatever CC is.
    pvalid, pos_o, nmm_o, n2 = verify.window_verify(
        text_rows, combo, pstart, pread, fetch_ok, pvalid, G=G,
        max_seed_diff=opt.max_seed_diff)

    # 7. gapped verify (G > 0): pool-2 screen of one-run gap placements
    metrics.stage("search.gapped")
    if G > 0:
        # gapped records can only enter the reporting window when the
        # lane's best ungapped score (n2) admits them (or no ungapped hit)
        need_gap = n2 * opt.s_mm >= (opt.s_gapo - opt.s_mm)
        gate = fetch_ok & need_gap[pread]
        n_gate = gate.sum()
        gidx = _nonzero_sized(gate, GPOOL, POOL)
        gcut = torch.where(n_gate > GPOOL, gidx[GPOOL - 1], POOL)
        # pool-2 overflow: candidates past the cutoff lose their gapped
        # screen.  Pool order is slot-major (fair), so the loss shaves
        # every read's LAST candidates; counted into n_missed
        # (truncation: conservative MAPQ + beam only when the read ends
        # with no occurrences) instead of a blanket fallback.
        g_lostp = gate & (arange(POOL) > gcut)
        n_missed = n_missed + _add_at(B, torch.where(g_lostp, pread, B),
                                      torch.ones_like(pread))
        g_key, g_q, g_read, g_drop = verify.gapped_screen(
            text_rows, combo, pstart, pread, fetch_ok, gidx, n_gate, G=G,
            n=n, opt=opt)
        # conservative overflow: a dropped q-class could still enter the
        # reporting window, so it is counted as a missed candidate
        # (truncation), like every other capacity miss
        if 2 * G + 1 > GC_SLOTS:
            n_missed = n_missed + _add_at(B, torch.where(g_drop, g_read, B),
                                          torch.ones_like(g_read))
    else:
        g_q = torch.zeros((1, GC_SLOTS), dtype=i64, device=dev)
        g_key = torch.full((1, GC_SLOTS), _BIGKEY, dtype=i64, device=dev)
        g_read = torch.full((1,), B, dtype=i64, device=dev)
        n_gate = torch.zeros((), dtype=i64, device=dev)

    # 8. structural fallback (shape/budget beyond the pigeonhole screen).
    # Capacity misses (wide repeat intervals, slot/pool overflow) are NOT
    # fallbacks: they enumerate a capped candidate subset and report the
    # shortfall in n_missed; the caller re-runs a truncated read on the
    # beam only when NO candidate verified.
    fallback = short_fb | (md > (n_seg - 1))
    if opt.max_gapo > 0 and opt.max_gape + 1 > G:
        # the MAX_GAP_RUN clamp bound: reads whose budget admits a gap
        # run longer than the screened G must take the exhaustive beam
        fallback = fallback | (md > G)
    metrics.stage(None)
    i32 = torch.int32
    return PigeonResult(pos=pos_o, nmm=nmm_o, valid=pvalid,
                        cidx=cidx.to(i32), fallback=fallback,
                        n_cand=total.clamp(max=CC).to(i32),
                        g_q=g_q, g_key=g_key, g_read=g_read.to(i32),
                        n_gate=n_gate.to(i32), n_missed=n_missed.to(i32))


def _host(x, dtype):
    """Tensor -> numpy array of ``dtype`` (READS BACK); 32-bit patterns held
    in int64 come back as uint32."""
    if dtype is np.uint32:
        x = torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)
        return x.cpu().numpy().view(np.uint32)
    return x.cpu().numpy().astype(dtype, copy=False)


_FIELD_DTYPES = dict(pos=np.uint32, nmm=np.uint8, valid=np.bool_,
                     cidx=np.int32, fallback=np.bool_, n_cand=np.int32,
                     g_q=np.uint32, g_key=np.uint32, g_read=np.int32,
                     n_gate=np.int32, n_missed=np.int32)


def result_to_host(res: PigeonResult, skip=None) -> PigeonResult:
    """Every field as a numpy array of the reference's dtype (READS BACK);
    fields named in ``skip`` take its arrays instead."""
    skip = skip or {}
    return PigeonResult(**{
        k: skip[k] if k in skip else _host(x, _FIELD_DTYPES[k])
        for k, x in res._asdict().items()})


def fetch_result(res: PigeonResult) -> PigeonResult:
    """Device->host transfer of the result arrays (see
    :func:`result_to_host`).

    ``n_gate`` is read first (the wait for the device).  When no lane
    needed the gapped screen (n_gate == 0: every lane on clean mismatch
    workloads), the pool-2 arrays are synthesized empty host-side instead
    of transferred.
    """
    if not isinstance(res.n_gate, torch.Tensor):
        return PigeonResult(*(np.asarray(x) for x in res))
    skip = {}
    if int(res.n_gate.sum()) == 0:
        GC = res.g_key.shape[1]
        B = res.fallback.shape[0]
        skip = dict(g_q=np.zeros((1, GC), np.uint32),
                    g_key=np.full((1, GC), _BIGKEY, np.uint32),
                    g_read=np.full(1, 2 * B, np.int32))
    return result_to_host(res, skip)


def unpack_gap_key(key):
    """Packed gapped key -> (score, gap_len, nmm) int arrays."""
    key = np.asarray(key, np.uint32)
    return (key >> 8).astype(np.int64), ((key >> 4) & 0xF).astype(np.int64), \
        (key & 0xF).astype(np.int64)


def pigeon_occurrences(res: PigeonResult, B: int, opt, cand_cap: int):
    """Host finalization (READS BACK): per-read deduped Occurrence lists.

    Lanes [0, B) are forward-strand reads, [B, 2B) their reverse
    complements (the ``pipeline.search_batch_device`` convention).
    Merges the ungapped candidate slots with the gapped pool-2 classes;
    dedup keeps the minimum score per (pos, strand).
    Returns (occs per read [B], fallback bool[B], missed int32[B]) —
    ``missed[j] > 0`` means read j's candidate enumeration was CAPPED
    (repeat intervals / slot / pool overflow): its occurrence list is a
    truncated subset and MAPQ must be suppressed accordingly.
    """
    from ..resolve.samse import Occurrence
    CC = cand_cap
    s_mm = opt.s_mm
    pos = np.asarray(res.pos)
    nmm = np.asarray(res.nmm)
    valid = np.asarray(res.valid)
    cidx = np.asarray(res.cidx, np.int64)
    fallback = np.asarray(res.fallback)
    B2 = fallback.shape[0]
    assert B2 == 2 * B, (B2, B)
    fb = fallback[:B] | fallback[B:]
    miss_all = np.asarray(res.n_missed, np.int64)
    missed = miss_all[:B] + miss_all[B:]

    # pool-form ungapped entries grouped by lane (cidx // CC)
    ung_by_lane: dict[int, list] = {}
    for i in np.nonzero(valid)[0]:
        ung_by_lane.setdefault(int(cidx[i]) // CC, []).append(
            (int(pos[i]), int(nmm[i])))

    # gapped pool-2 entries grouped by lane
    g_read = np.asarray(res.g_read)
    g_q = np.asarray(res.g_q)
    g_key = np.asarray(res.g_key)
    gap_by_lane: dict[int, list] = {}
    live = np.nonzero((g_read < B2) & (g_key != _BIGKEY).any(axis=1))[0]
    for i in live:
        lane = int(g_read[i])
        for s in range(g_key.shape[1]):
            kv = int(g_key[i, s])
            if kv == _BIGKEY:
                continue
            score, g, nm = kv >> 8, (kv >> 4) & 0xF, kv & 0xF
            gap_by_lane.setdefault(lane, []).append(
                (int(g_q[i, s]), score, nm, g))

    def better(cur, score, ngapo, ngape, nm):
        # canonical dedup order (shared with pigeon_occ_arrays):
        # min (score, ngapo, ngape, nmm) wins
        return cur is None or (cur.score, cur.ngapo, cur.ngape, cur.nmm) \
            > (score, ngapo, ngape, nm)

    occs = []
    for j in range(B):
        d = {}
        if not fb[j]:
            for lane, strand in ((j, 0), (j + B, 1)):
                for p, nm in ung_by_lane.get(lane, ()):
                    key = (p, strand)
                    if better(d.get(key), nm * s_mm, 0, 0, nm):
                        d[key] = Occurrence(p, strand, nm * s_mm, nm, 0, 0)
                for q, score, nm, g in gap_by_lane.get(lane, ()):
                    key = (q, strand)
                    if better(d.get(key), score, 1, g - 1, nm):
                        d[key] = Occurrence(q, strand, score, nm, 1, g - 1)
        occs.append(sorted(d.values(), key=lambda o: (o.score, o.strand, o.pos)))
    return occs, fb, missed


def pigeon_occ_arrays(res: PigeonResult, B: int, opt, cand_cap: int):
    """Vectorized host finalization: flat occurrence ARRAYS, no Python
    per-occurrence objects (the loop twin is :func:`pigeon_occurrences`;
    tested equal).

    Returns (occ dict, fallback bool[B], missed int32[B]; see
    :func:`pigeon_occurrences` for the ``missed`` contract).  The dict
    holds numpy arrays ``rid, pos, strand, score, nmm, ngapo, ngape``
    deduped per (rid, strand, pos) by minimum (score, ngapo, ngape, nmm)
    and sorted by (rid, score, strand, pos) — the order the resolution
    layer consumes.  Entries of fallback reads are dropped.
    """
    CC = cand_cap
    s_mm = opt.s_mm
    pos = np.asarray(res.pos)
    nmm = np.asarray(res.nmm)
    valid = np.asarray(res.valid)
    cidx = np.asarray(res.cidx, np.int64)
    fallback = np.asarray(res.fallback)
    B2 = fallback.shape[0]
    assert B2 == 2 * B, (B2, B)
    fb = fallback[:B] | fallback[B:]
    miss_all = np.asarray(res.n_missed, np.int64)
    missed = miss_all[:B] + miss_all[B:]

    pi = np.nonzero(valid)[0]
    li = cidx[pi] // CC
    u_pos = pos[pi].astype(np.int64)
    u_nmm = nmm[pi].astype(np.int32)
    u_rid = np.where(li < B, li, li - B).astype(np.int64)
    u_str = (li >= B).astype(np.int8)
    u_sc = u_nmm * s_mm
    u_go = np.zeros(li.size, np.int32)
    u_ge = np.zeros(li.size, np.int32)

    g_read = np.asarray(res.g_read)
    g_key = np.asarray(res.g_key)
    g_q = np.asarray(res.g_q)
    gi, gs = np.nonzero((g_key != _BIGKEY) & (g_read < B2)[:, None])
    lane = g_read[gi]
    kv = g_key[gi, gs].astype(np.int64)
    v_pos = g_q[gi, gs].astype(np.int64)
    v_sc = (kv >> 8).astype(np.int32)
    v_g = ((kv >> 4) & 0xF).astype(np.int32)
    v_nmm = (kv & 0xF).astype(np.int32)
    v_rid = np.where(lane < B, lane, lane - B).astype(np.int64)
    v_str = (lane >= B).astype(np.int8)
    v_go = np.ones(gi.size, np.int32)
    v_ge = v_g - 1

    rid = np.concatenate([u_rid, v_rid])
    o_pos = np.concatenate([u_pos, v_pos])
    o_str = np.concatenate([u_str, v_str])
    o_sc = np.concatenate([u_sc, v_sc])
    o_nmm = np.concatenate([u_nmm, v_nmm])
    o_go = np.concatenate([u_go, v_go])
    o_ge = np.concatenate([u_ge, v_ge])

    keep = ~fb[rid]
    rid, o_pos, o_str, o_sc, o_nmm, o_go, o_ge = (
        a[keep] for a in (rid, o_pos, o_str, o_sc, o_nmm, o_go, o_ge))

    # dedup per (rid, strand, pos): min (score, ngapo, ngape, nmm)
    order = np.lexsort((o_nmm, o_ge, o_go, o_sc, o_pos, o_str, rid))
    rid, o_pos, o_str, o_sc, o_nmm, o_go, o_ge = (
        a[order] for a in (rid, o_pos, o_str, o_sc, o_nmm, o_go, o_ge))
    first = np.ones(rid.size, bool)
    first[1:] = ((rid[1:] != rid[:-1]) | (o_str[1:] != o_str[:-1])
                 | (o_pos[1:] != o_pos[:-1]))
    rid, o_pos, o_str, o_sc, o_nmm, o_go, o_ge = (
        a[first] for a in (rid, o_pos, o_str, o_sc, o_nmm, o_go, o_ge))

    # canonical consumption order: (rid, score, strand, pos)
    order = np.lexsort((o_pos, o_str, o_sc, rid))
    occ = dict(rid=rid[order], pos=o_pos[order], strand=o_str[order],
               score=o_sc[order], nmm=o_nmm[order], ngapo=o_go[order],
               ngape=o_ge[order])
    return occ, fb, missed


def occ_arrays_to_lists(occ, B):
    """Flat occurrence arrays -> per-read Occurrence lists.

    The inverse adapter of :func:`occ_lists_to_arrays` for consumers that
    need list form (paired-end resolution): arrays arrive deduped and
    sorted by (rid, score, strand, pos), so appending in order preserves
    the canonical list ordering.  One pass over ACTUAL occurrences
    (a few per read), no scan of the per-slot matrices.
    """
    from ..resolve.samse import Occurrence
    occs = [[] for _ in range(B)]
    rid = occ["rid"].tolist()
    pos = occ["pos"].tolist()
    strand = occ["strand"].tolist()
    score = occ["score"].tolist()
    nmm = occ["nmm"].tolist()
    go = occ["ngapo"].tolist()
    ge = occ["ngape"].tolist()
    for i in range(len(rid)):
        occs[rid[i]].append(Occurrence(pos[i], strand[i], score[i],
                                       nmm[i], go[i], ge[i]))
    return occs


def occ_lists_to_arrays(occs):
    """Adapter: per-read Occurrence lists -> the flat array dict of
    :func:`pigeon_occ_arrays` (lists are already deduped + sorted).

    Copy of ``hsa_tpu.search.pigeon.occ_lists_to_arrays``."""
    rid, pos, strand, score, nmm, ngapo, ngape = [], [], [], [], [], [], []
    for j, lst in enumerate(occs):
        for o in lst:
            rid.append(j); pos.append(o.pos); strand.append(o.strand)
            score.append(o.score); nmm.append(o.nmm)
            ngapo.append(o.ngapo); ngape.append(o.ngape)
    return dict(rid=np.asarray(rid, np.int64), pos=np.asarray(pos, np.int64),
                strand=np.asarray(strand, np.int8),
                score=np.asarray(score, np.int32),
                nmm=np.asarray(nmm, np.int32),
                ngapo=np.asarray(ngapo, np.int32),
                ngape=np.asarray(ngape, np.int32))
