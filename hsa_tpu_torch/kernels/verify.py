"""The pigeonhole engine's verify stages as two CUDA kernels, each beside
its plain PyTorch version.

Replaces device work that ``hsa_tpu`` leaves to XLA inside the jitted
``pigeon_search`` (``hsa_tpu/search/pigeon.py:669-876``).  Both kernels are
in ``csrc/pigeon_verify.cu`` (see its note); one thread a pool candidate.

- :func:`window_verify` (stages "window" and "verify",
  ``pigeon.py:669-718``): fetch each candidate's text window (``NR`` packed
  text rows, ``DW + 1`` words at the candidate's shift), XOR its central
  diagonal ``G`` against the read's packed words, count the mismatches and
  the seed's by popcount, and decide the candidate; the per-read best
  ungapped count ``n2`` too (``:720-722``).
- :func:`gapped_screen` (stage "gapped", ``pigeon.py:723-876``): for each
  pool-2 candidate, rebuild its window, form the mismatch and seed prefix
  sums of the ``2G + 1`` diagonals, score every one-run gap placement of
  length ``g = 1..G`` (deletion or insertion, after or before the anchor),
  keep each start class's best key ``score << 8 | g << 4 | nmm``, then the
  ``GC_SLOTS`` best classes and the overflow flag.

Inputs are the tensors ``pigeon_search`` holds: int64 values in
``[0, 2^32)`` (the kernels read their low 32-bit words), bool masks,
``text_rows`` int32 ``[nt, 8]`` (``pack_text_rows``' rows), and ``combo``
int64 ``[B, 4 RW + 1]``: each read's packed words, valid, N and seed masks
(``RW`` words each) and ``lens | md << 16``.  Every lane is computed, dead
ones included (a pool lane whose ``fetch_ok`` is false reads the window at
0, a pool-2 lane past ``n_gate`` the pool's last candidate), so the two
versions agree on every output word.

Each wrapper runs the plain version only for CPU tensors.  For CUDA tensors
it builds the kernels at first use and launches on the current stream, or
raises; ``WINDOW_VERIFY`` and ``GAPPED_SCREEN`` count their launches and
``launch_shapes``.
"""

from __future__ import annotations

import ctypes

import torch

from ..search.fm import M32, popcount32
from .build import CudaKernel, launch

PAT = 0x55555555
GC_SLOTS = 4          # gapped q-class slots per pool-2 candidate
BIGNMM = 0x3FFF
BIGKEY = 0xFFFFFFFF
MAX_DW = 10           # packed words of a read of MAX_READ_LEN = 160
MAX_G = 7             # MAX_GAP_RUN


def _declare(lib):
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hsa_window_verify.argtypes = [vp, ll, vp, ll, ll, vp, vp, vp, vp, ll,
                                      i, i, vp, vp, vp, vp, vp]
    lib.hsa_window_verify.restype = ctypes.c_int
    lib.hsa_gapped_screen.argtypes = [vp, ll, vp, ll, ll, vp, vp, vp, ll, vp,
                                      ll, vp, i, ll, i, i, i, i, i, i, vp, vp,
                                      vp, vp, vp]
    lib.hsa_gapped_screen.restype = ctypes.c_int


# one source, two kernels: a counter each (the second loads the library
# that the first built)
WINDOW_VERIFY = CudaKernel("pigeon_verify.cu", _declare)
GAPPED_SCREEN = CudaKernel("pigeon_verify.cu", _declare)


# -- the plain versions ---------------------------------------------------------

def _expand_prefix(mm_words, DW):
    """Pair-bit mismatch words [P, >=DW] -> exclusive per-base prefix sums.

    Returns (P_[P, 16*DW] int32 with P_[:, t] = #mismatches at read
    positions < t, total [P] int32)."""
    shifts = (2 * torch.arange(16, device=mm_words.device))[None, None, :]
    bits = ((mm_words[:, :DW, None] >> shifts) & 1).to(torch.int32)
    bits = bits.reshape(bits.shape[0], DW * 16)
    cs = torch.cumsum(bits, dim=1, dtype=torch.int32)
    return cs - bits, cs[:, -1]


def _read_words(combo):
    """(RW, DW) of a ``combo`` matrix [B, 4 RW + 1]."""
    RW = (combo.shape[1] - 1) // 4
    return RW, RW - 1


def window_words(text_rows, pstart, fetch_ok, G: int, DW: int):
    """int64 [P, DW + 1] window words: word t packs the 16 text bases from
    ``pstart - G + 16t`` (``pigeon.py:669-686``).  ``NR`` text-row gathers
    cover ``[pstart - G, pstart - G + 128 NR)`` in lead-padded row
    coordinates; a lane whose fetch is not ok reads from 0."""
    P = pstart.shape[0]
    NR = (DW + 16) // 8              # rows a fetch: ws (<= 7) + DW + 1 words
    startf = torch.where(fetch_ok, (pstart + (128 - G)) & M32, 0)
    r0 = startf >> 7
    rix = torch.stack([r0 + i for i in range(NR)], dim=1) \
        .clamp(max=text_rows.shape[0] - 1)
    words = text_rows[rix.reshape(-1)].long().reshape(P, NR * 8) & M32
    ws = (startf >> 4) & 7
    sh = (2 * (startf & 15))[:, None]
    sh_nz = sh > 0
    inv = torch.where(sh_nz, 32 - sh, 1)
    # the reference's per-lane select among the fetched words (``_selectn``,
    # a tree of ``where``) is one gather on the matrix of those words
    both = words.gather(1, ws[:, None] + torch.arange(
        DW + 2, device=pstart.device)[None, :])
    lo, hi = both[:, :DW + 1], both[:, 1:]
    return torch.where(sh_nz, (lo >> sh) | ((hi << inv) & M32), lo)


def diag_words(W, d: int, DW: int):
    """Packed window words of diagonal d: base (pstart - G + d + 16t)."""
    if d == 0:
        return W[:, :DW]
    return (W[:, :DW] >> (2 * d)) | ((W[:, 1:DW + 1] << (32 - 2 * d)) & M32)


def mismatch_words(W, d: int, row, RW: int, DW: int):
    """Pair-bit mismatch words [P, DW] of diagonal d against the reads of
    ``row`` (N positions count, positions past the read do not)."""
    x = diag_words(W, d, DW) ^ row[:, :DW]
    return ((((x | (x >> 1)) & PAT) | row[:, 2 * RW:2 * RW + DW])
            & row[:, RW:RW + DW])


def window_verify_plain(text_rows, combo, pstart, pread, fetch_ok, pvalid, *,
                        G: int, max_seed_diff: int):
    """(pvalid [P] bool, pos [P] int64, nmm [P] uint8, n2 [B] int64): the
    ungapped verify on the central diagonal ``G`` (``pigeon.py:669-722``).
    ``pvalid`` comes in as the in-text test and goes out with the mismatch
    and seed budgets applied; ``n2`` is each read's least verified count
    (``BIGNMM`` where none)."""
    RW, DW = _read_words(combo)
    crow = combo[pread]
    pmd = crow[:, 4 * RW] >> 16
    mm = mismatch_words(window_words(text_rows, pstart, fetch_ok, G, DW), G,
                        crow, RW, DW)
    pnmm = popcount32(mm).sum(dim=1)
    seed_f = popcount32(mm & crow[:, 3 * RW:3 * RW + DW]).sum(dim=1)
    pvalid = pvalid & (pnmm <= pmd) & (seed_f <= max_seed_diff)
    pos_o = torch.where(pvalid, pstart, 0)
    n2 = torch.full((combo.shape[0],), BIGNMM, dtype=torch.int64,
                    device=combo.device).scatter_reduce(
        0, pread, torch.where(pvalid, pnmm, BIGNMM), "amin",
        include_self=True)
    return pvalid, pos_o, pnmm.to(torch.uint8), n2


def gapped_screen_plain(text_rows, combo, pstart, pread, fetch_ok, gidx,
                        n_gate, *, G: int, n: int, opt):
    """(g_key [GP, GC_SLOTS] int64, g_q [GP, GC_SLOTS] int64, g_read [GP]
    int64, g_drop [GP] bool): the one-run gap screen of the pool-2
    candidates ``gidx`` (pool indices, ``n_gate`` of them live, the rest
    filled with the pool's size) (``pigeon.py:723-876``).  ``g_read`` is
    the candidate's read, ``B`` past ``n_gate``; ``g_drop`` marks a live
    candidate whose dropped class could still enter the reporting window
    (always False when the ``2G + 1`` classes fit the slots)."""
    dev = combo.device
    i64, i32 = torch.int64, torch.int32
    B = combo.shape[0]
    RW, DW = _read_words(combo)
    POOL, GPOOL = pstart.shape[0], gidx.shape[0]
    in_g = torch.arange(GPOOL, device=dev) < n_gate
    g2 = gidx.clamp(max=POOL - 1)
    pstart2, pread2 = pstart[g2], pread[g2]
    crow2 = combo[pread2]
    plens2 = crow2[:, 4 * RW] & 0xFFFF
    pmd2 = crow2[:, 4 * RW] >> 16
    WW2 = window_words(text_rows, pstart2, fetch_ok[g2], G, DW)

    LT = 16 * DW
    lens32 = plens2.to(i32)[:, None]                   # [P2, 1]
    md32 = pmd2.to(i32)[:, None]
    seed_start = lens32 - opt.seed_len
    tpos = torch.arange(LT, dtype=i32, device=dev)[None, :]   # [1, LT]
    skip = opt.indel_end_skip
    BIG = BIGNMM
    big_col = torch.full((GPOOL, G), BIG, dtype=i32, device=dev)

    def diag_prefix(d):
        """(mm prefix, mm total, seed prefix, seed total) of diag d."""
        mmw = mismatch_words(WW2, d, crow2, RW, DW)
        Pm, Tm = _expand_prefix(mmw, DW)
        Ps, Ts = _expand_prefix(mmw & crow2[:, 3 * RW:3 * RW + DW], DW)
        return Pm, Tm[:, None], Ps, Ts[:, None]

    def shift(P, gg):
        return torch.cat([P[:, gg:], big_col[:, :gg]], dim=1)

    def best(ok_t, q_ok, nmm_t):
        return torch.where(ok_t & q_ok[:, None], nmm_t, BIG) \
            .amin(dim=1).long()

    PG, TG, SG, TSG = diag_prefix(G)
    # per-q-class (delta in [-G, G]) minimum: key = score<<8|g<<4|nmm
    class_key = [torch.full((GPOOL,), BIGKEY, dtype=i64, device=dev)
                 for _ in range(2 * G + 1)]

    def upd_class(ci, nmm_best, g):
        key = ((nmm_best * opt.s_mm
                + (opt.s_gapo + opt.s_gape * (g - 1))) << 8) \
            | (g << 4) | nmm_best
        key = torch.where(nmm_best < BIG, key, BIGKEY)
        class_key[ci] = torch.minimum(class_key[ci], key)

    for g in range(1, G + 1):
        feas_g = g <= md32
        Pp, Tp, Sp, TSp = diag_prefix(G + g)
        Pm_, Tm_, Sm_, TSm_ = diag_prefix(G - g)

        def ok(tmask, nmm_t, sd_t):
            return tmask & feas_g & (nmm_t + g <= md32) \
                & (sd_t <= opt.max_seed_diff)

        # deletion, gap after anchor: q = pstart (class delta 0)
        tm = (tpos >= skip) & (tpos <= lens32 - skip)
        gseed = (tpos > seed_start).to(i32) * g
        nmm_t = PG + (Tp - Pp)
        sd_t = SG + (TSp - Sp) + gseed
        q_ok = (pstart2 < n) & (((pstart2 + plens2 + g) & M32) <= n)
        upd_class(G, best(ok(tm, nmm_t, sd_t), q_ok, nmm_t), g)

        # deletion, gap before anchor: q = pstart - g (class delta -g)
        nmm_t = Pm_ + (TG - PG)
        sd_t = Sm_ + (TSG - SG) + gseed
        q2 = (pstart2 - g) & M32
        q_ok = (q2 < n) & (((q2 + plens2 + g) & M32) <= n)
        upd_class(G - g, best(ok(tm, nmm_t, sd_t), q_ok, nmm_t), g)

        # insertion, gap after anchor: q = pstart (class delta 0);
        # read positions t..t+g-1 are the inserted run
        tm_i = (tpos >= skip - 1) & (tpos <= lens32 - skip - g)
        iseed = (tpos + g - seed_start).clamp(0, g)
        nmm_t = PG + (Tm_ - shift(Pm_, g))
        sd_t = SG + (TSm_ - shift(Sm_, g)) + iseed
        plen_g = (plens2 - g) & M32
        q_ok = (pstart2 < n) & (((pstart2 + plen_g) & M32) <= n)
        upd_class(G, best(ok(tm_i, nmm_t, sd_t), q_ok, nmm_t), g)

        # insertion, gap before anchor: q = pstart + g (class delta +g)
        nmm_t = Pp + (TG - shift(PG, g))
        sd_t = Sp + (TSG - shift(SG, g)) + iseed
        q3 = (pstart2 + g) & M32
        q_ok = (q3 < n) & (((q3 + plen_g) & M32) <= n)
        upd_class(G + g, best(ok(tm_i, nmm_t, sd_t), q_ok, nmm_t), g)
        del Pp, Tp, Sp, TSp, Pm_, Tm_, Sm_, TSm_, nmm_t, sd_t

    # top-GC_SLOTS q-classes by packed key (score-major); among equal
    # keys the lowest class wins (the first minimum): the class index
    # rides in the low 4 bits of the compared value
    NCL = 2 * G + 1
    cls = torch.arange(NCL, device=dev)[None, :]
    kmat = torch.stack(class_key, dim=1)               # [P2, 2G+1]
    qmat = (pstart2[:, None] + (cls - G)) & M32
    out_k, out_q = [], []
    for _ in range(min(GC_SLOTS, NCL)):
        i = ((kmat << 4) | cls).amin(dim=1, keepdim=True) & 15
        out_k.append(kmat.gather(1, i)[:, 0])
        out_q.append(qmat.gather(1, i)[:, 0])
        kmat = torch.where(cls == i, BIGKEY, kmat)
    while len(out_k) < GC_SLOTS:
        out_k.append(torch.full((GPOOL,), BIGKEY, dtype=i64, device=dev))
        out_q.append(torch.zeros(GPOOL, dtype=i64, device=dev))
    g_key = torch.stack(out_k, dim=1)
    g_q = torch.stack(out_q, dim=1)
    # conservative overflow: a dropped q-class could still enter the
    # reporting window (score <= kept best + s_mm)
    if NCL > GC_SLOTS:
        rem_key = kmat.amin(dim=1)
        g_drop = in_g & (rem_key != BIGKEY) \
            & ((rem_key >> 8) <= (out_k[0] >> 8) + opt.s_mm)
    else:
        g_drop = torch.zeros(GPOOL, dtype=torch.bool, device=dev)
    g_key = torch.where(in_g[:, None], g_key, BIGKEY)
    g_read = torch.where(in_g, pread2, B)
    return g_key, g_q, g_read, g_drop


# -- the kernels ------------------------------------------------------------------

def _check_pool(text_rows, combo, pstart, pread, fetch_ok, G):
    dev = combo.device
    if text_rows.dtype != torch.int32 or text_rows.dim() != 2 or \
            text_rows.shape[1] != 8 or not text_rows.is_contiguous():
        raise TypeError(f"text_rows must be contiguous int32 [nt, 8], got "
                        f"{text_rows.dtype} {tuple(text_rows.shape)}")
    if combo.dtype != torch.int64 or combo.dim() != 2 or \
            (combo.shape[1] - 1) % 4 or not combo.is_contiguous():
        raise TypeError(f"combo must be contiguous int64 [B, 4 RW + 1], got "
                        f"{combo.dtype} {tuple(combo.shape)}")
    DW = _read_words(combo)[1]
    if not 1 <= DW <= MAX_DW or not 0 <= G <= MAX_G:
        raise ValueError(f"DW={DW} or G={G} outside [1, {MAX_DW}], "
                         f"[0, {MAX_G}]")
    P = pstart.shape[0]
    for name, t, dt in (("pstart", pstart, torch.int64),
                        ("pread", pread, torch.int64),
                        ("fetch_ok", fetch_ok, torch.bool)):
        if t.dtype != dt or t.shape != (P,) or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous {dt} [{P}], got "
                            f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("text_rows", text_rows), ("pstart", pstart),
                    ("pread", pread), ("fetch_ok", fetch_ok)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, combo on {dev}")


def window_verify(text_rows, combo, pstart, pread, fetch_ok, pvalid, *,
                  G: int, max_seed_diff: int):
    """The ungapped verify of every pool candidate
    (:func:`window_verify_plain`'s contract)."""
    _check_pool(text_rows, combo, pstart, pread, fetch_ok, G)
    if pvalid.dtype != torch.bool or pvalid.shape != pstart.shape or \
            pvalid.device != combo.device or not pvalid.is_contiguous():
        raise TypeError("pvalid must be contiguous bool like pstart")
    if combo.device.type == "cpu":
        return window_verify_plain(text_rows, combo, pstart, pread, fetch_ok,
                                   pvalid, G=G, max_seed_diff=max_seed_diff)
    if combo.device.type != "cuda":
        raise ValueError(f"window_verify: unsupported device {combo.device}")
    B, P = combo.shape[0], pstart.shape[0]
    RW = _read_words(combo)[0]
    valid_o = torch.empty_like(pvalid)
    pos_o = torch.empty_like(pstart)
    nmm_o = torch.empty(P, dtype=torch.uint8, device=combo.device)
    n2 = torch.full((B,), BIGNMM, dtype=torch.int64, device=combo.device)
    if P:
        launch("window_verify", WINDOW_VERIFY.lib().hsa_window_verify, n2, (
            text_rows.data_ptr(), text_rows.shape[0], combo.data_ptr(), B,
            RW, pstart.data_ptr(), pread.data_ptr(), fetch_ok.data_ptr(),
            pvalid.data_ptr(), P, G, max_seed_diff, valid_o.data_ptr(),
            pos_o.data_ptr(), nmm_o.data_ptr(), n2.data_ptr()))
        WINDOW_VERIFY.count_launch((P, B, RW, G))
    return valid_o, pos_o, nmm_o, n2


def gapped_screen(text_rows, combo, pstart, pread, fetch_ok, gidx, n_gate, *,
                  G: int, n: int, opt):
    """The one-run gap screen of the pool-2 candidates
    (:func:`gapped_screen_plain`'s contract)."""
    _check_pool(text_rows, combo, pstart, pread, fetch_ok, G)
    if G < 1:
        raise ValueError("gapped_screen needs G >= 1")
    if gidx.dtype != torch.int64 or gidx.dim() != 1 or \
            not gidx.is_contiguous() or gidx.device != combo.device:
        raise TypeError("gidx must be a contiguous int64 vector on combo's "
                        "device")
    if not isinstance(n_gate, torch.Tensor) or n_gate.numel() != 1 or \
            n_gate.dtype != torch.int64 or n_gate.device != combo.device:
        raise TypeError("n_gate must be a one-element int64 tensor on "
                        "combo's device")
    if combo.device.type == "cpu":
        return gapped_screen_plain(text_rows, combo, pstart, pread, fetch_ok,
                                   gidx, n_gate, G=G, n=n, opt=opt)
    if combo.device.type != "cuda":
        raise ValueError(f"gapped_screen: unsupported device {combo.device}")
    B, P, GP = combo.shape[0], pstart.shape[0], gidx.shape[0]
    RW = _read_words(combo)[0]
    dev = combo.device
    g_key = torch.empty((GP, GC_SLOTS), dtype=torch.int64, device=dev)
    g_q = torch.empty((GP, GC_SLOTS), dtype=torch.int64, device=dev)
    g_read = torch.empty(GP, dtype=torch.int64, device=dev)
    g_drop = torch.empty(GP, dtype=torch.bool, device=dev)
    if GP:
        if P == 0:
            raise ValueError("gapped_screen: an empty pool has no candidate")
        launch("gapped_screen", GAPPED_SCREEN.lib().hsa_gapped_screen, g_key, (
            text_rows.data_ptr(), text_rows.shape[0], combo.data_ptr(), B, RW,
            pstart.data_ptr(), pread.data_ptr(), fetch_ok.data_ptr(), P,
            gidx.data_ptr(), GP, n_gate.data_ptr(), G, n, opt.s_mm,
            opt.s_gapo, opt.s_gape, opt.seed_len, opt.indel_end_skip,
            opt.max_seed_diff, g_key.data_ptr(), g_q.data_ptr(),
            g_read.data_ptr(), g_drop.data_ptr()))
        GAPPED_SCREEN.count_launch((GP, P, B, RW, G))
    return g_key, g_q, g_read, g_drop
