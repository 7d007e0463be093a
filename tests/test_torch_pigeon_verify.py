"""The pigeon engine's verify stages (``kernels/verify.py``) against
``hsa_tpu.search.pigeon.pigeon_search``, and the CUDA kernels' arithmetic
against their plain versions, on the CPU.

``pigeon_search`` composes ``window_verify`` and ``gapped_screen`` (on CPU
tensors their plain versions); its every ``PigeonResult`` field must equal
the JAX function's (run eagerly on the CPU, as ``tests/test_pigeon.py``
runs it) on the same seeded inputs: gap runs G from 1 to 7 and G = 0,
insertions and deletions of 1 and G bases on both sides of the anchor,
candidates at the text's first and last bases (the in-text tests' 2^32
wraps), N bases and mismatches in the seed region, and low-complexity
text where more than ``GC_SLOTS`` start classes score and keys tie.  Each
stage's inputs, caught as ``pigeon_search`` hands them over, then go
through :func:`emulate_window_verify` and :func:`emulate_gapped_screen`,
the kernels of ``csrc/pigeon_verify.cu`` restated step by step on numpy
arrays, which must give the plain versions' outputs on every lane, dead
ones included (the card holds the kernels themselves against the plain
versions: ``chip_smoke.py``).  All integer work: the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from hsa_tpu.config import AlnOpt
from hsa_tpu_torch.kernels import verify
from hsa_tpu_torch.search import pigeon as tpigeon
from test_torch_pigeon import Genome, _edge_reads, sample_reads, search_both

M32 = 0xFFFFFFFF
PAT = 0x55555555
BIG = verify.BIGNMM
BIGKEY = verify.BIGKEY


@pytest.fixture(scope="module")
def iid():
    return Genome(np.random.RandomState(11).randint(0, 4, 20_000)
                  .astype(np.int8))


def low_complexity_text(seed=13, n=20_000):
    """An i.i.d. text with, every 500 bases, two runs of 30 bases of one
    period-1 or period-2 unit with 40 i.i.d. bases between them: a read
    that spans both runs aligns again, gapped, wherever a gap of a multiple
    of the unit shifts a run, at one score in several start classes."""
    rs = np.random.RandomState(seed)
    t = rs.randint(0, 4, n).astype(np.int8)
    units = ([0], [0, 1], [2], [1, 3])
    for i, p in enumerate(RUN_STARTS):
        run = np.tile(np.asarray(units[i % len(units)], np.int8), 30)[:30]
        t[p:p + 30] = run
        t[p + 70:p + 100] = run
    return t


RUN_STARTS = range(300, 20_000 - 300, 500)


@pytest.fixture(scope="module")
def lowc():
    return Genome(low_complexity_text())


def indel_reads(text, rs, n, L, G, lo=0, hi=None, mism=1):
    """Reads of ``L`` bp with a deletion or an insertion of 1 or ``G``
    bases (alternating) at a position anywhere but the ends, so before or
    after whichever segment anchors, and up to ``mism`` substitutions."""
    hi = len(text) if hi is None else hi
    out = []
    for j in range(n):
        g = 1 if j % 2 else max(G, 1)
        p = rs.randint(lo, hi - L - G - 2)
        t = rs.randint(8, L - 8 - g)
        r = text[p:p + L + g].copy()
        if (j // 2) % 2:
            r = np.concatenate([r[:t], r[t + g:]])               # deletion
        else:
            ins = rs.randint(0, 4, g).astype(np.int8)
            r = np.concatenate([r[:t], ins, r[t:]])              # insertion
        r = r[:L].copy()
        for _ in range(rs.randint(0, mism + 1)):
            q = rs.randint(0, L)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        out.append(r.astype(np.int8))
    return out


class Capture:
    """The inputs and outputs of every call of ``window_verify`` and
    ``gapped_screen`` while active (``pigeon_search`` calls them through
    the module)."""

    def __init__(self, monkeypatch):
        self.calls = {"window_verify": [], "gapped_screen": []}
        for name in self.calls:
            real = getattr(verify, name)

            def spy(*args, _real=real, _name=name, **kw):
                out = _real(*args, **kw)
                self.calls[_name].append((args, kw, out))
                return out
            monkeypatch.setattr(verify, name, spy)


def _np(x):
    return x.numpy().astype(np.int64) if isinstance(x, torch.Tensor) else x


def _popc(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _funnel(lo, hi, sh):
    return np.where(sh > 0, (lo >> sh) | ((hi << (32 - sh)) & M32), lo)


def _window(text, pstart, ok, G):
    """(text_word(j), sh) of ``csrc/pigeon_verify.cu``'s window_at."""
    nt = text.shape[0]
    startf = np.where(ok, (pstart + 128 - G) & M32, 0)
    r0, ws, sh = startf >> 7, (startf >> 4) & 7, 2 * (startf & 15)

    def word(j):                      # j: offset from the window's first word
        jj = ws + j
        return text[np.minimum(r0 + (jj >> 3), nt - 1), jj & 7]
    return word, sh


def _rows(combo, pr):
    B = combo.shape[0]
    return (combo & M32)[np.clip(pr, 0, B - 1)]


def emulate_window_verify(text_rows, combo, pstart, pread, fetch_ok, pvalid,
                          G, max_seed_diff):
    """``window_verify_kernel`` on numpy: one lane a candidate, the window
    words streamed, then the atomic min."""
    text = _np(text_rows) & M32
    combo, pstart, pread = _np(combo), _np(pstart) & M32, _np(pread) & M32
    fetch_ok, pvalid = _np(fetch_ok).astype(bool), _np(pvalid).astype(bool)
    B = combo.shape[0]
    RW = (combo.shape[1] - 1) // 4
    row = _rows(combo, pread)
    pmd = row[:, 4 * RW] >> 16
    word, sh = _window(text, pstart, fetch_ok, G)
    tw1 = word(1)
    ww = _funnel(word(0), tw1, sh)
    nmm = np.zeros_like(pstart)
    seed = np.zeros_like(pstart)
    for t in range(RW - 1):
        tw2 = word(t + 2)
        ww1 = _funnel(tw1, tw2, sh)
        diag = ((ww >> 2 * G) | ((ww1 << (32 - 2 * G)) & M32)) if G else ww
        x = diag ^ row[:, t]
        mm = (((x | (x >> 1)) & PAT) | row[:, 2 * RW + t]) & row[:, RW + t]
        nmm += _popc(mm)
        seed += _popc(mm & row[:, 3 * RW + t])
        tw1, ww = tw2, ww1
    ok = pvalid & (nmm <= pmd) & (seed <= max_seed_diff)
    n2 = np.full(B, BIG, np.int64)
    np.minimum.at(n2, np.clip(pread, 0, B - 1), np.where(ok, nmm, BIG))
    return ok, np.where(ok, pstart, 0), nmm.astype(np.uint8), n2


def emulate_gapped_screen(text_rows, combo, pstart, pread, fetch_ok, gidx,
                          n_gate, G, n, opt):
    """``gapped_screen_kernel`` on numpy, every lane at once: the window
    rebuilt, the three diagonals' words for each g, one pass over the
    positions with running exclusive prefixes (and the g-ahead streams for
    the insertions), the class keys, the GC_SLOTS picks, the drop flag."""
    text = _np(text_rows) & M32
    combo, pstart, pread = _np(combo), _np(pstart) & M32, _np(pread) & M32
    fetch_ok, gidx = _np(fetch_ok).astype(bool), _np(gidx) & M32
    B, P, GP = combo.shape[0], pstart.shape[0], gidx.shape[0]
    RW = (combo.shape[1] - 1) // 4
    DW, LT = RW - 1, 16 * (RW - 1)
    in_g = np.arange(GP) < int(n_gate)
    g2 = np.minimum(gidx, P - 1)
    ps, pr = pstart[g2], pread[g2]
    row = _rows(combo, pr)
    lens, md = row[:, 4 * RW] & 0xFFFF, row[:, 4 * RW] >> 16
    word, sh = _window(text, ps, fetch_ok[g2], G)
    WW = [_funnel(word(t), word(t + 1), sh) for t in range(DW + 1)]

    def diag_mm(d):
        mm, sd = [], []
        for w in range(DW):
            dw = ((WW[w] >> 2 * d) | ((WW[w + 1] << (32 - 2 * d)) & M32)) \
                if d else WW[w]
            x = dw ^ row[:, w]
            m = (((x | (x >> 1)) & PAT) | row[:, 2 * RW + w]) & row[:, RW + w]
            mm.append(m)
            sd.append(m & row[:, 3 * RW + w])
        return mm, sd, sum(_popc(m) for m in mm), sum(_popc(s) for s in sd)

    def class_key(best, g):
        k = ((best * opt.s_mm + (opt.s_gapo + opt.s_gape * (g - 1))) * 256) \
            | (g << 4) | best
        return np.where(best < BIG, k, BIGKEY)

    mG, sG, TG, TSG = diag_mm(G)
    key = np.full((GP, 2 * G + 1), BIGKEY, np.int64)
    seed_start = lens - opt.seed_len
    skip, msd = opt.indel_end_skip, opt.max_seed_diff
    for g in range(1, G + 1):
        mP, sP, TP, TSP = diag_mm(G + g)
        mM, sM, TM, TSM = diag_mm(G - g)
        feas = g <= md
        low = (1 << (2 * g)) - 1
        cG = cS = cP = cPs = cM = cMs = np.zeros(GP, np.int64)
        hG, hGs = _popc(mG[0] & low), _popc(sG[0] & low)
        hM, hMs = _popc(mM[0] & low), _popc(sM[0] & low)
        b = [np.full(GP, BIG, np.int64) for _ in range(4)]
        for w in range(DW):
            a = [mG[w], sG[w], mP[w], sP[w], mM[w], sM[w]]

            def ahead(x):
                nxt = x[w + 1] << (32 - 2 * g) & M32 if w + 1 < DW else 0
                return (x[w] >> 2 * g) | nxt
            la = [ahead(mG), ahead(sG), ahead(mM), ahead(sM)]
            for q in range(16):
                t = 16 * w + q
                on = t + g < LT
                shG, shGs = (hG, hGs) if on else (BIG, BIG)
                shM, shMs = (hM, hMs) if on else (BIG, BIG)
                tm = (t >= skip) & (t <= lens - skip)
                tm_i = (t >= skip - 1) & (t <= lens - skip - g)
                gseed = np.where(t > seed_start, g, 0)
                iseed = np.clip(t + g - seed_start, 0, g)
                for i, (v, sd, m) in enumerate((
                        (cG + (TP - cP), cS + (TSP - cPs) + gseed, tm),
                        (cM + (TG - cG), cMs + (TSG - cS) + gseed, tm),
                        (cG + (TM - shM), cS + (TSM - shMs) + iseed, tm_i),
                        (cP + (TG - shG), cPs + (TSG - shGs) + iseed, tm_i))):
                    take = feas & m & (v + g <= md) & (sd <= msd)
                    b[i] = np.where(take, np.minimum(b[i], v), b[i])
                cG, cS, cP, cPs, cM, cMs = (c + (x & 1) for c, x in zip(
                    (cG, cS, cP, cPs, cM, cMs), a))
                hG, hGs, hM, hMs = (c + (x & 1) for c, x in zip(
                    (hG, hGs, hM, hMs), la))
                a = [x >> 2 for x in a]
                la = [x >> 2 for x in la]
        ok0 = (ps < n) & (((ps + lens + g) & M32) <= n)
        q2 = (ps - g) & M32
        ok2 = (q2 < n) & (((q2 + lens + g) & M32) <= n)
        plen_g = (lens - g) & M32
        ok3 = (ps < n) & (((ps + plen_g) & M32) <= n)
        q3 = (ps + g) & M32
        ok4 = (q3 < n) & (((q3 + plen_g) & M32) <= n)
        for c, ok_, bi in ((G, ok0, b[0]), (G - g, ok2, b[1]),
                           (G, ok3, b[2]), (G + g, ok4, b[3])):
            key[:, c] = np.minimum(key[:, c],
                                   class_key(np.where(ok_, bi, BIG), g))
    ncl = 2 * G + 1
    ok_k = np.full((GP, 4), BIGKEY, np.int64)
    oq = np.zeros((GP, 4), np.int64)
    lanes = np.arange(GP)
    for p in range(min(4, ncl)):
        c = (key * 16 | np.arange(ncl)).min(axis=1) & 15
        ok_k[:, p] = key[lanes, c]
        oq[:, p] = (ps + (c - G)) & M32
        key[lanes, c] = BIGKEY
    drop = np.zeros(GP, bool)
    if ncl > 4:
        rem = key.min(axis=1)
        drop = in_g & (rem != BIGKEY) & ((rem >> 8) <= (ok_k[:, 0] >> 8)
                                         + opt.s_mm)
    g_key = np.where(in_g[:, None], ok_k, BIGKEY)
    return g_key, oq, np.where(in_g, pr, B), drop


def check_emulations(cap, opt, n):
    """Every captured stage call: the emulated kernel equals the plain
    version's outputs on every lane."""
    assert cap.calls["window_verify"]
    for args, kw, out in cap.calls["window_verify"]:
        want = emulate_window_verify(*args, **kw)
        for w, g, f in zip(want, out, ("valid", "pos", "nmm", "n2")):
            np.testing.assert_array_equal(w, g.numpy(), err_msg=f)
    for args, kw, out in cap.calls["gapped_screen"]:
        assert kw["n"] == n
        want = emulate_gapped_screen(*args, kw["G"], n, kw["opt"])
        for w, g, f in zip(want, out, ("g_key", "g_q", "g_read", "g_drop")):
            np.testing.assert_array_equal(w, g.numpy(), err_msg=f)


# G -> (opt, md, n_seg): G = min(1 + min(max_gape, n_seg - 2), 7), 0 with
# gaps off
G_CASES = {
    0: (AlnOpt(max_diff=2, max_gapo=0), 2, 3),
    1: (AlnOpt(max_diff=2, max_gape=0), 2, 3),
    2: (AlnOpt(max_diff=2), 2, 3),
    3: (AlnOpt(max_diff=3), 3, 4),
    4: (AlnOpt(max_diff=4), 4, 5),
    5: (AlnOpt(max_diff=5), 5, 6),
    6: (AlnOpt(max_diff=6), 6, 7),
    7: (AlnOpt(max_diff=7), 7, 8),
}


@pytest.mark.parametrize("G", sorted(G_CASES))
def test_gap_runs_match_jax(iid, monkeypatch, G):
    """Insertions and deletions of 1 and G bases on both sides of the
    anchor, at every G the engine screens, and G = 0 (where only the
    reads with substitutions verify)."""
    opt, md, n_seg = G_CASES[G]
    assert tpigeon.max_gap_run(opt, n_seg) == G
    rs = np.random.RandomState(20 + G)
    reads = indel_reads(iid.text, rs, 10, 100, G) + sample_reads(
        iid.text, rs, 4, L=100, k=2)
    cap = Capture(monkeypatch)
    res = search_both(iid, reads, opt, md, n_seg, cand_cap=16)
    assert res.valid.sum() > 0
    if G:
        assert int(res.n_gate) > 0
        keys = res.g_key[res.g_key != BIGKEY]
        gaps = set(((keys >> 4) & 15).tolist())
        assert 1 in gaps and G in gaps      # both run lengths were scored
    check_emulations(cap, opt, len(iid.text))
    assert bool(cap.calls["gapped_screen"]) == (G > 0)


def test_text_ends_match_jax(iid, monkeypatch):
    """Candidates at the text's first and last bases, plain and with a
    gap near the middle: the in-text tests wrap at 2^32 there."""
    opt, md, n_seg = G_CASES[3]
    t = iid.text
    reads = _edge_reads(t) + [t[:60].copy(), t[-60:].copy(),
                              t[1:61].copy(), t[-61:-1].copy()]
    cap = Capture(monkeypatch)
    res = search_both(iid, reads, opt, md, n_seg, cand_cap=16)
    assert res.valid.sum() > 0 and int(res.n_gate) > 0
    n = len(t)
    assert (res.pos[res.valid] == 0).any()
    assert (res.pos[res.valid] == n - 60).any()
    check_emulations(cap, opt, n)


def test_n_bases_and_seed_region_match_jax(iid, monkeypatch):
    """Reads with N bases and substitutions in the seed (the 3' seed_len
    bases), with and without gaps: the N pairs count as mismatches, the
    seed's are capped at max_seed_diff."""
    opt, md, n_seg = G_CASES[2]
    rs = np.random.RandomState(41)
    reads = indel_reads(iid.text, rs, 8, 100, 2)
    for j, r in enumerate(reads):
        r[rs.randint(0, 100)] = 4
        if j % 2:
            q = 100 - 1 - rs.randint(0, opt.seed_len)
            r[q] = (r[q] + 1) % 4 if r[q] < 4 else 1
    reads += sample_reads(iid.text, rs, 8, L=100, k=2, with_n=1)
    cap = Capture(monkeypatch)
    res = search_both(iid, reads, opt, md, n_seg, cand_cap=16)
    assert res.valid.sum() > 0 and int(res.n_gate) > 0
    check_emulations(cap, opt, len(iid.text))


@pytest.mark.parametrize("G", [2, 4])
def test_class_overflow_and_ties_match_jax(lowc, monkeypatch, G):
    """Reads across two runs of a unit, at scores where every candidate
    gates and a gap costs the same at any length (``s_gapo`` = ``s_mm``,
    ``s_gape`` = 0): keys tie between classes (the lowest class is picked
    first); at G = 4 more than GC_SLOTS start classes score and g_drop
    counts the dropped ones into n_missed, at G = 2 (five classes, two of
    them scored here) nothing drops."""
    _, md, n_seg = G_CASES[G]
    opt = AlnOpt(max_diff=md, s_gapo=3, s_gape=0)
    assert tpigeon.max_gap_run(opt, n_seg) == G
    rs = np.random.RandomState(50 + G)
    reads = []
    for p in RUN_STARTS[:12]:
        r = lowc.text[p + 10:p + 110].copy()
        if rs.randint(2):
            q = 30 + rs.randint(0, 30)
            r[q] = (r[q] + 1) % 4
        reads.append(r)
    cap = Capture(monkeypatch)
    res = search_both(lowc, reads, opt, md, n_seg, cand_cap=16)
    check_emulations(cap, opt, len(lowc.text))
    g_key, _, g_read, g_drop = (x.numpy()
                                for x in cap.calls["gapped_screen"][0][2])
    ties = [row[row != BIGKEY].size > np.unique(row[row != BIGKEY]).size
            for row in g_key]
    assert any(ties)
    assert g_drop.any() == (G == 4)
    assert (res.n_missed[g_read[g_drop]] > 0).all()


def test_cpu_takes_the_plain_versions_and_the_wrappers_check(iid):
    """On CPU tensors the wrappers launch nothing; they refuse wrong types,
    and another device than the CPU or a card."""
    opt, md, n_seg = G_CASES[2]
    b = tpigeon.pack_pigeon_batch(indel_reads(
        iid.text, np.random.RandomState(3), 4, 100, 2), n_seg=n_seg)
    RW = b["rw"].shape[1]
    combo = torch.from_numpy(np.concatenate(
        [b["rw"], b["vmask"], b["nmask"], b["seedmask"],
         (b["lens"] | (md << 16))[:, None]], axis=1).astype(np.int64))
    rows = tpigeon.words_to_device(iid.rows, "cpu")
    P = 16
    pstart = torch.arange(P, dtype=torch.int64) * 1000
    pread = torch.arange(P, dtype=torch.int64) % 4
    ok = torch.ones(P, dtype=torch.bool)
    n0 = (verify.WINDOW_VERIFY.launches, verify.GAPPED_SCREEN.launches)
    out = verify.window_verify(rows, combo, pstart, pread, ok, ok, G=2,
                               max_seed_diff=2)
    assert [tuple(x.shape) for x in out] == [(P,), (P,), (P,), (4,)]
    gidx = torch.arange(8, dtype=torch.int64)
    out = verify.gapped_screen(rows, combo, pstart, pread, ok, gidx,
                               torch.tensor(5), G=2, n=len(iid.text), opt=opt)
    assert tuple(out[0].shape) == (8, verify.GC_SLOTS)
    assert (verify.WINDOW_VERIFY.launches,
            verify.GAPPED_SCREEN.launches) == n0
    with pytest.raises(TypeError, match="combo"):
        verify.window_verify(rows, combo.to(torch.int32), pstart, pread, ok,
                             ok, G=2, max_seed_diff=2)
    with pytest.raises(TypeError, match="pstart"):
        verify.window_verify(rows, combo, pstart.to(torch.int32), pread, ok,
                             ok, G=2, max_seed_diff=2)
    with pytest.raises(TypeError, match="n_gate"):
        verify.gapped_screen(rows, combo, pstart, pread, ok, gidx, 5, G=2,
                             n=len(iid.text), opt=opt)
    with pytest.raises(ValueError, match="G="):
        verify.window_verify(rows, combo, pstart, pread, ok, ok, G=8,
                             max_seed_diff=2)
    assert RW == 8 and verify.WINDOW_VERIFY._lib is None
