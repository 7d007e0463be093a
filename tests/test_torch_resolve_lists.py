"""The port's per-read-list resolvers against ``hsa_tpu``'s, and against the
port's own array resolvers on the same occurrences.

Hits come from the port's oracle (``fmcore`` + ``oracle.bnb``) on seeded
genomes of 6-12 kbp with a repeat family, so that some reads have several
equal-best placements, truncated occurrence lists and XA alternates.  Each
package gets its own hit and occurrence objects with the same fields.
Exact everywhere: every record field and SAM byte equal.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest

import hsa_tpu.pipeline as jpipeline
import hsa_tpu_torch.pipeline as tpipeline
from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt as JAlnOpt
from hsa_tpu.config import PEOpt as JPEOpt
from hsa_tpu.config import SamseOpt as JSamseOpt
from hsa_tpu.io.fastx import RefMeta as JRefMeta
from hsa_tpu.oracle.bnb import Hit as JHit
from hsa_tpu.resolve import cigar as jcigar
from hsa_tpu.resolve import sampe as jsampe
from hsa_tpu.resolve import samse as jsamse
from hsa_tpu_torch import fmcore, refpack
from hsa_tpu_torch.config import AlnOpt, PEOpt, SamseOpt
from hsa_tpu_torch.io.fastx import RefMeta
from hsa_tpu_torch.oracle.bnb import align_read
from hsa_tpu_torch.resolve import cigar as tcigar
from hsa_tpu_torch.resolve import sampe as tsampe
from hsa_tpu_torch.resolve import samse as tsamse
from hsa_tpu_torch.search.pigeon import occ_lists_to_arrays

OPT = dict(max_diff=2)
RESCUE = functools.partial(tsampe._rescue_batch, device="cpu")


def _fields(rec):
    d = dict(vars(rec))
    d["tags"] = dict(d["tags"])
    return d


def _sam(recs):
    return [r.to_sam() for r in recs]


def _jhits(per_read):
    return [[JHit(*dataclasses.astuple(h)) for h in hits] for hits in per_read]


def _jocc(lists):
    return [[jsamse.Occurrence(**vars(o)) for o in lst] for lst in lists]


@pytest.fixture(scope="module")
def ref():
    """Two sequences (8,000 and 4,000 bp) with a 60 bp unit repeated five
    times in the first and twice in the second, and a second unit once in
    each, one base apart; both packages' metas, the port's FM indexes and a
    locate function."""
    rs = np.random.RandomState(41)
    unit = rs.randint(0, 4, 60).astype(np.int8)
    c1 = rs.randint(0, 4, 8000).astype(np.int8)
    c2 = rs.randint(0, 4, 4000).astype(np.int8)
    for p in (1000, 2500, 4000, 5500, 7000):
        c1[p:p + 60] = unit
    for p in (1200, 3000):
        c2[p:p + 60] = unit
    c1[6200:6260] = c2[2000:2060]
    c2[2030] = (c2[2030] + 1) % 4
    text = np.concatenate([c1, c2])
    kw = dict(names=["c1", "c2"], starts=np.asarray([0, 8000], np.int64),
              lengths=np.asarray([8000, 4000], np.int64), total=12000)
    fm = fmcore.FMIndex.build(text)
    fm_r = fmcore.FMIndex.build(text[::-1].copy())

    def locate_fn(ranks):
        return np.array([fm.locate(int(r)) for r in ranks], np.int64)

    def search(reads):
        opt = AlnOpt(**OPT)
        return ([align_read(fm, fm_r, np.asarray(r, np.int8), opt)
                 for r in reads],
                [align_read(fm, fm_r, alphabet.revcomp(np.asarray(r, np.int8)),
                            opt) for r in reads])

    return text, RefMeta(**kw), JRefMeta(**kw), locate_fn, search


def se_reads(text, rs):
    reads = []
    for j in range(16):
        p = int(rs.randint(0, len(text) - 70))
        r = text[p:p + 61].copy()
        if j % 4 == 1:
            r = np.delete(r, 25)
        elif j % 4 == 2:
            r = np.insert(r, 30, (r[30] + 1) % 4)
        r = r[:60]
        r[rs.choice(60, j % 3, replace=False)] += 1
        r %= 4
        reads.append(alphabet.revcomp(r) if j % 2 else r)
    reads.append(text[1000:1060].copy())                 # the repeat unit
    r = text[2500:2560].copy()
    r[10] = (r[10] + 1) % 4
    reads.append(r)                                      # near the repeat
    reads.append(text[6200:6260].copy())                 # an XA alternate
    reads.append(text[7970:8030].copy())                 # across c1 | c2
    reads.append(rs.randint(0, 4, 60).astype(np.int8))   # junk
    return reads


@pytest.fixture(scope="module")
def se(ref):
    text, meta, jmeta, locate_fn, search = ref
    reads = se_reads(text, np.random.RandomState(5))
    hf, hr = search(reads)
    names = [f"r{j}" for j in range(len(reads))]
    quals = ["".join(chr(33 + (i * 7 + j) % 40) for i in range(len(r)))
             for j, r in enumerate(reads)]
    return reads, names, quals, hf, hr


@pytest.mark.parametrize("max_occ", [512, 3])
def test_collect_occurrences_ref(ref, se, max_occ):
    """The loop twin equals the reference's and the port's vectorized one;
    ``max_occ`` = 3 truncates the repeat's reads."""
    *_, locate_fn, _ = ref
    _, _, _, hf, hr = se
    got, gtr = tsamse.collect_occurrences_ref(hf, hr, locate_fn, max_occ)
    want, wtr = jsamse.collect_occurrences_ref(_jhits(hf), _jhits(hr),
                                               locate_fn, max_occ)
    assert gtr == wtr
    assert [[vars(o) for o in lst] for lst in got] == \
        [[vars(o) for o in lst] for lst in want]
    vec, vtr = tsamse.collect_occurrences(hf, hr, locate_fn, max_occ)
    assert list(vtr) == gtr
    assert [[vars(o) for o in lst] for lst in vec] == \
        [[vars(o) for o in lst] for lst in got]
    assert any(gtr) == (max_occ == 3)


def test_span_possible(ref):
    _, meta, jmeta, *_ = ref
    for pos in (0, 7900, 7940, 7941, 7950, 7999, 8000, 11940, 11941, 11999):
        for ngapo, ngape in ((0, 0), (1, 0), (1, 3)):
            o = tsamse.Occurrence(pos, 0, 0, 0, ngapo, ngape)
            jo = jsamse.Occurrence(pos, 0, 0, 0, ngapo, ngape)
            assert tsamse._span_possible(meta, o, 60) == \
                jsamse._span_possible(jmeta, jo, 60)


@pytest.mark.parametrize("max_occ", [512, 3])
def test_resolve_batch_se(ref, se, max_occ):
    text, meta, jmeta, locate_fn, _ = ref
    reads, names, quals, hf, hr = se
    got = tsamse.resolve_batch_se(text, meta, reads, names, quals, hf, hr,
                                  locate_fn, AlnOpt(**OPT), SamseOpt(),
                                  read_offset=7, max_occ=max_occ)
    want = jsamse.resolve_batch_se(text, jmeta, reads, names, quals,
                                   _jhits(hf), _jhits(hr), locate_fn,
                                   JAlnOpt(**OPT), JSamseOpt(), read_offset=7,
                                   max_occ=max_occ)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert sum(not r.flag & 4 for r in got) >= 15
    assert any("XA" in r.tags for r in got) and got[-1].flag & 4
    assert any(r.tags.get("XT") == "R" for r in got)
    assert any("X1" not in r.tags and not r.flag & 4 for r in got) == \
        (max_occ == 3)


def test_resolve_from_occurrences(ref, se):
    """With truncation and the engine's uncounted candidates (``c2_extra``)
    against the reference's, and against the port's array resolver on the
    same occurrences."""
    text, meta, jmeta, locate_fn, _ = ref
    reads, names, quals, hf, hr = se
    occs, trunc = tsamse.collect_occurrences_ref(hf, hr, locate_fn, 4)
    c2x = np.arange(len(reads)) % 5 * (np.arange(len(reads)) % 3 == 0) * 60
    got = tsamse.resolve_from_occurrences(text, meta, reads, names, quals,
                                          occs, trunc, AlnOpt(**OPT),
                                          SamseOpt(), read_offset=2,
                                          c2_extra=c2x)
    want = jsamse.resolve_from_occurrences(text, jmeta, reads, names, quals,
                                           _jocc(occs), trunc, JAlnOpt(**OPT),
                                           JSamseOpt(), read_offset=2,
                                           c2_extra=c2x)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    arr = tsamse.resolve_from_occ_arrays(
        text, meta, tpipeline.ReadBatch.from_reads(reads), names, quals,
        occ_lists_to_arrays(occs), trunc, AlnOpt(**OPT), SamseOpt(),
        read_offset=2, c2_extra=c2x)
    assert _sam(arr) == _sam(got)
    assert any(r.mapq < 37 and r.tags.get("X0") == 1 for r in got)


# -- paired ends ------------------------------------------------------------------

def pe_reads(text, rs, n=14, L=60, isize=300):
    """FR pairs, a mismatch in every third end 1, a rescued end 2 (six
    substitutions), a pair with a junk end 1, a discordant pair (end 2 from
    the other sequence) and a pair whose end 1 is the repeat unit."""
    r1s, r2s = [], []
    for j in range(n):
        p = int(rs.randint(100, 7500 - isize))
        r1 = text[p:p + L].copy()
        r2 = alphabet.revcomp(text[p + isize - L:p + isize])
        if j % 3 == 0:
            r1[rs.randint(0, L)] += rs.randint(1, 4)
            r1 %= 4
        if j == 4:
            for q in (5, 14, 23, 32, 41, 50):
                r2[q] = (r2[q] + 1) % 4
        r1s.append(r1)
        r2s.append(r2)
    r1s.append(rs.randint(0, 4, L).astype(np.int8))
    r2s.append(alphabet.revcomp(text[600:660]))
    r1s.append(text[5000:5060].copy())
    r2s.append(alphabet.revcomp(text[10000:10060]))
    r1s.append(text[5500:5560].copy())
    r2s.append(alphabet.revcomp(text[5740:5800]))
    return r1s, r2s


@pytest.fixture(scope="module")
def pe(ref):
    text, *_, search = ref
    r1s, r2s = pe_reads(text, np.random.RandomState(9))
    names = [f"p{j}" for j in range(len(r1s))]
    quals = ["I" * len(r) for r in r1s]
    return r1s, r2s, names, quals, search(r1s), search(r2s)


def test_resolve_batch_pe(ref, pe):
    text, meta, jmeta, locate_fn, _ = ref
    r1s, r2s, names, quals, h1, h2 = pe
    got = tsampe.resolve_batch_pe(text, meta, r1s, r2s, names, quals, None,
                                  h1, h2, locate_fn, AlnOpt(**OPT), PEOpt(),
                                  read_offset=3, rescue=RESCUE)
    want = jsampe.resolve_batch_pe(text, jmeta, r1s, r2s, names, quals, None,
                                   tuple(map(_jhits, h1)),
                                   tuple(map(_jhits, h2)), locate_fn,
                                   JAlnOpt(**OPT), JPEOpt(), read_offset=3)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    sam = _sam(got)
    assert any("XT:Z:M" in line for line in sam)               # rescued
    assert got[2 * 14].flag & 4 and not got[2 * 14 + 1].flag & 4  # junk end 1
    assert got[2 * 15].rnext == "c2" and not got[2 * 15].flag & 2  # discordant
    assert any(r.mapq > 37 for r in got)                      # paired MAPQ


def test_resolve_pe_from_occurrences(ref, pe):
    """Truncated lists and uncounted candidates against the reference's,
    and against the port's array resolver on the same occurrences."""
    text, meta, jmeta, locate_fn, _ = ref
    r1s, r2s, names, quals, h1, h2 = pe
    o1, t1 = tsamse.collect_occurrences_ref(*h1, locate_fn, 4)
    o2, t2 = tsamse.collect_occurrences_ref(*h2, locate_fn, 4)
    B = len(r1s)
    c2x1 = np.arange(B) % 2 * 30
    c2x2 = np.arange(B) % 3 * 7
    kw = dict(read_offset=1, trunc1=t1, trunc2=t2, c2x1=c2x1, c2x2=c2x2)
    got = tsampe.resolve_pe_from_occurrences(
        text, meta, r1s, r2s, names, quals, quals, o1, o2, AlnOpt(**OPT),
        PEOpt(), rescue=RESCUE, **kw)
    want = jsampe.resolve_pe_from_occurrences(
        text, jmeta, r1s, r2s, names, quals, quals, _jocc(o1), _jocc(o2),
        JAlnOpt(**OPT), JPEOpt(), **kw)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    arr = tsampe.resolve_pe_from_occ_arrays(
        text, meta, r1s, r2s, names, quals, quals, occ_lists_to_arrays(o1 + o2),
        AlnOpt(**OPT), PEOpt(), read_offset=1,
        trunc=np.concatenate([t1, t2]), c2x=np.concatenate([c2x1, c2x2]),
        rescue=RESCUE)
    assert _sam(arr) == _sam(got)


def test_fit_in_window():
    rs = np.random.RandomState(2)
    for j in range(12):
        w = rs.randint(0, 4, 200).astype(np.int8)
        p = rs.randint(0, 120)
        read = w[p:p + 61].copy()
        if j % 3 == 1:
            read = np.delete(read, 20)
        elif j % 3 == 2:
            read = np.insert(read, 30, 1)
        read = read[:60]
        read[rs.choice(60, j % 4, replace=False)] = 4 if j == 7 else 0
        for args in ((read, w), (read, w[:40])):
            assert tsampe.fit_in_window(*args, 3, 11, 4) == \
                jsampe.fit_in_window(*args, 3, 11, 4)
        got = tsampe.fit_in_window(read, w, 3, 11, 4)
        Lmax = len(read)
        native = refpack.glocal_batch(
            read.astype(np.uint8)[None], np.zeros(1, np.int64),
            np.asarray([60], np.int32), w.astype(np.uint8), np.zeros(1, np.int64),
            np.asarray([200], np.int32), 3, 11, 4)
        assert (int(native[0][0]), int(native[1][0])) == got[:2], Lmax
        runs = itertools.groupby(native[2][0].tolist())
        assert [("MID"[op], len(list(g))) for op, g in runs] == got[2]


def _occ(mod, rs, n, L=60, strand=None):
    return [mod.Occurrence(int(rs.randint(0, 3000)),
                           int(rs.randint(0, 2)) if strand is None else strand,
                           int(rs.randint(0, 3)) * 3, 0, 0, 0)
            for _ in range(n)]


def test_infer_isize():
    rs = np.random.RandomState(4)
    for n_pairs in (5, 8, 40):
        pairs, jpairs, L1, L2 = [], [], [], []
        for j in range(n_pairs):
            p = int(rs.randint(0, 5000))
            ins = int(rs.normal(300, 25)) if j % 9 else 2000
            a = (p, 0, 0, 0, 0, 0)
            b = (p + ins - 60, 1, 3, 1, 0, 0)
            if j % 7 == 3:
                b = (p + 100, 0, 0, 0, 0, 0)              # same strand
            pairs.append(([tsamse.Occurrence(*a)], [tsamse.Occurrence(*b)]))
            jpairs.append(([jsamse.Occurrence(*a)], [jsamse.Occurrence(*b)]))
            L1.append(60)
            L2.append(60)
        pairs.append(([], [tsamse.Occurrence(1, 0, 0, 0, 0, 0)]))
        jpairs.append(([], [jsamse.Occurrence(1, 0, 0, 0, 0, 0)]))
        L1.append(60)
        L2.append(60)
        assert tsampe.infer_isize(pairs, L1, L2, 500) == \
            jsampe.infer_isize(jpairs, L1, L2, 500)


def test_pair_mapq_grid():
    for q1 in (0, 1, 23, 37):
        for q2 in (0, 25, 37):
            for n_best in (1, 2):
                for subo in (None, 3, 6, 30):
                    assert tsampe.pair_mapq(q1, q2, n_best, subo, 0, 3) == \
                        jsampe.pair_mapq(q1, q2, n_best, subo, 0, 3)


@pytest.mark.parametrize("stats", [(300.0, 20.0), (None, None)])
def test_best_pair_batch(stats):
    """The matrix form against the loop form and the reference's, windows
    past ``_PAIR_W`` (the loop's share) and empty ends included."""
    mean, std = stats
    rs = np.random.RandomState(6)
    w1, w2, jw1, jw2 = [], [], [], []
    for j in range(40):
        n1, n2 = (int(x) for x in rs.randint(0, 6, 2))
        if j % 13 == 5:
            n1 = 20
        base = int(rs.randint(0, 2000))
        a = [(base + int(rs.randint(-50, 50)), int(rs.randint(0, 2)),
              int(rs.randint(0, 3)) * 3, 0, int(rs.randint(0, 2)), 0)
             for _ in range(n1)]
        b = [(base + int(rs.randint(150, 400)), int(rs.randint(0, 2)),
              int(rs.randint(0, 3)) * 3, 0, 0, 0) for _ in range(n2)]
        w1.append([tsamse.Occurrence(*x) for x in a])
        w2.append([tsamse.Occurrence(*x) for x in b])
        jw1.append([jsamse.Occurrence(*x) for x in a])
        jw2.append([jsamse.Occurrence(*x) for x in b])
    lens = [60] * 40
    got = tsampe._best_pair_batch(w1, w2, lens, lens, mean, std, 500)
    want = jsampe._best_pair_batch(jw1, jw2, lens, lens, mean, std, 500)

    def plain(res):
        return [None if r is None else (r[0], vars(r[1]), vars(r[2]), *r[3:])
                for r in res]

    assert plain(got) == plain(want)
    loop = [tsampe._best_pair(a, b, 60, 60, mean, std, 500) if a and b
            else None for a, b in zip(w1, w2)]
    assert plain(got) == plain(loop)
    assert sum(r is not None for r in got) >= 10


def test_banded_global_ref():
    """The numpy DP against the reference's and the native library's."""
    rs = np.random.RandomState(8)
    for j in range(10):
        ref = rs.randint(0, 4, 90).astype(np.int8)
        read = ref[:71].copy()
        if j % 2:
            read = np.delete(read, 20 + j)
        else:
            read = np.insert(read, 15 + j, 2)
        read = read[:60]
        read[rs.choice(60, j % 3, replace=False)] = 4 if j == 4 else 1
        for band in (1, 3, 8):
            got = tcigar.banded_global_ref(read, ref, 3, 11, 4, band)
            assert got == jcigar.banded_global_ref(read, ref, 3, 11, 4, band)
            assert got == tcigar.banded_global(read, ref, 3, 11, 4, band)
