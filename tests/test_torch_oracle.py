"""The port's oracle path against ``hsa_tpu``'s: the numpy FM index
(``fmcore``), the branch-and-bound search (``oracle.bnb``), the mapping
quality (``resolve.mapq``) and ``oracle_align``/``oracle_align_pe``, then
the port's own engines against its oracle (the counterparts of
tests/test_resolve.py and tests/test_sampe.py's parity tests).

Exact everywhere: every field, hit and SAM byte equal.  The port runs on
the CPU, so its mate rescue screens with the plain ``glocal_screen``.
"""

import dataclasses

import numpy as np
import pytest

import hsa_tpu.fmcore as jfm
import hsa_tpu.pipeline as jpipeline
import hsa_tpu.resolve.mapq as jmapq
import hsa_tpu_torch.fmcore as tfm
import hsa_tpu_torch.pipeline as tpipeline
import hsa_tpu_torch.resolve.mapq as tmapq
from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt as JAlnOpt
from hsa_tpu.config import PEOpt as JPEOpt
from hsa_tpu.io.fastx import RefMeta as JRefMeta
from hsa_tpu.oracle import bnb as jbnb
from hsa_tpu_torch import refpack as trefpack
from hsa_tpu_torch.config import AlnOpt, PEOpt
from hsa_tpu_torch.io.fastx import RefMeta
from hsa_tpu_torch.oracle import bnb as tbnb


# -- fmcore -------------------------------------------------------------------

def _text(n):
    if n == "repetitive":
        unit = np.random.RandomState(3).randint(0, 4, 37).astype(np.int8)
        return np.concatenate([np.tile(unit, 20), [0] * 40,
                               np.tile(unit[:11], 9)]).astype(np.int8)
    return np.random.RandomState(n).randint(0, 4, n).astype(np.int8)


@pytest.mark.parametrize("n", [1, 13, 257, 1000, "repetitive"])
def test_fmindex_bit_equal(n):
    t = _text(n)
    want, got = jfm.FMIndex.build(t, sa_intv=4), tfm.FMIndex.build(t, sa_intv=4)
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    np.testing.assert_array_equal(got.sa,
                                  trefpack.suffix_array(t.astype(np.uint8)))
    N = len(t)
    ranks = np.arange(-1, N + 1)
    for a in range(4):
        np.testing.assert_array_equal(got.occ(a, ranks), want.occ(a, ranks))
    rs = np.random.RandomState(len(t))
    k = rs.randint(0, N + 1, 64)
    l = np.minimum(k + rs.randint(0, 9, 64), N)
    for a in range(4):
        for g, w in zip(got.extend(a, k, l), want.extend(a, k, l)):
            np.testing.assert_array_equal(g, w)
    for r in range(N + 1):
        assert got.bwt_char(r) == want.bwt_char(r)
        assert got.lf(r) == want.lf(r)
        assert got.locate(r) == want.locate(r)
    for _ in range(40):
        p = rs.randint(0, N)
        pat = t[p:p + rs.randint(1, 12)].copy()
        if rs.rand() < 0.3:
            pat[rs.randint(0, len(pat))] = rs.randint(0, 5)
        iv = got.exact_interval(pat)
        assert iv == want.exact_interval(pat)
        if iv[0] <= iv[1]:
            np.testing.assert_array_equal(got.locate_interval(*iv),
                                          want.locate_interval(*iv))
    rev = tfm.FMIndex.build(t[::-1].copy(), sa_intv=4)
    jrev = jfm.FMIndex.build(t[::-1].copy(), sa_intv=4)
    for _ in range(10):
        read = rs.randint(0, 5, rs.randint(1, 40)).astype(np.int8)
        np.testing.assert_array_equal(tfm.cal_width(rev, read),
                                      jfm.cal_width(jrev, read))


# -- the branch-and-bound search ---------------------------------------------

@pytest.fixture(scope="module")
def genome():
    rs = np.random.RandomState(5)
    t = rs.randint(0, 4, 4000).astype(np.int8)
    return (t, tfm.FMIndex.build(t), tfm.FMIndex.build(t[::-1].copy()),
            jfm.FMIndex.build(t), jfm.FMIndex.build(t[::-1].copy()))


def planted(t, kind, rs):
    """(read, option overrides) for one kind of planted read."""
    p = int(rs.randint(100, len(t) - 200))
    r = t[p:p + 60].copy()
    if kind in ("mm1", "mm2"):
        for q in (17, 33)[:int(kind[-1])]:
            r[q] = (r[q] + 1) % 4
    elif kind == "deletion":
        r = np.delete(t[p:p + 61], 30)
    elif kind == "insertion":
        r = np.insert(r, 25, (r[25] + 2) % 4)[:60]
    elif kind == "N":
        r[40] = 4
    elif kind == "junk":
        r = rs.randint(0, 4, 60).astype(np.int8)
    elif kind == "seed":             # two mismatches in the 3' seed of 20
        r[45], r[52] = (r[45] + 1) % 4, (r[52] + 3) % 4
        return r, dict(max_diff=3, seed_len=20, max_seed_diff=1)
    elif kind == "revcomp":
        r = alphabet.revcomp(r)
    return r, {}


KINDS = ["exact", "mm1", "mm2", "deletion", "insertion", "N", "junk", "seed",
         "revcomp"]


@pytest.mark.parametrize("kind", KINDS)
def test_bnb_hits_equal(genome, kind):
    t, fm, fm_r, jfm_f, jfm_r = genome
    r, kw = planted(t, kind, np.random.RandomState(KINDS.index(kind)))
    kw = {"max_diff": 2, **kw}
    opt, jopt = AlnOpt(**kw), JAlnOpt(**kw)

    def tup(hits):
        return [dataclasses.astuple(h) for h in hits]

    got = tbnb.align_read(fm, fm_r, r, opt)
    assert tup(got) == tup(jbnb.align_read(jfm_f, jfm_r, r, jopt))
    D = tfm.cal_width(fm_r, r)
    for d in (D, np.zeros_like(D)):      # pruning changes the work only
        hits = tbnb.match_gap(fm, r, d, opt)
        assert tup(hits) == tup(jbnb.match_gap(jfm_f, r, d, jopt))
        assert tup(hits) == tup(got)
    if kind in ("exact", "mm1", "mm2", "deletion", "insertion", "N"):
        assert got and got[0].width == 1
    if kind in ("junk", "revcomp"):
        assert not got


# -- mapping quality -----------------------------------------------------------

@pytest.mark.parametrize("fn", ["g_log_n", "approx_mapq", "trunc_capped_mapq"])
def test_mapq_grid(fn):
    if fn == "g_log_n":
        for n in range(0, 300):
            assert tmapq.g_log_n(n) == jmapq.g_log_n(n)
    elif fn == "approx_mapq":
        for c1 in range(4):
            for c2 in (0, 1, 2, 9, 10, 254, 255, 256, 400):
                for nmm in range(4):
                    for md in (0, 2, 3, 5):
                        assert tmapq.approx_mapq(c1, c2, nmm, md) == \
                            jmapq.approx_mapq(c1, c2, nmm, md)
    else:
        for q in (0, 3, 23, 25, 37, 60):
            for c2 in (-1, 0, 1, 7, 255, 300):
                for missed in (-2, 0, 1, 30):
                    assert tmapq.trunc_capped_mapq(q, c2, missed) == \
                        jmapq.trunc_capped_mapq(q, c2, missed)


# -- the slice whole: oracle_align and oracle_align_pe ----------------------------

def _two_chroms():
    rs = np.random.RandomState(7)
    c1 = rs.randint(0, 4, 3000).astype(np.int8)
    c2 = rs.randint(0, 4, 2000).astype(np.int8)
    text = np.concatenate([c1, c2])
    kw = dict(names=["chr1", "chr2"], starts=np.asarray([0, 3000], np.int64),
              lengths=np.asarray([3000, 2000], np.int64), total=5000)
    return text, RefMeta(**kw), JRefMeta(**kw)


def se_reads(text, rs):
    """tests/test_resolve.py's planted reads: clean, a mismatch, reverse
    strand, a deletion, an insertion, junk, across the boundary; plus an N."""
    reads = [text[100:160].copy(), text[3500:3560].copy()]
    m = text[700:760].copy()
    m[20] = (m[20] + 1) % 4
    reads += [m, alphabet.revcomp(text[3900:3960])]
    reads.append(np.delete(text[1500:1561], 30))
    reads.append(np.insert(text[4200:4259], 30, 0))
    reads.append(rs.randint(0, 4, 50).astype(np.int8))
    reads.append(text[2970:3030].copy())
    n = text[2000:2060].copy()
    n[12] = 4
    reads.append(n)
    return reads


def test_oracle_align_byte_equal():
    text, meta, jmeta = _two_chroms()
    reads = se_reads(text, np.random.RandomState(11))
    names = [f"r{j}" for j in range(len(reads))]
    quals = ["I" * len(r) for r in reads]
    got = tpipeline.oracle_align(text, meta, reads, names, quals,
                                 AlnOpt(max_diff=2), read_offset=3)
    want = jpipeline.oracle_align(text, jmeta, reads, names, quals,
                                  JAlnOpt(max_diff=2), read_offset=3)
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
    assert sum(not r.flag & 4 for r in got) == 7
    assert any("D" in r.cigar for r in got) and any("I" in r.cigar for r in got)


def pe_reads(text, rs, n=12, L=60, isize=300):
    """tests/test_sampe.py's parity pairs: FR pairs, a mismatch in every
    third end 1, a rescued end 2 (six substitutions), a junk end 1, and a
    discordant pair (end 2 far away)."""
    reads1, reads2 = [], []
    for j in range(n):
        p = rs.randint(0, len(text) - isize - 10)
        r1 = text[p:p + L].copy()
        r2 = alphabet.revcomp(text[p + isize - L:p + isize])
        if j % 3 == 0:
            q = rs.randint(0, L)
            r1[q] = (r1[q] + rs.randint(1, 4)) % 4
        if j == 5:
            for q in (5, 14, 23, 32, 41, 50):
                r2[q] = (r2[q] + 1) % 4
        reads1.append(r1)
        reads2.append(r2)
    reads1.append(rs.randint(0, 4, L).astype(np.int8))
    reads2.append(alphabet.revcomp(text[100:160]))
    reads1.append(text[500:560].copy())
    reads2.append(alphabet.revcomp(text[9000:9060]))
    return reads1, reads2


@pytest.fixture(scope="module")
def pe_text():
    rs = np.random.RandomState(13)
    text = rs.randint(0, 4, 12_000).astype(np.int8)
    kw = dict(names=["c1"], starts=np.zeros(1, np.int64),
              lengths=np.asarray([len(text)], np.int64), total=len(text))
    return text, RefMeta(**kw), JRefMeta(**kw)


def test_oracle_align_pe_byte_equal(pe_text):
    text, meta, jmeta = pe_text
    reads1, reads2 = pe_reads(text, np.random.RandomState(31))
    names = [f"pair{j}" for j in range(len(reads1))]
    got = tpipeline.oracle_align_pe(text, meta, reads1, reads2, names, None,
                                    None, AlnOpt(max_diff=2), PEOpt(),
                                    device="cpu")
    want = jpipeline.oracle_align_pe(text, jmeta, reads1, reads2, names, None,
                                     None, JAlnOpt(max_diff=2), JPEOpt())
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
    sam = [r.to_sam() for r in got]
    assert any("XT:Z:M" in line for line in sam)         # a rescue
    assert got[-2].rnext == "=" and not got[-2].flag & 2   # discordant


# -- the port's engines against its own oracle ------------------------------------

@pytest.fixture(scope="module")
def se_index(tmp_path_factory):
    """The two-sequence genome as a FASTA, indexed by the port."""
    tmp = tmp_path_factory.mktemp("oracle_se")
    text, _, _ = _two_chroms()
    fa = tmp / "ref.fa"
    fa.write_text(f">chr1\n{alphabet.decode(text[:3000])}\n"
                  f">chr2 extra description\n{alphabet.decode(text[3000:])}\n")
    return text, tpipeline.build_index(str(fa), str(tmp / "ref"))


@pytest.mark.parametrize("engine", ["beam", "auto"])
def test_engine_equals_oracle_se(se_index, engine):
    """tests/test_resolve.py::test_record_parity_device_vs_oracle on the
    port: W=512 at max_diff=2, byte-equal to the port's oracle."""
    text, idx = se_index
    opt = AlnOpt(max_diff=2)
    al = tpipeline.Aligner(idx, opt, engine=engine, device="cpu")
    reads = se_reads(text, np.random.RandomState(11))
    names = [f"r{j}" for j in range(len(reads))]
    got = al.align(reads, names, None, beam_width=512)
    want = tpipeline.oracle_align(al.text, al.meta, reads, names, None, opt)
    if engine == "beam":
        assert int(al.last_overflow[0].sum()) == 0
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]


@pytest.mark.parametrize("engine", ["beam", "auto"])
def test_engine_equals_oracle_pe(pe_text, engine):
    """tests/test_sampe.py::test_pe_record_parity_device_vs_oracle on the
    port: W=256 at max_diff=2, byte-equal to the port's oracle."""
    text, meta, _ = pe_text
    from hsa_tpu_torch.index.layout import build_device_index
    al = tpipeline.Aligner.from_arrays(build_device_index(text), text, meta,
                                       AlnOpt(max_diff=2), engine=engine,
                                       device="cpu")
    reads1, reads2 = pe_reads(text, np.random.RandomState(31))
    names = [f"pair{j}" for j in range(len(reads1))]
    got = al.align_pe(reads1, reads2, names, beam_width=256)
    want = tpipeline.oracle_align_pe(text, meta, reads1, reads2, names, None,
                                     None, AlnOpt(max_diff=2), device="cpu")
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
