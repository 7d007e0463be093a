"""The port's pigeonhole engine against ``hsa_tpu``'s, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function (run
eagerly on the CPU, as ``tests/test_pigeon.py`` runs it) and through its
torch counterpart on ``device="cpu"``.  Everything here is integer work, so
the tolerance is 0: every ``PigeonResult`` field must be equal in dtype,
shape and value (dead lanes included), and every SAM byte-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu import alphabet
from hsa_tpu import refpack as jrefpack
from hsa_tpu.config import AlnOpt
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.search import exact as jexact
from hsa_tpu.search import pigeon as jpigeon
from hsa_tpu_torch import refpack as trefpack
from hsa_tpu_torch.index.layout import to_device
from hsa_tpu_torch.search import exact as texact
from hsa_tpu_torch.search import pigeon as tpigeon

OPT_MM = AlnOpt(max_diff=2, max_gapo=0)
OPT_GAP = AlnOpt(max_diff=2, max_gapo=1)
SEG_CAP = 8      # small cap so modest copy numbers exercise the paths


class Genome:
    """A text with its index in both packages' device forms."""

    def __init__(self, text):
        self.text = text
        self.di = build_device_index(text, sa_intv=8)
        self.dj = self.di.as_jax()
        self.dt = to_device(self.di, "cpu")
        self.rows = jpigeon.pack_text_rows(text)


def repeat_text(seed=5, n=60_000, unit_len=300, copies=40, div=0.0):
    """iid background + one repeat family of ``copies`` copies in the first
    half (tests/test_pigeon_repeats.py): exact copies, or with ``div``
    copies that differ from the consensus at about that share of bases."""
    rs = np.random.RandomState(seed)
    g = rs.randint(0, 4, n).astype(np.int8)
    unit = rs.randint(0, 4, unit_len).astype(np.int8)
    starts = []
    step = (n // 2) // (copies + 2)
    for i in range(copies):
        u = unit.copy()
        if div:
            m = rs.rand(unit_len) < div
            u[m] = (u[m] + rs.randint(1, 4, int(m.sum()))) % 4
        p = (i + 1) * step
        g[p:p + unit_len] = u
        starts.append(p)
    return g, np.asarray(starts)


@pytest.fixture(scope="module")
def iid():
    return Genome(np.random.RandomState(11).randint(0, 4, 20_000)
                  .astype(np.int8))


@pytest.fixture(scope="module")
def rep():
    """The exact repeat family, plus the last 8 bases of one background
    read planted at 30 more places (a wide anchor whose full segment is
    unique)."""
    text, copies = repeat_text()
    anchor = text[1000 + 82:1000 + 90].copy()
    for i in range(30):
        q = 31_000 + i * 700
        text[q:q + 8] = anchor
    g = Genome(text)
    g.copies = copies
    return g


def sample_reads(text, rs, n, L=60, k=2, with_n=0, indel=False, lo=0,
                 hi=None):
    """Reads of ``L`` bp cut from ``text[lo:hi]`` with up to ``k``
    substitutions, ``with_n`` Ns and, with ``indel``, a 1-2 bp insertion
    or deletion in every second read."""
    hi = len(text) if hi is None else hi
    out = []
    for j in range(n):
        p = rs.randint(lo, hi - L - 4)
        r = text[p:p + L + 3].copy()
        if indel and j % 2:
            t, g = rs.randint(8, L - 12), rs.randint(1, 3)
            if rs.randint(2):
                r = np.concatenate([r[:t], r[t + g:]])
            else:
                r = np.concatenate([r[:t], rs.randint(0, 4, g).astype(np.int8),
                                    r[t:]])
        r = r[:L].copy()
        for _ in range(rs.randint(0, k + 1)):
            q = rs.randint(0, L)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        for _ in range(with_n):
            r[rs.randint(0, L)] = 4
        out.append(r.astype(np.int8))
    return out


def assert_same_arrays(want, got, what):
    want = np.asarray(want)
    assert want.dtype == got.dtype and want.shape == got.shape, \
        (what, want.dtype, got.dtype, want.shape, got.shape)
    np.testing.assert_array_equal(want, got, err_msg=what)


def search_both(g, reads, opt, md_val, n_seg, *, K=0, tail=3, seg_phase=False,
                masks=True, **kw):
    """The JAX and the torch ``pigeon_search`` on the same packed batch;
    asserts every field equal and returns the (host) result."""
    both = list(reads) + [alphabet.revcomp(r) for r in reads]
    b = jpigeon.pack_pigeon_batch(both, n_seg=n_seg, seed_len=opt.seed_len,
                                  kmer_k=K, anchor_tail=tail,
                                  seg_phase=seg_phase)
    md = np.full(len(both), md_val, np.int32)
    vm, sm = (b["vmask"], b["seedmask"]) if masks else (None, None)
    seed_j = seed_t = None
    if K:
        tkj, tlj = jexact.kmer_table(g.dj, K)
        seed_j = (tkj, tlj, jnp.asarray(b["kmer"]), jnp.asarray(b["kmer_ok"]),
                  jnp.asarray(b["seg_short"]))
        seed_t = (np.asarray(tkj), np.asarray(tlj), b["kmer"], b["kmer_ok"],
                  b["seg_short"])

    def J(x):
        return None if x is None else jnp.asarray(x)

    want = jpigeon.pigeon_search(
        g.dj, jnp.asarray(g.rows), J(b["segs_rev"]), J(b["seg_lens"]),
        J(b["seg_off"]), J(b["rw"]), J(b["nmask"]), J(vm), J(sm),
        J(b["lens"]), J(md), opt, n_seg=n_seg, kmer_seed=seed_j,
        seg_phase=seg_phase, **kw)
    got = tpigeon.result_to_host(tpigeon.pigeon_search(
        g.dt, g.rows, b["segs_rev"], b["seg_lens"], b["seg_off"], b["rw"],
        b["nmask"], vm, sm, b["lens"], md, opt, n_seg=n_seg,
        kmer_seed=seed_t, seg_phase=seg_phase, **kw))
    for f in want._fields:
        assert_same_arrays(getattr(want, f), getattr(got, f), f)
    return got


# -- exact search, locate, K-mer table ----------------------------------------

@pytest.mark.parametrize("with_init", [False, True])
def test_exact_search_and_locate_all(iid, with_init):
    rs = np.random.RandomState(2)
    reads = sample_reads(iid.text, rs, 24, L=20, k=0)
    reads += [rs.randint(0, 4, 20).astype(np.int8) for _ in range(4)]
    reads[3][5] = 4                                    # an N kills the lane
    reads += [iid.text[40:52].copy(), np.zeros(0, np.int8)]   # short, empty
    rev, lens = jexact.pack_reads(reads, 20)
    rev_t, lens_t = texact.pack_reads(reads, 20)
    assert_same_arrays(rev, rev_t, "reads_rev")
    assert_same_arrays(lens, lens_t, "lens")
    init_j = init_t = None
    if with_init:       # seed with the intervals of the first 4 columns
        k0, l0, a0 = jexact.exact_search(iid.dj, jnp.asarray(rev[:, :4]),
                                         jnp.asarray(lens))
        init_j = (k0, l0, a0)
        init_t = tuple(torch.from_numpy(np.asarray(x).astype(
            np.bool_ if i == 2 else np.int64)) for i, x in enumerate(init_j))
        rev = rev[:, 4:]
    kj, lj, mj = jexact.exact_search(iid.dj, jnp.asarray(rev),
                                     jnp.asarray(lens), init=init_j)
    kt, lt, mt = texact.exact_search(iid.dt, rev, lens, init=init_t)
    np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
    assert mt[:24].sum() == 23 and not mt[3] and not mt[27]
    live = mt.numpy()
    np.testing.assert_array_equal(np.asarray(kj)[live], kt.numpy()[live])
    np.testing.assert_array_equal(np.asarray(lj)[live], lt.numpy()[live])
    pj, cj = jexact.locate_all(iid.dj, kj, lj, mj, 4)
    pt, ct = texact.locate_all(iid.dt, kt, lt, mt, 4)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    assert texact.NO_POS in pt.numpy()


@pytest.mark.parametrize("K", [4, 6])
def test_kmer_table(iid, K):
    tkj, tlj = jexact.kmer_table(iid.dj, K)
    tkt, tlt = texact.kmer_table(iid.dt, K, chunk=1 << 8)   # several chunks
    np.testing.assert_array_equal(np.asarray(tkj), tkt.numpy())
    np.testing.assert_array_equal(np.asarray(tlj), tlt.numpy())
    empty = tkt > tlt
    assert ((tkt[empty] == 1) & (tlt[empty] == 0)).all()


# -- pigeon_search, field by field ---------------------------------------------

def _edge_reads(text, L=60):
    """Reads that start within G of either end of the text, plain and with
    a deletion or an insertion near the middle."""
    n = len(text)
    out = []
    for p in (0, 1, 3, n - L, n - L - 2):
        out.append(text[p:p + L].copy())
    for p in (0, 2, n - L - 1):
        r = text[p:p + L + 1].copy()
        out.append(np.concatenate([r[:30], r[31:]]))           # deletion
        r = text[p:p + L - 1].copy()
        out.append(np.concatenate([r[:30], [(r[30] + 1) % 4], r[30:]])
                   .astype(np.int8))                           # insertion
    return out


# Most cases share one shape (16 reads of 60 bp, 3 segments, cand_cap 16), so
# that the reference's eager run compiles its operations once.
CASES = {
    # name: (reads(text, rs), opt, md, n_seg, search_both kwargs)
    "mismatch_only": (lambda t, rs: sample_reads(t, rs, 16), OPT_MM, 2, 3,
                      dict(cand_cap=16)),
    "gapped": (lambda t, rs: sample_reads(t, rs, 15, indel=True)
               + [rs.randint(0, 4, 60).astype(np.int8)], OPT_GAP, 2, 3,
               dict(cand_cap=16)),
    "reads_with_n_masks_derived": (
        lambda t, rs: sample_reads(t, rs, 16, k=1, with_n=1, indel=True),
        OPT_GAP, 2, 3, dict(cand_cap=16, masks=False)),
    "seg_phase_full_segments": (
        lambda t, rs: sample_reads(t, rs, 16, indel=True), OPT_GAP, 2, 3,
        dict(cand_cap=16, seg_phase=True)),
    "text_ends": (lambda t, rs: _edge_reads(t) + sample_reads(t, rs, 5),
                  OPT_GAP, 2, 3, dict(cand_cap=16)),
    "pool_and_gpool_overflow": (
        lambda t, rs: sample_reads(t, rs, 16, indel=True), OPT_GAP, 2, 3,
        dict(cand_cap=16, pool=24, gpool=8)),
    "n_seg_4_budget_3": (
        lambda t, rs: sample_reads(t, rs, 16, k=1, indel=True),
        AlnOpt(max_diff=3, max_gapo=1), 3, 4, dict(cand_cap=16)),
    "n_seg_6_kmer_seeded": (
        lambda t, rs: sample_reads(t, rs, 16, L=100, k=3, indel=True),
        AlnOpt(), 5, 6, dict(K=6, tail=3, cand_cap=16, masks=False)),
    "n_seg_6_kmer_seeded_seg_phase": (
        lambda t, rs: sample_reads(t, rs, 16, L=100, k=3, indel=True),
        AlnOpt(), 5, 6, dict(K=6, tail=3, cand_cap=16, masks=False,
                             seg_phase=True)),
    "reads_150bp_three_row_window": (
        lambda t, rs: sample_reads(t, rs, 8, L=150, indel=True),
        AlnOpt(max_diff=4, max_gapo=1), 4, 5, dict(cand_cap=8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_pigeon_search_fields_equal(iid, name):
    make, opt, md, n_seg, kw = CASES[name]
    reads = make(iid.text, np.random.RandomState(3))
    res = search_both(iid, reads, opt, md, n_seg, **kw)
    assert res.valid.sum() >= len(reads) // 2
    if "overflow" in name:
        assert res.n_missed.sum() > 0
    if name != "mismatch_only":
        assert int(res.n_gate) > 0          # the gapped screen had lanes


def _repeat_reads(g, L=90):
    """In-repeat reads (still wide after their whole segment: phase 2
    freezes them at the flank or at an N), a straddler, one whose two
    mismatches lie in the unique flank, a background read whose last 8-mer
    is planted 30 times (phase 1 narrows it), a chimera whose last segment
    is alien but for that 8-mer (phase 1 kills it), and background reads."""
    t, c = g.text, g.copies
    reads = [t[c[3] + 50:c[3] + 50 + L].copy(),
             t[c[9] + 100:c[9] + 100 + L].copy(),
             t[c[5] - 40:c[5] - 40 + L].copy()]
    r = t[c[7] - 10:c[7] - 10 + L].copy()
    r[2], r[6] = (r[2] + 1) % 4, (r[6] + 2) % 4
    reads.append(r)
    r = t[c[11] - 20:c[11] - 20 + L].copy()
    r[12] = 4                              # an N in the flank
    reads.append(r)
    reads.append(t[1000:1000 + L].copy())
    r = t[1000:1000 + L].copy()
    r[60:82] = np.random.RandomState(23).randint(0, 4, 22)
    reads.append(r)
    reads += sample_reads(t, np.random.RandomState(31), 9, L=L, lo=45_000,
                          hi=59_000)
    return reads


@pytest.mark.parametrize("name,kw", [
    ("full_segments", dict(cand_cap=16)),
    ("kmer_seeded", dict(cand_cap=16, K=6, tail=2)),
    ("kmer_seeded_seg_phase", dict(cand_cap=16, K=6, tail=2, seg_phase=True)),
    ("cand_cap_overflow", dict(cand_cap=4)),
    ("pool_overflow", dict(cand_cap=16, pool=48, gpool=16)),
])
def test_pigeon_search_repeat_genome(rep, name, kw):
    reads = _repeat_reads(rep)
    res = search_both(rep, reads, OPT_GAP, 2, 3, seg_cap=SEG_CAP, **kw)
    B, cc = len(reads), kw["cand_cap"]
    occs, fb, missed = tpigeon.pigeon_occurrences(res, B, OPT_GAP, cc)
    assert not fb.any()
    assert missed[0] > 0 and missed[3] > 0       # 40 copies >> seg_cap
    if name in ("full_segments", "kmer_seeded"):
        p = rep.copies[7] - 10       # found through the unique flank
        assert any(o.pos == p and o.nmm == 2 for o in occs[3])
        assert any(o.pos == 1000 and o.nmm == 0 for o in occs[5])
        assert missed[5] == 0 and occs[6] == [] and all(occs[7:])


# -- the fused upload buffer -----------------------------------------------------

@pytest.mark.parametrize("K,n_seg,L", [(0, 3, 60), (6, 6, 100), (6, 3, 150)])
def test_native_pack_and_unpack(iid, K, n_seg, L):
    rs = np.random.RandomState(4)
    reads = sample_reads(iid.text, rs, 13, L=L, with_n=1)
    reads.append(reads[0][:L - 17])                  # mixed lengths
    lens = np.asarray([len(r) for r in reads], np.int32)
    mat = np.full((len(reads), L), 5, np.uint8)
    for j, r in enumerate(reads):
        mat[j, :len(r)] = r
    md = rs.randint(0, 6, len(reads)).astype(np.int32)
    tail = 3
    buf, shape = trefpack.pigeon_pack(mat, lens, md, n_seg, K, tail)
    want = jrefpack.pigeon_pack(mat, lens, md, n_seg, K, tail)
    assert want is not None and shape == want[1]
    assert_same_arrays(want[0], buf, "native buffer")
    both = list(reads) + [alphabet.revcomp(r) for r in reads]
    for pg in (jpigeon, tpigeon):
        b = pg.pack_pigeon_batch(both, n_seg=n_seg, max_len=L, kmer_k=K,
                                 anchor_tail=tail, device_masks=True)
        nbuf, nshape = pg.pack_pigeon_upload(b, np.concatenate([md, md]))
        assert nshape == shape
        assert_same_arrays(nbuf, buf, "numpy pack + upload")
    want = jpigeon.unpack_pigeon_upload(jnp.asarray(buf), shape)
    got = tpigeon.unpack_pigeon_upload(buf, shape)
    assert len(want) == len(got) == 10
    for i, (w, x) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(np.asarray(w).astype(np.int64),
                                      x.numpy(), err_msg=str(i))


def test_upload_field_overflow_raises():
    b = tpigeon.pack_pigeon_batch([np.zeros(40, np.int8)], n_seg=2)
    with pytest.raises(ValueError, match="md overflows"):
        tpigeon.pack_pigeon_upload(b, np.asarray([1 << 16]))
    with pytest.raises(ValueError, match="handles reads"):
        tpigeon.pack_pigeon_batch([np.zeros(161, np.int8)], n_seg=2)
