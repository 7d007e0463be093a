"""The port's own host layer, module by module, held bit-equal to the
module of ``hsa_tpu`` it was copied from, on the same seeded inputs."""

import argparse
import dataclasses
import functools
import gzip
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hsa_tpu.alphabet as jalphabet
import hsa_tpu.cli as jcli
import hsa_tpu.config as jconfig
import hsa_tpu.metrics as jmetrics
import hsa_tpu.pipeline as jpipeline
import hsa_tpu.refpack as jrefpack
import hsa_tpu_torch.alphabet as talphabet
import hsa_tpu_torch.cli as tcli
import hsa_tpu_torch.config as tconfig
import hsa_tpu_torch.fmcore as tfmcore
import hsa_tpu_torch.metrics as tmetrics
import hsa_tpu_torch.pipeline as tpipeline
import hsa_tpu_torch.refpack as trefpack
from hsa_tpu.index import layout as jlayout
from hsa_tpu.io import fastx as jfastx
from hsa_tpu.io import sam as jsam
from hsa_tpu.oracle.bnb import Hit as JHit
from hsa_tpu.resolve import sampe as jsampe
from hsa_tpu.resolve import samse as jsamse
from hsa_tpu.resolve.samse import Occurrence
from hsa_tpu.search import beam as jbeam
from hsa_tpu.search import pigeon as jpigeon
from hsa_tpu_torch.index import layout as tlayout
from hsa_tpu_torch.io import fastx as tfastx
from hsa_tpu_torch.io import sam as tsam
from hsa_tpu_torch.oracle.bnb import align_read as talign_read
from hsa_tpu_torch.resolve import sampe as tsampe
from hsa_tpu_torch.resolve import samse as tsamse
from hsa_tpu_torch.search import beam as tbeam
from hsa_tpu_torch.search import pigeon as tpigeon


def _astuples(per_read):
    return [[dataclasses.astuple(h) for h in hits] for hits in per_read]


def test_occ_lists_to_arrays():
    rs = np.random.RandomState(0)
    occs = [[Occurrence(int(rs.randint(0, 10 ** 9)), int(rs.randint(0, 2)),
                        int(rs.randint(0, 40)), int(rs.randint(0, 4)),
                        int(rs.randint(0, 2)), int(rs.randint(0, 6)))
             for _ in range(rs.randint(0, 5))] for _ in range(30)]
    for lists in (occs, [], [[], []]):
        want = jpigeon.occ_lists_to_arrays(lists)
        got = tpigeon.occ_lists_to_arrays(lists)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.parametrize("max_len", [None, 90])
def test_pack_read_batch(max_len):
    rs = np.random.RandomState(1)
    reads = [rs.randint(0, 5, rs.randint(1, 80)).astype(np.int8)
             for _ in range(17)]
    for w, g in zip(jbeam.pack_read_batch(reads, max_len),
                    tbeam.pack_read_batch(reads, max_len)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


def test_pack_read_batch_too_long():
    reads = [np.zeros(50, np.int8)]
    with pytest.raises(ValueError) as want:
        jbeam.pack_read_batch(reads, 40)
    with pytest.raises(ValueError) as got:
        tbeam.pack_read_batch(reads, 40)
    assert str(want.value) == str(got.value)


def _raw_pair(seed, H=8, B=24):
    """The same raw beam result as JAX uint32 arrays and as the port's
    int32 tensors."""
    rs = np.random.RandomState(seed)
    score = rs.randint(0, 20, (H, B)).astype(np.uint32)
    hkey = (score << 14) | np.arange(H, dtype=np.uint32)[:, None]
    hkey[rs.rand(H, B) < 0.3] = 0x7FFF0000
    # a few duplicate (k, l, meta) hits with different scores
    hk = rs.randint(0, 4, (H, B)).astype(np.uint32) * np.uint32(2 ** 30 + 7)
    hl = hk + rs.randint(0, 3, (H, B)).astype(np.uint32)
    hm = rs.randint(0, 2 ** 27, (H, B)).astype(np.uint32)
    hm[1] = hm[0]
    best = np.where(rs.rand(B) < 0.2, 0x10000,
                    score.min(axis=0)).astype(np.uint32)
    ld = rs.randint(0, 3, B).astype(np.uint32)
    hd = rs.randint(0, 3, B).astype(np.uint32)
    arrays = (hkey, hk, hl, hm, best, ld, hd)
    jraw = jbeam.RawBeamResult(*(jnp.asarray(a) for a in arrays))
    traw = tbeam.RawBeamResult(*(torch.from_numpy(a.view(np.int32))
                                 for a in arrays))
    return jraw, traw


@pytest.mark.parametrize("seed", [0, 1])
def test_finalize_result_and_result_to_hits(seed):
    jraw, traw = _raw_pair(seed)
    want = jbeam.finalize_result(jraw, 3)
    got = tbeam.finalize_result(traw, 3)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    hits = tbeam.result_to_hits(got)
    # the port's Hit is its own dataclass: compare field by field
    assert _astuples(hits) == _astuples(jbeam.result_to_hits(want))
    assert tbeam.result_to_hits(traw, 3) == hits
    assert any(hits)


# -- leaves: alphabet, config, metrics ----- ----------------------------------

@pytest.mark.parametrize("what", ["codec", "revcomp", "ambiguous"])
def test_alphabet(what):
    rs = np.random.RandomState(3)
    seq = "".join(rs.choice(list("ACGTNacgtnRY"), 500))
    codes = jalphabet.encode(seq)
    if what == "codec":
        got = talphabet.encode(seq)
        assert got.dtype == codes.dtype
        np.testing.assert_array_equal(got, codes)
        assert talphabet.decode(got) == jalphabet.decode(codes)
    elif what == "revcomp":
        np.testing.assert_array_equal(talphabet.revcomp(codes),
                                      jalphabet.revcomp(codes))
    else:
        want, runs = jalphabet.substitute_ambiguous(codes, seed=5)
        got, truns = talphabet.substitute_ambiguous(codes, seed=5)
        np.testing.assert_array_equal(got, want)
        assert truns == runs and runs


@pytest.mark.parametrize("n", [None, "3", "0.02"])
def test_config_and_cli_options(n):
    """The same command line gives the same options, diff budgets and
    manifest-relevant fields in both packages."""
    argv = ["-o", "2", "-e", "5", "-l", "28", "-k", "1", "-M", "4", "-q", "7",
            "--batch", "99"] + (["-n", n] if n else [])
    opts = []
    for cli in (jcli, tcli):
        p = argparse.ArgumentParser()
        cli._add_search_opts(p)
        a = p.parse_args(argv)
        assert a.batch == 99 and a.beam_width is None and a.ladder is None
        opts.append(cli._opt_from_args(a))
    want, got = opts
    assert isinstance(got, tconfig.AlnOpt) and got.to_dict() == want.to_dict()
    assert [got.diff_budget(L) for L in range(15, 260, 7)] == \
        [want.diff_budget(L) for L in range(15, 260, 7)]
    assert dataclasses.asdict(tconfig.PEOpt()) == \
        dataclasses.asdict(jconfig.PEOpt())
    assert dataclasses.asdict(tconfig.SamseOpt()) == \
        dataclasses.asdict(jconfig.SamseOpt())
    assert [tconfig.cal_max_diff(L) for L in range(10, 300, 9)] == \
        [jconfig.cal_max_diff(L) for L in range(10, 300, 9)]


def test_metrics(tmp_path):
    lines = ["r0\t0\tc\t5\t37\t9M", "r1\t4\t*\t0\t0\t*", "r2\t16\tc\t9\t0\t9M"]
    dumps = []
    for mod in (jmetrics, tmetrics):
        met = mod.RunMetrics()
        met.config = dict(cmd="align")
        met.count("x", 3)
        met.note_batch(3, lines, (np.asarray([0, 1, 0]), np.asarray([0, 0, 2])),
                       flags=[0, 4, 16])
        path = tmp_path / f"{mod.__name__}.json"
        d = met.dump(str(path))
        assert json.load(open(path)).keys() == d.keys()
        dumps.append({k: v for k, v in d.items()
                      if not k.startswith("t_") and k != "wall_s"})
    assert dumps[0] == dumps[1] and dumps[0]["reads_mapped"] == 2


# -- the native library: each wrapper against the reference's ------------------

def _dp_jobs(rs, n=40, L=50, G=70):
    text = rs.randint(0, 4, 6000).astype(np.int8)
    reads = np.zeros((n, L), np.uint8)
    lens = rs.randint(30, L + 1, n).astype(np.int32)
    off = rs.randint(0, len(text) - G - 1, n).astype(np.int64)
    for i in range(n):
        r = text[off[i] + 3:off[i] + 3 + lens[i] + 1].copy()
        if i % 3 == 0:
            r = np.delete(r, 20)
        r = r[:lens[i]]
        q = rs.choice(lens[i], 2, replace=False)
        r[q] = (r[q] + 1) % 4
        reads[i, :lens[i]] = r
    return text, reads, lens, off


@pytest.mark.parametrize("what", ["pack_2bit", "suffix_array", "build",
                                  "build_with_sa", "banded_global",
                                  "banded_batch", "glocal_batch"])
def test_refpack_wrappers(what):
    assert jrefpack.available()
    assert trefpack.ensure_refpack()._name != jrefpack._lib._name    # two libraries
    rs = np.random.RandomState(len(what))
    text = rs.randint(0, 4, 5003).astype(np.uint8)

    def same(got, want):
        assert type(got) is type(want)
        if isinstance(want, (tuple, list)):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                same(g, w)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want

    if what == "pack_2bit":
        packed = jrefpack.pack_2bit(text)
        same(trefpack.pack_2bit(text), packed)
        same(trefpack.unpack_2bit(packed, len(text)),
             jrefpack.unpack_2bit(packed, len(text)))
        assert (trefpack.unpack_2bit(packed, len(text)) == text).all()
    elif what == "suffix_array":
        same(trefpack.suffix_array(text), jrefpack.suffix_array(text))
    elif what in ("build", "build_with_sa"):
        kw = dict(sa_intv=8, want_sa=what == "build_with_sa")
        same(trefpack.build(text, **kw), jrefpack.build(text, **kw))
    elif what == "banded_global":
        t, reads, lens, off = _dp_jobs(rs, n=12)
        for i in range(12):
            args = (reads[i, :lens[i]], t[off[i] + 3:off[i] + 3 + lens[i] + 2],
                    3, 11, 4, 3)
            same(trefpack.banded_global(*args), jrefpack.banded_global(*args))
    elif what == "banded_batch":
        t, reads, lens, off = _dp_jobs(rs)
        args = (reads, np.arange(len(lens)) * reads.shape[1], lens, t, off + 3,
                lens + 2, 3, 11, 4, np.full(len(lens), 3, np.int32))
        same(trefpack.banded_batch(*args), jrefpack.banded_batch(*args))
        same(trefpack.banded_batch(*(a[:0] if isinstance(a, np.ndarray)
                                     and a.ndim == 1 and a is not t else a
                                     for a in args)),
             ([], [], *[np.zeros(0, np.int32)] * 3))
    else:
        t, reads, lens, off = _dp_jobs(rs)
        args = (reads, np.arange(len(lens)) * reads.shape[1], lens, t, off,
                np.full(len(lens), 70, np.int32), 3, 11, 4)
        same(trefpack.glocal_batch(*args), jrefpack.glocal_batch(*args))


@pytest.mark.parametrize("kind", ["random", "repetitive"])
def test_suffix_array_force64(kind):
    """The int64 SA-IS instantiation (a genome over 2^31 bp takes it) equals
    the int32 one that ``suffix_array`` picks at this size, the numpy prefix
    doubling of ``fmcore`` and the reference's hook."""
    from hsa_tpu_torch import fmcore as tfmcore
    rs = np.random.RandomState(len(kind))
    if kind == "random":
        text = rs.randint(0, 4, 7001).astype(np.uint8)
    else:
        unit = rs.randint(0, 4, 23).astype(np.uint8)
        text = np.concatenate([np.tile(unit, 150), np.zeros(300, np.uint8),
                               np.tile(unit[:5], 60)])
    got = trefpack.suffix_array_force64(text)
    assert got.dtype == np.int64 and len(got) == len(text) + 1
    np.testing.assert_array_equal(got, trefpack.suffix_array(text))
    np.testing.assert_array_equal(got,
                                  tfmcore.suffix_array(text.astype(np.int8)))
    np.testing.assert_array_equal(got, jrefpack.suffix_array_force64(text))


# -- references, the index and its directory ----------------------------------

@pytest.fixture(scope="module")
def small_ref(tmp_path_factory):
    """A two-sequence FASTA with an N run, its reads, and both packages'
    index directories."""
    tmp = tmp_path_factory.mktemp("host_layer")
    rs = np.random.RandomState(17)
    c1 = rs.randint(0, 4, 9000).astype(np.int8)
    c2 = rs.randint(0, 4, 4000).astype(np.int8)
    s1 = jalphabet.decode(c1)
    s1 = s1[:3000] + "N" * 25 + s1[3025:]
    with open(tmp / "ref.fa", "w") as fh:
        fh.write(">c1 first\n")
        fh.writelines(s1[i:i + 60] + "\n" for i in range(0, len(s1), 60))
        fh.write(">c2\n" + jalphabet.decode(c2) + "\n")
    jdir = jpipeline.build_index(str(tmp / "ref.fa"), str(tmp / "j"))
    tdir = tpipeline.build_index(str(tmp / "ref.fa"), str(tmp / "t"))
    return tmp, jdir, tdir


def test_load_reference_and_refmeta(small_ref):
    tmp, *_ = small_ref
    wt, wm = jfastx.load_reference(str(tmp / "ref.fa"))
    gt, gm = tfastx.load_reference(str(tmp / "ref.fa"))
    assert gt.dtype == wt.dtype
    np.testing.assert_array_equal(gt, wt)
    assert gm.to_dict() == wm.to_dict() and wm.amb_runs
    rt = tfastx.RefMeta.from_dict(wm.to_dict())
    for pos in (0, 2990, 3010, 8999, 9000, 12999):
        assert rt.pos_to_ref(pos) == wm.pos_to_ref(pos)
        assert rt.count_amb(pos, 40) == wm.count_amb(pos, 40)
        assert rt.span_ok(pos, 40) == wm.span_ok(pos, 40)
    assert [tfastx.trim_read_length(q, 20) for q in ("IIII##", "####", "*")] \
        == [jfastx.trim_read_length(q, 20) for q in ("IIII##", "####", "*")]
    assert tsam.sam_header(gm, "align") == jsam.sam_header(wm, "align")


@pytest.mark.parametrize("sa_direct", [True, False])
def test_build_device_index(sa_direct, tmp_path):
    text = np.random.RandomState(8).randint(0, 4, 4099).astype(np.int8)
    want = jlayout.build_device_index(text, sa_intv=16, sa_direct=sa_direct)
    got = tlayout.build_device_index(text, sa_intv=16, sa_direct=sa_direct)
    want.save(str(tmp_path / "j.npz"))
    got.save(str(tmp_path / "t.npz"))
    zj, zt = np.load(tmp_path / "j.npz"), np.load(tmp_path / "t.npz")
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    assert (got.sa_direct is not None) == sa_direct


@pytest.mark.parametrize("written_by", ["hsa_tpu", "hsa_tpu_torch"])
def test_index_directory_loads_in_the_other_package(small_ref, written_by):
    """``build_index`` writes the same three files, and an index written by
    one package loads in the other and aligns the same."""
    _, jdir, tdir = small_ref
    for name in ("meta.json", "text.pac"):
        assert open(f"{jdir}/{name}", "rb").read() == \
            open(f"{tdir}/{name}", "rb").read()
    zj, zt = np.load(f"{jdir}/index.npz"), np.load(f"{tdir}/index.npz")
    for k in zj.files:
        np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    if written_by == "hsa_tpu":
        al = tpipeline.Aligner(jdir, engine="beam", device="cpu")
        other = tpipeline.Aligner(tdir, engine="beam", device="cpu")
    else:
        al = jpipeline.Aligner(tdir, engine="beam")
        other = jpipeline.Aligner(jdir, engine="beam")
    np.testing.assert_array_equal(al.text, other.text)
    assert al.meta.to_dict() == other.meta.to_dict()
    reads = [al.text[500:560].copy(), jalphabet.revcomp(al.text[9500:9560])]
    reads[0][7] = (reads[0][7] + 1) % 4
    recs = al.align(reads)
    assert [r.to_sam() for r in recs] == \
        [r.to_sam() for r in other.align(reads)]
    assert [r.pos for r in recs] == [501, 501] and recs[1].rname == "c2"


# -- resolvers: the same occurrences through both packages -----------------------

def _fields(rec):
    d = dict(vars(rec))
    d["tags"] = dict(d["tags"])
    return d


@pytest.fixture(scope="module")
def searched(small_ref):
    """Reads and pairs on the small reference, searched once by the port on
    the CPU: the occurrence arrays that both packages' resolvers get."""
    _, jdir, _ = small_ref
    al = tpipeline.Aligner(jdir, engine="beam", device="cpu")
    rs = np.random.RandomState(23)
    text, L = al.text, 50
    reads = []
    for j in range(14):
        p = rs.randint(0, 8900) if j % 3 else 9000 + rs.randint(0, 3900)
        r = text[p:p + L + 1].copy()
        if j % 4 == 1:
            r = np.delete(r, 22)
        r = r[:L]
        q = rs.choice(L, j % 3, replace=False)
        r[q] = (r[q] + 1) % 4
        reads.append(jalphabet.revcomp(r) if j % 2 else r)
    reads.append(rs.randint(0, 4, L).astype(np.int8))          # unmapped
    r1s, r2s = [], []
    for j in range(10):
        ins = int(rs.randint(150, 260))
        p = rs.randint(3100, 8900 - ins)
        r1s.append(text[p:p + L].copy())
        r2 = jalphabet.revcomp(text[p + ins - L:p + ins])
        if j == 9:                       # over the search budget: a rescue
            for q in (5, 13, 21, 29, 37, 45):
                r2[q] = (r2[q] + 1) % 4
        r2s.append(r2)
    se = al._align_occ(al._align_device(reads))
    pe = al._align_pe_occ(al._align_pe_device(r1s, r2s), r1s + r2s)[:3]
    return al, reads, se, r1s, r2s, pe


@pytest.mark.parametrize("emit", ["records", "sam"])
def test_resolve_from_occ_arrays(searched, emit):
    al, reads, (occ, trunc, c2x), *_ = searched
    names = [f"r{j}" for j in range(len(reads))]
    quals = ["I" * 50] * len(reads)
    jmeta = jfastx.RefMeta.from_dict(al.meta.to_dict())
    want = jsamse.resolve_from_occ_arrays(
        al.text, jmeta, jpipeline.ReadBatch.from_reads(reads), names, quals,
        occ, trunc, jconfig.AlnOpt(), jconfig.SamseOpt(), emit=emit,
        c2_extra=c2x)
    got = tsamse.resolve_from_occ_arrays(
        al.text, al.meta, tpipeline.ReadBatch.from_reads(reads), names, quals,
        occ, trunc, tconfig.AlnOpt(), tconfig.SamseOpt(), emit=emit,
        c2_extra=c2x)
    if emit == "sam":
        assert got == want
        return
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert sum(r.flag & 4 == 0 for r in got) >= 12 and got[-1].flag & 4
    assert any("D" in r.cigar or "I" in r.cigar for r in got)


@pytest.mark.parametrize("emit", ["records", "sam"])
def test_resolve_pe_from_occ_arrays(searched, emit):
    al, _, _, r1s, r2s, (occ, trunc, c2x) = searched
    names = [f"p{j}" for j in range(len(r1s))]
    quals = ["I" * 50] * len(r1s)
    jmeta = jfastx.RefMeta.from_dict(al.meta.to_dict())
    want = jsampe.resolve_pe_from_occ_arrays(
        al.text, jmeta, r1s, r2s, names, quals, quals, occ, jconfig.AlnOpt(),
        jconfig.PEOpt(), trunc=trunc, c2x=c2x, emit=emit)
    got = tsampe.resolve_pe_from_occ_arrays(
        al.text, al.meta, r1s, r2s, names, quals, quals, occ,
        tconfig.AlnOpt(), tconfig.PEOpt(), trunc=trunc, c2x=c2x, emit=emit,
        rescue=functools.partial(tsampe._rescue_batch, device="cpu"))
    if emit == "sam":
        assert got == want
        assert any("XT:Z:M" in line for line in got[0])
        return
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert got[19].tags.get("XT") == "M" and got[0].flag & 2


@pytest.fixture(scope="module")
def rescues():
    """A batch that rescues ungapped and gapped mates on both strands over a
    two-sequence reference with ambiguity runs (so that ``XN`` appears),
    with qualities that read differently reversed: the reference, the
    port's occurrences from its oracle, names and qualities."""
    rs = np.random.RandomState(19)
    n, L = 8000, 60
    text = rs.randint(0, 4, n).astype(np.int8)
    meta = tfastx.RefMeta(
        names=["c1", "c2"], starts=np.asarray([0, 4000], np.int64),
        lengths=np.asarray([4000, 4000], np.int64),
        amb_runs=[(520, 4), (1790, 3), (4610, 5), (6230, 2)], total=n)
    fm = tfmcore.FMIndex.build(text)
    fm_r = tfmcore.FMIndex.build(text[::-1].copy())
    opt = tconfig.AlnOpt(max_diff=2)

    def end(start, kind):
        """The forward-strand bases of an end whose span starts at
        ``start``: as in the text (kind 0), with five substitutions (1: an
        ungapped rescue) or a 1 bp deletion and three substitutions (2: a
        gapped one)."""
        w = text[start:start + L + 1].copy()
        if kind == 2:
            w = np.delete(w, 28)
        w = w[:L]
        for q in {0: (), 1: (5, 17, 40, 49, 55), 2: (6, 45, 53)}[kind]:
            w[q] = (w[q] + 1) % 4
        return w

    # (fragment start, end 1 forward?, spoiled end (0: none), its kind);
    # clean pairs' inserts 250-310 bp, spoiled pairs' 280
    plan = [(100, True, 0, 0), (900, True, 0, 0), (1400, False, 0, 0),
            (2100, True, 0, 0), (2700, False, 0, 0), (3300, True, 0, 0),
            (4200, True, 0, 0), (5000, False, 0, 0), (5600, True, 0, 0),
            (7000, False, 0, 0),
            (300, True, 2, 1), (1550, True, 2, 2), (4380, True, 2, 1),
            (2900, False, 2, 2), (6000, False, 2, 1), (1000, True, 1, 2),
            (1720, False, 1, 1), (6150, True, 2, 2), (3500, False, 1, 2)]
    r1s, r2s = [], []
    for j, (p, fwd1, bad, kind) in enumerate(plan):
        isize = 280 if bad else 250 + 10 * (j % 7)
        left_bad = bad == (1 if fwd1 else 2)
        left = end(p, kind if left_bad else 0)
        right = talphabet.revcomp(end(p + isize - L,
                                      kind if bad and not left_bad else 0))
        r1s.append(left if fwd1 else right)
        r2s.append(right if fwd1 else left)
    B = len(plan)
    names = [f"p{j}" for j in range(B)]
    q1 = ["".join(chr(33 + (i * 7 + j) % 40) for i in range(L))
          for j in range(B)]
    q2 = [q[::-1] for q in q1]

    def locate_fn(ranks):
        return np.array([fm.locate(int(r)) for r in ranks], np.int64)

    def occs(reads):
        hf = [talign_read(fm, fm_r, r, opt) for r in reads]
        hr = [talign_read(fm, fm_r, talphabet.revcomp(r), opt) for r in reads]
        return tsamse.collect_occurrences(hf, hr, locate_fn)

    return text, meta, r1s, r2s, names, q1, q2, occs(r1s), occs(r2s), opt


@pytest.mark.parametrize("emit", ["records", "sam"])
def test_pe_rescued_end_records(rescues, emit):
    """Rescued-end records, ungapped and gapped on both strands with
    ``XN``: the port's array resolver against the reference's on the same
    occurrences and against the port's loop twin, byte for byte; with the
    tracer on, the ``resolve.rescue`` stage notes as many rescued and
    gapped jobs as the batch's records show."""
    text, meta, r1s, r2s, names, q1, q2, (o1, t1), (o2, t2), opt = rescues
    occ = tpigeon.occ_lists_to_arrays(o1 + o2)
    trunc = np.concatenate([t1, t2])
    rescue = functools.partial(tsampe._rescue_batch, device="cpu")
    want = jsampe.resolve_pe_from_occ_arrays(
        text, jfastx.RefMeta.from_dict(meta.to_dict()), r1s, r2s, names, q1,
        q2, occ, jconfig.AlnOpt(max_diff=2), jconfig.PEOpt(), trunc=trunc,
        emit=emit)
    twin = tsampe.resolve_pe_from_occurrences(
        text, meta, r1s, r2s, names, q1, q2, o1, o2, opt, tconfig.PEOpt(),
        trunc1=t1, trunc2=t2, rescue=rescue)
    tmetrics.enable()
    try:
        got = tsampe.resolve_pe_from_occ_arrays(
            text, meta, r1s, r2s, names, q1, q2, occ, opt, tconfig.PEOpt(),
            trunc=trunc, emit=emit, rescue=rescue)
        notes = [s["attrs"] for s in tmetrics.collect()["spans"]
                 if s["name"] == "resolve.rescue"]
    finally:
        tmetrics.disable()
    if emit == "sam":
        assert got == want
        assert got == ([r.to_sam() for r in twin], [r.flag for r in twin])
        recs = twin
    else:
        assert [_fields(r) for r in got] == [_fields(r) for r in want]
        assert [r.to_sam() for r in got] == [r.to_sam() for r in twin]
        recs = got
    rescued = [r for r in recs if r.tags.get("XT") == "M"]
    gapped = [r for r in rescued if "I" in r.cigar or "D" in r.cigar]
    ungapped = [r for r in rescued if r not in gapped]
    for grp in (gapped, ungapped):
        assert {r.flag & 16 for r in grp} == {0, 16}
        assert any("XN" in r.tags for r in grp)
    assert [(a["rescued"], a["gapped"]) for a in notes] == \
        [(len(rescued), len(gapped))]


def test_collect_occurrences(searched):
    """``collect_occurrences`` of both packages on the same hits."""
    al, reads, *_ = searched
    hf, hr = al.search_batch(reads)
    jhits = [[[JHit(*dataclasses.astuple(h)) for h in hits]
              for hits in side] for side in (hf, hr)]
    wocc, wtr = jsamse.collect_occurrences(*jhits, al.locate_fn, 64)
    gocc, gtr = tsamse.collect_occurrences(hf, hr, al.locate_fn, 64)
    assert list(gtr) == list(wtr)
    assert [[vars(o) for o in lst] for lst in gocc] == \
        [[vars(o) for o in lst] for lst in wocc]
    assert any(gocc) and sum(map(len, gocc)) >= 12


# -- CLI helpers: batches, manifests ---------------------------------------------

def test_read_batch():
    rs = np.random.RandomState(4)
    reads = [rs.randint(0, 4, rs.randint(5, 40)).astype(np.int8)
             for _ in range(9)]
    want = jpipeline.ReadBatch.from_reads(reads)
    got = tpipeline.ReadBatch.from_reads(reads)
    assert len(got) == len(want) and tpipeline.ReadBatch.from_reads(got) is got
    for a, b in zip(got.padded(48), want.padded(48)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.subset([3, 1]).mat,
                                  want.subset([3, 1]).mat)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["fq", "fq.gz", "fq_trimmed", "fa"])
def test_stream_batches(tmp_path, kind):
    rs = np.random.RandomState(6)
    recs = [(f"n{j} extra", "".join(rs.choice(list("ACGTN"), rs.randint(20, 70))))
            for j in range(23)]
    trim = 15 if kind == "fq_trimmed" else 0
    if kind == "fa":
        path = tmp_path / "reads.fa"
        path.write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    else:
        body = "".join(
            f"@{n}\n{s}\n+\n{'I' * (len(s) - 6)}{'#' * 6}\n" for n, s in recs)
        if kind == "fq.gz":
            path = tmp_path / "reads.fq.gz"
            with gzip.open(path, "wt") as fh:
                fh.write(body)
        else:
            path = tmp_path / "reads.fq"
            path.write_text(body)
    want = list(jcli._stream_batches(str(path), 10, trim))
    got = list(tcli._stream_batches(str(path), 10, trim))
    assert [b[0] for b in got] == [0, 10, 20] == [b[0] for b in want]
    for (_, gn, gr, gq), (_, wn, wr, wq) in zip(got, want):
        assert gn == wn and gq == wq and len(gr) == len(wr)
        for a, b in zip(gr, wr):
            np.testing.assert_array_equal(a, b)
    if trim:
        assert all(len(r) == len(s) - 6 for r, (_, s) in zip(got[0][2], recs))


def test_manifest_helpers_and_lockstep(tmp_path):
    out = str(tmp_path / "o.sam")
    assert tcli._manifest_path(out) == jcli._manifest_path(out)
    tcli._save_manifest(out, "align|x|10|None|None", 30, -1)
    port_bytes = open(tcli._manifest_path(out), "rb").read()
    for cli in (tcli, jcli):                 # each reads the other's file
        assert cli._load_manifest(out, "align|x|10|None|None") == 30
        assert cli._load_manifest(out, "align|y|10|None|None") == 0
        assert cli._load_manifest(None, "k") == 0
    jcli._save_manifest(out, "align|x|10|None|None", 30, -1)
    assert open(jcli._manifest_path(out), "rb").read() == port_bytes
    assert list(tcli._zip_lockstep([1, 2], "ab")) == [(1, "a"), (2, "b")]
    with pytest.raises(AssertionError, match="unevenly"):
        list(tcli._zip_lockstep([1, 2], "abc"))
    assert list(tcli._prefetch(iter(range(7)))) == list(range(7))

    def boom():
        yield 1
        raise ValueError("reader failed")
    with pytest.raises(ValueError, match="reader failed"):
        list(tcli._prefetch(boom()))


# -- the pigeon engine's host side ---------------------------------------------

def test_pigeon_constants_and_small_helpers():
    for name in ("PAD", "MAX_READ_LEN", "GC_SLOTS", "MAX_GAP_RUN", "_BIGNMM",
                 "_BIGKEY", "_PAT"):
        assert getattr(tpigeon, name) == getattr(jpigeon, name), name
    assert tpigeon.PigeonResult._fields == jpigeon.PigeonResult._fields
    for n in (100, 20_000, 1 << 24, 46_709_983, 3_100_000_000):
        for K in (0, 6, 12):
            assert tpigeon.auto_anchor_tail(n, K) == \
                jpigeon.auto_anchor_tail(n, K)
    for opt in (jconfig.AlnOpt(), jconfig.AlnOpt(max_gapo=0),
                jconfig.AlnOpt(max_gape=1), jconfig.AlnOpt(max_gape=20)):
        for n_seg in range(1, 12):
            assert tpigeon.max_gap_run(opt, n_seg) == \
                jpigeon.max_gap_run(opt, n_seg)
    key = np.asarray([0x00000B10, 0x00001D23, 0xFFFFFFFF], np.uint32)
    for w, g in zip(jpigeon.unpack_gap_key(key), tpigeon.unpack_gap_key(key)):
        np.testing.assert_array_equal(w, g)
    for n in (0, 1, 2, 3, 64, 65, 512, 513, 2048, 2049, 40_000):
        assert tpipeline._beam_pad(n) == jpipeline._beam_pad(n)
    for args in ((16, 100, 6, 12, 4), (7, 150, 3, 0, 6), (1, 31, 2, 6, 3)):
        assert trefpack.pigeon_upload_shape(*args) == \
            jrefpack.pigeon_upload_shape(*args)


@pytest.mark.parametrize("n", [0, 1, 127, 128, 1000])
def test_pack_text_rows(n):
    text = np.random.RandomState(n).randint(0, 4, n).astype(np.int8)
    want, got = jpigeon.pack_text_rows(text), tpigeon.pack_text_rows(text)
    assert want.dtype == got.dtype and want.shape == got.shape
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("kw", [
    dict(n_seg=3), dict(n_seg=6, kmer_k=6, anchor_tail=3),
    dict(n_seg=3, seg_phase=True), dict(n_seg=4, kmer_k=6, anchor_tail=2,
                                        seg_phase=True, device_masks=True),
    dict(n_seg=5, max_len=160, seed_len=20)])
def test_pack_pigeon_batch_and_upload(kw):
    rs = np.random.RandomState(6)
    reads = [rs.randint(0, 5 if j % 3 == 0 else 4,
                        rs.randint(20, 150)).astype(np.int8)
             for j in range(21)]
    want = jpigeon.pack_pigeon_batch(reads, **kw)
    got = tpigeon.pack_pigeon_batch(reads, **kw)
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)
    # the prepacked (matrix, lens) form the pipeline passes
    rb = tpipeline.ReadBatch.from_reads(reads)
    mat = tpigeon.pack_pigeon_batch(rb.padded(), **kw)
    for k in want:
        np.testing.assert_array_equal(want[k], mat[k], err_msg=k)
    md = rs.randint(0, 7, len(reads)).astype(np.int32)
    (wb, ws), (gb, gs) = (jpigeon.pack_pigeon_upload(want, md),
                          tpigeon.pack_pigeon_upload(got, md))
    assert ws == gs and wb.dtype == gb.dtype
    np.testing.assert_array_equal(wb, gb)


def _pigeon_result(rs, B=12, CC=4, POOL=40, GPOOL=10, n_gate=6):
    """A PigeonResult of host arrays with duplicate positions, both strands,
    gapped classes and fallback lanes."""
    B2 = 2 * B
    cidx = rs.randint(0, B2 * CC, POOL).astype(np.int32)
    cidx[-3:] = B2 * CC                               # dead entries
    g_key = np.full((GPOOL, 4), 0xFFFFFFFF, np.uint32)
    g_q = rs.randint(0, 50, (GPOOL, 4)).astype(np.uint32)
    for i in range(n_gate):
        for s in range(rs.randint(1, 4)):
            nm, g = rs.randint(0, 3), rs.randint(1, 4)
            g_key[i, s] = ((nm * 3 + 11 + 4 * (g - 1)) << 8) | (g << 4) | nm
    g_read = np.where(np.arange(GPOOL) < n_gate,
                      rs.randint(0, B2, GPOOL), B2).astype(np.int32)
    return jpigeon.PigeonResult(
        pos=rs.randint(0, 50, POOL).astype(np.uint32),
        nmm=rs.randint(0, 3, POOL).astype(np.uint8),
        valid=(rs.rand(POOL) < 0.7) & (cidx < B2 * CC), cidx=cidx,
        fallback=rs.rand(B2) < 0.1,
        n_cand=rs.randint(0, CC, B2).astype(np.int32),
        g_q=g_q, g_key=g_key, g_read=g_read,
        n_gate=np.asarray(n_gate, np.int32),
        n_missed=(rs.rand(B2) < 0.3).astype(np.int32) * 5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pigeon_finalisers(seed):
    opt = jconfig.AlnOpt()
    res = _pigeon_result(np.random.RandomState(seed))
    tres = tpigeon.PigeonResult(*res)
    wo, wf, wm = jpigeon.pigeon_occ_arrays(res, 12, opt, 4)
    go, gf, gm = tpigeon.pigeon_occ_arrays(tres, 12, opt, 4)
    assert wo.keys() == go.keys() and wo["rid"].size > 0
    for k in wo:
        assert wo[k].dtype == go[k].dtype, k
        np.testing.assert_array_equal(wo[k], go[k], err_msg=k)
    np.testing.assert_array_equal(wf, gf)
    np.testing.assert_array_equal(wm, gm)
    wl = jpigeon.pigeon_occurrences(res, 12, opt, 4)
    gl = tpigeon.pigeon_occurrences(tres, 12, opt, 4)
    assert _astuples(wl[0]) == _astuples(gl[0])
    np.testing.assert_array_equal(wl[1], gl[1])
    np.testing.assert_array_equal(wl[2], gl[2])
    assert _astuples(jpigeon.occ_arrays_to_lists(wo, 12)) == \
        _astuples(tpigeon.occ_arrays_to_lists(go, 12)) == _astuples(gl[0])


@pytest.mark.parametrize("n_gate", [0, 6])
def test_fetch_result(n_gate):
    """Tensors come back as the reference's dtypes; with no gapped lane the
    pool-2 arrays are synthesized, ``g_read`` as 2B, as the reference's
    fetch does."""
    res = _pigeon_result(np.random.RandomState(3), n_gate=n_gate)
    wide = {"pos", "g_q", "g_key"}
    tres = tpigeon.PigeonResult(**{
        k: torch.from_numpy(v.astype(np.int64) if k in wide else v.copy())
        for k, v in res._asdict().items()})
    want = jpigeon.fetch_result(jpigeon.PigeonResult(
        *(jnp.asarray(x) for x in res)))
    got = tpigeon.fetch_result(tres)
    for k in res._fields:
        w, g = np.asarray(getattr(want, k)), getattr(got, k)
        assert w.dtype == g.dtype and w.shape == g.shape, k
        np.testing.assert_array_equal(w, g, err_msg=k)
    if n_gate == 0:
        assert got.g_read.tolist() == [2 * 24] and got.g_key.shape == (1, 4)
    # host arrays pass through
    again = tpigeon.fetch_result(got)
    assert all(a is b or np.array_equal(a, b) for a, b in zip(again, got))


def test_occ_merge():
    rs = np.random.RandomState(9)

    def occ(n, nr):
        rid = np.sort(rs.randint(0, nr, n)).astype(np.int64)
        return dict(rid=rid, pos=rs.randint(0, 99, n).astype(np.int64),
                    strand=rs.randint(0, 2, n).astype(np.int8),
                    score=rs.randint(0, 30, n).astype(np.int32),
                    nmm=rs.randint(0, 3, n).astype(np.int32),
                    ngapo=rs.randint(0, 2, n).astype(np.int32),
                    ngape=rs.randint(0, 3, n).astype(np.int32))
    fmap = np.asarray([3, 7, 11], np.int64)
    for a, b in ((occ(20, 12), occ(5, 3)), (occ(20, 12), occ(0, 3)),
                 (occ(0, 12), occ(4, 3))):
        want, got = jpipeline._occ_merge(a, b, fmap), \
            tpipeline._occ_merge(a, b, fmap)
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)
