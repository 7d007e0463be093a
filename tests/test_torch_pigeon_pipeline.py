"""The port's pigeon route through ``Aligner`` and the command line against
``hsa_tpu``'s, on the CPU: ``align``, ``align_stream`` (staged fallbacks,
pooled ``seg_phase`` retry, pooled beam, patch and splice), the capacity
profiles, the shared K-mer table cache and ``align --engine auto``.  Every
SAM must be byte-equal (tolerance 0)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt, SamseOpt
from hsa_tpu.pipeline import Aligner as JAligner
from hsa_tpu.search import exact as jexact
from hsa_tpu.search import pigeon as jpigeon
from hsa_tpu_torch import cli as tcli
from hsa_tpu_torch.pipeline import Aligner as TAligner
from hsa_tpu_torch.search import pigeon as tpigeon
from test_torch_pigeon import (OPT_GAP, SEG_CAP, Genome, assert_same_arrays,
                               iid, rep, repeat_text,  # noqa: F401 (fixtures)
                               sample_reads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sams(recs):
    return [r.to_sam() for r in recs]


def _mixed_reads(text, rs, n=40, L=100):
    """Reads of L bp (every 4th with a deletion, 0-2 substitutions, some
    Ns, half reverse-strand) plus three the router must hand to the beam:
    two longer than the engine takes and one too short for its budget."""
    out = []
    for j in range(n):
        p = rs.randint(0, len(text) - L - 3)
        r = text[p:p + L + 1].copy()
        if j % 4 == 0:
            c = rs.randint(10, L - 10)
            r = np.concatenate([r[:c], r[c + 1:]])
        r = r[:L].copy()
        q = rs.choice(L, j % 3, replace=False)
        r[q] = (r[q] + 1) % 4
        if j % 7 == 3:
            r[rs.randint(0, L)] = 4
        out.append((alphabet.revcomp(r) if j % 2 else r).astype(np.int8))
    out.append(rs.randint(0, 4, 200).astype(np.int8))
    out.append(text[500:700].copy())
    out.append(text[900:930].copy())
    return out


@pytest.fixture(scope="module")
def iid_aligners(iid):
    return (JAligner.from_arrays(iid.di, iid.text, engine="auto"),
            TAligner.from_arrays(iid.di, iid.text, engine="auto",
                                 device="cpu"))


def test_align_auto_byte_equal(iid, iid_aligners):
    ja, ta = iid_aligners
    reads = _mixed_reads(iid.text, np.random.RandomState(5))
    names = [f"q{j}" for j in range(len(reads))]
    quals = ["I" * len(r) for r in reads]
    want = _sams(ja.align(reads, names, quals))
    got = _sams(ta.align(reads, names, quals))
    assert got == want
    assert sum("\t4\t*" not in s for s in got) >= 41
    for a in ("last_fallback_frac", "last_ineligible_frac",
              "last_trunc_frac", "last_retry_frac"):
        assert getattr(ta, a) == getattr(ja, a), a
    assert ta.last_ineligible_frac == 3 / 43
    np.testing.assert_array_equal(ta.last_overflow[0], ja.last_overflow[0])
    np.testing.assert_array_equal(ta.last_overflow[1], ja.last_overflow[1])


@pytest.mark.parametrize("emit", ["sam", "records"])
def test_align_stream_auto_byte_equal(iid, iid_aligners, emit):
    ja, ta = iid_aligners
    reads = _mixed_reads(iid.text, np.random.RandomState(5))

    def batches():        # the last batch holds only beam-routed reads
        for s in (0, 16, 32, 40):
            yield s, None, reads[s:s + (8 if s >= 32 else 16)], None

    sopt = SamseOpt(n_multi=2)
    want = list(ja.align_stream(batches(), sopt=sopt, emit=emit))
    got = list(ta.align_stream(batches(), sopt=sopt, emit=emit))
    assert [s for s, _ in got] == [0, 16, 32, 40]
    if emit == "sam":
        assert got == want
    else:
        assert [_sams(p) for _, p in got] == [_sams(p) for _, p in want]


def test_engine_pigeon_forces_the_fast_path(iid):
    reads = _mixed_reads(iid.text, np.random.RandomState(5))
    ta = TAligner.from_arrays(iid.di, iid.text, engine="pigeon", device="cpu")
    ja = JAligner.from_arrays(iid.di, iid.text, engine="pigeon")
    assert _sams(ta.align(reads[:12])) == _sams(ja.align(reads[:12]))
    with pytest.raises(ValueError, match="ineligible"):
        ta.align(reads)
    with pytest.raises(ValueError, match="max_gapo"):
        TAligner.from_arrays(iid.di, iid.text, opt=AlnOpt(max_gapo=2),
                             engine="pigeon", device="cpu").align(reads[:4])
    beam = TAligner.from_arrays(iid.di, iid.text, opt=AlnOpt(max_gapo=2),
                                engine="auto", device="cpu")
    assert beam._align_device(reads[:4])[0] == "beam"


def _pair(g, opt=OPT_GAP, **attrs):
    """(JAX aligner, port aligner) with the same capacity attributes."""
    ja = JAligner.from_arrays(g.di, g.text, opt=opt)
    ta = TAligner.from_arrays(g.di, g.text, opt=opt, engine="auto",
                              device="cpu")
    for al in (ja, ta):
        for k, v in attrs.items():
            setattr(al, k, v)
    return ja, ta


def test_align_stream_staged_fallback_patch_and_splice(rep):
    """Batches that stage because they carry beam-routed reads: the pooled
    flush patches and splices their records; equal to the reference's
    stream and to its per-batch ``align``."""
    ja, ta = _pair(rep, _PIGEON_SEG_CAP=SEG_CAP, _PIGEON_REPEAT_THRESH=10.0)

    def mk_batch(seed):
        r2 = np.random.RandomState(seed)
        out = []
        for i in range(6):
            L = jpigeon.MAX_READ_LEN + 20 if i == 2 else 80
            p = r2.randint(0, len(rep.text) - L)
            r = rep.text[p:p + L].copy()
            q = r2.randint(0, L)
            r[q] = (r[q] + 1) % 4
            out.append(r)
        return out

    batches = [mk_batch(s) for s in (1, 2, 3)]
    ref = [_sams(ja.align(b, read_offset=100 * i))
           for i, b in enumerate(batches)]

    def gen():
        for i, b in enumerate(batches):
            yield 100 * i, None, b, None

    got = list(ta.align_stream(gen(), fb_group=3, fb_flush=1000))
    assert [s for s, _ in got] == [0, 100, 200]
    assert [_sams(p) for _, p in got] == ref
    want = list(ja.align_stream(gen(), fb_group=3, fb_flush=1000,
                                emit="sam"))
    assert list(ta.align_stream(gen(), fb_group=3, fb_flush=1000,
                                emit="sam")) == want
    assert ta.last_ineligible_frac == ja.last_ineligible_frac == 1 / 6


@pytest.fixture(scope="module")
def divergent():
    text, starts = repeat_text(seed=9, div=0.04)
    g = Genome(text)
    rs = np.random.RandomState(17)
    g.reads = []
    for c in starts[:8]:
        r = text[int(c) + 40:int(c) + 130].copy()
        for _ in range(2):
            q = rs.randint(0, 90)
            r[q] = (r[q] + rs.randint(1, 4)) % 4
        g.reads.append(r)
    g.starts = starts
    return g


TINY = dict(_PIGEON_SEG_CAP=4, _PIGEON_CAND_CAP=8, _PIGEON_REPEAT_THRESH=10.0)


@pytest.mark.parametrize("retry", [True, False])
def test_seg_phase_retry(divergent, retry):
    """Reads truncated with no verified candidate re-run on the half-shifted
    partition at the retry caps (or, with the retry off, on the beam)."""
    ja, ta = _pair(divergent, _PIGEON_RETRY=retry, **TINY)
    want, got = ja.align(divergent.reads), ta.align(divergent.reads)
    assert _sams(got) == _sams(want)
    for a in ("last_fallback_frac", "last_trunc_frac", "last_retry_frac"):
        assert getattr(ta, a) == getattr(ja, a), a
    if retry:
        assert ta.last_retry_frac > 0.0 and ta.last_fallback_frac == 0.0
        for j, c in enumerate(divergent.starts[:8]):
            assert got[j].pos == int(c) + 41 and not got[j].flag & 4
    else:
        assert ta.last_retry_frac == 0.0 and ta.last_fallback_frac > 0.0


def test_align_stream_pooled_retry_and_beam(divergent):
    """The stream defers the retry too: staged batches, one pooled
    seg_phase pass, then one pooled beam over the dual failures and the
    long reads, patch resolve and splice."""
    caps = dict(TINY, _PIGEON_RETRY_CAPS=(6, 8, 4))   # some retries fail too
    ja, ta = _pair(divergent, **caps)
    long_read = divergent.text[41_000:41_200].copy()
    rs = np.random.RandomState(3)
    clean = sample_reads(divergent.text, rs, 4, L=90, lo=45_000, hi=59_000)
    reads = divergent.reads + [long_read] + clean

    def gen():
        for s in (0, 5, 10):
            yield s, None, reads[s:s + 5], None

    for emit in ("sam", "records"):
        want = list(ja.align_stream(gen(), emit=emit, fb_group=2))
        got = list(ta.align_stream(gen(), emit=emit, fb_group=2))
        if emit == "sam":
            assert got == want
        else:
            assert [_sams(p) for _, p in got] == [_sams(p) for _, p in want]
    per_batch = [ta.align(reads[s:s + 5], read_offset=s) for s in (0, 5, 10)]
    assert [_sams(p) for _, p in got] == [_sams(p) for p in per_batch]
    mapped = [not r.flag & 4 for _, p in got for r in p]
    assert sum(mapped) >= 12


def test_repeat_profile_upshift_and_downshift(rep):
    ja, ta = _pair(rep, _PIGEON_SEG_CAP=SEG_CAP,
                   _PIGEON_REPEAT_CAPS=(64, 160, 64), _PIGEON_DOWNSHIFT_N=2)
    repeat_reads = [rep.text[c + 30:c + 120].copy() for c in rep.copies[:6]]
    clean = sample_reads(rep.text, np.random.RandomState(23), 6, L=90, k=0,
                         lo=35_000, hi=59_000)
    trail = []
    for reads in (repeat_reads, repeat_reads, clean, clean, repeat_reads):
        want, got = ja.align(reads), ta.align(reads)
        assert _sams(got) == _sams(want)
        assert ta._pigeon_profile == ja._pigeon_profile
        assert ta.last_trunc_frac == ja.last_trunc_frac
        trail.append((ta._pigeon_profile, ta.last_trunc_frac > 0))
    # the second repeat batch, at the wide caps, already counts as clean
    assert trail == [("repeat", True), ("repeat", False), ("base", False),
                     ("base", False), ("repeat", True)]


# -- K-mer seeding in the pipeline, and its cache ---------------------------------

@pytest.fixture
def k6(monkeypatch):
    """Both aligners seed with 6-mers (the real depth, 12, needs a genome
    of 2^24 bp)."""
    for cls in (JAligner, TAligner):
        monkeypatch.setattr(cls, "_kmer_k", property(lambda self: 6))


@pytest.mark.parametrize("written_by", ["hsa_tpu", "hsa_tpu_torch"])
def test_kmer_cache_is_shared(iid, k6, tmp_path, written_by):
    d = str(tmp_path)
    ja = JAligner.from_arrays(iid.di, iid.text, index_dir=d)
    ta = TAligner.from_arrays(iid.di, iid.text, engine="auto", device="cpu",
                              index_dir=d)
    first, second = (ja, ta) if written_by == "hsa_tpu" else (ta, ja)
    first._kmer_tables()
    with np.load(os.path.join(d, "kmer6.npz")) as z:
        assert sorted(z.files) == ["tk", "tl"]
        assert z["tk"].dtype == z["tl"].dtype == np.uint32
        assert z["tk"].shape == (4 ** 6,)
    assert os.listdir(d) == ["kmer6.npz"]
    tabs = second._kmer_tables()
    want = jexact.kmer_table(iid.dj, 6)
    for w, x in zip(want, tabs):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(x))
    if written_by == "hsa_tpu":
        assert ta.kmer_table_s[1] == "loaded"
    else:
        assert ta.kmer_table_s[1] == "built"


def test_kmer_cache_tolerates_a_read_only_directory(iid, k6, tmp_path):
    ta = TAligner.from_arrays(iid.di, iid.text, engine="auto", device="cpu",
                              index_dir=str(tmp_path / "missing"))
    tk, _ = ta._kmer_tables()
    assert tk.shape == (4 ** 6,) and ta.kmer_table_s[1] == "built"


def test_align_kmer_seeded_byte_equal(iid, k6):
    """K > 0 in the pipeline: the native pack's K-mer fields, the table
    gather and the tail scan."""
    ja, ta = _pair(iid, opt=None)
    reads = _mixed_reads(iid.text, np.random.RandomState(8), n=24)
    assert _sams(ta.align(reads)) == _sams(ja.align(reads))
    occ_j, fb_j, miss_j = ja.pigeon_occ_arrays(reads[:24], 6)
    occ_t, fb_t, miss_t = ta.pigeon_occ_arrays(reads[:24], 6)
    for k in occ_j:
        assert_same_arrays(occ_j[k], occ_t[k], k)
    assert_same_arrays(fb_j, fb_t, "fb")
    assert_same_arrays(miss_j, miss_t, "missed")
    def tuples(lists):
        return [[dataclasses.astuple(o) for o in occs] for occs in lists]

    lists = tuples(ta.pigeon_occurrences(reads[:24], 6)[0])
    assert lists == tuples(ja.pigeon_occurrences(reads[:24], 6)[0])
    assert lists == tuples(tpigeon.occ_arrays_to_lists(occ_t, 24))
    assert any(lists)


# -- the command line ---------------------------------------------------------------

def test_cli_align_auto_matches_jax_cli(tmp_path):
    rs = np.random.RandomState(3)
    chrom = rs.randint(0, 4, 8000).astype(np.int8)
    (tmp_path / "ref.fa").write_text(">seq1\n" + alphabet.decode(chrom) + "\n")
    reads = _mixed_reads(chrom, rs, n=20)
    with open(tmp_path / "reads.fq", "w") as fh:
        for i, r in enumerate(reads):
            fh.write(f"@r{i}\n{alphabet.decode(r)}\n+\n{'I' * len(r)}\n")
    ref, fq = str(tmp_path / "ref.fa"), str(tmp_path / "reads.fq")
    assert tcli.main(["index", ref]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "hsa_tpu.cli", "align", ref, fq,
                        "--batch", "8", "-f", str(tmp_path / "jax.sam"),
                        "--metrics", str(tmp_path / "jax.json"),
                        "--platform", "cpu"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    # the default engine is auto; spelled out it gives the same
    for extra, tag in (([], "port"), (["--engine", "auto"], "port2")):
        assert tcli.main(["align", ref, fq, "--batch", "8", "--device", "cpu",
                          "-f", str(tmp_path / f"{tag}.sam"), "--metrics",
                          str(tmp_path / f"{tag}.json")] + extra) == 0
        assert (tmp_path / f"{tag}.sam").read_text() == \
            (tmp_path / "jax.sam").read_text()
    mj = json.load(open(tmp_path / "jax.json"))
    mt = json.load(open(tmp_path / "port.json"))
    assert mt["config"]["engine"] == mj["config"]["engine"] == "auto"
    # the port's metrics hold the reference's keys, plus the device in the
    # config, each batch's wait and each span name's seconds and count
    assert set(mt) == set(mj) | {"spans"}
    assert mt["spans"]["stream.yield"]["n"] == 3
    assert set(mt["config"]) == set(mj["config"]) | {"device"}
    timers = {k for k in mj if k.startswith("t_")} | {"wall_s", "config",
                                                       "batches"}
    for k in set(mj) - timers:
        assert mt[k] == mj[k], k
    assert len(mt["batches"]) == len(mj["batches"]) == 3
    for bt, bj in zip(mt["batches"], mj["batches"]):
        assert set(bt) == set(bj) | {"wait_s"}
        assert {k: bt[k] for k in bj} == bj
    assert mt["reads_in"] == 23 and mt["reads_mapped"] >= 21
