"""The port's paired ends on the pigeon route against ``hsa_tpu``'s, on the
CPU: ``_align_pe_device`` / ``_align_pe_occ`` (both ``defer`` settings),
``align_pe`` and ``cli align-pe`` at its default engine (the staged
``align_pe_stream`` is in ``test_torch_pe_stream.py``).  Integer work and text: tolerance 0, every array equal in
dtype, shape and value and every SAM byte-equal.

One diverged repeat family at small capacity caps makes the escalations
happen: ends cut from it are truncated with no verified candidate (a
retry), and at small retry caps some retries fail too (the beam).  Every
batch is 8 pairs of 70 bp so that the JAX side compiles few shapes.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt
from hsa_tpu.pipeline import Aligner as JAligner
from hsa_tpu_torch import cli as tcli
from hsa_tpu_torch.pipeline import Aligner as TAligner
from hsa_tpu_torch.pipeline import ReadBatch
from test_torch_pigeon import Genome, assert_same_arrays, repeat_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPT = AlnOpt(max_diff=2, max_gapo=1)
L, ISIZE = 70, 200
# small caps force capacity misses; the pinned threshold keeps the base
# profile (the upshift would land after different batch counts per flow);
# the small retry caps make some retries fail as well
CAPS = dict(_PIGEON_SEG_CAP=4, _PIGEON_CAND_CAP=8, _PIGEON_REPEAT_THRESH=10.0,
            _PIGEON_RETRY_CAPS=(6, 8, 4))
FRACS = ("last_fallback_frac", "last_ineligible_frac", "last_retry_frac")


@pytest.fixture(scope="module")
def fam():
    """tests/test_pigeon_repeats.py:build_divergent_family, indexed."""
    text, starts = repeat_text(seed=9, div=0.04)
    g = Genome(text)
    g.starts = starts
    return g


def _aligners(g, engine="auto", **attrs):
    ja = JAligner.from_arrays(g.di, g.text, opt=OPT, engine=engine)
    ta = TAligner.from_arrays(g.di, g.text, opt=OPT, engine=engine,
                              device="cpu")
    for al in (ja, ta):
        for k, v in dict(CAPS, **attrs).items():
            setattr(al, k, v)
    return ja, ta


def mk_batch(g, seed, n_fam=3, n=8, lo=32_000):
    """``n`` FR pairs, two substitutions in each end; the first ``n_fam``
    lie inside the diverged family, the rest in the iid part from ``lo``."""
    rs = np.random.RandomState(seed)
    r1s, r2s = [], []
    for i in range(n):
        p = (int(g.starts[rs.randint(len(g.starts))]) + 40 if i < n_fam
             else rs.randint(lo, len(g.text) - ISIZE - 1))
        frag = g.text[p:p + ISIZE].copy()
        for end in (0, ISIZE - L):
            for _ in range(2):
                q = end + rs.randint(0, L)
                frag[q] = (frag[q] + rs.randint(1, 4)) % 4
        r1s.append(frag[:L].astype(np.int8))
        r2s.append(alphabet.revcomp(frag[-L:].astype(np.int8)))
    return r1s, r2s


def with_long_ends(g, r1s, r2s, at=(1, 5)):
    """End 2 of the pairs ``at`` becomes a 200 bp read (longer than the
    engine takes: the router hands that end alone to the beam)."""
    r2s = list(r2s)
    for j in at:
        p = 40_000 + 300 * j
        r1s[j] = g.text[p:p + L].copy()
        r2s[j] = alphabet.revcomp(g.text[p + 150:p + 350])
    return r1s, r2s


def with_rescue(g, r1s, r2s, j=6):
    """Pair ``j``: end 2 carries 6 substitutions, over the search budget
    and within the mate rescue's."""
    r2s = list(r2s)
    r1s[j] = g.text[50_000:50_000 + L].copy()
    r2 = alphabet.revcomp(g.text[50_000 + ISIZE - L:50_000 + ISIZE])
    for q in (5, 15, 25, 35, 45, 55):
        r2[q] = (r2[q] + 1) % 4
    r2s[j] = r2
    return r1s, r2s


SCENARIOS = {
    "clean": lambda g: mk_batch(g, 4, n_fam=0),
    "divergent": lambda g: mk_batch(g, 3),
    "long_end2": lambda g: with_long_ends(g, *mk_batch(g, 1)),
}


def _assert_same_occ(want, got):
    assert set(want) == set(got)
    for k in want:
        assert_same_arrays(want[k], got[k], k)


@pytest.mark.parametrize("what", list(SCENARIOS))
def test_pe_device_and_occ_match(fam, what):
    ja, ta = _aligners(fam)
    r1s, r2s = SCENARIOS[what](fam)
    all_reads = list(r1s) + list(r2s)
    hj = ja._align_pe_device(r1s, r2s)
    ht = ta._align_pe_device(r1s, r2s)
    # the handle, field by field
    assert hj[0] == ht[0] == "pigeon"
    assert hj[1:5] == ht[1:5] and hj[6] == ht[6] == 8
    for f in hj[5]._fields:
        assert_same_arrays(getattr(hj[5], f), getattr(ht[5], f), f)
    # deferred: the escalations come back to the caller
    dj = ja._align_pe_occ(hj, all_reads, defer=True)
    dt = ta._align_pe_occ(ht, all_reads, defer=True)
    _assert_same_occ(dj[0], dt[0])
    assert_same_arrays(dj[1], dt[1], "trunc")
    assert_same_arrays(dj[2], dt[2], "c2x")
    assert dj[3] == dt[3] and dj[4] == dt[4]
    for a in FRACS:
        assert getattr(ja, a) == getattr(ta, a), a
    # in-batch: retry merge, beam re-run, occ merge
    calls = _spy(ta)
    oj = ja._align_pe_occ(hj, all_reads)
    ot = ta._align_pe_occ(ht, all_reads)
    _assert_same_occ(oj[0], ot[0])
    assert_same_arrays(oj[1], ot[1], "trunc")
    assert_same_arrays(oj[2], ot[2], "c2x")
    assert ot[3] == [] and ot[4] == []
    for a in FRACS:
        assert getattr(ja, a) == getattr(ta, a), a
    ld, hd = ta.last_overflow
    assert ld.shape == hd.shape == (16,)
    if what == "clean":
        assert dt[3] == [] and dt[4] == [] and calls == dict(retry=0, beam=0)
        assert ta.last_fallback_frac == ta.last_retry_frac == 0.0
    elif what == "divergent":
        # two retries, one of which fails again and goes to the beam
        assert len(dt[4]) == 2 and dt[3] == []
        assert calls == dict(retry=1, beam=1)
        assert ta.last_retry_frac == 2 / 16
        assert ta.last_fallback_frac == 1 / 16
    else:
        # the long ends are end 2 of pairs 1 and 5: reads 9 and 13 of 16
        assert dt[3] == [9, 13] and ht[3] == [j for j in range(16)
                                              if j not in (9, 13)]
        assert ta.last_ineligible_frac == 2 / 16 and calls["beam"] == 1
    assert len(np.unique(ot[0]["rid"])) >= 14


def _spy(al):
    """Count the aligner's escalation calls."""
    calls = dict(retry=0, beam=0)
    for name, key in (("_pigeon_retry", "retry"), ("_beam_rerun", "beam")):
        def wrap(*a, _f=getattr(al, name), _k=key, **kw):
            calls[_k] += 1
            return _f(*a, **kw)
        setattr(al, name, wrap)
    return calls


def _mixed_batch(g):
    """Family pairs (a retry and a dual failure), a mate to rescue and two
    long ends, in one batch."""
    return with_long_ends(g, *with_rescue(g, *mk_batch(g, 3)))


@pytest.mark.parametrize("engine,emit", [("auto", "records"),
                                         ("pigeon", "sam")])
def test_align_pe_byte_equal(fam, engine, emit):
    ja, ta = _aligners(fam, engine)
    r1s, r2s = (_mixed_batch(fam) if engine == "auto"
                else with_rescue(fam, *mk_batch(fam, 3)))
    names = [f"p{j}" for j in range(8)]
    q1, q2 = ["I" * len(r) for r in r1s], ["I" * len(r) for r in r2s]
    want = ja.align_pe(r1s, r2s, names, q1, q2, read_offset=40, emit=emit)
    got = ta.align_pe(r1s, r2s, names, q1, q2, read_offset=40, emit=emit)
    if emit == "records":
        got, want = [r.to_sam() for r in got], [r.to_sam() for r in want]
    else:
        assert got[1] == want[1]
        got, want = got[0], want[0]
    assert got == want
    assert ta.last_rescue_jobs >= 1
    assert [ln.split("\t")[0] for ln in got if "XT:Z:M" in ln] == ["p6"]
    assert sum(int(ln.split("\t")[1]) & 4 == 0 for ln in got) >= 15
    # ReadBatch inputs, as the command line hands them over, change nothing
    rb1, rb2 = ReadBatch.from_reads(r1s), ReadBatch.from_reads(r2s)
    again = ta.align_pe(rb1, rb2, names, q1, q2, read_offset=40, emit="sam")
    assert again[0] == got
    if engine == "pigeon":
        with pytest.raises(ValueError, match="ineligible"):
            ta.align_pe(*_mixed_batch(fam))


# -- the command line ---------------------------------------------------------------

def _write_fastq(path, names, reads):
    with open(path, "w") as fh:
        for nm, r in zip(names, reads):
            fh.write(f"@{nm}\n{alphabet.decode(r)}\n+\n{'I' * len(r)}\n")


def test_cli_align_pe_default_engine_matches_jax_cli(tmp_path):
    """No ``--engine`` = ``--engine auto`` = ``hsa_tpu``'s ``align-pe``,
    byte for byte, with the shared counters equal."""
    rs = np.random.RandomState(13)
    chrom = rs.randint(0, 4, 20_000).astype(np.int8)
    (tmp_path / "ref.fa").write_text(">c1\n" + alphabet.decode(chrom) + "\n")
    g = type("G", (), dict(text=chrom, starts=None))
    r1s, r2s = [], []
    for seed in (1, 2, 3):
        a, b = mk_batch(g, seed, n_fam=0, lo=0)
        r1s += a
        r2s += b
    r1s[2], r2s[2] = chrom[3000:3000 + L].copy(), \
        alphabet.revcomp(chrom[3150:3350])            # a 200 bp end
    r2 = alphabet.revcomp(chrom[5300 - L:5300])       # a mate to rescue
    for q in (5, 15, 25, 35, 45, 55):
        r2[q] = (r2[q] + 1) % 4
    r1s[20], r2s[20] = chrom[5100:5100 + L].copy(), r2
    names = [f"p{j}" for j in range(len(r1s))]
    _write_fastq(tmp_path / "r1.fq", names, r1s)
    _write_fastq(tmp_path / "r2.fq", names, r2s)
    ref = str(tmp_path / "ref.fa")
    r1, r2 = str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")
    assert tcli.main(["index", ref]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", "hsa_tpu.cli", "align-pe", ref,
                        r1, r2, "--batch", "8", "-f",
                        str(tmp_path / "jax.sam"), "--metrics",
                        str(tmp_path / "jax.json"), "--platform", "cpu"],
                       capture_output=True, text=True, cwd=REPO, env=env,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    want = (tmp_path / "jax.sam").read_text()
    for extra, tag in (([], "port"), (["--engine", "auto"], "port2")):
        args = ["align-pe", ref, r1, r2, "--batch", "8", "--device", "cpu",
                "-f", str(tmp_path / f"{tag}.sam"), "--metrics",
                str(tmp_path / f"{tag}.json")] + extra
        assert tcli.main(args) == 0
        assert (tmp_path / f"{tag}.sam").read_text() == want
    assert "XT:Z:M" in want
    mj = json.load(open(tmp_path / "jax.json"))
    mt = json.load(open(tmp_path / "port.json"))
    assert mt["config"]["engine"] == mj["config"]["engine"] == "auto"
    assert set(mt["config"]) == set(mj["config"]) | {"device"}
    for k in ("reads_in", "records_out", "reads_mapped", "mapped_frac"):
        assert mt[k] == mj[k], k
    assert mt["reads_in"] == 48 and mt["reads_mapped"] >= 47
    # per batch its own rescue jobs: those of that batch aligned alone
    assert [b["n"] for b in mt["batches"]] == [16, 16, 16]
    al = TAligner(ref + ".hsa", device="cpu")
    jobs = []
    for s in (0, 8, 16):
        al.align_pe(r1s[s:s + 8], r2s[s:s + 8], read_offset=s)
        jobs.append(al.last_rescue_jobs)
    assert [b["rescue_jobs"] for b in mt["batches"]] == jobs
    assert jobs == [1, 0, 1]     # the long end's pair, none, the rescue
    assert all("wait_s" in b for b in mt["batches"])
    # --resume after a finished run appends nothing
    assert tcli.main(args + ["--resume"]) == 0
    assert (tmp_path / "port2.sam").read_text() == want
