"""The genome and read generators: deterministic, and with wgsim's
statistics."""

import numpy as np
import pytest

from portbench.genome import synth_genome
from portbench.traffic import generator as G

SPEC = dict(mut_rate=0.001, indel_frac=0.15, indel_extend=0.3, err_rate=0.02,
            outer_mean=500, outer_sd=50)
BIG = 2 ** 33 + 7                  # seeds beyond 32 bits


def test_genome_is_the_repository_model():
    """The bases are ``benchmarks/common.py``'s for the same arguments."""
    import importlib.util
    import os
    from tests_paths import ROOT
    s = importlib.util.spec_from_file_location(
        "bench_common", os.path.join(ROOT, "benchmarks", "common.py"))
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    g = synth_genome(400_000, "repeats", 21)
    assert np.array_equal(g, m.synth_genome(400_000, "repeats", seed=21))
    assert np.array_equal(g, synth_genome(400_000, "repeats", 21))


@pytest.mark.parametrize("paired", [False, True])
def test_reads_deterministic(paired):
    g = synth_genome(200_000, "repeats", 5)
    a = G.reads(SPEC, g, 3000, 100, paired, BIG)
    b = G.reads(SPEC, g, 3000, 100, paired, BIG)
    c = G.reads(SPEC, g, 3000, 100, paired, BIG + 1)
    for x, y in zip(a, b):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    assert a[0].dtype == np.int8 and a[0].min() >= 0 and a[0].max() <= 3


def test_mutations_follow_wgsim():
    rng = np.random.default_rng(3)
    g = rng.integers(0, 4, 2_000_000).astype(np.int8)
    hap, start = G.mutate(g, rng, 0.001, 0.15, 0.3)
    kept = np.diff(start)
    dels = (kept == 0).sum()
    ins_bases = (kept[kept > 1] - 1).sum()
    subs = ((hap[start[:-1]] != g) & (kept == 1)).sum()
    sites = 2_000_000 * 0.001
    assert abs(subs / sites - 0.85) < 0.05
    # deletions: half of the indels, 1/(1 - 0.3) bases each on average
    assert abs(dels / (sites * 0.075) - 1 / 0.7) < 0.15
    assert abs(ins_bases / (sites * 0.075) - 1 / 0.7) < 0.15
    assert len(hap) == len(g) - dels + ins_bases


@pytest.mark.parametrize("paired", [False, True])
def test_reads_follow_wgsim(paired):
    rng = np.random.default_rng(4)
    g = rng.integers(0, 4, 1_000_000).astype(np.int8)
    d = G.draw(SPEC, g, 20_000, 100, paired, BIG)
    hap, L = d["hap"], 100
    fwd = hap[d["start"][:, None] + np.arange(L)]
    if paired:
        far = G._revcomp(hap[(d["start"] + d["frag"] - L)[:, None]
                         + np.arange(L)])
        exp1 = np.where(d["flip"][:, None], far, fwd)
        exp2 = np.where(d["flip"][:, None], fwd, far)
        err = np.mean(np.concatenate([d["r1"] != exp1, d["r2"] != exp2]))
        assert abs(d["frag"].mean() - 500) < 2
        assert abs(d["frag"].std() - 50) < 2
    else:
        exp1 = np.where(d["flip"][:, None], G._revcomp(fwd), fwd)
        err = np.mean(d["r1"] != exp1)
    assert abs(err - 0.02) < 0.001
    assert abs(d["flip"].mean() - 0.5) < 0.02
    # uniform over the haplotype
    q = np.quantile(d["start"], [0.25, 0.5, 0.75]) / len(hap)
    assert np.allclose(q, [0.25, 0.5, 0.75], atol=0.02)


def test_fastq_names_and_records(tmp_path):
    r = np.random.default_rng(0).integers(0, 4, (5, 12)).astype(np.int8)
    p = tmp_path / "r.fq"
    G.write_fastq(str(p), r, 7, "2")
    lines = p.read_text().splitlines()
    assert lines[0] == "@" + G.read_name(7) and lines[4] == "@r000000008"
    assert lines[1] == "".join("ACGT"[x] for x in r[0])
    assert lines[2] == "+" and lines[3] == "2" * 12

