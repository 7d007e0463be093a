"""The plain reference against the port's own oracle on a small genome
(the reference imports nothing of the port; this test does, to hold it)."""

import json
import os

import numpy as np
import pytest

from portbench import check, genome
from portbench.genome import synth_genome
from portbench.reference import oracle
from portbench.traffic import generator as G
from tests_paths import ROOT

SPEC = dict(mut_rate=0.001, indel_frac=0.15, indel_extend=0.3, err_rate=0.02,
            outer_mean=500, outer_sd=50)


@pytest.mark.parametrize("text", ["iid", "repeats", "zeros", "tandem"])
def test_suffix_array_equals_the_ports(text):
    from hsa_tpu_torch import fmcore
    t = {"iid": lambda: synth_genome(20_000, "iid", 3),
         "repeats": lambda: synth_genome(20_000, "repeats", 3),
         "zeros": lambda: np.zeros(500, np.int8),
         "tandem": lambda: np.tile(np.array([0, 1, 1], np.int8), 300)}[text]()
    assert np.array_equal(oracle.suffix_array(t), fmcore.suffix_array(t))


def test_records_equal_the_ports_oracle():
    """Byte-equal SAM lines to ``hsa_tpu_torch.pipeline.oracle_align`` on
    wgsim reads of a repeat genome, tie-breaks at large ordinals."""
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.io.fastx import RefMeta
    from hsa_tpu_torch.pipeline import oracle_align
    g = synth_genome(120_000, "repeats", 5)
    r, _ = G.reads(SPEC, g, 60, 100, False, 2 ** 35 + 1)
    names = [G.read_name(i) for i in range(60)]
    quals = ["2" * 100] * 60
    meta = RefMeta(names=["chr21"], starts=np.zeros(1, np.int64),
                   lengths=np.asarray([len(g)], np.int64), total=len(g))
    off = 3 * 2 ** 31
    want = [x.to_sam() for x in oracle_align(g, meta, list(r), names, quals,
                                             AlnOpt(), read_offset=off)]
    ref = oracle.Reference(g, "chr21", oracle.suffix_array(g),
                           oracle.suffix_array(g[::-1].copy()), oracle.Opt())
    got = [ref.align(r[i], names[i], quals[i], off + i)[0] for i in range(60)]
    assert got == want


@pytest.mark.parametrize("workers", [0, 2])
def test_edit_score_and_compare(tmp_path, workers):
    g = synth_genome(60_000, "repeats", 9)
    r, _ = G.reads(SPEC, g, 20, 100, False, 11)
    opt = oracle.Opt()
    cfg = {"name": "t", "genome": {"name": "chr21", "length": len(g),
                                   "model": "repeats", "seed": 9}}
    genome.load_genome(cfg, str(tmp_path))
    with check.reference(cfg, g, str(tmp_path), [opt], workers) as refs:
        got = [(i, w[0]) for i, w in enumerate(refs.align(
            0, [(r[i], G.read_name(i), "2" * 100, i) for i in range(20)]))]
        same = check.compare(refs, g, r, 20, got, opt)
        assert same["status_diff"] == same["line_diff"] == 0.0
        for i, line in got:
            f = line.split("\t")
            if not int(f[1]) & 4:
                tags = dict(t.split(":", 2)[::2] for t in f[11:])
                want = 3 * int(tags["XM"]) + (11 * int(tags["XO"]) + 4 * (
                    int(tags["XG"]) - int(tags["XO"])) if int(tags["XO"])
                    else 0)
                assert check.edit_score(line, r[i], g, opt) == want
        # a record moved by one base differs, repetitive or not
        i, line = next((i, ln) for i, ln in got
                       if not int(ln.split("\t")[1]) & 4)
        f = line.split("\t")
        f[3] = str(int(f[3]) + 1)
        bad = check.compare(refs, g, r, 20, [(i, "\t".join(f))], opt)
    assert bad["line_diff"] == 1.0


def test_repeat_rule():
    """``Reference.repeat`` counts each k-mer of both strands as a scan of
    the text does; a repetitive read is held by flag, score and best
    position, not by its tags."""
    g = synth_genome(100_000, "repeats", 5)
    ref = oracle.Reference(g, "chr21", oracle.suffix_array(g),
                           oracle.suffix_array(g[::-1].copy()), oracle.Opt())
    text = g.tobytes()

    def scan(read, k, over):
        for seq in (read, oracle.revcomp(read)):
            for i in range(len(seq) - k + 1):
                km, at, c = seq[i:i + k].tobytes(), -1, 0
                while (at := text.find(km, at + 1)) >= 0:
                    c += 1
                if c > over:
                    return True
        return False

    rng = np.random.default_rng(2)
    starts = rng.integers(0, len(g) - 100, 30)
    reads = [g[p:p + 100].copy() for p in starts]
    for k, over in ((16, 32), (12, 2)):
        got = [ref.repeat(x, k, over) for x in reads]
        assert got == [scan(x, k, over) for x in reads]
        assert k == 16 or 0 < sum(got) < len(got)
    assert check.repeat_k(100, oracle.Opt()) == 16
    assert check.repeat_k(150, oracle.Opt()) == 21
    opt = oracle.Opt()
    read = next(x for x in reads if ref.align(x, "r", "2" * 100, 0)[1]
                is not None)
    line, _best, best_set, _trunc = ref.align(read, "r", "2" * 100, 0)
    f = line.split("\t")
    score = check._score(line, read, g, opt)

    def judged(fields, repeat):
        moved = "\t".join(fields)
        return check._judge([moved], [line], [check._score(moved, read, g,
                                                             opt)],
                            [score], [best_set], repeat)

    tags = [t for t in f[11:] if not t.startswith("X1")]
    lower = f[:4] + [str(int(f[4]) - 1)] + f[5:11]
    higher = f[:4] + [str(int(f[4]) + 1)] + f[5:11]
    moved = f[:3] + [str(int(f[3]) + 1)] + f[4:]
    # a repetitive read: flag, score and best position, not MAPQ or tags
    assert judged(f[:4] + ["0"] + f[5:11], True)
    assert not judged(moved, True)
    # a read the port marks as capped: MAPQ at most the reference's, no X1
    assert judged(lower + tags, False)
    assert not judged(higher + tags, False)
    assert not judged(moved[:11] + tags, False)
    # any other read: the whole line
    assert judged(f, False) and not judged(lower + f[11:], False)


@pytest.fixture(scope="module")
def iid_reference():
    g = synth_genome(200_000, "iid", 13)
    return g, oracle.Reference(g, "chr21", oracle.suffix_array(g),
                               oracle.suffix_array(g[::-1].copy()),
                               oracle.Opt())


@pytest.mark.parametrize("seed_len,subs,mapped", [
    (1024, (5, 20, 35), True),
    (1024, (5, 17, 29, 41), True),
    (32, (20, 30, 40), False),
    (32, (5, 20, 35), True),
    (50, (20, 30, 40), True),
    (49, (20, 30, 40), False),
], ids=["unseeded-3", "unseeded-4", "seed-holds-3", "seed-holds-2",
        "l-at-L", "l-under-L"])
def test_seed_rule(iid_reference, seed_len, subs, mapped):
    """``-l`` at or over the read length turns seeding off (the ``bwa aln``
    manual; ``bwtaln.c``): under ``-n 4 -k 2`` a 50 bp read with 3 or 4
    substitutions spread over it maps at its origin; under a seed, one with
    3 in its last ``-l`` bases does not."""
    g, ref = iid_reference
    ref = ref.with_opt(oracle.Opt(max_diff=4, seed_len=seed_len,
                                  max_seed_diff=2))
    for p in np.random.default_rng(seed_len).integers(0, len(g) - 50, 4):
        read = g[p:p + 50].copy()
        read[list(subs)] = (read[list(subs)] + 1) % 4
        f = ref.align(read, "r", "2" * 50, 0)[0].split("\t")
        if mapped:
            assert (f[1], f[3], f[5]) == ("0", str(p + 1), "50M")
            assert f"NM:i:{len(subs)}" in f
        else:
            assert f[1] == "4"


def test_beam_repeat_rule(tmp_path):
    """On the beam route the port's hit buffer caps the enumeration: every
    read whose strand search the port's beam flags with ``n_hits_dropped``
    is one the reference calls repetitive."""
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.index.layout import build_device_index
    from hsa_tpu_torch.pipeline import Aligner
    cfg = {"name": "t", "engine": "auto", "options": {"-o": 2},
           "genome": {"name": "chr21", "length": 100_000, "model": "repeats",
                      "seed": 6}}
    assert check.beam_route(cfg)
    assert check.beam_route(dict(cfg, engine="beam", options={"-o": 1}))
    g = genome.load_genome(cfg, str(tmp_path))
    r, _ = G.reads(SPEC, g, 100, 50, False, 1)
    al = Aligner.from_arrays(build_device_index(g), g,
                             opt=AlnOpt(max_gapo=2), device="cpu")
    al.search_batch(list(r))
    hits_dropped = al.last_overflow[1]
    flagged = (hits_dropped[:100] > 0) | (hits_dropped[100:] > 0)
    opt = oracle.Opt(max_gapo=2)
    with check.reference(cfg, g, str(tmp_path), [opt], 0) as refs:
        rep = np.asarray(check.repeats(refs, list(r), 50, opt, True))
    print(f"beam route: {flagged.sum()} of 100 reads flagged by the port, "
          f"{rep.sum()} repetitive, {(rep & ~flagged).sum()} of them "
          f"unflagged")
    assert flagged.any() and rep[flagged].all()


@pytest.mark.parametrize("name", ["chr21rep_se100", "chr21rep_pe150"])
def test_repeat_rule_of_the_cells(tmp_path, name):
    """The cells' configurations take the pigeon route, where a read is
    repetitive by ``repeat_k`` and ``REPEAT_OVER``, decision for
    decision."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           name + ".json")) as fh:
        cfg = json.load(fh)
    cfg["genome"]["length"] = 100_000
    assert not check.beam_route(cfg)
    g = genome.load_genome(cfg, str(tmp_path))
    L = cfg["read_length"]
    r, _ = G.reads(SPEC, g, 40, L, False, 3)
    opt = check.reference_opt(cfg)
    with check.reference(cfg, g, str(tmp_path), [opt], 0) as refs:
        got = check.repeats(refs, list(r), L, opt, check.beam_route(cfg))
        want = [refs.refs[0].repeat(x, check.repeat_k(L, opt),
                                    check.REPEAT_OVER) for x in r]
    assert got == want and 0 < sum(got) < len(got)
