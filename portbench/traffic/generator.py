"""The one traffic generator: wgsim's read model, vectorised, read from a
traffic file's parameters.

The model is that of lh3/wgsim (``wgsim.c``): the genome is mutated once
(substitutions, and at ``indel_frac`` of the sites indels, each extended with
probability ``indel_extend``; insertions of at most 4 bases), reads are cut
from the mutated haplotype at uniform positions on both strands, and every
base is changed with probability ``err_rate``.  Pairs are the two ends of a
fragment of N(``outer_mean``, ``outer_sd``) bases, read 2 from the reverse
strand, the two swapped with probability 1/2.  Departures from wgsim are
listed in ``PERF.md``: one haplotype (wgsim ``-h``), and no reads dropped for
ambiguous bases (the genome has none).

Fragments start at uniform positions over the haplotype.  Everything is
drawn from one ``numpy.random.Generator`` seeded with the run's seed.
"""

from __future__ import annotations

import numpy as np

CHUNK = 1 << 16


def mutate(g, rng, mut_rate, indel_frac, indel_extend):
    """(haplotype int8[m], map int64[n + 1]): wgsim's mutations applied once
    to ``g``; ``map[i]`` is where reference base ``i`` starts in the
    haplotype."""
    n = len(g)
    site = np.nonzero(rng.random(n) < mut_rate)[0]
    r = rng.random(site.size)
    sub = r >= indel_frac
    dele = ~sub & (rng.random(site.size) < 0.5)
    ins = ~sub & ~dele
    base = g.copy()
    s = site[sub]
    base[s] = (g[s] + rng.integers(1, 4, s.size)) & 3
    keep = np.ones(n, np.int64)
    d = site[dele]
    dlen = rng.geometric(1.0 - indel_extend, d.size)
    ends = np.minimum(d + dlen, n)
    run = np.zeros(n + 1, np.int64)
    np.add.at(run, d, 1)
    np.add.at(run, ends, -1)
    keep[np.cumsum(run)[:n] > 0] = 0
    ipos = site[ins]
    ipos_ok = keep[ipos] > 0
    ipos = ipos[ipos_ok]
    ilen = np.minimum(rng.geometric(1.0 - indel_extend, ins.sum()), 4)[ipos_ok]
    counts = keep.copy()
    counts[ipos] += ilen
    hap = np.repeat(base, counts)
    start = np.concatenate([[0], np.cumsum(counts)])
    # the inserted bases follow their site's own base
    at = np.repeat(start[ipos] + 1, ilen) + (
        np.arange(int(ilen.sum())) - np.repeat(np.cumsum(ilen) - ilen, ilen))
    hap[at] = rng.integers(0, 4, at.size)
    return hap.astype(np.int8), start


def _errors(reads, rng, err_rate):
    e = rng.random(reads.shape) < err_rate
    reads[e] = (reads[e] + rng.integers(1, 4, int(e.sum()))) & 3


def _revcomp(x):
    return (3 - x[:, ::-1]).astype(np.int8)


def reads(spec, g, n, L, paired, seed):
    """``n`` reads (or pairs) of ``L`` bases drawn from ``seed``:
    int8 [n, L] (and a second [n, L] for read 2, else None)."""
    d = draw(spec, g, n, L, paired, seed)
    return d["r1"], d["r2"]


def draw(spec, g, n, L, paired, seed):
    """:func:`reads` with where each came from: the haplotype ``hap``, each
    fragment's start ``start`` and length ``frag`` on it, and ``flip`` (read
    1 taken from the reverse strand)."""
    rng = np.random.default_rng(seed)
    hap, _ = mutate(g, rng, spec["mut_rate"], spec["indel_frac"],
                       spec["indel_extend"])
    m = len(hap)
    out1 = np.empty((n, L), np.int8)
    out2 = np.empty((n, L), np.int8) if paired else None
    start = np.empty(n, np.int64)
    frag = np.empty(n, np.int64)
    flips = np.empty(n, bool)
    for c0 in range(0, n, CHUNK):
        B = min(CHUNK, n - c0)
        if paired:
            d = np.rint(rng.normal(spec["outer_mean"], spec["outer_sd"], B))
            d = np.maximum(d.astype(np.int64), L)
        else:
            d = np.full(B, L, np.int64)
        p = (rng.random(B) * (m - d + 1)).astype(np.int64)
        r1 = hap[p[:, None] + np.arange(L)]
        flip = rng.random(B) < 0.5
        if paired:
            r2 = _revcomp(hap[(p + d - L)[:, None] + np.arange(L)])
            r1[flip], r2[flip] = r2[flip], r1[flip].copy()
            _errors(r1, rng, spec["err_rate"])
            _errors(r2, rng, spec["err_rate"])
            out2[c0:c0 + B] = r2
        else:
            r1[flip] = _revcomp(r1[flip])
            _errors(r1, rng, spec["err_rate"])
        out1[c0:c0 + B] = r1
        start[c0:c0 + B], frag[c0:c0 + B], flips[c0:c0 + B] = p, d, flip
    return dict(r1=out1, r2=out2, hap=hap, start=start, frag=frag, flip=flips)


def write_fastq(path, reads_, names_from: int, qual_char: str):
    """FASTQ of ``reads_`` named ``r<ordinal>`` (ordinals from
    ``names_from``), every quality ``qual_char`` (wgsim writes one quality
    for its error rate)."""
    n, L = reads_.shape
    width = 10
    rec = 1 + width + 1 + L + 3 + L + 1
    lut = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as fh:
        for c0 in range(0, n, CHUNK):
            B = min(CHUNK, n - c0)
            buf = np.empty((B, rec), np.uint8)
            buf[:, 0] = ord("@")
            buf[:, 1] = ord("r")
            ids = np.arange(names_from + c0, names_from + c0 + B)
            for k in range(width - 1):
                buf[:, width - k] = ord("0") + ids // 10 ** k % 10
            o = width + 1
            buf[:, o] = ord("\n")
            buf[:, o + 1:o + 1 + L] = lut[reads_[c0:c0 + B]]
            o += 1 + L
            buf[:, o:o + 3] = np.frombuffer(b"\n+\n", np.uint8)
            buf[:, o + 3:o + 3 + L] = ord(qual_char)
            buf[:, -1] = ord("\n")
            fh.write(buf.tobytes())


def read_name(ordinal: int) -> str:
    return f"r{ordinal:09d}"
