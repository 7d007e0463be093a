"""A configuration's genome and the port's index of it, cached in the checkout.

The genome is made from the fixed seed in the configuration file (a
deployment's reference is fixed; ``--seed`` draws only the reads) by
:func:`synth_genome`, a copy of the repeat model the repository has used
since its first benchmarks.  Each cache entry sits in ``portbench/cache/``
under a key of the configuration's genome, this file and the port's
index-format sources.  An entry is built in a directory of its own, moved into
place, and marked complete last: an entry without the mark (or with another
key in it) is removed and built again, never loaded.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# the port's files that decide what its index and K-mer tables hold
INDEX_SOURCES = ("hsa_tpu_torch/index/layout.py", "hsa_tpu_torch/refpack.py",
                 "hsa_tpu_torch/csrc/refpack.cpp", "hsa_tpu_torch/csrc/sais.hpp",
                 "hsa_tpu_torch/io/fastx.py", "hsa_tpu_torch/alphabet.py",
                 "hsa_tpu_torch/search/exact.py", "hsa_tpu_torch/pipeline.py")
DONE = "COMPLETE"


def synth_genome(n: int, model: str = "iid", seed: int = 7):
    """The genome, int8[n] over 0..3.

    ``repeats``: 55% i.i.d. background, 30% dispersed repeat-family copies
    (Alu-like: 300 bp consensus sequences re-inserted with 2-8% divergence),
    10% segmental duplications (10-50 kbp blocks copied with 1% divergence),
    5% tandem repeats (2-6 bp motifs, 50-500 copies).  The bases are those of
    ``benchmarks/common.py:synth_genome`` for the same arguments.
    """
    rs = np.random.RandomState(seed)
    if model == "iid":
        return rs.randint(0, 4, n).astype(np.int8)
    g = rs.randint(0, 4, n).astype(np.int8)

    def mutate(seg, rate):
        m = rs.rand(len(seg)) < rate
        seg = seg.copy()
        seg[m] = (seg[m] + rs.randint(1, 4, int(m.sum()))) % 4
        return seg

    fam_bp = int(n * 0.30)
    families = [rs.randint(0, 4, 300).astype(np.int8) for _ in range(8)]
    placed = 0
    while placed < fam_bp:
        fam = families[rs.randint(len(families))]
        p = rs.randint(0, n - 300)
        g[p:p + 300] = mutate(fam, rs.uniform(0.02, 0.08))
        placed += 300
    dup_bp = int(n * 0.10)
    placed = 0
    while placed < dup_bp:
        ln = int(rs.randint(10_000, 50_000))
        if 2 * ln + 2 >= n:
            ln = max(n // 4, 1)
        src = rs.randint(0, n - ln)
        dst = rs.randint(0, n - ln)
        g[dst:dst + ln] = mutate(g[src:src + ln], 0.01)
        placed += ln
    tr_bp = int(n * 0.05)
    placed = 0
    while placed < tr_bp:
        motif = rs.randint(0, 4, int(rs.randint(2, 7))).astype(np.int8)
        copies = int(rs.randint(50, 500))
        arr = np.tile(motif, copies)[:min(len(motif) * copies, n // 10)]
        p = rs.randint(0, n - len(arr))
        g[p:p + len(arr)] = arr
        placed += len(arr)
    return g


def _digest(paths, extra: bytes = b"") -> str:
    h = hashlib.sha256(extra)
    for p in paths:
        with open(os.path.join(ROOT, p), "rb") as fh:
            h.update(p.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def genome_key(cfg) -> str:
    spec = json.dumps(cfg["genome"], sort_keys=True).encode()
    return _digest(["portbench/genome.py"], spec)


def index_key(cfg) -> str:
    spec = json.dumps(cfg["genome"], sort_keys=True).encode()
    return _digest(("portbench/genome.py",) + INDEX_SOURCES, spec)


def _complete(path, key) -> bool:
    try:
        with open(os.path.join(path, DONE)) as fh:
            return fh.read().strip() == key
    except OSError:
        return False


def entry(name: str, key: str, build, cache: str = CACHE) -> str:
    """The cache directory ``<cache>/<name>-<key>``: loaded when marked
    complete with ``key``, else removed, made by ``build(tmp_dir)`` in
    ``<dir>.part``, moved into place and marked."""
    path = os.path.join(cache, f"{name}-{key}")
    if _complete(path, key):
        return path
    part = path + ".part"
    for d in (path, part):
        shutil.rmtree(d, ignore_errors=True)
    os.makedirs(part)
    build(part)
    os.replace(part, path)
    with open(os.path.join(path, DONE), "w") as fh:
        fh.write(key)
    return path


def genome_file(cfg, cache: str = CACHE) -> str:
    return os.path.join(cache, f"genome-{genome_key(cfg)}", "genome.npy")


def load_genome(cfg, cache: str = CACHE):
    """The genome int8[n] of ``cfg``, from the cache."""
    gspec = cfg["genome"]

    def build(d):
        np.save(os.path.join(d, "genome.npy"),
                synth_genome(gspec["length"], gspec["model"], gspec["seed"]))

    d = entry("genome", genome_key(cfg), build, cache)
    return np.load(os.path.join(d, "genome.npy"))


def write_fasta(path, name, g):
    """One record of 80 bases a line."""
    seq = np.frombuffer(b"ACGT", np.uint8)[g]
    full = len(seq) // 80 * 80
    body = np.full((full // 80, 81), ord("\n"), np.uint8)
    body[:, :80] = seq[:full].reshape(-1, 80)
    with open(path, "wb") as fh:
        fh.write(f">{name}\n".encode())
        fh.write(body.tobytes())
        if full < len(seq):
            fh.write(seq[full:].tobytes() + b"\n")


def port_index(cfg, g, warm, cache: str = CACHE) -> str:
    """The port's index prefix of ``cfg``'s genome ``g``, built by the port's
    own ``cli index``; ``warm(prefix)`` runs once on a fresh entry (the
    K-mer tables that the port caches beside its index)."""
    from hsa_tpu_torch.cli import cmd_index

    def build(d):
        fa = os.path.join(d, "genome.fa")
        write_fasta(fa, cfg["genome"]["name"], g)
        cmd_index([fa, "-p", os.path.join(d, "genome")])
        os.remove(fa)
        warm(os.path.join(d, "genome"))

    d = entry("index", index_key(cfg), build, cache)
    return os.path.join(d, "genome")
