"""FASTA / FASTQ readers and reference metadata (the ``.ann``/``.amb`` analog).

Lineage: ``kseq.h`` (record parsing) + ``bntseq.c`` (multi-sequence
concatenation, ambiguity runs, coordinate mapping).  Pure-Python buffered
readers; throughput is adequate for index build and batched read streaming
(a C++ mmap reader is a later optimization — SURVEY.md §2).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field

import numpy as np

from .. import alphabet


def _open(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path: str):
    """Yield (name, sequence_string) per record."""
    name, chunks = None, []
    with _open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0]
                chunks = []
            else:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def read_fastq(path: str):
    """Yield (name, seq, qual) per record."""
    with _open(path) as fh:
        while True:
            h = fh.readline()
            if not h:
                return
            s = fh.readline().strip()
            fh.readline()
            q = fh.readline().strip()
            yield h.strip()[1:].split()[0], s, q


@dataclass
class RefMeta:
    """Concatenated multi-sequence reference metadata (``.ann`` analog)."""

    names: list
    starts: np.ndarray   # int64[n_seqs] offsets in the concatenated text
    lengths: np.ndarray  # int64[n_seqs]
    amb_runs: list = field(default_factory=list)  # [(start, length)] in concat coords
    total: int = 0

    def pos_to_ref(self, pos: int):
        """concat position -> (seq_index, offset). -1 if out of range.

        Scalar-hot (3 calls per emitted record): uses bisect over cached
        Python lists — ~8x cheaper than numpy searchsorted on scalars.
        """
        try:
            sl, ll = self._starts_l, self._lengths_l
        except AttributeError:
            sl = self._starts_l = [int(x) for x in self.starts]
            ll = self._lengths_l = [int(x) for x in self.lengths]
        import bisect
        i = bisect.bisect_right(sl, pos) - 1
        if i < 0 or pos >= sl[i] + ll[i]:
            return -1, -1
        return i, int(pos - sl[i])

    def count_amb(self, pos: int, glen: int) -> int:
        """# ambiguity-substituted bases in [pos, pos+glen) (XN tag)."""
        if not self.amb_runs:
            return 0
        if not hasattr(self, "_amb_starts"):
            self._amb_starts = np.asarray([r[0] for r in self.amb_runs], np.int64)
            self._amb_ends = self._amb_starts + np.asarray(
                [r[1] for r in self.amb_runs], np.int64)
        lo = int(np.searchsorted(self._amb_ends, pos, side="right"))
        hi = int(np.searchsorted(self._amb_starts, pos + glen, side="left"))
        total = 0
        for i in range(lo, hi):
            total += min(int(self._amb_ends[i]), pos + glen) -                      max(int(self._amb_starts[i]), pos)
        return total

    def span_ok(self, pos: int, glen: int) -> bool:
        """True iff [pos, pos+glen) stays inside one sequence."""
        i, off = self.pos_to_ref(pos)
        return i >= 0 and off + glen <= self._lengths_l[i]

    def to_dict(self):
        return dict(names=list(self.names), starts=self.starts.tolist(),
                    lengths=self.lengths.tolist(), amb_runs=list(self.amb_runs),
                    total=self.total)

    @classmethod
    def from_dict(cls, d):
        return cls(names=list(d["names"]),
                   starts=np.asarray(d["starts"], np.int64),
                   lengths=np.asarray(d["lengths"], np.int64),
                   amb_runs=[tuple(r) for r in d["amb_runs"]],
                   total=int(d.get("total") or int(np.sum(d["lengths"]))))


def load_reference(path: str, seed: int = 11):
    """FASTA -> (codes int8[n] over 0..3, RefMeta). Ambiguity substituted."""
    names, starts, lengths, parts = [], [], [], []
    off = 0
    for name, seq in read_fasta(path):
        codes = alphabet.encode(seq)
        names.append(name)
        starts.append(off)
        lengths.append(len(codes))
        parts.append(codes)
        off += len(codes)
    if not names:
        raise ValueError(f"no sequences in {path}")
    concat = np.concatenate(parts)
    clean, amb = alphabet.substitute_ambiguous(concat, seed=seed)
    meta = RefMeta(names=names, starts=np.asarray(starts, np.int64),
                   lengths=np.asarray(lengths, np.int64), amb_runs=amb, total=off)
    return clean, meta


def trim_read_length(qual: str, trim_qual: int, offset: int = 33) -> int:
    """3'-end quality trim length (lineage: ``bwaseqio.c:bwa_trim_read``).

    Scans from the 3' end accumulating (trim_qual - q); the kept length is
    the position maximizing the running sum (at least 1 base is kept, as in
    the lineage). trim_qual < 1 disables trimming.
    """
    L = len(qual)
    if trim_qual < 1 or not qual or qual == "*":
        return L
    s = 0
    max_s = 0
    trim_len = L
    for i in range(L - 1, 0, -1):
        s += trim_qual - (ord(qual[i]) - offset)
        if s < 0:
            break
        if s > max_s:
            max_s = s
            trim_len = i
    return trim_len
