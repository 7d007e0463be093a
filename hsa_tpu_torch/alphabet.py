"""Nucleotide alphabet, encoding, and deterministic ambiguity handling.

Conventions (used by every layer: numpy core, C++ index build, device kernels):

- Bases are encoded A=0, C=1, G=2, T=3.  Any other letter (N, IUPAC codes)
  encodes to 4 in *reads* ("never matches": a read base of 4 mismatches every
  genome base, mirroring the reference lineage where ``nst_nt4_table`` maps
  ambiguity codes to 4 and the search charges a mismatch for them).
- In the *genome*, ambiguous bases are replaced by a pseudo-random base drawn
  from a deterministic LCG (so that index builds are reproducible), and the
  ambiguous stretches are recorded as ``(start, length)`` runs — the analog of
  the reference's ``.amb`` records (lineage: ``bntseq.c:bns_fasta2bntseq``,
  which substitutes ``lrand48()&3`` and records ``bntamb1_t`` runs).
- The sentinel of the suffix array is implicit; it is lexicographically
  smaller than every base.
"""

from __future__ import annotations

import numpy as np

# A C G T
_CODE = np.full(256, 4, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _CODE[ord(_c)] = _i
    _CODE[ord(_c.lower())] = _i
_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# LCG constants (numerical recipes); used to substitute ambiguous genome bases.
_LCG_A = np.uint64(6364136223846793005)
_LCG_C = np.uint64(1442695040888963407)


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> int8 codes (A=0 C=1 G=2 T=3, other=4)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    return _CODE[raw]


def decode(codes: np.ndarray) -> str:
    """int8 codes -> ASCII string (4 -> 'N')."""
    return _DECODE[np.clip(codes, 0, 4)].tobytes().decode("ascii")


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement; code 4 (N) stays 4."""
    out = codes[::-1].copy()
    mask = out < 4
    out[mask] = 3 - out[mask]
    return out


def substitute_ambiguous(codes: np.ndarray, seed: int = 11) -> tuple[np.ndarray, list[tuple[int, int]]]:
    """Replace code-4 genome bases with deterministic pseudo-random bases.

    Returns (clean_codes, amb_runs) where amb_runs is a list of
    (start, length) runs of ambiguous bases — the ``.amb`` analog.
    """
    codes = codes.copy()
    amb_idx = np.nonzero(codes == 4)[0]
    runs: list[tuple[int, int]] = []
    if amb_idx.size:
        # run-length encode the ambiguous positions
        breaks = np.nonzero(np.diff(amb_idx) != 1)[0]
        starts = np.concatenate([[0], breaks + 1])
        ends = np.concatenate([breaks, [amb_idx.size - 1]])
        for s, e in zip(starts, ends):
            runs.append((int(amb_idx[s]), int(amb_idx[e] - amb_idx[s] + 1)))
        # deterministic LCG stream keyed by absolute position and seed
        state = (amb_idx.astype(np.uint64) + np.uint64(seed)) * _LCG_A + _LCG_C
        state = state * _LCG_A + _LCG_C
        codes[amb_idx] = ((state >> np.uint64(33)) & np.uint64(3)).astype(np.int8)
    return codes, runs
