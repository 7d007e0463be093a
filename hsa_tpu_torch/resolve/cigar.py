"""Gapped-hit refinement: banded global/semi-global DP -> CIGAR/NM/MD.

Analog of the reference's ``bwa_refine_gapped`` + ``stdaln.c`` banded DP:
the search records only budget counts (nmm/ngapo/ngape), so the edit script
is reconstructed by re-aligning the read against the reference window that
starts at the located position.  Penalties mirror the search exactly
(mismatch ``s_mm``, gap of length g costs ``s_gapo + (g-1)*s_gape``), so
the DP cost of the searched script is achievable; the DP may find an
equal-or-cheaper canonical script.

Determinism: traceback prefers M over D over I on ties, so CIGARs are
stable.  Counterpart of ``hsa_tpu/resolve/cigar.py``; the DP itself runs in
the port's native library.
"""

from __future__ import annotations

import numpy as np

from .. import refpack


def banded_global(read: np.ndarray, ref: np.ndarray, s_mm: int, s_gapo: int,
                  s_gape: int, band: int):
    """Min-cost alignment of the full read against a prefix-anchored ref window.

    The alignment starts at (0, 0); the read must be fully consumed; the end
    column is free (trailing reference bases are not part of the alignment).
    Returns (cost, cigar list[(op, len)] with ops 'M','I','D', n_ref_consumed).
    ``read`` codes 0..4 (4 = N: mismatches everything), ``ref`` codes 0..3.
    Runs in the native library (``refpack.banded_global``); the numpy
    reference DP stays in ``hsa_tpu/resolve/cigar.py``.
    """
    return refpack.banded_global(read, ref, s_mm, s_gapo, s_gape, band)


def cigar_stats(cigar, read: np.ndarray, ref: np.ndarray):
    """(nm, md) from an alignment: NM edit distance and MD tag string."""
    nm = 0
    md_parts = []
    match_run = 0
    i = j = 0
    for op, ln in cigar:
        if op == "M":
            for _ in range(ln):
                if read[i] <= 3 and read[i] == ref[j]:
                    match_run += 1
                else:
                    nm += 1
                    md_parts.append(str(match_run))
                    md_parts.append("ACGTN"[min(int(ref[j]), 4)])
                    match_run = 0
                i += 1
                j += 1
        elif op == "I":
            nm += ln
            i += ln
        elif op == "D":
            nm += ln
            md_parts.append(str(match_run))
            match_run = 0
            md_parts.append("^" + "".join("ACGTN"[min(int(ref[j + t]), 4)] for t in range(ln)))
            j += ln
    md_parts.append(str(match_run))
    return nm, "".join(md_parts)


def cigar_string(cigar) -> str:
    return "".join(f"{ln}{op}" for op, ln in cigar)
