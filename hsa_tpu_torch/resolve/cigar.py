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

BIG = 1 << 28


def banded_global(read: np.ndarray, ref: np.ndarray, s_mm: int, s_gapo: int,
                  s_gape: int, band: int):
    """Min-cost alignment of the full read against a prefix-anchored ref window.

    The alignment starts at (0, 0); the read must be fully consumed; the end
    column is free (trailing reference bases are not part of the alignment).
    Returns (cost, cigar list[(op, len)] with ops 'M','I','D', n_ref_consumed).
    ``read`` codes 0..4 (4 = N: mismatches everything), ``ref`` codes 0..3.
    Runs in the native library (``refpack.banded_global``), bit-identical to
    the numpy reference :func:`banded_global_ref`.
    """
    return refpack.banded_global(read, ref, s_mm, s_gapo, s_gape, band)


def banded_global_ref(read: np.ndarray, ref: np.ndarray, s_mm: int,
                      s_gapo: int, s_gape: int, band: int):
    """Numpy reference implementation (semantics oracle for the C++ port).

    The alignment starts at (0, 0); the read must be fully consumed; the end
    column is free (trailing reference bases are not part of the alignment).
    Returns (cost, cigar list[(op, len)] with ops 'M','I','D', n_ref_consumed).
    ``read`` codes 0..4 (4 = N: mismatches everything), ``ref`` codes 0..3.
    """
    L, G = len(read), len(ref)
    band = max(band, 1)
    # cost matrices: rows 0..L, cols 0..G; three states (M/I/D) for affine
    m = np.full((L + 1, G + 1), BIG, dtype=np.int64)
    ins = np.full((L + 1, G + 1), BIG, dtype=np.int64)  # gap in ref (read base extra)
    dele = np.full((L + 1, G + 1), BIG, dtype=np.int64)  # gap in read (ref base extra)
    m[0, 0] = 0
    for j in range(1, min(G, L + band) + 1):
        dele[0, j] = s_gapo + (j - 1) * s_gape
    for i in range(1, min(L, band) + 1):
        ins[i, 0] = s_gapo + (i - 1) * s_gape
    for i in range(1, L + 1):
        jlo = max(1, i - band)
        jhi = min(G, i + band)
        if jlo > jhi:
            continue
        js = np.arange(jlo, jhi + 1)
        sub = np.where(read[i - 1] == ref[js - 1], 0, s_mm)
        if read[i - 1] > 3:
            sub[:] = s_mm
        best_prev = np.minimum(np.minimum(m[i - 1, js - 1], ins[i - 1, js - 1]),
                               dele[i - 1, js - 1])
        m[i, js] = best_prev + sub
        # insertion: consume read base i (vertical move)
        ins[i, js] = np.minimum(m[i - 1, js] + s_gapo, ins[i - 1, js] + s_gape)
        # deletion: consume ref base j (horizontal move) — sequential within row
        row_m = m[i]
        row_d = dele[i]
        for j in js:
            row_d[j] = min(row_m[j - 1] + s_gapo, row_d[j - 1] + s_gape)

    # free end in ref: best over all states and end columns
    totals = np.minimum(np.minimum(m[L], ins[L]), dele[L])
    jend = int(np.argmin(totals))
    cost = int(totals[jend])

    # traceback with canonical preference M > D > I
    ops = []
    i, j = L, jend
    state = int(np.argmin([m[L, jend], dele[L, jend], ins[L, jend]]))  # 0=M 1=D 2=I
    while i > 0 or j > 0:
        if i == 0:
            ops.append("D"); j -= 1; continue
        if j == 0:
            ops.append("I"); i -= 1; continue
        if state == 0:  # arrived via diagonal
            sub = s_mm if (read[i - 1] > 3 or read[i - 1] != ref[j - 1]) else 0
            prev = [m[i - 1, j - 1], dele[i - 1, j - 1], ins[i - 1, j - 1]]
            target = m[i, j] - sub
            # first state whose cost equals target (M > D > I preference)
            for s_, p_ in enumerate(prev):
                if p_ == target:
                    state = s_
                    break
            ops.append("M"); i -= 1; j -= 1
        elif state == 1:  # deletion: came from left (m open or dele extend)
            if m[i, j - 1] + s_gapo == dele[i, j]:
                state = 0
            else:
                state = 1
            ops.append("D"); j -= 1
        else:  # insertion: came from above
            if m[i - 1, j] + s_gapo == ins[i, j]:
                state = 0
            else:
                state = 2
            ops.append("I"); i -= 1
    ops.reverse()
    # run-length encode
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return cost, [(op, ln) for op, ln in cigar], jend


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
