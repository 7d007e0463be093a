"""Single-end mapping quality (lineage: ``bwase.c:bwa_approx_mapQ``).

c1 = number of distinct (position, strand) occurrences at the best score,
c2 = number within the score window above best (see SURVEY.md A.5).  Both
are clamped at 256 (beyond that MAPQ is pinned anyway).  This is the
documented lineage formula; re-verify against the mount when available.
The port's copy of ``hsa_tpu/resolve/mapq.py``; the array resolvers carry
its vector form.
"""

from __future__ import annotations

import math


def g_log_n(n: int) -> int:
    return int(4.343 * math.log(n) + 0.5) if n > 0 else 0


def approx_mapq(c1: int, c2: int, nmm: int, max_diff: int) -> int:
    if c1 == 0:
        return 23
    if c1 > 1:
        return 0
    if nmm == max_diff:
        return 25
    if c2 == 0:
        return 37
    n = min(c2, 255)
    q = 23 - g_log_n(n)
    return max(q, 0)


def trunc_capped_mapq(mapq: int, c2_total: int, missed: int) -> int:
    """MAPQ ceiling for a read whose candidate enumeration was CAPPED.

    The ``missed`` unexamined candidates could each be a window-quality
    alternative, so the quality cannot exceed what the c2 branch of
    :func:`approx_mapq` assigns for ``c2_total`` = found-window
    alternates + missed (the lineage's max_entries truncation has the
    same confidence semantics; docs/PARITY.md #14).  missed <= 0 leaves
    mapq unchanged.
    """
    if missed <= 0:
        return mapq
    return min(mapq, max(23 - g_log_n(min(max(c2_total, 1), 255)), 0))
