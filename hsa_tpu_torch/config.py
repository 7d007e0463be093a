"""Alignment option structs mirroring the reference's ``gap_opt_t`` / ``pe_opt_t``.

Defaults follow the BWA-0.5.x-lineage defaults recorded in SURVEY.md Appendix
A.4 (lineage: ``bwtaln.c:gap_init_opt`` and ``bwape.c``).  The reference mount
being empty, these are the best-attested defaults; each field names the
reference CLI flag it mirrors so they can be re-checked against the mount.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, asdict


def cal_max_diff(length: int, err: float = 0.02, thres: float = 0.04) -> int:
    """Read-length -> allowed-diff budget (lineage: ``bwtaln.c:bwa_cal_maxdiff``).

    Smallest k such that the Poisson(length*err) upper-tail beyond k is below
    ``thres`` — i.e. with per-base error rate ``err``, reads with more than k
    errors are rarer than ``thres``.
    """
    lam = length * err
    elam = math.exp(-lam)
    y = 1.0
    x = 1
    s = elam
    for k in range(1, 1000):
        y *= lam
        x *= k
        s += elam * y / x
        if 1.0 - s < thres:
            return k
    return 2


@dataclass
class AlnOpt:
    """Search options (reference ``gap_opt_t``, ``bwa aln`` flags).

    ``max_diff`` semantics: if >= 0, a fixed budget on nmm+ngapo+ngape; if
    negative, ``fnr`` is interpreted as the missing-fraction threshold and the
    budget is derived per read length via :func:`cal_max_diff` (flag ``-n``).
    """

    max_diff: int = -1          # -n (int form); -1 => use fnr
    fnr: float = 0.04           # -n (float form)
    max_gapo: int = 1           # -o  max gap opens
    max_gape: int = 6           # -e  max gap extensions (lineage default 6)
    seed_len: int = 32          # -l  seed length (3' end of read)
    max_seed_diff: int = 2      # -k  diffs allowed inside the seed
    s_mm: int = 3               # -M  mismatch penalty
    s_gapo: int = 11            # -O  gap open penalty
    s_gape: int = 4             # -E  gap extension penalty
    indel_end_skip: int = 5     # -i  no indel within this many bp of read ends
    # -R / -m are accepted for CLI parity but CURRENTLY UNUSED: their
    # lineage roles (early-stop work caps on the DFS) are covered by other
    # knobs in the beam architecture — beam_width/max_hits capacities (with
    # overflow counters) bound the work, and resolution's max_occ/n_multi
    # bound occurrence collection and XA output (docs/PARITY.md items 1, 4).
    max_top2: int = 30          # -R (unused; see note above)
    max_entries: int = 2_000_000  # -m (unused; see note above)
    trim_qual: int = 0          # -q  quality trimming threshold
    # --- engine knobs with no reference analog (TPU beam search) ---
    beam_width: int = 64        # frontier capacity per read; overflow is counted
    max_len: int = 160          # static read-length bound for device kernels

    def diff_budget(self, read_len: int) -> int:
        if self.max_diff >= 0:
            return self.max_diff
        return cal_max_diff(read_len, 0.02, self.fnr)

    def to_dict(self):
        return asdict(self)


@dataclass
class PEOpt:
    """Paired-end options (reference ``pe_opt_t``, ``bwa sampe`` flags)."""

    max_isize: int = 500        # -a
    max_occ: int = 100_000      # -o  max occurrences of one end for pairing
    n_multi: int = 3            # -n  max hits in XA for paired reads
    N_multi: int = 10           # -N  max hits in XA for discordant reads
    is_sw: bool = True          # mate rescue via banded SW enabled


@dataclass
class SamseOpt:
    """``bwa samse`` options."""

    n_multi: int = 3            # -n  max hits reported in XA
