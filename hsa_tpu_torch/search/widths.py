"""Device width pass: the D(i) prefix lower-bound array (torch).

Counterpart of ``hsa_tpu/search/widths.py`` (lineage
``bwtaln.c:bwt_cal_width``): per read, D[i] lower-bounds the differences
needed to match read[0..i] anywhere in the genome, by greedy exact
extension with resets on the reverse-text index.  The ``lax.scan`` over
read columns is a Python loop; all reads advance one base per iteration.
"""

from __future__ import annotations

import torch

from . import fm

PAD = 5


def cal_width_device(idx, reads_fwd, lens):
    """D arrays for a batch: int64 [B, Lmax] (entries beyond len hold
    D[len-1]).

    reads_fwd: integer [B, Lmax] codes in 5'->3' order, PAD-padded, on
    ``idx.device``.  ``lens`` is unused, as in the JAX version.
    Requires ``idx.rev_occ_blocks``.
    """
    B, Lmax = reads_fwd.shape
    k0 = torch.zeros(B, dtype=torch.int64, device=reads_fwd.device)
    l0 = torch.full_like(k0, idx.n)
    k, l, z = k0, l0, torch.zeros_like(k0)
    cols = reads_fwd.long().t()
    D = []
    for col in cols:
        is_pad = col >= PAD
        k2, l2 = fm.extend(idx, col, k, l, rev=True)
        ok = (k2 <= l2) & (col != 4)
        # reset lanes that broke; bump their z
        z = torch.where(~is_pad & ~ok, z + 1, z)
        k = torch.where(is_pad, k, torch.where(ok, k2, k0))
        l = torch.where(is_pad, l, torch.where(ok, l2, l0))
        D.append(z)
    return torch.stack(D, dim=1)
