"""Batched FM-index primitives over the fused rank-indexed rows (torch).

Counterpart of ``hsa_tpu/search/fm.py`` (``fm.py:55-324``, unsharded
branches): the same rank convention, row layout and primary-slot
correction, restated on ``int64`` tensors.

Types: every rank, count and row word is an ``int64`` holding a value in
``[0, 2^32)``.  The JAX code relies on uint32 semantics in three places,
and each is made explicit here: ``~`` is masked back to 32 bits, shifts
only ever see non-negative values, and ``lax.population_count`` is a SWAR
popcount (:func:`popcount32`).

Gathers: ``jnp.take`` never faults on an out-of-range index, and the beam
engine relies on that for its dead frontier slots, which carry arbitrary
ranks.  torch raises on the CPU and asserts on the device, so every gather
index here is clamped to its table.  Live lanes never reach the clamp, so
results on them are unchanged.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_PAT55 = 0x55555555


def popcount32(x):
    """Set-bit count of 32-bit values held in an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def _gather_rows(blocks, b):
    """Fused rows of block ids ``b`` -> int64 [B, 8] 32-bit words."""
    b = b.clamp(0, blocks.shape[0] - 1)
    return blocks.index_select(0, b).long() & M32


def _word_masks(off):
    """Two masks; mask j selects the 2-bit symbol pairs of word 4+j that
    lie below prefix length ``off`` (int64 [B] in [0, 32])."""
    ms = []
    rem = off
    for _ in range(2):
        v = rem.clamp(max=16)
        rem = rem - v
        sh = 2 * (16 - v.clamp(min=1))
        pat = torch.full_like(sh, _PAT55)
        ms.append(torch.where(v > 0, pat >> sh, 0))
    return ms


def _count_base(rows, ms, a):
    """In-block match count of base ``a`` (int or int64 [B])."""
    tot = None
    for j in range(2):
        x = rows[:, 4 + j] ^ (a * _PAT55)
        nx = ~x & M32
        c = popcount32(nx & (nx >> 1) & ms[j])
        tot = c if tot is None else tot + c
    return tot


def _primary_corr(idx, b, off, *, rev: bool):
    """1 where the primary's dummy slot falls inside [32b, 32b+off)."""
    primary = idx.rev_primary if rev else idx.primary
    p_blk, p_off = primary >> 5, primary & 31
    return ((b == p_blk) & (off > p_off)).long()


def _select4(rows, a, base_col=0):
    """Per-lane column select: rows[:, base_col + a] for a in 0..3."""
    r01 = torch.where(a < 1, rows[:, base_col + 0], rows[:, base_col + 1])
    r23 = torch.where(a < 3, rows[:, base_col + 2], rows[:, base_col + 3])
    return torch.where(a < 2, r01, r23)


def _sym_at(rows, off):
    """2-bit symbol of rank slot ``off`` (in [0, 31]); dummy 0 at the
    primary slot."""
    word = torch.where(off < 16, rows[:, 4], rows[:, 5])
    return (word >> (2 * (off & 15))) & 3


def _row_decode(idx, p, *, rev: bool = False):
    """(rows [B, 8], b, off) for prefix lengths / ranks ``p``."""
    blocks = idx.rev_occ_blocks if rev else idx.occ_blocks
    b = p >> 5
    off = p & 31
    return _gather_rows(blocks, b), b, off


def occ_lt4_flat(idx, p):
    """Tuple of 4 [B] counts: occurrences of each base among bwt_full
    rows [0, p), primary excluded."""
    rows, b, off = _row_decode(idx, p)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=False)
    outs = []
    for a in range(4):
        tot = rows[:, a] + _count_base(rows, ms, a)
        if a == 0:
            tot = tot - corr
        outs.append(tot)
    return tuple(outs)


def occ_lt(idx, a, p, *, rev: bool = False):
    """[B] count of base a[B] (0..3) among bwt_full rows [0, p)."""
    rows, b, off = _row_decode(idx, p, rev=rev)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=rev)
    return (_select4(rows, a) + _count_base(rows, ms, a)
            - torch.where(a == 0, corr, 0))


def extend(idx, a, k, l, *, rev: bool = False):
    """Left-extend [k, l] with base a. Empty iff k' > l'.

    Callers mask lanes where a > 3 themselves (N never matches).
    """
    a = a.clamp(max=3)
    B = k.shape[0]
    o = occ_lt(idx, torch.cat([a, a]), torch.cat([k, l + 1]), rev=rev)
    Ca = idx.C[a]
    return Ca + o[:B], Ca + o[B:] - 1


def extend4_flat(idx, k, l):
    """All-bases extension: two tuples of 4 [B] vectors (k'_a, l'_a).

    One concatenated row gather serves both interval ends.
    """
    B = k.shape[0]
    o = occ_lt4_flat(idx, torch.cat([k, l + 1]))
    ks = tuple(idx.C[a] + o[a][:B] for a in range(4))
    ls = tuple(idx.C[a] + o[a][B:] - 1 for a in range(4))
    return ks, ls


def _lf_from_rows(idx, rows, b, off, r):
    """LF mapping decoded from already-gathered rows of ranks r."""
    c = _sym_at(rows, off)
    # occ_lt(c, r+1) = checkpoint[c] + in-block matches among slots [0, off+1)
    ms = _word_masks(off + 1)
    corr = _primary_corr(idx, b, off + 1, rev=False)
    occ = (_select4(rows, c) + _count_base(rows, ms, c)
           - torch.where(c == 0, corr, 0))
    res = idx.C[c] + occ - 1
    return torch.where(r == idx.primary, 0, res)


def _mark_from_rows(rows, off):
    """(is_marked [B], mark_rank [B]) from fused rows."""
    bit = (rows[:, 6] >> off) & 1
    below = ((torch.ones_like(off) << off) - 1) & rows[:, 6]
    return bit, rows[:, 7] + popcount32(below)


def _take(table, i):
    return table[i.clamp(0, table.shape[0] - 1)]


def locate(idx, r):
    """Text positions (int64) of ranks r[B].

    With a direct suffix array this is one gather; otherwise the bounded
    LF walk of ``sa_intv`` steps (one fused-row gather per step for mark
    and LF, plus one sample gather at each lane's mark step)."""
    if idx.sa_direct is not None:
        return _take(idx.sa_direct, r)
    pos = torch.zeros_like(r)
    steps = torch.zeros_like(r)
    done = torch.zeros_like(r, dtype=torch.bool)
    for _ in range(idx.sa_intv):
        rows, b, off = _row_decode(idx, r)
        bit, mrank = _mark_from_rows(rows, off)
        r_next = _lf_from_rows(idx, rows, b, off, r)
        m = bit == 1
        pos = torch.where(m & ~done, _take(idx.samples, mrank) + steps, pos)
        done = done | m
        r = torch.where(done, r, r_next)
        steps = torch.where(done, steps, steps + 1)
    return pos
