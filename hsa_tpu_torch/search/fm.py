"""Batched FM-index primitives over the fused rank-indexed rows (torch).

Counterpart of ``hsa_tpu/search/fm.py`` (``fm.py:55-324``): the same rank
convention, row layout and primary-slot correction, restated on ``int64``
tensors.

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

Index sharding (``fm.py:55-76``): when the index carries a
``shard_group`` (a rank's local tables, built by
:class:`hsa_tpu_torch.dist.ShardedIndex`), the occ, sample and direct-SA
tables hold one row range of the global tables, starting at
``row_offset`` / ``rev_row_offset`` / ``sample_offset`` / ``sa_offset``.
Every primitive then gathers the clamped local row, multiplies every
value derived from it by the ``own`` mask (the primary-slot correction
included: a shard that does not own the lane's block must not subtract
it), and merges with ONE ``all_reduce(SUM)`` over the shard group: the
owner contributes the value, every other shard zero.  A gather index is
clamped to the *global* table first, as the unsharded gather clamps it,
so exactly one shard owns every lane, dead ones included, and a sharded
result equals the unsharded one bit for bit.  Unsharded indexes (no
``shard_group``) run the code below unchanged.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


# the offset attribute of each sharded table (``hsa_tpu/dist/mesh.py:108``)
_OFFSET = {"occ_blocks": "row_offset", "rev_occ_blocks": "rev_row_offset",
           "samples": "sample_offset", "sa_direct": "sa_offset"}


def _owned(idx, name, i):
    """Global row ids ``i`` of table ``name`` -> (row ids into the table
    the index holds, own mask [B] or None).

    Unsharded: ``i`` and None.  Sharded: ``i`` clamped to the global
    table (``idx.global_rows[name]`` rows), less the shard's offset, and
    the lanes whose row this shard holds (``fm.py:55-71``)."""
    if getattr(idx, "shard_group", None) is None:
        return i, None
    local = i.clamp(0, idx.global_rows[name] - 1) - getattr(idx, _OFFSET[name])
    own = (local >= 0) & (local < getattr(idx, name).shape[0])
    return local, own


def _merge(idx, x, own):
    """Owner-gated sum over the shard group (``fm.py:74-76``); ``x``
    unchanged when ``own`` is None (unsharded).

    ``x`` holds values in [0, 2^32) (``[B]`` or stacked ``[k, B]``); all
    ranks but the owner contribute 0, so the sum of the 32-bit patterns
    is exact and the merge moves ``int32``, as the reference's moves
    uint32.  The index's ``collectives`` counter records each call."""
    if own is None:
        return x
    buf = (x * own).to(torch.int32)
    dist.all_reduce(buf, group=idx.shard_group)
    idx.collectives.record(buf)
    return buf.long() & M32


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


def _row_decode_owned(idx, p, *, rev: bool = False):
    """(rows [B, 8], b, off, own) for prefix lengths / ranks ``p``; ``b``
    is the global block id, ``own`` None unsharded."""
    name = "rev_occ_blocks" if rev else "occ_blocks"
    b = p >> 5
    off = p & 31
    local, own = _owned(idx, name, b)
    return _gather_rows(getattr(idx, name), local), b, off, own


def _row_decode(idx, p, *, rev: bool = False):
    """(rows [B, 8], b, off) for prefix lengths / ranks ``p`` of an
    unsharded index (a shard's rows are its own, unmerged)."""
    rows, b, off, own = _row_decode_owned(idx, p, rev=rev)
    if own is not None:
        raise ValueError("_row_decode reads an unsharded index only")
    return rows, b, off


def _occ_lt4_rows(idx, p):
    """(the four [B] counts of bases 0..3 among bwt_full rows [0, p), own)
    from a shard's own rows, unmerged."""
    rows, b, off, own = _row_decode_owned(idx, p)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=False)
    outs = []
    for a in range(4):
        tot = rows[:, a] + _count_base(rows, ms, a)
        if a == 0:
            tot = tot - corr
        outs.append(tot)
    return outs, own


def occ_lt4(idx, p):
    """[B, 4] counts of each base among bwt_full rows [0, p), primary
    excluded (``fm.py:146-159``).  Sharded: one merge of the four."""
    outs, own = _occ_lt4_rows(idx, p)
    return _merge(idx, torch.stack(outs), own).T


def occ_lt4_flat(idx, p):
    """Tuple of 4 [B] counts: occurrences of each base among bwt_full
    rows [0, p), primary excluded.  Sharded: one merge of the stacked
    four counts (``fm.py:162-179``)."""
    outs, own = _occ_lt4_rows(idx, p)
    if own is None:
        return tuple(outs)
    return tuple(_merge(idx, torch.stack(outs), own).unbind(0))


def occ_lt(idx, a, p, *, rev: bool = False):
    """[B] count of base a[B] (0..3) among bwt_full rows [0, p)."""
    rows, b, off, own = _row_decode_owned(idx, p, rev=rev)
    ms = _word_masks(off)
    corr = _primary_corr(idx, b, off, rev=rev)
    return _merge(idx, _select4(rows, a) + _count_base(rows, ms, a)
                  - torch.where(a == 0, corr, 0), own)


def extend(idx, a, k, l, *, rev: bool = False):
    """Left-extend [k, l] with base a. Empty iff k' > l'.

    Callers mask lanes where a > 3 themselves (N never matches).
    """
    a = a.clamp(max=3)
    B = k.shape[0]
    o = occ_lt(idx, torch.cat([a, a]), torch.cat([k, l + 1]), rev=rev)
    Ca = idx.C[a]
    return Ca + o[:B], Ca + o[B:] - 1


def extend4(idx, k, l):
    """All-bases extension ``([B, 4] k', [B, 4] l')``, the ``bwt_2occ4``
    analog (``fm.py:209-214``): ``C4 + occ_lt4(k)`` and ``C4 +
    occ_lt4(l + 1) - 1``.  Both interval ends go through one
    concatenated row gather, so a shard merges once a call."""
    B = k.shape[0]
    o = occ_lt4(idx, torch.cat([k, l + 1]))
    C4 = idx.C[None, 0:4]
    return C4 + o[:B], C4 + o[B:] - 1


def extend4_flat(idx, k, l):
    """All-bases extension: two tuples of 4 [B] vectors (k'_a, l'_a).

    One concatenated row gather serves both interval ends.
    """
    B = k.shape[0]
    o = occ_lt4_flat(idx, torch.cat([k, l + 1]))
    ks = tuple(idx.C[a] + o[a][:B] for a in range(4))
    ls = tuple(idx.C[a] + o[a][B:] - 1 for a in range(4))
    return ks, ls


def bwt_char(idx, r):
    """bwt_full symbol at ranks r (``fm.py:232-238``): the dummy 0 at r ==
    primary, which callers mask.  Sharded: the owner's symbol, every other
    shard's zeroed, in one merge."""
    rows, _, off, own = _row_decode_owned(idx, r)
    return _merge(idx, _sym_at(rows, off), own)


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


def lf(idx, r):
    """LF mapping of ranks r, ``LF(primary) = 0`` (``fm.py:253-259``): one
    row gather.  Sharded: the primary's 0 is set in the owner's value
    (``_lf_from_rows``) before the owner mask, then one merge."""
    rows, b, off, own = _row_decode_owned(idx, r)
    return _merge(idx, _lf_from_rows(idx, rows, b, off, r), own)


def _mark_from_rows(rows, off):
    """(is_marked [B], mark_rank [B]) from fused rows."""
    bit = (rows[:, 6] >> off) & 1
    below = ((torch.ones_like(off) << off) - 1) & rows[:, 6]
    return bit, rows[:, 7] + popcount32(below)


def _take(table, i):
    return table[i.clamp(0, table.shape[0] - 1)]


def _lookup(idx, name, i):
    """Entries ``i`` (global ids) of the 1-D table ``name`` (samples or
    the direct SA), merged over the shard group when sharded
    (``fm.py:270-279, 288-298``)."""
    local, own = _owned(idx, name, i)
    return _merge(idx, _take(getattr(idx, name), local), own)


def locate(idx, r):
    """Text positions (int64) of ranks r[B].

    With a direct suffix array this is one gather; otherwise the bounded
    LF walk of ``sa_intv`` steps (one fused-row gather per step for mark
    and LF, plus one sample gather at each lane's mark step).  Sharded,
    each walk step merges ``[bit, mrank, r_next]`` in one call
    (``fm.py:308-314``), then the sample lookup in another."""
    if idx.sa_direct is not None:
        return _lookup(idx, "sa_direct", r)
    pos = torch.zeros_like(r)
    steps = torch.zeros_like(r)
    done = torch.zeros_like(r, dtype=torch.bool)
    for _ in range(idx.sa_intv):
        rows, b, off, own = _row_decode_owned(idx, r)
        bit, mrank = _mark_from_rows(rows, off)
        r_next = _lf_from_rows(idx, rows, b, off, r)
        if own is not None:
            bit, mrank, r_next = _merge(
                idx, torch.stack([bit, mrank, r_next]), own).unbind(0)
        m = bit == 1
        pos = torch.where(m & ~done, _lookup(idx, "samples", mrank) + steps,
                          pos)
        done = done | m
        r = torch.where(done, r, r_next)
        steps = torch.where(done, steps, steps + 1)
    return pos
