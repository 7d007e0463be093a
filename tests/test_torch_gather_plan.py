"""The launch plans of the card's three row-gather kernels
(``hsa_tpu_torch.kernels.gather``: ``rows_plan`` for ``csrc/gather_rows.cu``,
``take_plan`` for ``csrc/table_take.cu``, ``onehot_plan`` for
``csrc/onehot_gather.cu``) within the card's limits, and a numpy emulation
of each kernel's walk (a block a tile of gather_rows, its lanes' pieces of
a warp's rows; slices and groups of table_take; onehot_gather's tiles, two
lanes a row, the shuffled index and the rounding epilogue) writing every
output row exactly once with ``tab[clamp(q)]`` (rounded through float32
for onehot_gather).

The kernels themselves run only on the card (``chip_smoke.py`` phases 2b and
4b hold every launch against the plain version); these tests reach what
surrounds them.  The card model: 132 SMs.
"""

import os
import re

import numpy as np
import pytest
import torch

from hsa_tpu_torch.kernels import gather

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "hsa_tpu_torch", "csrc")
SMS = 132
NB_EDGES = [1, 7_264, 7_265, 116_224, 116_225]
NQ_EDGES = [1, 255, 257, 131_072]


def _source_constant(name, const):
    with open(os.path.join(CSRC, name)) as fh:
        return int(re.search(rf"constexpr int {const} = (\d+);",
                             fh.read()).group(1))


def test_constants_match_the_sources():
    assert _source_constant("gather_rows.cu", "kMaxThreads") == \
        gather.MAX_THREADS
    assert _source_constant("table_take.cu", "kThreads") == \
        gather.TAKE_THREADS
    assert _source_constant("table_take.cu", "kMaxSmem") == gather.MAX_SMEM
    assert _source_constant("table_take.cu", "kRowBytes") == 32
    assert _source_constant("table_take.cu", "kMaxCluster") == \
        gather.SLICES[-1]
    assert _source_constant("onehot_gather.cu", "kMaxThreads") == \
        gather.MAX_THREADS
    assert _source_constant("onehot_gather.cu", "kLanesARow") == \
        gather.ONEHOT_LANES


@pytest.mark.parametrize("w", gather.ROW_WORDS)
@pytest.mark.parametrize("pipe", gather.PIPES)
def test_rows_plan_within_limits(pipe, w):
    """Every plan within a block's threads and the C function's checks; the
    wrapper takes every pipe depth of the probes at both row widths."""
    for nq in NQ_EDGES + [1 << 20]:
        for chunk in (1, 8, 32, 255, gather.CHUNK, 1024, 5_000):
            p = gather.rows_plan(nq, chunk)
            assert p.tile == min(chunk, nq, gather.MAX_THREADS) >= 1
            assert p.threads % 32 == 0 and p.tile <= p.threads < p.tile + 32
            assert p.threads <= gather.MAX_THREADS
            assert p.grid == -(-nq // p.tile)
            assert (p.grid - 1) * p.tile < nq <= p.grid * p.tile
    rs = np.random.RandomState(pipe * 100 + w)
    tab = rs.randint(-2 ** 31, 2 ** 31, (40, w), dtype=np.int64)
    q = rs.randint(-3, 43, 300)
    got = gather.gather_rows(torch.from_numpy(tab.astype(np.int32)),
                             torch.from_numpy(q.astype(np.int32)), pipe)
    np.testing.assert_array_equal(got.numpy(), tab[np.clip(q, 0, 39)])


def emulate_gather_rows(tab, q, plan):
    """gather_rows.cu's walk in numpy: block b takes tile b; thread j of a
    block loads index j of the tile (when the tile has row j); lane l of a
    warp copies its T = W / 4 pieces p = j x 32 + l of the warp's 32 rows
    (row p / T, 16-byte part p % T) with the index of lane p / T (the
    shuffle), when that row is in the tile.  Returns (out, times each
    output word was written)."""
    nb, w = tab.shape
    nq = len(q)
    T = w // 4
    out = np.full((nq, w), -1, np.int64)
    writes = np.zeros((nq, w), np.int64)
    lane = np.arange(32)
    for blk in range(plan.grid):
        t0 = blk * plan.tile
        n = min(plan.tile, nq - t0)
        raw = np.zeros(plan.threads, np.int64)
        raw[:n] = q[t0:t0 + n]
        for row0 in range(0, plan.threads, 32):
            for j in range(T):
                p = j * 32 + lane
                r = row0 + p // T
                b = np.clip(raw[r], 0, nb - 1)     # the shuffle's index
                ok = r < n
                cols = (p % T)[:, None] * 4 + np.arange(4)
                out[t0 + r[ok, None], cols[ok]] = tab[b[ok, None], cols[ok]]
                np.add.at(writes, (t0 + r[ok, None], cols[ok]), 1)
    return out, writes


@pytest.mark.parametrize("w", gather.ROW_WORDS)
@pytest.mark.parametrize("pipe", gather.PIPES)
def test_gather_rows_walk_writes_each_row_once(pipe, w):
    rs = np.random.RandomState(pipe * 100 + w)
    nb = 300
    tab = rs.randint(-2 ** 31, 2 ** 31, (nb, w), dtype=np.int64)
    # a tile of one row, ragged warps and tiles, the default tile
    for nq, chunk in ((1, 256), (255, 32), (257, 8), (1_000, 100),
                      (2_000, 1_000), (4_099, gather.CHUNK)):
        q = rs.randint(-5, nb + 5, nq)
        plan = gather.rows_plan(nq, chunk)
        out, writes = emulate_gather_rows(tab, q, plan)
        np.testing.assert_array_equal(writes, 1)
        np.testing.assert_array_equal(out, tab[np.clip(q, 0, nb - 1)])


@pytest.mark.parametrize("T", [2, 8])
def test_gather_rows_lanes_cover_a_warps_rows(T):
    """A warp's T rounds of 32 lanes copy piece p = j * 32 + lane to shared
    offset p: row p / T, 16-byte part p % T, every (row, part) of its 32
    rows once."""
    pieces = [(p // T, p % T) for j in range(T) for p in
              (j * 32 + lane for lane in range(32))]
    assert sorted(pieces) == [(r, c) for r in range(32) for c in range(T)]


@pytest.mark.parametrize("nb", NB_EDGES)
def test_take_plan_within_limits(nb):
    cap = gather.SLICES[-1] * gather.TAKE_MAX_ROWS
    assert cap == 116_224
    for nq in NQ_EDGES:
        p = gather.take_plan(nb, nq, SMS)
        if nb > cap:
            assert p is None
            continue
        assert p.slices in gather.SLICES
        assert p.rows == -(-nb // p.slices) <= gather.TAKE_MAX_ROWS
        assert p.smem == 32 * p.rows <= gather.MAX_SMEM
        assert p.slices * p.rows >= nb
        fewer = [c for c in gather.SLICES if c < p.slices]
        assert all(-(-nb // c) > gather.TAKE_MAX_ROWS for c in fewer)
        want = -(-nq // (gather.TAKE_THREADS * gather.TAKE_ROWS_A_THREAD))
        assert p.groups == max(1, min(want, SMS // p.slices))
        assert p.groups * p.slices <= SMS            # a block an SM at most
    # a card of fewer SMs than slices still runs one group
    assert gather.take_plan(cap, 1 << 20, 8).groups == 1


def emulate_table_take(tab, q, plan):
    """table_take.cu's walk in numpy: block b holds slice b % slices (rows
    r0 .. r0 + nr, the first min(nr, rows - 1) by the copy engine, the last
    by hand when the slice is full, where the mbarrier lay) for group
    b / slices; every block of group g scans the group's share of the
    queries, [g x per, (g + 1) x per), in rounds of kUnroll x kThreads, and
    writes the rows its own slice holds.  Returns (out, times each output
    row was written)."""
    nb, nq = len(tab), len(q)
    unroll = _source_constant("table_take.cu", "kUnroll")
    threads = _source_constant("table_take.cu", "kThreads")
    cs, rows, groups = plan.slices, plan.rows, plan.groups
    per = -(-nq // groups)
    out = np.full((nq, 8), -1, np.int64)
    writes = np.zeros(nq, np.int64)
    for blk in range(groups * cs):
        r0 = (blk % cs) * rows
        nr = max(0, min(nb - r0, rows))
        bulk = min(nr, rows - 1)
        slice_ = np.full((rows, 8), -3, np.int64)
        slice_[:bulk] = tab[r0:r0 + bulk]
        if nr == rows:
            slice_[rows - 1] = tab[r0 + rows - 1]
        g = blk // cs
        lo, hi = g * per, min(nq, (g + 1) * per)
        for base in range(lo, hi, unroll * threads):
            for u in range(unroll):
                i = np.arange(base + u * threads,
                              min(base + (u + 1) * threads, hi))
                local = np.clip(q[i], 0, nb - 1) - r0
                hit = (local >= 0) & (local < nr)
                out[i[hit]] = slice_[local[hit]]
                np.add.at(writes, i[hit], 1)
    return out, writes


@pytest.mark.parametrize("nb", NB_EDGES[:4] + [33, 65_536])
def test_table_take_walk_writes_each_row_once(nb):
    rs = np.random.RandomState(nb)
    tab = rs.randint(-2 ** 31, 2 ** 31, (nb, 8), dtype=np.int64)
    for nq in NQ_EDGES:
        q = rs.randint(-3, nb + 3, nq)
        q[:2] = [0, nb - 1][:nq]            # both ends of the table
        rows16 = -(-nb // 16)                # chip_smoke.py's sweep's form
        for plan in (gather.take_plan(nb, nq, SMS),
                     gather.TakePlan(16, rows16, 2, rows16 * 32)):
            out, writes = emulate_table_take(tab, q, plan)
            np.testing.assert_array_equal(writes, 1)
            np.testing.assert_array_equal(out, tab[np.clip(q, 0, nb - 1)])


ONEHOT_NQ = [1, 15, 16, 17, 255, 257, 16_384, 1 << 20]
# the rounding's edge words (tests/test_torch_gather_probe.py's
# test_onehot_plain_rounds_through_float32)
EDGE_WORDS = [0, 1, (1 << 24) + 1, (1 << 25) + 3, 0x7FFFFFFF, 0x80000001,
              0xFFFFFF7F, 0xFFFFFFFF]


@pytest.mark.parametrize("nq", ONEHOT_NQ)
def test_onehot_plan_within_limits(nq):
    """Every plan within a block's threads and the C function's checks:
    tiles of ONEHOT_TILE rows (fewer for fewer queries), ONEHOT_LANES lanes
    a row rounded up to a warp; 128 blocks of 256 threads, one wave on the
    132 SMs, at the probe's 16,384 queries."""
    p = gather.onehot_plan(nq)
    assert p.tile == min(gather.ONEHOT_TILE, nq) >= 1
    lanes = gather.ONEHOT_LANES * p.tile
    assert p.threads % 32 == 0 and lanes <= p.threads < lanes + 32
    assert p.threads <= gather.MAX_THREADS
    assert p.tile <= gather.MAX_THREADS // gather.ONEHOT_LANES
    assert p.grid == -(-nq // p.tile)
    assert (p.grid - 1) * p.tile < nq <= p.grid * p.tile
    if nq == 16_384:
        assert (p.grid, p.threads) == (128, 256) and p.grid <= SMS


def round_f32(words):
    """uint32 -> float32 (nearest, ties to even) -> uint32, saturating at
    2^32 - 1: __float2uint_rn(__uint2float_rn(w))."""
    f = words.astype(np.uint32).astype(np.float32).astype(np.float64)
    return np.minimum(f, 2.0 ** 32 - 1).astype(np.int64)


def emulate_onehot_gather(tab, q, plan):
    """onehot_gather.cu's walk in numpy: block b takes tile b (n rows);
    thread t handles row t / 2 of the tile, half t % 2 of it (words 4 x
    half .. 4 x half + 3); lane l < 16 of a warp loads the index of the
    warp's row l when the tile has it, and every lane takes lane l / 2's by
    shuffle (0 from a lane that loaded nothing), clamped to the table; a
    lane whose row is in the tile reads its half row, rounds each word
    through float32 and writes it.  Returns (out, times each output word
    was written)."""
    nb = len(tab)
    nq = len(q)
    lanes = gather.ONEHOT_LANES
    words = 8 // lanes
    out = np.full((nq, 8), -1, np.int64)
    writes = np.zeros((nq, 8), np.int64)
    lane = np.arange(32)
    for blk in range(plan.grid):
        t0 = blk * plan.tile
        n = min(plan.tile, nq - t0)
        for w0 in range(0, plan.threads, 32):
            wrow0 = w0 // lanes
            raw = np.where((lane < 32 // lanes) & (wrow0 + lane < n),
                           q[np.minimum(t0 + wrow0 + lane, nq - 1)], 0)
            r = np.clip(raw[lane // lanes], 0, nb - 1)      # the shuffle
            row = (w0 + lane) // lanes
            half = lane % lanes
            for li in np.flatnonzero(row < n):
                cols = slice(words * half[li], words * (half[li] + 1))
                out[t0 + row[li], cols] = round_f32(tab[r[li], cols])
                writes[t0 + row[li], cols] += 1
    return out, writes


@pytest.mark.parametrize("nq", [1, 15, 16, 17, 255, 257, 1_000])
def test_onehot_walk_writes_each_word_once(nq):
    """The emulated walk writes every output word once, equal to
    ``onehot_gather_plain`` (the one-hot product in float32), with the
    clamped indices -3 and R and the rounding's edge words in the table."""
    rs = np.random.RandomState(nq)
    nb = 70
    tab = rs.randint(0, 2 ** 32, (nb, 8), dtype=np.int64)
    tab[0] = EDGE_WORDS
    tab[nb - 1] = EDGE_WORDS[::-1]
    q = rs.randint(0, nb, nq)
    q[:4] = [-3, nb, 0, nb - 1][:nq]
    out, writes = emulate_onehot_gather(tab, q, gather.onehot_plan(nq))
    np.testing.assert_array_equal(writes, 1)
    want = gather.onehot_gather_plain(
        torch.from_numpy(q.astype(np.int32)),
        torch.from_numpy(tab.astype(np.uint32).view(np.int32)))
    np.testing.assert_array_equal(out, want.numpy().view(np.uint32))
    edge = round_f32(np.array(EDGE_WORDS))
    assert edge[7] == 0xFFFFFFFF and edge[2] == 1 << 24   # saturates, rounds
    if nq >= 4:
        np.testing.assert_array_equal(out[0], edge)       # -3 -> row 0
        np.testing.assert_array_equal(out[1], edge[::-1])  # R -> row R - 1
