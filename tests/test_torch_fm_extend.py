"""The FM backward step (``fm.extend``, ``fm.extend4_flat``) against
``hsa_tpu.search.fm``, and the ``fm_extend`` CUDA kernel's arithmetic
against its plain version, on the CPU.

The plain versions (``fm.extend_plain``, ``fm.extend4_flat_plain``, what
``fm.extend``/``extend4_flat`` run on CPU tensors) go through the same
seeded inputs as the JAX functions, on ``tests/test_torch_fm.py``'s
indexes: intervals of exact matches, empty ones (``k > l``), ends around
the primary's block and at ``p = n``, and dead lanes with arbitrary ranks.
The reference fills a gather past its table where the port clamps it, and
wraps ``l + 1`` at 2^32 where the port does not, so a lane is held against
it only where both ends' rows lie in the table; every lane, dead ones
included, is held against :func:`emulate_fm_extend`, the kernel of
``csrc/fm_extend.cu`` restated on numpy arrays (the card holds the kernel
itself against the plain version: ``chip_smoke.py``).  All integer work:
the tolerance is 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu.search import fm as jfm
from hsa_tpu_torch.kernels import extend as kx
from hsa_tpu_torch.search import fm as tfm
from test_torch_fm import CASES, _idx, _intervals

M32 = 0xFFFFFFFF
PAT = 0x55555555


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _u32(x):
    return np.asarray(x).astype(np.int64) & M32


def lanes(t, di, dj, rs, rev=False):
    """(a, k, l) int64: exact-match intervals, empty ones (k > l), ends
    around the primary's block, ends at n and n + 1, and dead lanes with
    arbitrary ranks in [0, 2^32) (l = 2^32 - 1 makes l + 1 = 2^32)."""
    n = di.n
    ks, ls = _intervals(t, di, dj, rs)
    prim = (di.rev_primary if rev else di.primary) & M32
    blk = 32 * (prim >> 5)
    around = np.arange(blk - 3, blk + 35)
    extra_k = [ks[:40] + 1 + rs.randint(0, 5, 40),        # empty: k > l
               around, around, [n, n + 1, n, 0, 0],
               [M32, 1 << 31, n + 1000, rs.randint(0, 1 << 32), 5]]
    extra_l = [ks[:40] - 1, around - 1, around + 7, [n - 1, n, n, n, M32],
               [M32, M32, 3, rs.randint(0, 1 << 32), 1 << 31]]
    k = np.concatenate([ks] + [np.asarray(x, np.int64) for x in extra_k])
    l = np.concatenate([ls] + [np.asarray(x, np.int64) for x in extra_l])
    keep = (k >= 0) & (l >= 0)
    k, l = k[keep], l[keep]
    a = rs.randint(0, 6, k.size)       # 4 = N and 5 = PAD clamp to 3
    return a.astype(np.int64), k, l


def in_table(di, p, rev=False):
    rows = (di.rev_occ_blocks if rev else di.occ_blocks).shape[0]
    return (p >= 0) & (p < 32 * rows) & (p < (1 << 32))


def _popc(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def emulate_fm_extend(blocks, C, primary, a, k, l, shard=None):
    """``csrc/fm_extend.cu`` on numpy: the kernel's results for int64 lanes
    (their low 32-bit words), ``a`` None for all four bases; ``shard`` =
    (its first row, the global table's rows) gives the int32 owner-masked
    counts of a shard whose rows ``blocks`` are."""
    rows = np.asarray(blocks).astype(np.int64) & M32
    R = rows.shape[0]
    p_blk, p_off = primary >> 5, primary & 31

    def load_end(p):
        b, off = p >> 5, p & 31
        if shard is not None:
            local = np.minimum(b, shard[1] - 1) - shard[0]
            own = (local >= 0) & (local < R)
            r = np.clip(local, 0, R - 1)
        else:
            own = np.ones_like(b, bool)
            r = np.minimum(b, R - 1)
        v0 = np.minimum(off, 16)
        m = [np.where(v > 0, PAT >> (2 * (16 - np.maximum(v, 1))), 0)
             for v in (v0, off - v0)]
        corr = ((b == p_blk) & (off > p_off)).astype(np.int64)
        return rows[r], m, corr, own

    def occ(e, base):
        row, m, corr, _ = e
        pat = (base * PAT) & M32
        n4 = ~(row[:, 4] ^ pat) & M32
        n5 = ~(row[:, 5] ^ pat) & M32
        in_block = _popc(n4 & (n4 >> 1) & m[0]) + _popc(n5 & (n5 >> 1) & m[1])
        cnt = np.take_along_axis(row, np.broadcast_to(base, (row.shape[0],))
                                 [:, None], axis=1)[:, 0]
        return cnt + in_block - np.where(base == 0, corr, 0)

    ek = load_end(k & M32)
    el = load_end((l & M32) + 1)
    bases = [np.full(k.shape, b) for b in range(4)] if a is None else \
        [np.clip(((a & M32) ^ (1 << 31)) - (1 << 31), 0, 3)]
    if shard is not None:
        out = [np.where(e[3], occ(e, b) & M32, 0) for e in (ek, el)
               for b in bases]
        return np.stack(out).astype(np.int64)
    ks = [C[b] + occ(ek, b) for b in bases]
    ls = [C[b] + occ(el, b) - 1 for b in bases]
    return np.stack(ks + ls)


CASES_REV = [("direct", False), ("direct", True), ("walk", True),
             ("edge", False), ("edge", True)]


@pytest.mark.parametrize("name,rev", CASES_REV)
def test_extend_plain_matches_jax(name, rev):
    """fm.extend on the CPU (its plain version) against hsa_tpu's, on every
    lane whose rows lie in the table; empty intervals, the primary's block
    and p = n among them."""
    t, di, dj, dt = _idx(name)
    a, k, l = lanes(t, di, dj, np.random.RandomState(3), rev)
    live = in_table(di, k, rev) & in_table(di, l + 1, rev)
    assert (~live).sum() >= 3 and (k[live] > l[live]).sum() >= 40
    assert (k[live] == di.n).any() and (l[live] + 1 == di.n).any()
    gk, gl = tfm.extend(dt, _t(a), _t(k), _t(l), rev=rev)
    wk, wl = jfm.extend(dj, jnp.asarray(np.minimum(a, 3)[live], jnp.uint32),
                        jnp.asarray(k[live], jnp.uint32),
                        jnp.asarray(l[live], jnp.uint32), rev=rev)
    np.testing.assert_array_equal(_u32(wk), gk.numpy()[live])
    np.testing.assert_array_equal(_u32(wl), gl.numpy()[live])


@pytest.mark.parametrize("name", list(CASES))
def test_extend4_flat_plain_matches_jax(name):
    t, di, dj, dt = _idx(name)
    _, k, l = lanes(t, di, dj, np.random.RandomState(5))
    live = in_table(di, k) & in_table(di, l + 1)
    gk, gl = tfm.extend4_flat(dt, _t(k), _t(l))
    wk, wl = jfm.extend4_flat(dj, jnp.asarray(k[live], jnp.uint32),
                              jnp.asarray(l[live], jnp.uint32))
    for b in range(4):
        np.testing.assert_array_equal(_u32(wk[b]), gk[b].numpy()[live])
        np.testing.assert_array_equal(_u32(wl[b]), gl[b].numpy()[live])


# extend by one base on either table; extend4_flat reads the forward rows
EMULATED = [(name, rev, False) for name, rev in CASES_REV] + \
    [(name, False, True) for name in CASES]


@pytest.mark.parametrize("name,rev,four", EMULATED)
def test_kernel_emulation_matches_plain(name, rev, four):
    """Every lane, dead ones included: the kernel's arithmetic equals the
    plain version's, which clamps where the kernel clamps."""
    t, di, dj, dt = _idx(name)
    a, k, l = lanes(t, di, dj, np.random.RandomState(7), rev)
    blocks = dt.rev_occ_blocks if rev else dt.occ_blocks
    primary = dt.rev_primary if rev else dt.primary
    want = emulate_fm_extend(blocks.numpy(), dt.C.numpy(), primary,
                             None if four else a, k, l)
    if four:
        ks, ls = tfm.extend4_flat_plain(dt, _t(k), _t(l))
        got = torch.stack(ks + ls).numpy()
    else:
        got = torch.stack(tfm.extend_plain(dt, _t(a), _t(k), _t(l),
                                           rev=rev)).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n_shard", [2, 3])
@pytest.mark.parametrize("name", ["direct", "edge"])
def test_kernel_emulation_sharded(name, n_shard):
    """The kernel's sharded arithmetic: each shard's owner-masked int32
    counts of its own row range, summed as the merge sums them, plus C,
    equal the plain unsharded step on every lane (each lane's row has one
    owner, dead lanes' too, after the clamp to the global table)."""
    t, di, dj, dt = _idx(name)
    a, k, l = lanes(t, di, dj, np.random.RandomState(9))
    rows = dt.occ_blocks.numpy()
    R = rows.shape[0]
    per = -(-R // n_shard)
    C = dt.C.numpy()
    for four in (False, True):
        merged = sum(emulate_fm_extend(rows[s * per:(s + 1) * per], C,
                                       dt.primary, None if four else a, k, l,
                                       shard=(s * per, R))
                     for s in range(n_shard)) & M32
        bases = range(4) if four else [np.minimum(a, 3)]
        Cb = [C[b] for b in bases]
        nb = len(Cb)
        got = np.stack([Cb[i] + merged[i] for i in range(nb)]
                       + [Cb[i] + merged[nb + i] - 1 for i in range(nb)])
        want = emulate_fm_extend(rows, C, dt.primary, None if four else a,
                                 k, l)
        np.testing.assert_array_equal(want, got)


def test_cpu_takes_the_plain_version_and_the_wrapper_checks():
    """On CPU tensors fm.extend/extend4_flat launch nothing; the kernel's
    wrapper refuses CPU tensors and wrong types before any build."""
    t, di, dj, dt = _idx("direct")
    a, k, l = lanes(t, di, dj, np.random.RandomState(11))
    n0 = kx.KERNEL.launches
    tfm.extend(dt, _t(a), _t(k), _t(l))
    tfm.extend4_flat(dt, _t(k), _t(l))
    assert kx.KERNEL.launches == n0
    with pytest.raises(ValueError, match="unsupported device"):
        kx.fm_extend(dt, _t(a), _t(k), _t(l))
    with pytest.raises(TypeError, match="int64"):
        kx.fm_extend(dt, _t(a), _t(k).to(torch.int32), _t(l))
    with pytest.raises(TypeError, match="int64"):
        kx.fm_extend(dt, _t(a)[:-1], _t(k), _t(l))
    assert kx.KERNEL._lib is None          # nothing was built


def test_dead_lanes_do_not_fault():
    """Arbitrary ranks (beam dead slots) clamp in the plain version."""
    _, di, _, dt = _idx("walk")
    k = _t([0, di.n + 1, 2 ** 32 - 1, 1 << 31, 12345])
    k4, l4 = tfm.extend4_flat(dt, k, k)
    ke, le = tfm.extend(dt, _t([0, 1, 2, 3, 5]), k, k, rev=True)
    assert all(x.shape == (5,) for x in k4 + l4 + (ke, le))
