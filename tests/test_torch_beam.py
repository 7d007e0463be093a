"""Port beam engine and width pass (torch, CPU) vs hsa_tpu's (JAX, CPU).

The same seeded reads go through ``hsa_tpu.search.beam.align_batch`` and
the port's ``align_batch``; finalized hits, every finalized array on valid
slots, and both overflow counters must be bit-equal.
"""

from dataclasses import astuple

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu.config import AlnOpt
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.search import beam as jbeam
from hsa_tpu.search.widths import cal_width_device as jwidth
from hsa_tpu_torch.index.layout import to_device
from hsa_tpu_torch.search import beam as tbeam
from hsa_tpu_torch.search.widths import cal_width_device as twidth

T = np.random.RandomState(42).randint(0, 4, size=5000).astype(np.int8)
DI = build_device_index(T)
DJ = DI.as_jax()
DT = to_device(DI, "cpu")


def make_reads(rs, n, L, n_mm=0, indel=None, n_bases=0):
    reads = []
    for _ in range(n):
        p = rs.randint(0, len(T) - L - 2)
        r = T[p:p + L + (1 if indel == "del" else 0)].copy()
        if indel == "del":
            cut = rs.randint(8, L - 8)
            r = np.concatenate([r[:cut], r[cut + 1:]])
        elif indel == "ins":
            cut = rs.randint(8, L - 8)
            r = np.concatenate([r[:cut], [rs.randint(0, 4)], r[cut:]])[:L]
        q = rs.choice(L, size=n_mm, replace=False)
        r[q] = (r[q] + rs.randint(1, 4, size=n_mm)) % 4
        r[rs.choice(L, size=n_bases, replace=False)] = 4
        reads.append(r.astype(np.int8))
    return reads


def mixed_reads(seed):
    rs = np.random.RandomState(seed)
    return (make_reads(rs, 4, 40) + make_reads(rs, 4, 72, n_mm=1)
            + make_reads(rs, 4, 100, n_mm=2) + make_reads(rs, 3, 64, indel="del")
            + make_reads(rs, 3, 64, indel="ins", n_mm=1)
            + make_reads(rs, 3, 50, n_mm=1, n_bases=1)
            + [rs.randint(0, 4, 55).astype(np.int8),      # unalignable
               np.full(48, 4, dtype=np.int8)])           # all N


def assert_same(reads, opt, W, H, text_idx=(DJ, DT)):
    dj, dt = text_idx
    hj, rj = jbeam.align_batch(dj, reads, opt, beam_width=W, max_hits=H)
    ht, rt = tbeam.align_batch(dt, reads, opt, beam_width=W, max_hits=H)
    # the port's Hit is its own dataclass: compare field by field
    assert [[astuple(h) for h in hits] for hits in ht] == \
        [[astuple(h) for h in hits] for hits in hj]
    valid = np.asarray(rj.hit_valid)
    for f in rj._fields:
        a, b = np.asarray(getattr(rj, f)), np.asarray(getattr(rt, f))
        assert a.dtype == b.dtype, f
        if a.shape == valid.shape and f != "hit_valid":
            a, b = np.where(valid, a, 0), np.where(valid, b, 0)
        np.testing.assert_array_equal(a, b, err_msg=f)
    return rj


@pytest.mark.parametrize("W,H", [(64, 32), (512, 48)])
def test_beam_matches_jax(W, H):
    rj = assert_same(mixed_reads(W), AlnOpt(), W, H)
    assert np.asarray(rj.hit_valid).any()


def test_beam_matches_jax_fixed_budget_no_gaps():
    rs = np.random.RandomState(3)
    reads = make_reads(rs, 10, 60, n_mm=2) + make_reads(rs, 4, 60, n_bases=2)
    assert_same(reads, AlnOpt(max_diff=2, max_gapo=0), 64, 32)


def test_beam_matches_jax_seed_constraint():
    rs = np.random.RandomState(7)
    reads = make_reads(rs, 8, 60, n_mm=2)
    for r in reads[:4]:
        r[55] = (r[55] + 1) % 4
        r[58] = (r[58] + 2) % 4
    assert_same(reads, AlnOpt(max_diff=4, seed_len=20, max_seed_diff=1), 64, 32)


def test_tiny_beam_overflow_counts_match():
    # a repetitive genome stresses the beam: W=4 must overflow, and the
    # port must count exactly the JAX engine's drops
    t = np.tile(np.random.RandomState(10).randint(0, 4, 200), 25).astype(np.int8)
    di = build_device_index(t)
    rs = np.random.RandomState(9)
    reads = [t[p:p + 40].copy() for p in rs.randint(0, len(t) - 40, 8)]
    for r in reads:
        r[20] = (r[20] + 1) % 4
    rj = assert_same(reads, AlnOpt(max_diff=2), 4, 2,
                     text_idx=(di.as_jax(), to_device(di, "cpu")))
    assert np.asarray(rj.n_live_dropped).sum() > 0


def test_width_pass_matches_jax():
    reads = mixed_reads(11)
    fwd, lens = jbeam.pack_read_batch(reads)
    want = np.asarray(jwidth(DJ, jnp.asarray(fwd), jnp.asarray(lens)))
    got = twidth(DT, torch.from_numpy(fwd).long(), torch.from_numpy(lens))
    np.testing.assert_array_equal(want, got.numpy())


def test_out_of_range_batches_raise():
    with pytest.raises(ValueError, match="read length"):
        tbeam.align_batch(DT, [T[:520]], AlnOpt(max_diff=2))
    with pytest.raises(ValueError, match="diff budget"):
        tbeam.align_batch(DT, [T[:50]], AlnOpt(max_diff=16))


def test_ladder_raises():
    """``ladder`` runs the adaptive beam; what raises is a read it cannot
    pack."""
    reads = mixed_reads(5)
    hj, rj = jbeam.align_batch(DJ, reads, AlnOpt(), max_hits=16,
                               ladder=(8, 64))
    ht, rt = tbeam.align_batch(DT, reads, AlnOpt(), max_hits=16,
                               ladder=(8, 64))
    assert [[astuple(h) for h in hits] for hits in ht] == \
        [[astuple(h) for h in hits] for hits in hj]
    np.testing.assert_array_equal(rj.n_live_dropped, rt.n_live_dropped)
    assert sum(map(len, ht)) >= 20
    with pytest.raises(ValueError, match="read length"):
        tbeam.align_batch(DT, [T[:520]], AlnOpt(max_diff=2), ladder=(8, 64))
