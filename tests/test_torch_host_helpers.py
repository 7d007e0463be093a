"""Host helpers the port copies from JAX-importing modules, held bit-equal
to their originals on the same seeded inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu.resolve.samse import Occurrence
from hsa_tpu.search import beam as jbeam
from hsa_tpu.search import pigeon as jpigeon
from hsa_tpu_torch.search import beam as tbeam
from hsa_tpu_torch.search import pigeon as tpigeon


def test_occ_lists_to_arrays():
    rs = np.random.RandomState(0)
    occs = [[Occurrence(int(rs.randint(0, 10 ** 9)), int(rs.randint(0, 2)),
                        int(rs.randint(0, 40)), int(rs.randint(0, 4)),
                        int(rs.randint(0, 2)), int(rs.randint(0, 6)))
             for _ in range(rs.randint(0, 5))] for _ in range(30)]
    for lists in (occs, [], [[], []]):
        want = jpigeon.occ_lists_to_arrays(lists)
        got = tpigeon.occ_lists_to_arrays(lists)
        assert want.keys() == got.keys()
        for k in want:
            assert want[k].dtype == got[k].dtype, k
            np.testing.assert_array_equal(want[k], got[k], err_msg=k)


@pytest.mark.parametrize("max_len", [None, 90])
def test_pack_read_batch(max_len):
    rs = np.random.RandomState(1)
    reads = [rs.randint(0, 5, rs.randint(1, 80)).astype(np.int8)
             for _ in range(17)]
    for w, g in zip(jbeam.pack_read_batch(reads, max_len),
                    tbeam.pack_read_batch(reads, max_len)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(w, g)


def test_pack_read_batch_too_long():
    reads = [np.zeros(50, np.int8)]
    with pytest.raises(ValueError) as want:
        jbeam.pack_read_batch(reads, 40)
    with pytest.raises(ValueError) as got:
        tbeam.pack_read_batch(reads, 40)
    assert str(want.value) == str(got.value)


def _raw_pair(seed, H=8, B=24):
    """The same raw beam result as JAX uint32 arrays and as the port's
    int32 tensors."""
    rs = np.random.RandomState(seed)
    score = rs.randint(0, 20, (H, B)).astype(np.uint32)
    hkey = (score << 14) | np.arange(H, dtype=np.uint32)[:, None]
    hkey[rs.rand(H, B) < 0.3] = 0x7FFF0000
    # a few duplicate (k, l, meta) hits with different scores
    hk = rs.randint(0, 4, (H, B)).astype(np.uint32) * np.uint32(2 ** 30 + 7)
    hl = hk + rs.randint(0, 3, (H, B)).astype(np.uint32)
    hm = rs.randint(0, 2 ** 27, (H, B)).astype(np.uint32)
    hm[1] = hm[0]
    best = np.where(rs.rand(B) < 0.2, 0x10000,
                    score.min(axis=0)).astype(np.uint32)
    ld = rs.randint(0, 3, B).astype(np.uint32)
    hd = rs.randint(0, 3, B).astype(np.uint32)
    arrays = (hkey, hk, hl, hm, best, ld, hd)
    jraw = jbeam.RawBeamResult(*(jnp.asarray(a) for a in arrays))
    traw = tbeam.RawBeamResult(*(torch.from_numpy(a.view(np.int32))
                                 for a in arrays))
    return jraw, traw


@pytest.mark.parametrize("seed", [0, 1])
def test_finalize_result_and_result_to_hits(seed):
    jraw, traw = _raw_pair(seed)
    want = jbeam.finalize_result(jraw, 3)
    got = tbeam.finalize_result(traw, 3)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    hits = tbeam.result_to_hits(got)
    assert hits == jbeam.result_to_hits(want)
    assert tbeam.result_to_hits(traw, 3) == hits
    assert any(hits)
