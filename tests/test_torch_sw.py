"""Port glocal screen and mate rescue (plain PyTorch on the CPU) vs the JAX
package: the jnp screen, its Pallas kernel in interpret mode, the host
``fit_in_window`` oracle and ``sampe._rescue_batch``.  Exact equality
throughout (integer DP)."""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt
from hsa_tpu.io.fastx import RefMeta
from hsa_tpu.kernels.sw import glocal_screen as jscreen
from hsa_tpu.kernels.sw import glocal_screen_pallas
from hsa_tpu.resolve import sampe
from hsa_tpu.resolve.samse import Occurrence
from hsa_tpu_torch.kernels import build, sw
from hsa_tpu_torch.kernels.sw import glocal_screen, glocal_screen_plain
from hsa_tpu_torch.resolve import sampe as tsampe
from hsa_tpu_torch.resolve.sampe import _rescue_batch as rescue_batch

S_MM, S_GAPO, S_GAPE = 3, 11, 4


def cases(rs, n, L, G):
    """The read classes of tests/test_kernels_sw.py (exact, 2 mismatches,
    a deletion, random, shorter read in a shorter window), then edges: an
    N, an empty read, an empty window, a window shorter than the read."""
    reads = np.zeros((n, L), np.int32)
    lens = np.full(n, L, np.int32)
    wins = rs.randint(0, 4, (n, G)).astype(np.int32)
    wlens = np.full(n, G, np.int32)
    for j in range(n):
        kind = j % 9
        s = rs.randint(0, G - L - 1)
        if kind in (0, 5):
            reads[j] = wins[j, s:s + L]
            if kind == 5:
                reads[j, rs.randint(0, L)] = 4           # an N
        elif kind == 1:
            reads[j] = wins[j, s:s + L]
            for q in rs.choice(L, 2, replace=False):
                reads[j, q] = (reads[j, q] + 1) % 4
        elif kind == 2:
            w = wins[j, s:s + L + 1]
            cut = rs.randint(5, L - 5)
            reads[j] = np.concatenate([w[:cut], w[cut + 1:]])
        elif kind == 3:
            reads[j] = rs.randint(0, 4, L)
        elif kind == 4:
            lens[j], wlens[j] = L - 7, G - 13
            s = rs.randint(0, G - 13 - (L - 7))
            reads[j, :L - 7] = wins[j, s:s + L - 7]
        elif kind == 6:
            lens[j] = 0
        elif kind == 7:
            wlens[j] = 0
            reads[j] = rs.randint(0, 4, L)
        else:
            wlens[j] = L // 2
            reads[j] = wins[j, :L]
    return reads, lens, wins, wlens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32))


def port(reads, lens, wins, wlens):
    cost, end = glocal_screen(_t(reads), _t(lens), _t(wins), _t(wlens), S_MM,
                              S_GAPO, S_GAPE)
    assert cost.dtype == end.dtype == torch.int32
    return cost.numpy(), end.numpy()


@pytest.mark.parametrize("seed,n,L,G", [(0, 27, 40, 160), (1, 18, 33, 100),
                                        (2, 20, 20, 31)])
def test_plain_matches_jnp_and_pallas_interpret(seed, n, L, G):
    arrs = cases(np.random.RandomState(seed), n, L, G)
    cost, end = port(*arrs)
    jargs = [jnp.asarray(a) for a in arrs]
    for want in (jscreen(*jargs, S_MM, S_GAPO, S_GAPE),
                 glocal_screen_pallas(*jargs, S_MM, S_GAPO, S_GAPE, tile=8,
                                      interpret=True)):
        np.testing.assert_array_equal(cost, np.asarray(want[0]))
        np.testing.assert_array_equal(end, np.asarray(want[1]))


def test_plain_costs_equal_fit_in_window():
    reads, lens, wins, wlens = cases(np.random.RandomState(3), 18, 40, 160)
    cost, end = port(reads, lens, wins, wlens)
    for j in range(len(reads)):
        rd, w = reads[j, :lens[j]], wins[j, :wlens[j]]
        exp = sampe.fit_in_window(rd, w, S_MM, S_GAPO, S_GAPE)[0]
        assert cost[j] == exp, (j, cost[j], exp)
        # an alignment with that cost ends at column `end`
        assert sampe.fit_in_window(rd, w[:end[j]], S_MM, S_GAPO,
                                   S_GAPE)[0] == exp


def test_cpu_path_launches_no_kernel():
    before = sw.KERNEL.launches
    port(*cases(np.random.RandomState(4), 9, 20, 40))
    assert sw.KERNEL.launches == before


@pytest.mark.parametrize("bad", ["dtype", "rank", "rows", "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    reads, lens = torch.zeros((4, 8), dtype=torch.int32), torch.full((4,), 8,
                                                                     dtype=torch.int32)
    wins, wlens = torch.zeros((4, 20), dtype=torch.int32), torch.full(
        (4,), 20, dtype=torch.int32)
    err = TypeError
    if bad == "dtype":
        wins = wins.long()
    elif bad == "rank":
        lens = lens[:, None]
    elif bad == "rows":
        wlens, err = wlens[:3], ValueError
    else:
        reads, err = torch.zeros((8, 4), dtype=torch.int32).t(), ValueError
    with pytest.raises(err):
        glocal_screen(reads, lens, wins, wlens, S_MM, S_GAPO, S_GAPE)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel build that fails raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.CudaKernel("glocal_screen.cu", sw._declare).lib()


# -- the port's rescue against sampe._rescue_batch ---------------------------

@pytest.fixture(scope="module")
def rescue_env():
    """Two sequences; jobs on both strands that are accepted (ungapped and
    gapped, one at exactly the cost budget), rejected (a random read) and
    short-window (the anchor near a sequence's end: 56 bases, which the
    read overhangs by 4 cheap insertions)."""
    rs = np.random.RandomState(21)
    seqs = [rs.randint(0, 4, 3000).astype(np.int8) for _ in range(2)]
    text = np.concatenate(seqs)
    meta = RefMeta(names=["a", "b"], starts=np.asarray([0, 3000], np.int64),
                   lengths=np.asarray([3000, 3000], np.int64), total=6000)
    L, jobs = 60, []

    def mate(p, strand, dele=False, n_mm=0):
        r = text[p:p + L + dele].copy()
        if dele:
            r = np.concatenate([r[:25], r[26:]])
        for q in rs.choice(L, n_mm, replace=False):
            r[q] = (r[q] + 1) % 4
        return alphabet.revcomp(r) if strand else r

    # anchor forward at p -> the missing mate is reverse, right of it
    for j, (p, dele, n_mm) in enumerate([(100, False, 5), (900, True, 3),
                                         (3400, True, 0), (1500, False, 8)]):
        jobs.append((j, 2, Occurrence(p, 0, 0, 0, 0, 0),
                     mate(p + 250, 1, dele, n_mm), L))
    # anchor reverse -> the missing mate is forward, left of it
    jobs.append((4, 1, Occurrence(2000, 1, 0, 0, 0, 0),
                 mate(1760, 0, True, 2), L))
    jobs.append((5, 1, Occurrence(4000, 1, 0, 0, 0, 0),
                 rs.randint(0, 4, L).astype(np.int8), L))       # rejected
    over = np.concatenate([text[2944:3000], np.arange(4, dtype=np.int8)])
    jobs.append((6, 2, Occurrence(2944, 0, 0, 0, 0, 0),
                 alphabet.revcomp(over), L))                   # short window
    jobs.append((7, 2, Occurrence(4500, 0, 0, 0, 0, 0),
                 mate(4700, 1, n_mm=9), L))       # cost 27 = 9 * s_mm budget
    return text, meta, jobs


def test_rescue_batch_matches_reference(rescue_env):
    text, meta, jobs = rescue_env
    opt = AlnOpt()
    want = list(sampe._rescue_batch(text, meta, jobs, 400, opt))
    got = list(rescue_batch(text, meta, jobs, 400, opt, "cpu"))
    # the two packages' Occurrence classes differ: compare field by field

    def fields(res):
        return [(j, e, o and vars(o)) for j, e, o in res]
    assert fields(got) == fields(want)
    occ = [o for _, _, o in got]
    assert occ[6] is None and occ[5] is None                    # short, junk
    assert occ[7] is not None and occ[7].score == 27
    assert sum(o is not None for o in occ) >= 5
    assert any(o is not None and o.ngapo for o in occ)          # gapped
    assert {o.strand for o in occ if o is not None} == {0, 1}


def test_rescue_on_an_absent_card_raises(rescue_env):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    text, meta, jobs = rescue_env
    with pytest.raises(RuntimeError, match="no CUDA device"):
        list(rescue_batch(text, meta, jobs, 400, AlnOpt(), "cuda"))


def test_bind_rescue_names_the_shared_global():
    """The paired resolver runs the rescue it is given (``rescue=``, which
    an aligner binds to its device) and has none of its own: without one it
    raises, so no caller lands on the CPU by default.  With the module's
    ``_rescue_batch`` bound to the CPU it gives the reference's records."""
    rs = np.random.RandomState(5)
    text = rs.randint(0, 4, 3000).astype(np.int8)
    meta = RefMeta(names=["s"], starts=np.zeros(1, np.int64),
                   lengths=np.asarray([3000], np.int64), total=3000)
    r1, r2 = [text[400:460].copy()], [alphabet.revcomp(text[600:660])]
    occ = {k: np.asarray([v], np.int64) for k, v in dict(
        rid=0, pos=400, strand=0, score=0, nmm=0, ngapo=0, ngape=0).items()}
    args = (text, meta, r1, r2, ["p"], ["I" * 60], ["I" * 60], occ, AlnOpt())
    seen = []

    def mine(text_, meta_, jobs, rlim, opt):
        seen.append((len(jobs), jobs[0][1], rlim))
        return iter(())
    lone = tsampe.resolve_pe_from_occ_arrays(*args, rescue=mine)
    assert seen == [(1, 2, 500)] and lone[1].pos == 401 and lone[1].flag & 4
    with pytest.raises(TypeError, match="rescue"):
        tsampe.resolve_pe_from_occ_arrays(*args)
    with pytest.raises(TypeError, match="device"):
        tsampe.resolve_pe_from_occ_arrays(*args, rescue=rescue_batch)
    got = tsampe.resolve_pe_from_occ_arrays(
        *args, rescue=functools.partial(rescue_batch, device="cpu"))
    want = sampe.resolve_pe_from_occ_arrays(*args)
    assert [r.to_sam() for r in got] == [r.to_sam() for r in want]
    assert got[1].pos == 601 and got[1].tags["XT"] == "M"
