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
from hsa_tpu_torch.kernels.sw import BIG, glocal_screen, glocal_screen_plain
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
    read overhangs by 4 cheap insertions); then the edge jobs of
    ``EDGE_JOBS``, from index 8 on."""
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

    def edited(p, strand, ins=(), dels=(), mm=(), n_at=()):
        """The text's bases from ``p`` with bases substituted, set to N,
        inserted and deleted ((position, count)), every position counted
        from ``p``; cut to L and shown as the missing mate's strand reads
        it."""
        r = list(text[p:p + L + 8])
        for q in mm:
            r[q] = (r[q] + 1) % 4
        for q in n_at:
            r[q] = 4
        for q, n in sorted([*ins, *((q, -n) for q, n in dels)], reverse=True):
            if n > 0:
                r[q:q] = [(r[q] + 2) % 4] * n
            else:
                del r[q:q - n]
        r = np.asarray(r[:L], np.int8)
        return alphabet.revcomp(r) if strand else r

    # 8: two N bases inside the aligned span, reverse mate
    jobs.append((8, 2, Occurrence(1200, 0, 0, 0, 0, 0),
                 edited(1450, 1, n_at=(12, 40)), L))
    # 9: a 2 bp insertion, forward mate left of a reverse anchor
    jobs.append((9, 1, Occurrence(2600, 1, 0, 0, 0, 0),
                 edited(2350, 0, ins=[(30, 2)]), L))
    # 10: a 1 bp deletion and a 1 bp insertion 30 bases apart
    jobs.append((10, 2, Occurrence(300, 0, 0, 0, 0, 0),
                 edited(560, 1, ins=[(45, 1)], dels=[(15, 1)]), L))
    # 11: gapped at exactly the budget: a 2 bp deletion (15) + 4 mismatches
    jobs.append((11, 2, Occurrence(3600, 0, 0, 0, 0, 0),
                 edited(3850, 1, dels=[(30, 2)], mm=(5, 15, 45, 55)), L))
    # 12: the window clamped at the second sequence's start (reverse anchor
    # 100 bases into it), the mate forward in the first 60 bases
    jobs.append((12, 1, Occurrence(3100, 1, 0, 0, 0, 0),
                 edited(3010, 0, mm=(20,)), L))
    return text, meta, jobs


EDGE_JOBS = {"n_in_span": 8, "ins_2bp": 9, "two_gaps": 10,
             "gapped_at_budget": 11, "clamped_at_seq2": 12}


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


@pytest.mark.parametrize("case", [*EDGE_JOBS, "one_job"])
def test_rescue_edge_case_matches_reference(rescue_env, case):
    """Each edge job alone (a job list of one), field by field against the
    reference, and what the case is there for; ``one_job`` a list of one
    rejected job (nothing traced back)."""
    text, meta, jobs = rescue_env
    opt = AlnOpt()
    i = EDGE_JOBS.get(case, 5)
    want = list(sampe._rescue_batch(text, meta, [jobs[i]], 400, opt))
    got = list(rescue_batch(text, meta, [jobs[i]], 400, opt, "cpu"))
    assert [(j, e, o and vars(o)) for j, e, o in got] == \
        [(j, e, o and vars(o)) for j, e, o in want]
    (j, e, o), = got
    assert (j, e) == jobs[i][:2]
    budget = 9 * opt.s_mm
    if case == "one_job":
        assert o is None
        return
    assert o is not None and o.strand == (jobs[i][2].strand == 0)
    if case == "n_in_span":
        assert (o.nmm, o.ngapo, o.score) == (2, 0, 2 * opt.s_mm)
    elif case == "ins_2bp":
        assert (o.nmm, o.ngapo, o.ngape) == (0, 1, 1)
        assert o.score == opt.s_gapo + opt.s_gape
    elif case == "two_gaps":
        assert (o.nmm, o.ngapo, o.ngape) == (0, 2, 0)
    elif case == "gapped_at_budget":
        assert (o.nmm, o.ngapo, o.ngape, o.score) == (4, 1, 1, budget)
    else:
        lo, _hi, _st = tsampe._rescue_windows(
            text, meta, np.asarray([3100]), np.asarray([1]),
            np.asarray([jobs[i][4]]), 400)
        assert lo.tolist() == [3000] and o.pos == 3010 and o.nmm == 1


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


# -- the CUDA kernel's decomposition, emulated lane by lane --------------------

def _shfl_up(x, d):
    """``__shfl_up_sync``: lanes below ``d`` get their own value back."""
    out = x.copy()
    out[d:] = x[:-d]
    return out


def _shfl_down(x, d):
    out = x.copy()
    out[:-d] = x[d:]
    return out


def emulate_kernel(reads, lens, wins, wlens, s_mm, s_gapo, s_gape,
                   max_cpl=sw.MAX_CPL):
    """``csrc/glocal_screen.cu`` step by step in numpy, one array slot per
    lane: lane-owned column runs kept less the column's ramp, the left
    neighbour's shuffle, the idempotent warp prefix-min for the deletion
    carry, column tiles that hand two values per row through the scratch (32
    rows at a time, one row per lane), warps looping over jobs, and the
    final (value, column) reduction.  Every value must fit int32."""
    R, L = reads.shape
    G = wins.shape[1]
    cpl, n_tiles, n_warps, n_scratch = sw._plan(R, L, G, max_cpl)
    assert cpl % 2 == 0 and 2 <= cpl <= max_cpl and n_tiles * 32 * cpl >= G
    tile_w = 32 * cpl
    scratch = np.full(n_scratch, -12345, np.int64)   # never read unwritten
    cost, end = np.zeros(R, np.int64), np.zeros(R, np.int64)
    lane = np.arange(32)
    k = np.arange(cpl)
    dconst = s_gapo - s_gape
    lane_ramp = lane * cpl * s_gape
    for warp in range(n_warps):
        edge_t = scratch[warp * 2 * L:warp * 2 * L + L]
        edge_d = scratch[warp * 2 * L + L:(warp + 1) * 2 * L]
        for r in range(warp, R, n_warps):
            n_rows = max(0, min(int(lens[r]), L))
            W = max(0, min(int(wlens[r]), G))
            bv, bc = np.full(32, BIG, np.int64), np.full(32, G + 1, np.int64)
            m0, ins0 = 0, BIG
            for tile in range(n_tiles):
                tile0 = tile * tile_w
                if tile > 0 and tile0 >= W:
                    break
                more = tile + 1 < n_tiles
                cols = tile0 + lane[:, None] * cpl + k[None, :]    # 0-based
                w = np.where(cols < W, wins[r][np.minimum(cols, G - 1)]
                             if G else 5, 5)
                win = np.where(w > 3, 5, w)
                m = np.tile(-k * s_gape, (32, 1)).astype(np.int64)
                ins = m + BIG
                t = m.copy()
                m0, ins0 = 0, BIG
                for i0 in range(0, n_rows, 32):
                    nn = min(32, n_rows - i0)
                    rd = np.full(32, 4, np.int64)
                    rd[:nn] = reads[r, i0:i0 + nn]
                    in_t, in_d = np.zeros(32, np.int64), np.zeros(32, np.int64)
                    if tile > 0:
                        in_t[:nn] = edge_t[i0:i0 + nn]
                        in_d[:nn] = edge_d[i0:i0 + nn]
                        assert (in_t[:nn] != -12345).all()
                    out_t, out_d = np.zeros(32, np.int64), np.zeros(32, np.int64)
                    for ii in range(nn):
                        rb = min(int(rd[ii]), 4) if rd[ii] <= 3 else 4
                        diag = _shfl_up(t[:, cpl - 1], 1) + cpl * s_gape
                        seed = BIG + s_gape
                        if tile > 0:
                            seed = in_d[ii]
                            diag[0] = in_t[ii] + s_gape
                        else:
                            diag[0] = min(m0, ins0) + s_gape
                        for c in range(cpl):                    # pass 1
                            mn = diag + np.where(rb == win[:, c], -s_gape,
                                                 s_mm - s_gape)
                            diag = t[:, c].copy()
                            ins[:, c] = np.minimum(m[:, c] + s_gapo,
                                                   ins[:, c] + s_gape)
                            m[:, c] = mn
                        run = m.min(axis=1)
                        incl = np.minimum(run + dconst - lane_ramp, seed)
                        for d in (1, 2, 4, 8, 16):
                            incl = np.minimum(incl, _shfl_up(incl, d))
                        carry = _shfl_up(incl, 1)
                        carry[0] = seed
                        carry = carry + lane_ramp
                        if more:      # t of the row before, del' of this
                            out_t[ii] = t[31, cpl - 1] + (cpl - 1) * s_gape
                            out_d[ii] = incl[31] + tile_w * s_gape
                        for c in range(cpl):                    # pass 2
                            t[:, c] = np.minimum(np.minimum(m[:, c], ins[:, c]),
                                                 carry)
                            carry = np.minimum(m[:, c] + dconst, carry)
                        ins0 = min(m0 + s_gapo, ins0 + s_gape)
                        m0 = BIG
                        for a in (m, ins, t, incl, carry):
                            assert np.abs(a).max() < 2 ** 31
                    if more:
                        edge_t[i0:i0 + nn] = out_t[:nn]
                        edge_d[i0:i0 + nn] = out_d[:nn]
                for c in range(cpl):
                    col = cols[:, c] + 1
                    v = t[:, c] + c * s_gape
                    better = (col <= W) & (v < bv)
                    bv, bc = np.where(better, v, bv), np.where(better, col, bc)
            for d in (16, 8, 4, 2, 1):
                v2, c2 = _shfl_down(bv, d), _shfl_down(bc, d)
                better = (v2 < bv) | ((v2 == bv) & (c2 < bc))
                bv, bc = np.where(better, v2, bv), np.where(better, c2, bc)
            end0 = min(ins0, m0)
            cost[r] = min(int(bv[0]), end0)
            end[r] = 0 if end0 <= bv[0] else bc[0]
    return cost.astype(np.int32), end.astype(np.int32)


def _edge_arrays(name):
    """The edge shapes that the card's smoke test runs at full size, small."""
    rs = np.random.RandomState(sum(map(ord, name)))
    if name == "narrowest window":              # G = L + 8
        return cases(rs, 18, 40, 48)
    if name == "several tiles":                 # 4 tiles of 64 at max_cpl 2
        return cases(rs, 18, 40, 200)
    if name == "ragged tiles":                  # 3 tiles of 128, the last part
        return cases(rs, 11, 70, 300)
    if name == "no multiple of 32":
        return cases(rs, 18, 33, 77)
    if name == "one job":
        return cases(rs, 1, 40, 100)
    if name == "jobs no multiple of the block":
        return cases(rs, 7, 35, 90)
    if name == "all N":
        reads, lens, wins, wlens = cases(rs, 9, 40, 100)
        return np.full_like(reads, 4), lens, wins, wlens
    assert name == "mixed lengths"
    reads, lens, wins, wlens = cases(rs, 27, 40, 100)
    lens = rs.randint(0, 41, 27).astype(np.int32)
    wlens = rs.randint(0, 101, 27).astype(np.int32)
    lens[::5], wlens[1::5] = 0, 0
    return reads, lens, wins, wlens


EDGES = [("narrowest window", 24), ("several tiles", 2), ("ragged tiles", 4),
         ("no multiple of 32", 24), ("one job", 24), ("one job", 2),
         ("jobs no multiple of the block", 24), ("all N", 24), ("all N", 2),
         ("mixed lengths", 24), ("mixed lengths", 2)]


@pytest.mark.parametrize("name,max_cpl", EDGES)
def test_kernel_emulation_matches_plain_and_jnp(name, max_cpl, monkeypatch):
    """Tolerance 0: integer DP.  With ``max_cpl`` 2 or 4 the windows span
    several column tiles, and two warps loop over the jobs."""
    monkeypatch.setattr(sw, "MAX_WARPS", 2)
    arrs = _edge_arrays(name)
    if max_cpl < 24:
        assert sw._plan(*arrs[0].shape, arrs[2].shape[1], max_cpl)[1] > 1
    got = emulate_kernel(*arrs, S_MM, S_GAPO, S_GAPE, max_cpl=max_cpl)
    plain = port(*arrs)
    jargs = [jnp.asarray(a) for a in arrs]
    want = jscreen(*jargs, S_MM, S_GAPO, S_GAPE)
    for ref in (plain, want):
        np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
        np.testing.assert_array_equal(got[1], np.asarray(ref[1]))


def test_kernel_emulation_matches_pallas_interpret():
    arrs = cases(np.random.RandomState(7), 18, 33, 100)
    got = emulate_kernel(*arrs, S_MM, S_GAPO, S_GAPE, max_cpl=2)
    want = glocal_screen_pallas(*[jnp.asarray(a) for a in arrs], S_MM, S_GAPO,
                                S_GAPE, tile=8, interpret=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("scores", [(1, 2, 1), (4, 6, 1), (2, 0, 3)])
def test_kernel_emulation_other_scores(scores):
    """Other scores than the CLI's, a free gap open among them: the ramp-free
    coordinates and the fused minima hold for any costs."""
    arrs = cases(np.random.RandomState(11), 18, 40, 160)
    got = emulate_kernel(*arrs, *scores, max_cpl=2)
    want = glocal_screen_plain(*(_t(a) for a in arrs), *scores)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())


def test_plan_covers_every_window():
    """Every width gets an even cpl of 2..24 whose tiles cover it, and a
    tiled window one of the cpl whose tiled kernel is built; the rescue's
    576 columns are one tile of exactly 18 a lane; the scratch of a tiled
    window holds two rows for every launched warp and stays within its
    cap, or within one block's rows for reads so long that those exceed it."""
    for G in range(0, 8000):
        cpl, n_tiles, n_warps, scratch = sw._plan(1000, 150, G)
        assert cpl % 2 == 0 and 2 <= cpl <= sw.MAX_CPL
        assert n_tiles * 32 * cpl >= G
        assert (n_tiles - 1) * 32 * cpl < max(G, 1)
        assert (n_tiles == 1) == (G <= 32 * sw.MAX_CPL)
        assert n_tiles == 1 or cpl >= sw.MIN_TILED_CPL
        assert n_warps == 1000 if n_tiles == 1 else 1 <= n_warps <= 1000
        assert scratch == (0 if n_tiles == 1 else -(-n_warps // 4) * 4 * 300)
    assert sw._plan(1000, 150, 769)[:2] == (sw.MIN_TILED_CPL, 2)
    assert sw._plan(2076, 150, 576) == (18, 1, 2076, 0)
    assert sw._plan(5, 150, 158)[:2] == (6, 1)
    assert sw._plan(16384, 150, 2048)[2] == sw.MAX_WARPS
    # long reads: fewer warps, so that the scratch stays within its cap
    for L in (50_000, 10 ** 6):
        cpl, n_tiles, n_warps, scratch = sw._plan(16384, L, 2048)
        assert n_tiles == 3 and 4 <= n_warps < sw.MAX_WARPS
        assert n_warps % 4 == 0 and scratch == n_warps * 2 * L
        assert scratch * 4 <= sw.SCRATCH_BYTES
    # reads so long that one block's rows exceed the cap: one block
    assert sw._plan(16384, 10 ** 8, 2048)[2:] == (4, 8 * 10 ** 8)
    assert sw._plan(3, 10 ** 6, 2048)[2:] == (3, 8 * 10 ** 6)
