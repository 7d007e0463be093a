"""Port select_topk (plain PyTorch version on the CPU) vs the JAX package's
sort reference and its Pallas kernel in interpret mode.

Bit-exact everywhere: against the sort reference on every slot (both are
sorts of unique keys), against the Pallas kernel on valid slots, the drop
row and nvalid (its invalid slots differ by design, as in
tests/test_select_kernel.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu.kernels.select import select_topk as jselect
from hsa_tpu.kernels.select import select_topk_reference
from hsa_tpu_torch.kernels import build, select
from hsa_tpu_torch.kernels.select import KEY_SH, SENT, select_topk


def make_case(C, B, seed, frac_valid=0.7, with_window=False, with_accum=False,
              n_pay=2):
    rs = np.random.RandomState(seed)
    score = rs.randint(0, 50, (C, B)).astype(np.uint32)
    row = np.arange(C, dtype=np.uint32)[:, None]
    key = (score << KEY_SH) | row
    invalid = rs.rand(C, B) > frac_valid
    key = np.where(invalid, (SENT | row).astype(np.uint32), key)
    pays = [rs.randint(0, 2 ** 32, (C, B), dtype=np.int64).astype(np.uint32)
            for _ in range(n_pay)]
    win = rs.randint(5, 40, B).astype(np.uint32) if with_window else None
    acc = (rs.randint(0, 2 ** 32, (1, B), dtype=np.int64).astype(np.uint32)
           if with_accum else None)
    return key, pays, win, acc


def _t32(a):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32))


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def run_port(key, pays, K, win, acc):
    okeyd, pouts, nd = select_topk(_t32(key), [_t32(p) for p in pays], K,
                                   _t32(win), _t32(acc))
    return _u32(okeyd.numpy()), [_u32(p.numpy()) for p in pouts], _u32(nd.numpy())


SHAPES = [(32, 64, 8, False), (72, 128, 8, True), (56, 96, 16, False),
          (17, 33, 4, True), (576, 40, 64, True), (352, 40, 32, False)]


@pytest.mark.parametrize("C,B,K,window", SHAPES)
def test_plain_matches_sort_reference(C, B, K, window):
    key, pays, win, _ = make_case(C, B, seed=C + B, with_window=window, n_pay=3)
    rk, rp, rd = select_topk_reference(
        jnp.asarray(key), tuple(jnp.asarray(p) for p in pays), K,
        None if win is None else jnp.asarray(win))
    okeyd, pouts, nd = run_port(key, pays, K, win, None)
    np.testing.assert_array_equal(okeyd[:K], _u32(rk))
    for a, b in zip(rp, pouts):
        np.testing.assert_array_equal(_u32(a), b)
    np.testing.assert_array_equal(okeyd[K], _u32(rd))
    np.testing.assert_array_equal(nd.reshape(-1), _u32(rd))


@pytest.mark.parametrize("C,B,K,window", SHAPES[:4])
@pytest.mark.parametrize("accum", [False, True])
def test_plain_matches_pallas_interpret(C, B, K, window, accum):
    key, pays, win, acc = make_case(C, B, seed=C * B, with_window=window,
                                    with_accum=accum)
    kkd, kp, kd = jselect(jnp.asarray(key), tuple(jnp.asarray(p) for p in pays),
                          K, None if win is None else jnp.asarray(win),
                          None if acc is None else jnp.asarray(acc),
                          interpret=True, lanes=32)
    kk = _u32(kkd)
    okeyd, pouts, nd = run_port(key, pays, K, win, acc)
    kvalid, pvalid = kk[:K] < SENT, okeyd[:K] < SENT
    np.testing.assert_array_equal(kvalid, pvalid)
    np.testing.assert_array_equal(np.where(kvalid, kk[:K], 0),
                                  np.where(pvalid, okeyd[:K], 0))
    for a, b in zip(kp, pouts):
        np.testing.assert_array_equal(np.where(kvalid, _u32(a), 0),
                                      np.where(pvalid, b, 0))
    np.testing.assert_array_equal(kk[K], okeyd[K])
    np.testing.assert_array_equal(_u32(kd).reshape(-1), nd.reshape(-1))


def test_nvalid_and_drop_row():
    key, pays, win, acc = make_case(40, 24, seed=3, with_window=True,
                                    with_accum=True)
    okeyd, _, _ = run_port(key, pays, 8, win, acc)
    valid = (key < SENT) & ((key >> KEY_SH) <= win[None, :])
    nvalid = valid.sum(axis=0)
    np.testing.assert_array_equal(
        okeyd[8], (acc[0].astype(np.int64) + np.maximum(nvalid - 8, 0))
        & 0xFFFFFFFF)
    np.testing.assert_array_equal((okeyd[:8] < SENT).sum(axis=0),
                                  np.minimum(nvalid, 8))


def test_all_invalid_column():
    key, pays, _, _ = make_case(16, 32, seed=1, frac_valid=0.0)
    kkd, _, kd = jselect(jnp.asarray(key), tuple(jnp.asarray(p) for p in pays),
                         4, None, interpret=True, lanes=32)
    okeyd, _, nd = run_port(key, pays, 4, None, None)
    assert not (okeyd[:4] < SENT).any()
    np.testing.assert_array_equal(_u32(kd).reshape(-1), nd.reshape(-1))
    assert (nd == 0).all()


def test_cpu_path_launches_no_kernel():
    before = select.KERNEL.launches
    key, pays, _, _ = make_case(24, 16, seed=2)
    run_port(key, pays, 4, None, None)
    assert select.KERNEL.launches == before


@pytest.mark.parametrize("bad", ["dtype", "K", "n_pay", "strided", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    key = torch.zeros((8, 4), dtype=torch.int32)
    pays = [torch.zeros((8, 4), dtype=torch.int32)]
    K, win = 2, None
    err = TypeError
    if bad == "dtype":
        key = key.long()
    elif bad == "K":
        K, err = 9, ValueError
    elif bad == "n_pay":
        pays, err = pays * 4, ValueError
    elif bad == "strided":
        pays, err = [torch.zeros((4, 8), dtype=torch.int32).t()], ValueError
    else:
        win = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(err):
        select_topk(key, pays, K, window=win)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel build that fails raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    k = build.CudaKernel("select_topk.cu", select._declare)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k.lib()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()


# -- edge cases of the selection, plain version against the JAX package ------

def edge_case(name):
    """(key, pays, win, acc, K) for one edge of the compaction and the rank:
    every key valid, no key valid in some columns, exactly K and K + 1 valid
    keys, a width that is no multiple of 32, and a drop counter that wraps
    past 2^32."""
    C, B, K = 48, 64, 8
    if name == "ragged_width":
        B = 45
    key, pays, win, acc = make_case(C, B, seed=len(name), frac_valid=0.6,
                                    with_accum=True, n_pay=3)
    rs = np.random.RandomState(7)
    row = np.arange(C, dtype=np.uint32)[:, None]
    valid_key = (rs.randint(0, 50, (C, B)).astype(np.uint32) << KEY_SH) | row
    if name == "all_valid":
        key = valid_key
    elif name == "none_valid_in_some_columns":
        key[:, ::3] = (SENT | row).astype(np.uint32)
    elif name in ("n_equals_K", "n_equals_K_plus_1"):
        n = K if name == "n_equals_K" else K + 1
        for b in range(B):
            keep = rs.permutation(C)[:n]
            col = (SENT | row[:, 0]).astype(np.uint32)
            col[keep] = valid_key[keep, b]
            key[:, b] = col
    elif name == "accum_wraps":
        acc = np.full((1, B), 2 ** 32 - 3, np.uint32)
        acc[0, ::2] = 2 ** 32 - 1
    return key, pays, win, acc, K


EDGES = ["all_valid", "none_valid_in_some_columns", "n_equals_K",
         "n_equals_K_plus_1", "ragged_width", "accum_wraps"]


@pytest.mark.parametrize("name", EDGES)
def test_edge_cases_match_reference_and_pallas(name):
    key, pays, win, acc, K = edge_case(name)
    jk, jp = jnp.asarray(key), tuple(jnp.asarray(p) for p in pays)
    okeyd, pouts, nd = run_port(key, pays, K, win, acc)
    # the sort reference: every slot
    rk, rp, rd = select_topk_reference(jk, jp, K, None)
    np.testing.assert_array_equal(okeyd[:K], _u32(rk))
    for a, b in zip(rp, pouts):
        np.testing.assert_array_equal(_u32(a), b)
    np.testing.assert_array_equal(
        okeyd[K], (_u32(rd).reshape(-1) + acc[0].astype(np.int64)) & 0xFFFFFFFF)
    # the Pallas kernel, interpreted: valid slots and the drop row
    lanes = 32 if key.shape[1] % 32 == 0 else key.shape[1]
    kkd, kp, kd = jselect(jk, jp, K, None, jnp.asarray(acc), interpret=True,
                          lanes=lanes)
    kk = _u32(kkd)
    valid = okeyd[:K] < SENT
    np.testing.assert_array_equal(kk[:K] < SENT, valid)
    np.testing.assert_array_equal(np.where(valid, kk[:K], 0),
                                  np.where(valid, okeyd[:K], 0))
    for a, b in zip(kp, pouts):
        np.testing.assert_array_equal(np.where(valid, _u32(a), 0),
                                      np.where(valid, b, 0))
    np.testing.assert_array_equal(kk[K], okeyd[K])
    nvalid = (key < SENT).sum(axis=0)
    np.testing.assert_array_equal(
        nd.reshape(-1),
        (acc[0].astype(np.int64) + np.maximum(nvalid - K, 0)) & 0xFFFFFFFF)


# -- the CUDA kernel's algorithm, emulated in Python ---------------------------

def emulate_kernel(key, pays, K, win, acc, TX, seed):
    """``csrc/select_topk.cu`` step by step on numpy arrays: per tile of
    ``TX`` columns the valid keys are appended to per-column lists in an
    arbitrary order (the order of the kernel's shared-memory atomics, here
    shuffled from ``seed``); per column a "warp" bisects on the key's
    value to the K-th smallest, moves the keys at or below it to the front
    of the list in place, 32 entries a pass, and ranks what is left by
    counting smaller keys; the K smallest are staged in a tile of row
    stride TX + 1 with their rows, and the tile is written out with the
    payloads fetched by row.  Invalid slots: SENT and payload 0."""
    C, B = key.shape
    rs = np.random.RandomState(seed)
    cap = (C + 31) // 32 * 32 + 1
    TS = TX + 1
    okey = np.full((K + 1, B), 0xDEAD, np.int64)
    pouts = [np.full((K, B), 0xDEAD, np.int64) for _ in pays]
    for col0 in range(0, B, TX):
        skey = np.zeros((TX, cap), np.int64)
        srow = np.zeros((TX, cap), np.int64)
        cnt = np.zeros(TX, np.int64)
        tkey = np.full((K + 1) * TS, -7, np.int64)
        trow = np.full(K * TS, -7, np.int64)
        # 1. compaction, in a shuffled thread order
        cells = [(c, x) for c in range(C) for x in range(TX) if col0 + x < B]
        for i in rs.permutation(len(cells)):
            c, x = cells[i]
            k = int(key[c, col0 + x])
            if k < SENT and not (win is not None
                                 and (k >> KEY_SH) > int(win[col0 + x])):
                skey[x, cnt[x]], srow[x, cnt[x]] = k, c
                cnt[x] += 1
        # 2. per column: bisect to the K-th smallest, compact, rank
        for xc in range(TX):
            if col0 + xc >= B:
                break
            n = int(cnt[xc])
            m = min(n, K)
            ck, cr = skey[xc], srow[xc]
            if n > K:
                lo, hi = int(ck[:n].min()), int(ck[:n].max())
                rounds = 0
                while lo < hi:
                    mid = lo + (hi - lo) // 2
                    if int((ck[:n] <= mid).sum()) >= K:
                        hi = mid
                    else:
                        lo = mid + 1
                    rounds += 1
                assert rounds <= 31
                kept = 0
                for base in range(0, n, 32):     # a warp's pass, in place
                    k32 = ck[base:min(base + 32, n)].copy()
                    r32 = cr[base:min(base + 32, n)].copy()
                    keep = k32 <= lo
                    assert kept <= base
                    ck[kept:kept + keep.sum()] = k32[keep]
                    cr[kept:kept + keep.sum()] = r32[keep]
                    kept += int(keep.sum())
                assert kept == K
            for i in range(m):
                rank = int((ck[:m] < ck[i]).sum())
                tkey[rank * TS + xc] = ck[i]
                trow[rank * TS + xc] = cr[i]
            for s in range(n, K):
                tkey[s * TS + xc], trow[s * TS + xc] = SENT, -1
            a = int(acc.reshape(-1)[col0 + xc]) if acc is not None else 0
            tkey[K * TS + xc] = (a + max(n - K, 0)) & 0xFFFFFFFF
        # 3. write out by rows
        for x in range(TX):
            col = col0 + x
            if col >= B:
                continue
            for s in range(K + 1):
                okey[s, col] = tkey[s * TS + x]
            for s in range(K):
                r = trow[s * TS + x]
                for p, po in zip(pays, pouts):
                    po[s, col] = int(p[r, col]) if r >= 0 else 0
    return okey, pouts


def sweep_rows(C, B, plan):
    """The rows of a column in the order of the tall kernel's sweep: thread
    y of the R = 512 / (cols / vec) threads a column has reads rows c0 + u
    * R + y, u < 8 loads, for c0 = 0, 8R, ...; vec = 4 columns a thread
    where the tile and the width allow it.  Each row comes exactly once."""
    vec = 4 if plan.cols % 4 == 0 and B % 4 == 0 else 1
    R = 512 // (plan.cols // vec)
    rows = [c for c0 in range(0, C, 8 * R) for u in range(8)
            for c in range(c0 + u * R, c0 + (u + 1) * R) if c < C]
    assert sorted(rows) == list(range(C))
    return np.asarray(rows)


def emulate_tall(key, pays, K, win, acc, seed, plan=None, passes=None):
    """The tall kernel of ``csrc/select_topk.cu`` step by step on numpy
    arrays, at ``plan`` (by default :func:`select.tall_plan`'s): each
    column's rows in the order of the kernel's sweep; the histogram of the
    score's low 10 bits and the score range; where the scores span fewer
    than 1,024 values, the K-th key's score by a prefix sum from the least
    score, else the whole 31-bit range; then, while the keys below and in
    the boundary bin overflow a list of ``plan.ls``, a pass over the next 10
    bits of the keys in the bin; the emit pass, the kept keys in a shuffled
    order (the shared-memory atomics', from ``seed``); a stable LSD counting
    sort, at most 5 bits a digit, of the key minus the least key, each of
    32 lanes placing its share of the list with counters of its own; the
    write-out.  Invalid slots: SENT and payload 0.  ``passes``, a list,
    gets each column's count of histogram passes after the first."""
    C, B = key.shape
    plan = plan or select.tall_plan(C, B, K)
    assert plan.tall and plan.ls >= K
    bins, digit = select.TALL_BINS, 10
    rs = np.random.RandomState(seed)
    rows = sweep_rows(C, B, plan)
    okey = np.full((K + 1, B), 0xDEAD, np.int64)
    pouts = [np.full((K, B), 0xDEAD, np.int64) for _ in pays]
    for col in range(B):
        k = key[rows, col].astype(np.int64)
        valid = k < SENT
        if win is not None:
            valid &= (k >> KEY_SH) <= int(win[col])
        # 1-2. the histogram pass
        s = k[valid] >> KEY_SH
        hist = np.bincount(s & (bins - 1), minlength=bins)
        n = len(s)
        smin, smax = (int(s.min()), int(s.max())) if n else (2 ** 31 - 1, -1)
        lo, lg, below, cnt = 0, 31, 0, n
        if n > K and smax - smin < bins:
            h = hist[(smin + np.arange(bins)) & (bins - 1)]
            at = int(np.argmax(np.cumsum(h) >= K))
            below, cnt = int(h[:at].sum()), int(h[at])
            lo, lg = (smin + at) << KEY_SH, KEY_SH
        # 3. into the boundary bin while it overflows the list
        extra = 0
        while n > K and below + cnt > plan.ls:
            db = min(digit, lg)
            sh = lg - db
            d = k[valid] - lo
            h = np.bincount(d[(d >= 0) & (d < 1 << lg)] >> sh,
                            minlength=1 << db)
            at = int(np.argmax(np.cumsum(h) >= K - below))
            below, cnt = below + int(h[:at].sum()), int(h[at])
            lo, lg = lo + (at << sh), sh
            extra += 1
        assert extra <= 4
        if passes is not None:
            passes.append(extra)
        top = lo + (1 << lg) - 1
        # 4. the emit pass: the kept keys, shuffled
        keep = valid & (k <= top)
        order = rs.permutation(int(keep.sum()))
        lk, lr = k[keep][order], rows[keep][order]
        assert len(lk) == (n if n <= K else below + cnt) <= plan.ls
        # 5. the stable LSD counting sort, 5 bits a digit at most: "lane" l
        #    counts and places entries [l * per, (l + 1) * per) with
        #    counters of its own, the starts in (digit, lane) order
        if len(lk) > 1 and lk.max() > lk.min():
            mn = int(lk.min())
            bits = int(lk.max() - mn).bit_length()
            n_pass = -(-bits // 5)
            dw = -(-bits // n_pass)
            lane = np.arange(len(lk)) // -(-len(lk) // 32)
            for p in range(n_pass):
                d = ((lk - mn) >> (p * dw)) & ((1 << dw) - 1)
                own = np.zeros((32, 1 << dw), np.int64)
                np.add.at(own, (lane, d), 1)
                flat = own.T.ravel()                 # digit-major, then lane
                start = (np.cumsum(flat) - flat).reshape(1 << dw, 32).T.copy()
                pos = np.empty(len(d), np.int64)
                for i, (ln, x) in enumerate(zip(lane, d)):
                    pos[i] = start[ln, x]
                    start[ln, x] += 1
                sk, sr = np.empty_like(lk), np.empty_like(lr)
                sk[pos], sr[pos] = lk, lr
                lk, lr = sk, sr
        # 6. the write-out
        m = min(len(lk), K)
        okey[:m, col], okey[m:K, col] = lk[:m], SENT
        for p, po in zip(pays, pouts):
            po[:m, col], po[m:, col] = p[lr[:m], col], 0
        a = int(acc.reshape(-1)[col]) if acc is not None else 0
        okey[K, col] = (a + max(n - K, 0)) & 0xFFFFFFFF
    return okey, pouts


@pytest.mark.parametrize("TX", [16, 8, 1])
@pytest.mark.parametrize("name", ["windowed", "all_valid", "ragged_width",
                                  "none_valid_in_some_columns",
                                  "n_equals_K_plus_1"])
def test_kernel_algorithm_emulated(name, TX):
    """The kernel's compaction + rank gives the plain version's answer on
    valid slots and the drop row, and SENT / 0 elsewhere.  ``all_valid``
    at C = 300 compacts 300 keys to K = 40 in ten passes.  ``TX`` = 1 is the
    tall variant."""
    if name == "windowed":
        key, pays, win, acc = make_case(40, 40, seed=11, with_window=True,
                                        with_accum=True, n_pay=3)
        K = 8
    elif name == "all_valid":
        key, pays, win, acc = make_case(300, 9, seed=12, frac_valid=1.0,
                                        with_accum=True, n_pay=1)
        K = 40
    else:
        key, pays, win, acc, K = edge_case(name)
    okeyd, pouts, _ = run_port(key, pays, K, win, acc)
    args = (key.astype(np.int64), [p.astype(np.int64) for p in pays], K, win,
            acc)
    ek, ep = (emulate_tall(*args, seed=TX) if TX == 1
              else emulate_kernel(*args, TX, seed=TX))
    valid = okeyd[:K] < SENT
    np.testing.assert_array_equal(np.where(valid, okeyd[:K], SENT), ek[:K])
    np.testing.assert_array_equal(okeyd[K], ek[K])
    for a, b in zip(pouts, ep):
        np.testing.assert_array_equal(np.where(valid, a, 0), b)


def test_tall_variant_emulated_at_many_rows():
    """The tall kernel over more rows than one load of its threads (512
    rows a load of one column: five loads, the last ragged), with more
    valid keys than K, at the frontier's ratio C = 9K."""
    key, pays, win, acc = make_case(2_340, 3, seed=21, frac_valid=0.8,
                                    with_window=True, with_accum=True)
    K = 260
    okeyd, pouts, _ = run_port(key, pays, K, win, acc)
    ek, ep = emulate_tall(key.astype(np.int64),
                          [p.astype(np.int64) for p in pays], K, win, acc,
                          seed=5)
    valid = okeyd[:K] < SENT
    assert valid[:, 0].sum() == K
    np.testing.assert_array_equal(np.where(valid, okeyd[:K], SENT), ek[:K])
    np.testing.assert_array_equal(okeyd[K], ek[K])
    for a, b in zip(pouts, ep):
        np.testing.assert_array_equal(np.where(valid, a, 0), b)


def tall_case(name):
    """(key, pays, win, acc, K, plan) for an edge of the tall kernel's radix
    select and counting sort."""
    C, B, K = (601 if name == "rows_no_multiple_of_the_split" else 600), 6, 100
    rs = np.random.RandomState(len(name) + 40)
    row = np.arange(C, dtype=np.int64)[:, None]
    score = rs.randint(0, 30, (C, B)).astype(np.int64)
    tag = np.broadcast_to(row, (C, B))
    invalid = rs.rand(C, B) > 0.9
    plan = select.tall_plan(C, B, K)
    if name == "full_range_scores":
        score = rs.randint(0, 0x1FFFC, (C, B)).astype(np.int64)
    elif name == "one_score":
        score = np.full((C, B), 1234, np.int64)
    elif name == "shuffled_low":
        tag = np.argsort(rs.rand(C, B), axis=0)
    elif name in ("n_equals_K_at_bin_edge", "n_equals_K_plus_1_at_bin_edge"):
        # K valid keys of scores 3..7 then (for K + 1) one alone at score 9
        n = K + (name == "n_equals_K_plus_1_at_bin_edge")
        invalid = np.ones((C, B), bool)
        for b in range(B):
            pick = rs.permutation(C)[:n]
            invalid[pick, b] = False
            score[pick[:K], b] = rs.randint(3, 8, K)
            score[pick[K:], b] = 9
    elif name == "no_valid_key_in_a_column":
        invalid[:, 2] = True
    key = np.where(invalid, SENT | np.arange(C)[:, None],
                   (score << KEY_SH) | tag).astype(np.uint32)
    pays = [rs.randint(0, 2 ** 32, (C, B), dtype=np.int64).astype(np.uint32)
            for _ in range(3)]
    acc = rs.randint(0, 2 ** 32, (1, B), dtype=np.int64).astype(np.uint32)
    return key, pays, None, acc, K, plan


TALL_EDGES = ["full_range_scores", "one_score", "shuffled_low",
              "n_equals_K_at_bin_edge", "n_equals_K_plus_1_at_bin_edge",
              "no_valid_key_in_a_column", "rows_no_multiple_of_the_split"]


@pytest.mark.parametrize("name", TALL_EDGES)
def test_tall_kernel_edges_emulated(name):
    """The tall kernel's walk, emulated, against the plain version (valid
    slots, drop row, payloads) and the JAX package's sort reference (every
    valid slot): scores over the whole 17-bit range (the select from the
    top bits, passes over a list of 256), every key of one score (the order
    from the low field alone), low fields that are not the row, exactly K and
    K + 1 valid keys with the K-th at a bin's edge, a column with no valid
    key, and rows that the threads' split leaves ragged (601 rows over 512
    threads a column)."""
    key, pays, win, acc, K, plan = tall_case(name)
    okeyd, pouts, _ = run_port(key, pays, K, win, acc)
    passes = []
    ek, ep = emulate_tall(key.astype(np.int64),
                          [p.astype(np.int64) for p in pays], K, win, acc,
                          seed=9, plan=plan, passes=passes)
    valid = okeyd[:K] < SENT
    np.testing.assert_array_equal(np.where(valid, okeyd[:K], SENT), ek[:K])
    np.testing.assert_array_equal(okeyd[K], ek[K])
    for a, b in zip(pouts, ep):
        np.testing.assert_array_equal(np.where(valid, a, 0), b)
    rk, rp, rd = select_topk_reference(
        jnp.asarray(key), tuple(jnp.asarray(p) for p in pays), K, None)
    rk = _u32(rk)
    np.testing.assert_array_equal(np.where(valid, rk, SENT), ek[:K])
    for a, b in zip(rp, ep):
        np.testing.assert_array_equal(np.where(valid, _u32(a), 0), b)
    if name in ("full_range_scores", "one_score"):
        assert min(passes) >= 1        # the boundary bin overflowed the list
    if name == "no_valid_key_in_a_column":
        assert (ek[:K, 2] == SENT).all() and ek[K, 2] == acc[0, 2]


# -- the kernel's plan: which variant each beam select takes -----------------

@pytest.mark.parametrize("W", [8, 64, 255, 355, 356, 512, 1024, 1820])
@pytest.mark.parametrize("which", ["frontier", "merge"])
def test_plan_fits_every_beam_width(W, which):
    """The beam's frontier select ([9W, B], K = W) and hit merge ([5W + H,
    B], K = H, H up to 64) get a plan whose shared memory fits a block at
    every width the beam's keys allow (9W < 2^14) and every batch width:
    the tiled kernel at the widest tile that fits (16 columns where the
    first kernel ran, 8 up to W = 355 at the frontier), the tall kernel
    above, at the widest tile that fits and gives half of the SMs a
    block."""
    assert 9 * W < 1 << KEY_SH
    shapes = [(9 * W, W)] if which == "frontier" else \
        [(5 * W + H, H) for H in (8, 32, 64)]
    for C, K in shapes:
        for B in (4, 256, 516, 2_048, 16_384, 32_768):
            plan = select._plan(C, B, K)
            if not plan.tall:
                assert plan.cols in select.TILES
                assert select.smem_bytes(plan.cols, C, K) <= select.MAX_SMEM
                wider = [t for t in select.TILES if t > plan.cols]
                assert all(select.smem_bytes(t, C, K) > select.MAX_SMEM
                           for t in wider)
                continue
            assert all(select.smem_bytes(t, C, K) > select.MAX_SMEM
                       for t in select.TILES)
            assert plan.ls >= max(K, select.TALL_MIN_LIST)
            assert select.tall_smem_bytes(plan.cols, plan.ls) <= \
                select.MAX_SMEM
            wider = [c for c in select.TALL_COLS if c > plan.cols]
            assert all(select.tall_smem_bytes(c, plan.ls) > select.MAX_SMEM
                       or 2 * -(-B // c) < select.SMS for c in wider)
            tiles = -(-B // plan.cols)
            assert 2 * tiles >= select.SMS or plan.cols == min(
                c for c in select.TALL_COLS
                if select.tall_smem_bytes(c, plan.ls) <= select.MAX_SMEM)
            # the code the C function decodes
            c = -plan.code
            assert (c & 15, c >> 4) == (plan.cols, plan.ls)
    if which == "frontier":
        assert select._plan(9 * W, 32_768, W).tall == (W > 355)
    # the byte counts of the source's tiled kernel, at the widths named in
    # its note: the frontier's tile of 8 fits up to W = 355 and not above
    assert select.smem_bytes(8, 9 * 355, 355) == 230_492
    assert select.smem_bytes(8, 9 * 356, 356) == 232_612
    # the tall kernel's at W = 512 and W = 1820
    assert select.tall_smem_bytes(8, 576) == 107_968
    assert select.tall_smem_bytes(4, 2_047) == 148_352
