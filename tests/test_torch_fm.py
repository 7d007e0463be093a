"""Port FM primitives (torch, CPU) vs hsa_tpu.search.fm (JAX, CPU).

Same seeded inputs through both; every comparison is bit-exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu.fmcore import FMIndex
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.search import fm as jfm
from hsa_tpu_torch.fmcore import FMIndex as TFMIndex
from hsa_tpu_torch.index.layout import to_device
from hsa_tpu_torch.search import fm as tfm


def _genome(n, seed):
    return np.random.RandomState(seed).randint(0, 4, size=n).astype(np.int8)


# (name, text, sa_direct): a 6 kbp genome with and without the direct SA
# (the LF walk), and a block-edge genome (length not a multiple of 32)
_T = _genome(6000, 3)
_TE = _genome(128 * 40 + 7, 21)
CASES = {"direct": (_T, True), "walk": (_T, False), "edge": (_TE, False)}
_BUILT = {}


def _idx(name):
    if name not in _BUILT:
        t, sad = CASES[name]
        di = build_device_index(t, sa_intv=32 if name != "edge" else 8,
                                sa_direct=sad)
        _BUILT[name] = (t, di, di.as_jax(), to_device(di, "cpu"))
    return _BUILT[name]


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


def _ranks(di, rs, m=400):
    n = di.n
    special = [0, 1, 31, 32, 33, di.primary, di.primary + 1, n - 1, n, n + 1]
    return np.concatenate([np.arange(0, 200), special,
                           rs.randint(0, n + 2, m)]).astype(np.int64)


@pytest.mark.parametrize("name", list(CASES))
def test_to_device_matches_as_jax(name):
    _, di, dj, dt = _idx(name)
    assert (dt.n, dt.primary, dt.sa_intv) == (int(dj.n), int(dj.primary),
                                             dj.sa_intv)
    assert dt.rev_primary == int(dj.rev_primary)
    for f in ("C", "occ_blocks", "samples", "rev_occ_blocks", "sa_direct"):
        a, b = getattr(dj, f), getattr(dt, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_u32(a), _u32(b.numpy()), err_msg=f)
    assert dt.occ_blocks.dtype == torch.int32
    assert dt.C.dtype == torch.int64 and dt.samples.dtype == torch.int64


@pytest.mark.parametrize("name", list(CASES))
def test_occ_lt4_flat(name):
    _, di, dj, dt = _idx(name)
    ps = _ranks(di, np.random.RandomState(0))
    want = jfm.occ_lt4_flat(dj, jnp.asarray(ps, jnp.uint32))
    got = tfm.occ_lt4_flat(dt, _t(ps))
    for a in range(4):
        np.testing.assert_array_equal(_u32(want[a]), got[a].numpy())


@pytest.mark.parametrize("name,rev", [("direct", False), ("direct", True),
                                      ("edge", False), ("edge", True)])
def test_occ_lt(name, rev):
    _, di, dj, dt = _idx(name)
    rs = np.random.RandomState(1)
    ps = _ranks(di, rs)
    a = rs.randint(0, 4, ps.size)
    want = jfm.occ_lt(dj, jnp.asarray(a, jnp.uint32),
                      jnp.asarray(ps, jnp.uint32), rev=rev)
    got = tfm.occ_lt(dt, _t(a), _t(ps), rev=rev)
    np.testing.assert_array_equal(_u32(want), got.numpy())


def _intervals(t, di, dj, rs, m=150):
    """Random valid intervals (exact matches of short genome substrings)
    plus the whole-text interval."""
    ref = FMIndex.build(t)
    ks, ls = [0], [di.n]
    for plen in (1, 3, 6):
        for p in rs.randint(0, len(t) - plen, m // 3):
            k, l = ref.exact_interval(t[p:p + plen])
            ks.append(int(k)); ls.append(int(l))
    return np.asarray(ks, np.int64), np.asarray(ls, np.int64)


@pytest.mark.parametrize("name,rev", [("direct", False), ("walk", True),
                                      ("edge", False)])
def test_extend(name, rev):
    t, di, dj, dt = _idx(name)
    rs = np.random.RandomState(2)
    ks, ls = _intervals(t, di, dj, rs)
    a = rs.randint(0, 6, ks.size)      # 4 = N and 5 = PAD clamp to 3
    wk, wl = jfm.extend(dj, jnp.asarray(np.minimum(a, 3), jnp.uint32),
                        jnp.asarray(ks, jnp.uint32), jnp.asarray(ls, jnp.uint32),
                        rev=rev)
    gk, gl = tfm.extend(dt, _t(a), _t(ks), _t(ls), rev=rev)
    np.testing.assert_array_equal(_u32(wk), gk.numpy())
    np.testing.assert_array_equal(_u32(wl), gl.numpy())


@pytest.mark.parametrize("name", ["direct", "edge"])
def test_extend4_flat(name):
    t, di, dj, dt = _idx(name)
    ks, ls = _intervals(t, di, dj, np.random.RandomState(7))
    wk, wl = jfm.extend4_flat(dj, jnp.asarray(ks, jnp.uint32),
                              jnp.asarray(ls, jnp.uint32))
    gk, gl = tfm.extend4_flat(dt, _t(ks), _t(ls))
    for a in range(4):
        np.testing.assert_array_equal(_u32(wk[a]), gk[a].numpy())
        np.testing.assert_array_equal(_u32(wl[a]), gl[a].numpy())


def test_extend4_flat_dead_slots_do_not_fault():
    """Dead beam slots carry arbitrary ranks; jnp.take clamps, the port
    clamps its gathers instead of faulting."""
    _, di, _, dt = _idx("direct")
    k = _t([0, di.n + 1, 2 ** 32 - 1, 12345678901])
    k4, l4 = tfm.extend4_flat(dt, k, k)
    assert all(x.shape == (4,) for x in k4 + l4)
    assert tfm.locate(dt, k).shape == (4,)


@pytest.mark.parametrize("prim", ["word_masks", "count_base", "primary_corr",
                                  "select4", "sym_at", "lf_from_rows",
                                  "mark_from_rows"])
@pytest.mark.parametrize("name", ["walk", "edge"])
def test_row_primitives(prim, name):
    """The decode helpers on the same gathered rows, including the
    primary slot and both ends of every block."""
    _, di, dj, dt = _idx(name)
    rs = np.random.RandomState(4)
    r = np.concatenate([_ranks(di, rs), [di.primary - 1, di.primary]])
    r = np.clip(r, 0, di.n).astype(np.int64)
    jrows, jb, joff, _ = jfm._row_decode(dj, jnp.asarray(r, jnp.uint32))
    trows, tb, toff = tfm._row_decode(dt, _t(r))
    np.testing.assert_array_equal(_u32(jrows), trows.numpy())
    a = rs.randint(0, 4, r.size)
    ja, ta = jnp.asarray(a, jnp.uint32), _t(a)
    if prim == "word_masks":
        offs = np.arange(33)
        want = jfm._word_masks(jnp.asarray(offs, jnp.int32))
        got = tfm._word_masks(_t(offs))
        pairs = list(zip(want, got))
    elif prim == "count_base":
        want = jfm._count_base(jrows, jfm._word_masks(joff), ja)
        got = tfm._count_base(trows, tfm._word_masks(toff), ta)
        pairs = [(want, got)]
    elif prim == "primary_corr":
        pairs = [(jfm._primary_corr(dj, jb, joff + 1, rev=False),
                  tfm._primary_corr(dt, tb, toff + 1, rev=False)),
                 (jfm._primary_corr(dj, jb, joff, rev=True),
                  tfm._primary_corr(dt, tb, toff, rev=True))]
    elif prim == "select4":
        pairs = [(jfm._select4(jrows, ja), tfm._select4(trows, ta)),
                 (jfm._select4(jrows, ja, 4), tfm._select4(trows, ta, 4))]
    elif prim == "sym_at":
        pairs = [(jfm._sym_at(jrows, joff), tfm._sym_at(trows, toff))]
    elif prim == "lf_from_rows":
        pairs = [(jfm._lf_from_rows(dj, jrows, jb, joff,
                                    jnp.asarray(r, jnp.uint32)),
                  tfm._lf_from_rows(dt, trows, tb, toff, _t(r)))]
    else:
        pairs = list(zip(jfm._mark_from_rows(jrows, joff),
                         tfm._mark_from_rows(trows, toff)))
    for want, got in pairs:
        np.testing.assert_array_equal(_u32(want), got.numpy())


def test_popcount32():
    x = np.random.RandomState(9).randint(0, 2 ** 32, 1000, dtype=np.int64)
    x[:3] = [0, 2 ** 32 - 1, 0x80000001]
    want = np.array([bin(int(v)).count("1") for v in x])
    np.testing.assert_array_equal(tfm.popcount32(_t(x)).numpy(), want)


@pytest.mark.parametrize("name", list(CASES))
def test_locate(name):
    _, di, dj, dt = _idx(name)
    r = _ranks(di, np.random.RandomState(5))
    r = np.clip(r, 0, di.n)
    want = jfm.locate(dj, jnp.asarray(r, jnp.uint32))
    got = tfm.locate(dt, _t(r))
    np.testing.assert_array_equal(_u32(want), got.numpy())
    # and against the suffix array itself
    if di.sa_direct is not None:
        np.testing.assert_array_equal(got.numpy(), di.sa_direct[r])


# -- occ_lt4, extend4, bwt_char, lf: tests/test_device_fm.py's twins --------
def _device_fm_case():
    """tests/test_device_fm.py's index: 5,000 bp from seed 3, sa_intv 32."""
    if "device_fm" not in _BUILT:
        t = _genome(5000, 3)
        di = build_device_index(t, sa_intv=32)
        _BUILT["device_fm"] = (t, TFMIndex.build(t, sa_intv=32), di.as_jax(),
                               to_device(di, "cpu"))
    return _BUILT["device_fm"]


@pytest.mark.parametrize("prim", ["occ_lt4", "extend4", "bwt_char", "lf"])
def test_device_fm_twins(prim):
    """Each of the four on test_device_fm.py's inputs, bit-equal to
    hsa_tpu.search.fm and to the port's fmcore.FMIndex (the primary's
    symbol only to hsa_tpu's: fmcore leaves it undefined)."""
    t, ref, dj, dt = _device_fm_case()
    U = lambda x: jnp.asarray(x, jnp.uint32)   # noqa: E731
    if prim == "occ_lt4":
        ps = np.concatenate([np.arange(0, 300), [ref.primary, ref.primary + 1,
                                                 ref.n, ref.n + 1],
                             np.random.RandomState(0).randint(0, ref.n + 2,
                                                              500)])
        got = tfm.occ_lt4(dt, _t(ps)).numpy()
        np.testing.assert_array_equal(_u32(jfm.occ_lt4(dj, U(ps))), got)
        want = np.stack([ref.occ(a, ps - 1) for a in range(4)], axis=1)
        np.testing.assert_array_equal(want, got)
        assert got.shape == (ps.size, 4)
    elif prim == "extend4":
        rs = np.random.RandomState(7)
        ks, ls = [], []
        for _ in range(50):
            p = rs.randint(0, ref.n - 4)
            k, l = ref.exact_interval(t[p:p + 4])
            ks.append(k)
            ls.append(l)
        ks, ls = np.asarray(ks, np.int64), np.asarray(ls, np.int64)
        gk, gl = (x.numpy() for x in tfm.extend4(dt, _t(ks), _t(ls)))
        wk, wl = jfm.extend4(dj, U(ks), U(ls))
        np.testing.assert_array_equal(_u32(wk), gk)
        np.testing.assert_array_equal(_u32(wl), gl)
        for a in range(4):
            ek, el = ref.extend(a, ks, ls)
            np.testing.assert_array_equal(ek, gk[:, a])
            np.testing.assert_array_equal(el, gl[:, a])
    else:
        ranks = np.arange(0, ref.n + 1, 13)
        ranks = np.append(ranks[ranks != ref.primary], ref.primary)
        got = getattr(tfm, prim)(dt, _t(ranks)).numpy()
        np.testing.assert_array_equal(_u32(getattr(jfm, prim)(dj, U(ranks))),
                                      got)
        want = [getattr(ref, prim)(int(r)) for r in ranks[:-1]]
        np.testing.assert_array_equal(want, got[:-1])
        if prim == "lf":
            assert got[-1] == 0


# -- the shard branches, in a world of 2 gloo processes ---------------------
SHARD_WORKER = """
import sys
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from hsa_tpu_torch.dist import ShardedIndex, init_multihost, make_mesh
from hsa_tpu_torch.index.layout import DeviceIndex
from hsa_tpu_torch.search import fm

work, names, (rank, world, addr) = sys.argv[2], sys.argv[3], sys.argv[4:7]
torch.set_num_threads(1)
init_multihost(addr, int(world), int(rank), "gloo", timeout=60)
mesh = make_mesh(1, 2)
out = {}
for name in names.split(","):
    z = {k: torch.from_numpy(v)
         for k, v in np.load(f"{work}/{name}_in.npz").items()}
    idx = ShardedIndex(DeviceIndex.load(f"{work}/{name}.npz"), mesh, "cpu").idx
    out[f"{name}_occ_lt4_flat"] = torch.stack(fm.occ_lt4_flat(idx, z["p"]))
    # the four device functions, with the merges each call made
    r = z["p"].clamp(max=idx.n)
    for prim, args in (("occ_lt4", (z["p"],)), ("extend4", (z["k"], z["l"])),
                       ("bwt_char", (r,)), ("lf", (r,))):
        n0 = idx.collectives.all_reduces
        got = getattr(fm, prim)(idx, *args)
        out[f"{name}_{prim}_merges"] = torch.tensor(
            idx.collectives.all_reduces - n0)
        out[f"{name}_{prim}"] = (torch.stack(got) if isinstance(got, tuple)
                                 else got)
    for rev in (False, True):
        sfx = "_rev" if rev else ""
        out[f"{name}_occ_lt{sfx}"] = fm.occ_lt(idx, z["a"], z["p"], rev=rev)
        out[f"{name}_extend{sfx}"] = torch.stack(
            fm.extend(idx, z["ea"], z["k"], z["l"], rev=rev))
    try:
        fm._row_decode(idx, z["p"])
        refused = 0
    except ValueError:
        refused = 1
    out[f"{name}_row_decode_refused"] = torch.tensor(refused)
np.savez(f"{work}/out{rank}.npz", **{k: v.numpy() for k, v in out.items()})
"""
SHARD_CASES = ["direct", "edge"]
SHARD_PRIMS = ["occ_lt4_flat", "occ_lt", "occ_lt_rev", "extend", "extend_rev",
               "occ_lt4", "extend4", "bwt_char", "lf"]
# the functions that merge exactly once a call
ONE_MERGE = ("occ_lt4", "extend4", "bwt_char", "lf")


def _shard_ranks(di, n_shard=2):
    """Prefix lengths around every shard boundary of the occ rows, in and
    around the primary's block (forward and reverse) and at the text's
    ends."""
    rows = -(-di.occ_blocks.shape[0] // n_shard)
    ps = [np.arange(0, 40)]
    for s in range(1, n_shard):
        ps.append(np.arange(32 * s * rows - 40, 32 * s * rows + 40))
    for prim in (di.primary, di.rev_primary):
        ps.append(np.arange(32 * (prim >> 5) - 2, 32 * (prim >> 5) + 34))
    ps.append(np.arange(di.n - 40, di.n + 2))
    return np.clip(np.concatenate(ps), 0, di.n + 1).astype(np.int64)


@pytest.fixture(scope="module")
def shard_world(tmp_path_factory):
    """Both ranks' shard-branch results at mesh (1, 2), with the inputs."""
    import os
    import sys

    from hsa_tpu_torch.dist.launch import run_world
    work = tmp_path_factory.mktemp("torch_fm_shard")
    inputs = {}
    for name in SHARD_CASES:
        t, di, dj, _ = _idx(name)
        di.save(str(work / f"{name}.npz"))
        rs = np.random.RandomState(11)
        p = _shard_ranks(di)
        ks, ls = _intervals(t, di, dj, rs)
        # intervals that straddle the boundary and the primary's block too
        ks = np.concatenate([ks, p[:-1]])
        ls = np.concatenate([ls, p[1:]])
        inputs[name] = dict(p=p, a=rs.randint(0, 4, p.size), k=ks, l=ls,
                            ea=rs.randint(0, 6, ks.size))
        np.savez(work / f"{name}_in.npz", **inputs[name])
    script = work / "worker.py"
    script.write_text(SHARD_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run_world([sys.executable, str(script), repo, str(work),
               ",".join(SHARD_CASES)], 2, timeout=120,
              env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=repo)
    return inputs, [dict(np.load(work / f"out{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("prim", SHARD_PRIMS)
@pytest.mark.parametrize("name", SHARD_CASES)
def test_shard_branches_match_unsharded(shard_world, name, prim):
    """occ_lt4_flat, occ_lt, extend, occ_lt4, extend4, bwt_char and lf on a
    2-shard index, at prefix lengths (ranks) around the shard boundary and
    the primary's block, on both ranks equal to hsa_tpu's unsharded
    functions (a primary-slot correction subtracted, or LF(primary) = 0
    added, by the shard that does not own the block would show here); the
    four device functions merge once a call."""
    inputs, outs = shard_world
    _, di, dj, _ = _idx(name)
    z = inputs[name]
    U = lambda x: jnp.asarray(x, jnp.uint32)   # noqa: E731
    rev = prim.endswith("_rev")
    if prim == "occ_lt4_flat":
        want = jfm.occ_lt4_flat(dj, U(z["p"]))
    elif prim == "occ_lt4":
        want = [jfm.occ_lt4(dj, U(z["p"]))]
    elif prim == "extend4":
        want = jfm.extend4(dj, U(z["k"]), U(z["l"]))
    elif prim in ("bwt_char", "lf"):
        want = [getattr(jfm, prim)(dj, U(np.minimum(z["p"], di.n)))]
    elif prim.startswith("occ_lt"):
        want = [jfm.occ_lt(dj, U(z["a"]), U(z["p"]), rev=rev)]
    else:
        want = jfm.extend(dj, U(np.minimum(z["ea"], 3)), U(z["k"]),
                          U(z["l"]), rev=rev)
    want = np.stack([_u32(w) for w in want])
    for out in outs:
        got = out[f"{name}_{prim}"].reshape(want.shape)
        np.testing.assert_array_equal(want, got)
        if prim in ONE_MERGE:
            assert out[f"{name}_{prim}_merges"] == 1


@pytest.mark.parametrize("name", SHARD_CASES)
def test_row_decode_refuses_a_shard(shard_world, name):
    """_row_decode returns a shard's own, unmerged rows, so on a sharded
    index it raises rather than answer."""
    _, outs = shard_world
    for out in outs:
        assert out[f"{name}_row_decode_refused"] == 1
