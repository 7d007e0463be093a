"""The port's sharded index (``hsa_tpu_torch.dist``) against ``hsa_tpu``'s.

One world of 4 gloo processes on the CPU, started with
``hsa_tpu_torch.dist.launch.run_world`` (timeouts on the process groups and
on the world; every rank is killed if one fails), forms the meshes
``(2, 2)`` and ``(1, 4)`` and writes each entry point's whole result per
rank.  The inputs are ``tests/test_dist.py``'s: a 30,000 bp text from seed
42, indexed with and without the direct suffix array.  Every rank's result
must be bit-equal to JAX's unsharded one (exact, locate in both index forms,
width + beam), and pigeon at ``(2, 2)`` field by field to
``hsa_tpu.dist.mesh.ShardedIndex.pigeon_fn`` on the same mesh shape.  The
world also runs ``tests/test_multihost.py``'s sharded exact search, and a
case where the owner mask decides the sum.
"""

import os
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp

from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt
from hsa_tpu.dist.mesh import ShardedIndex as JShardedIndex
from hsa_tpu.dist.mesh import make_mesh as jmake_mesh
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.search import fm as jfm
from hsa_tpu.search import pigeon as jpg
from hsa_tpu.search.beam import beam_search
from hsa_tpu.search.exact import exact_search, pack_reads
from hsa_tpu.search.widths import cal_width_device
from hsa_tpu_torch.dist.launch import run_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (1, 4))
OPT_BEAM = dict(max_diff=1, max_gapo=0)
OPT_PIGEON = dict(max_diff=2, max_gapo=1)
W, H, N_SEG, CC = 128, 16, 3, 16

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    sys.path.insert(0, sys.argv[1])
    from hsa_tpu_torch.config import AlnOpt
    from hsa_tpu_torch.dist import COLLECTIVES, ShardedIndex, init_multihost
    from hsa_tpu_torch.dist import make_mesh
    from hsa_tpu_torch.index.layout import DeviceIndex
    from hsa_tpu_torch.search import fm
    from hsa_tpu_torch.search import pigeon as pg

    work, (rank, world, addr) = sys.argv[2], sys.argv[3:6]
    torch.set_num_threads(1)
    init_multihost(addr, int(world), int(rank), "gloo", timeout=60)
    z = dict(np.load(f"{work}/inputs.npz"))
    batch = {k[3:]: v for k, v in z.items() if k.startswith("pb_")}
    out = {}

    def unmasked(idx, name, i):
        local, own = real_owned(idx, name, i)
        return local, torch.ones_like(own)

    real_owned = fm._owned
    for nd, ns in %(meshes)r:
        tag = f"{nd}x{ns}"
        mesh = make_mesh(nd, ns)
        si = ShardedIndex(DeviceIndex.load(f"{work}/idx.npz"), mesh, "cpu")
        sw = ShardedIndex(DeviceIndex.load(f"{work}/walk.npz"), mesh, "cpu")
        COLLECTIVES.reset()
        k, l, m = si.exact_fn()(z["ex_reads"], z["ex_lens"])
        out.update({f"{tag}_ex_k": k, f"{tag}_ex_l": l, f"{tag}_ex_m": m})
        out[f"{tag}_loc"] = si.locate_fn()(z["loc_ranks"])
        out[f"{tag}_loc_walk"] = sw.locate_fn()(z["loc_ranks"])
        D = si.width_fn()(z["bm_fwd"], z["bm_lens"])
        raw = si.beam_fn(AlnOpt(**%(opt_beam)r), beam_width=%(W)d,
                         max_hits=%(H)d)(z["bm_fwd"], z["bm_lens"], D,
                                         z["bm_md"])
        out[f"{tag}_D"] = D
        out.update({f"{tag}_bm_{f}": v for f, v in raw._asdict().items()})
        res = si.pigeon_fn(AlnOpt(**%(opt_pigeon)r), %(N_SEG)d,
                           z["pg_rows"], cand_cap=%(CC)d)(batch, z["pg_md"])
        out.update({f"{tag}_pg_{f}": v
                    for f, v in pg.result_to_host(res)._asdict().items()})
        out[f"{tag}_calls"] = np.array([c[1:] for c in COLLECTIVES.calls])
        out[f"{tag}_devices"] = np.array(sorted(COLLECTIVES.devices))
        # the owner mask: lanes whose block lies in the last shard, merged
        # with the mask and with every shard counted as an owner
        p = torch.from_numpy(z["own_p"])
        out[f"{tag}_own"] = torch.stack(fm.occ_lt4_flat(si.idx, p))
        fm._owned = unmasked
        out[f"{tag}_own_unmasked"] = torch.stack(fm.occ_lt4_flat(si.idx, p))
        fm._owned = real_owned
    # tests/test_multihost.py's two-process exact search as a (2, 2) mesh
    mesh = make_mesh(2, 2)
    si = ShardedIndex(DeviceIndex.load(f"{work}/mh.npz"), mesh, "cpu")
    out["mh_k"], out["mh_l"], _ = si.exact_fn()(z["mh_reads"], z["mh_lens"])
    # hsa_tpu_torch.entry's dry-run rank body on the mesh of
    # dryrun_multichip(4)
    from hsa_tpu_torch.entry import dryrun_rank
    dry = dryrun_rank(make_mesh(2, 2), "cpu")
    out.update({f"dry_{f}": np.asarray(v)
                for f, v in dry["beam"]._asdict().items()})
    out["dry_pos"] = dry["pos"]
    out["dry_occ"] = np.array([(j, *vars(o).values())
                               for j, occ in enumerate(dry["occs"])
                               for o in occ], np.int64)
    out["dry_counts"] = np.array([dry["reads"], dry["hits"],
                                  dry["pigeon_mapped"]])
    np.savez(f"{work}/out{rank}.npz",
             **{k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})
""") % dict(meshes=MESHES, opt_beam=OPT_BEAM, opt_pigeon=OPT_PIGEON, W=W,
            H=H, N_SEG=N_SEG, CC=CC)


def reads_from(t, rs, n, L, mm=0):
    """tests/test_dist.py's reads: ``n`` substrings of ``L`` bp with ``mm``
    substitutions each."""
    out = []
    for _ in range(n):
        p = rs.randint(0, len(t) - L)
        r = t[p:p + L].copy()
        for _ in range(mm):
            j = rs.randint(0, L)
            r[j] = (r[j] + 1) % 4
        out.append(r)
    return out


def pigeon_reads(t):
    """tests/test_dist.py's pigeon batch: 12 reads with 2 substitutions, one
    with a planted insertion and one with a deletion, both strands."""
    rs = np.random.RandomState(7)
    reads = reads_from(t, rs, 12, 60, mm=2)
    for kind in (0, 1):
        p = rs.randint(0, len(t) - 70)
        if kind:
            r = np.concatenate([t[p:p + 30], t[p + 32:p + 62]])
        else:
            r = np.concatenate([t[p:p + 30], [1, 2], t[p + 30:p + 58]])
        reads.append(r.astype(np.int8))
    return list(reads) + [alphabet.revcomp(r) for r in reads]


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, JAX's results and every rank's outputs."""
    work = tmp_path_factory.mktemp("torch_dist")
    t = np.random.RandomState(42).randint(0, 4, 30_000).astype(np.int8)
    di = build_device_index(t)
    di.save(str(work / "idx.npz"))
    build_device_index(t, sa_direct=False).save(str(work / "walk.npz"))
    t2 = np.random.RandomState(42).randint(0, 4, 20_000).astype(np.int8)
    build_device_index(t2, with_reverse=False).save(str(work / "mh.npz"))

    ex_reads, ex_lens = pack_reads(reads_from(t, np.random.RandomState(0),
                                              16, 60), 64)
    loc_ranks = np.random.RandomState(1).randint(0, len(t) + 1, 64)
    bm = reads_from(t, np.random.RandomState(2), 8, 50, mm=1)
    bm_fwd = np.stack(bm).astype(np.uint8)
    bm_lens = np.full(8, 50, np.int32)
    bm_md = np.full(8, 1, np.int32)
    both = pigeon_reads(t)
    opt_pg = AlnOpt(**OPT_PIGEON)
    batch = jpg.pack_pigeon_batch(both, n_seg=N_SEG, seed_len=opt_pg.seed_len)
    pg_md = np.full(len(both), 2, np.int32)
    pg_rows = jpg.pack_text_rows(t)
    # prefix lengths in the last of 4 shards (rows [705, 940): 938 real)
    rows = -(-di.occ_blocks.shape[0] // 4)
    own_p = np.concatenate([[32 * 3 * rows - 1], np.arange(
        32 * 3 * rows, len(t) + 2, 61)]).astype(np.int64)
    mh_reads, mh_lens = pack_reads(
        [t2[p:p + 40].copy() for p in
         np.random.RandomState(0).randint(0, len(t2) - 40, 16)], 40)
    np.savez(work / "inputs.npz", ex_reads=ex_reads, ex_lens=ex_lens,
             loc_ranks=loc_ranks, bm_fwd=bm_fwd, bm_lens=bm_lens, bm_md=bm_md,
             pg_md=pg_md, pg_rows=pg_rows, own_p=own_p, mh_reads=mh_reads,
             mh_lens=mh_lens, **{f"pb_{k}": v for k, v in batch.items()})
    script = work / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run_world([sys.executable, str(script), REPO, str(work)], 4, timeout=240,
              env=env, cwd=REPO)
    outs = [dict(np.load(work / f"out{r}.npz")) for r in range(4)]

    dev = di.as_jax()
    want = {}
    want["ex"] = exact_search(dev, jnp.asarray(ex_reads), jnp.asarray(ex_lens))
    ranks = jnp.asarray(loc_ranks, jnp.uint32)
    want["loc"] = jfm.locate(dev, ranks)
    want["loc_walk"] = jfm.locate(
        build_device_index(t, sa_direct=False).as_jax(), ranks)
    opt_b = AlnOpt(**OPT_BEAM)
    fwd_j, lens_j = jnp.asarray(bm_fwd), jnp.asarray(bm_lens)
    want["D"] = cal_width_device(dev, fwd_j, lens_j)
    want["bm"] = beam_search(dev, fwd_j, lens_j, want["D"],
                             jnp.asarray(bm_md), opt_b, beam_width=W,
                             max_hits=H)
    trows = jnp.asarray(pg_rows)
    want["pg_1x4"] = jpg.pigeon_search(
        dev, trows, *(jnp.asarray(batch[k]) for k in (
            "segs_rev", "seg_lens", "seg_off", "rw", "nmask", "vmask",
            "seedmask", "lens")), jnp.asarray(pg_md), opt_pg, n_seg=N_SEG,
        cand_cap=CC)
    want["pg_2x2"] = JShardedIndex(di, jmake_mesh(2, 2)).pigeon_fn(
        opt_pg, N_SEG, trows, cand_cap=CC)(batch, pg_md)
    want["own"] = jfm.occ_lt4_flat(dev, jnp.asarray(own_p, jnp.uint32))
    dev2 = build_device_index(t2, with_reverse=False).as_jax()
    want["mh"] = exact_search(dev2, jnp.asarray(mh_reads),
                              jnp.asarray(mh_lens))
    want["dry"] = jax_dryrun(2)
    return outs, want


def jax_dryrun(n_data):
    """__graft_entry__.dryrun_multichip's searches on hsa_tpu's unsharded
    functions: the finalized beam, the best hits' positions and the pigeon
    occurrences."""
    import __graft_entry__ as jentry
    from hsa_tpu.search.adaptive import finalize_any
    from hsa_tpu.kernels.select import SENT
    t, di = jentry._tiny_index(n=8_000)
    dev = di.as_jax()
    B = 4 * n_data
    fwd, lens = jentry._reads(t, B, 30, seed=3)
    opt = AlnOpt(max_diff=1)
    fwd_j, lens_j = jnp.asarray(fwd), jnp.asarray(lens)
    D = cal_width_device(dev, fwd_j, lens_j)
    res = beam_search(dev, fwd_j, lens_j, D, jnp.full(B, 1, jnp.int32), opt,
                      beam_width=32, max_hits=8)
    ranks = jnp.where(res.hkey[0] < SENT, res.hit_k[0], 0).astype(jnp.uint32)
    popt = AlnOpt(max_diff=2, max_gapo=1)
    preads = [r[:42].astype(np.int8) for r in fwd]
    both = preads + [alphabet.revcomp(r) for r in preads]
    batch = jpg.pack_pigeon_batch(both, n_seg=3, seed_len=popt.seed_len)
    pres = jpg.pigeon_search(
        dev, jnp.asarray(jpg.pack_text_rows(t)), *(jnp.asarray(batch[k]) for k in (
            "segs_rev", "seg_lens", "seg_off", "rw", "nmask", "vmask",
            "seedmask", "lens")), jnp.full(len(both), 2, jnp.int32), popt,
        n_seg=3, cand_cap=16)
    occs, _, _ = jpg.pigeon_occurrences(jpg.fetch_result(pres), B, popt, 16)
    return dict(beam=finalize_any(res, opt.s_mm), pos=jfm.locate(dev, ranks),
                occ=np.array([(j, *vars(o).values())
                              for j, occ in enumerate(occs) for o in occ],
                             np.int64))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_exact_matches_jax(world, mesh):
    outs, want = world
    tag = f"{mesh[0]}x{mesh[1]}"
    for out in outs:
        for f, w in zip(("k", "l", "m"), want["ex"]):
            np.testing.assert_array_equal(_u32(w), _u32(out[f"{tag}_ex_{f}"]),
                                          err_msg=f)


@pytest.mark.parametrize("form", ["loc", "loc_walk"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_locate_matches_jax(world, mesh, form):
    outs, want = world
    for out in outs:
        np.testing.assert_array_equal(_u32(want[form]),
                                      out[f"{mesh[0]}x{mesh[1]}_{form}"])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_width_and_beam_match_jax(world, mesh):
    outs, want = world
    tag = f"{mesh[0]}x{mesh[1]}"
    for out in outs:
        np.testing.assert_array_equal(_u32(want["D"]), out[f"{tag}_D"])
        for f, w in want["bm"]._asdict().items():
            np.testing.assert_array_equal(_u32(w), _u32(out[f"{tag}_bm_{f}"]),
                                          err_msg=f)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_pigeon_matches_jax(world, mesh):
    """(2, 2): every field equal to hsa_tpu's ShardedIndex on the same mesh
    shape (per-slice pools); (1, 4): to hsa_tpu's unsharded search, but
    ``n_gate``, one entry a data slice."""
    outs, want = world
    tag = f"{mesh[0]}x{mesh[1]}"
    res = want[f"pg_{tag}"]
    for out in outs:
        for f, w in res._asdict().items():
            w = np.asarray(w)
            got = out[f"{tag}_pg_{f}"]
            if f == "n_gate" and mesh[0] == 1:
                w = w.reshape(1)
            assert got.dtype == w.dtype and got.shape == w.shape, f
            np.testing.assert_array_equal(w, got, err_msg=f)
    assert np.asarray(res.n_gate).sum() > 0    # the gapped pool ran


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_merges_counted(world, mesh):
    """One all-reduce a step of each scan, 4 bytes a merged value, all on
    the CPU here; the count of an entry point is the same on every rank of
    a shard group."""
    outs, _ = world
    nd = mesh[0]
    tag = f"{nd}x{mesh[1]}"
    calls = outs[0][f"{tag}_calls"]
    # exact: 64 columns, both interval ends of 16 / nd reads a step
    assert tuple(calls[0]) == (64, 64 * 2 * (16 // nd) * 4)
    # locate with the direct SA: one merge of 64 / nd positions
    assert tuple(calls[1]) == (1, (64 // nd) * 4)
    # the LF walk: [bit, mrank, r_next] and the sample, sa_intv steps
    assert tuple(calls[2]) == (2 * 32, 32 * 4 * (64 // nd) * 4)
    # width: 50 columns, both ends; beam: 50 steps, 4 counts at both ends
    # of W slots a read
    assert tuple(calls[3]) == (50, 50 * 2 * (8 // nd) * 4)
    assert tuple(calls[4]) == (50, 50 * 4 * 2 * W * (8 // nd) * 4)
    assert calls[5][0] > 0
    for out in outs:
        assert list(out[f"{tag}_devices"]) == ["cpu"]
        assert out[f"{tag}_calls"].shape == calls.shape
        np.testing.assert_array_equal(out[f"{tag}_calls"][:, 0], calls[:, 0])


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_owner_mask_decides_the_last_shard(world, mesh):
    """Lanes whose block lies in the last, zero-padded shard: the merge
    equals the unsharded counts, and the same merge with every shard
    counted as an owner does not (the other shards' clamped rows are real
    rows)."""
    outs, want = world
    tag = f"{mesh[0]}x{mesh[1]}"
    w = np.stack([_u32(x) for x in want["own"]])
    for out in outs:
        np.testing.assert_array_equal(w, out[f"{tag}_own"])
        assert (out[f"{tag}_own_unmasked"] != w).any(axis=0).all()


def test_two_rank_groups_exact_matches_multihost_reference(world):
    """tests/test_multihost.py's sharded exact search (20,000 bp, 16 reads
    of 40 bp) on a (2, 2) mesh of processes: every rank holds the same
    global result, equal to the single-process search."""
    outs, want = world
    for out in outs:
        np.testing.assert_array_equal(_u32(want["mh"][0]), out["mh_k"])
        np.testing.assert_array_equal(_u32(want["mh"][1]), out["mh_l"])


def test_dryrun_rank_matches_jax_unsharded(world):
    """hsa_tpu_torch.entry.dryrun_rank on the world's (2, 2) mesh: every
    rank's finalized beam, best-hit positions and pigeon occurrences equal
    hsa_tpu's unsharded beam and pigeon search on the same 8,000 bp index,
    with hits and occurrences on every read."""
    outs, want = world
    w = want["dry"]
    for out in outs:
        for f, x in w["beam"]._asdict().items():
            np.testing.assert_array_equal(_u32(x), _u32(out[f"dry_{f}"]),
                                          err_msg=f)
        np.testing.assert_array_equal(_u32(w["pos"]), out["dry_pos"])
        np.testing.assert_array_equal(w["occ"], out["dry_occ"])
        reads, hits, mapped = out["dry_counts"]
        assert reads == 8
        assert hits == np.asarray(w["beam"].hit_valid).any(axis=1).sum() > 0
        assert mapped == len(set(w["occ"][:, 0])) > 0


# -- the launcher and the mesh's preconditions, no torch world needed -------
def _ranks(tmp_path, body, n=2, timeout=30):
    """run_world over a script whose ranks run ``body`` (rank, world and
    address in ``rank``, ``world``, ``addr``)."""
    script = tmp_path / "rank.py"
    script.write_text("import sys, os, time\n"
                      "rank, world, addr = sys.argv[-3:]\n"
                      f"work = {str(tmp_path)!r}\n" + textwrap.dedent(body))
    run_world([sys.executable, str(script)], n, timeout=timeout)


def test_run_world_kills_the_world_when_a_rank_fails(tmp_path):
    """Rank 1 fails at once; rank 0 would sleep a minute but is killed, and
    the error carries rank 1's exit code and output."""
    body = """
        if rank == "1":
            print("rank one gives up")
            sys.exit(3)
        time.sleep(60)
    """
    with pytest.raises(RuntimeError, match="a rank failed") as e:
        _ranks(tmp_path, body)
    assert "rank one gives up" in str(e.value)
    assert "(exit 3)" in str(e.value)


def test_run_world_times_out(tmp_path):
    with pytest.raises(RuntimeError, match="timed out after 1 s"):
        _ranks(tmp_path, "time.sleep(60)\n", timeout=1)


def test_run_world_retries_a_taken_port(tmp_path):
    """Rank 0's store finds its port taken in the first attempt: the world
    is started again on a new port and succeeds; every rank of both
    attempts got the same address within an attempt."""
    body = """
        open(os.path.join(work, f"{rank}.addr"), "a").write(addr + "\\n")
        first = not os.path.exists(os.path.join(work, "tried"))
        if rank == "0" and first:
            open(os.path.join(work, "tried"), "w").close()
            print("code: -98, name: EADDRINUSE, message: address already in use")
            sys.exit(1)
    """
    _ranks(tmp_path, body)
    a0 = (tmp_path / "0.addr").read_text().split()
    assert len(a0) == 2 and a0[0] != a0[1]
    assert (tmp_path / "1.addr").read_text().split()[-1] == a0[-1]


def test_run_world_gives_up_on_other_failures(tmp_path):
    """A rank 0 that fails for another reason is not started again."""
    body = """
        open(os.path.join(work, "tries"), "a").write("x")
        sys.exit(1 if rank == "0" else 0)
    """
    with pytest.raises(RuntimeError, match="a rank failed"):
        _ranks(tmp_path, body, n=1)
    assert (tmp_path / "tries").read_text() == "x"


def test_make_mesh_needs_init_multihost(monkeypatch):
    """make_mesh takes the world's timeout from init_multihost, so a world
    started otherwise is refused."""
    from hsa_tpu_torch.dist import mesh as tmesh
    monkeypatch.setattr(tmesh, "_timeout", None)
    with pytest.raises(RuntimeError, match="init_multihost"):
        tmesh.make_mesh(1, 1)
