"""Entry points: one forward step, and a dry run over a sharded mesh.

Counterpart of ``__graft_entry__.py``:

- :func:`entry` returns one forward step of the flagship engine (the
  pigeonhole seed-and-verify search with the one-run gapped screen) and its
  example arguments, tensors on ``device``;
- :func:`dryrun_multichip` starts ``n`` rank processes
  (:func:`hsa_tpu_torch.dist.launch.run_world`) that form a ``(data,
  shard)`` mesh and run width, beam, locate and pigeon through
  :class:`~hsa_tpu_torch.dist.ShardedIndex` on a small index
  (:func:`dryrun_rank`, the body of one rank), then prints one line with the
  hits, the pigeon engine's mapped reads and, per entry point, the
  all-reduces and bytes a shard that :data:`~hsa_tpu_torch.dist.COLLECTIVES`
  counted (the reference prints the psum sites of the traced steps).

Nothing is caught: a failed rank, or a dry run with no hit or no pigeon
occurrence, raises.  Run ``python -m hsa_tpu_torch.entry --device cpu`` (the
step) or ``python -m hsa_tpu_torch.entry --dryrun 4 --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from collections import Counter

import numpy as np
import torch

from . import alphabet
from .config import AlnOpt
from .index.layout import (build_device_index, resolve_device, to_device,
                           words_to_device)
from .kernels import select
from .search import fm
from .search import pigeon as pg
from .search.adaptive import finalize_any
from .search.beam import M32, beam_search
from .search.exact import as_wide
from .search.widths import cal_width_device

# entry(): the reference's example (``__graft_entry__.py:35-62``)
STEP_BP, STEP_B, STEP_L, STEP_MD = 20_000, 64, 50, 2
STEP_OPT = dict(max_diff=2, max_gapo=1)
N_SEG, CAND_CAP = 3, 16
# the dry run (``__graft_entry__.py:65-155``): beam at max_diff 1, then the
# pigeon engine on both strands of the reads cut to DRY_L2
DRY_BP, DRY_L, DRY_L2 = 8_000, 30, 42
DRY_BEAM_OPT, DRY_W, DRY_H = dict(max_diff=1), 32, 8
DRY_PIGEON_OPT, DRY_PIGEON_MD = dict(max_diff=2, max_gapo=1), 2
WORLD_TIMEOUT_S = 600


def _tiny_index(n=STEP_BP, seed=0, sa_intv=32):
    t = np.random.RandomState(seed).randint(0, 4, n).astype(np.int8)
    return t, build_device_index(t, sa_intv=sa_intv)


def _reads(t, B, L, seed=1):
    """``B`` substrings of ``t`` of ``L`` bp, one base of each replaced by
    the successor of another (``__graft_entry__.py:22-32``)."""
    rs = np.random.RandomState(seed)
    fwd = np.full((B, L), 5, np.uint8)
    lens = np.full(B, L, np.int32)
    for j in range(B):
        p = rs.randint(0, len(t) - L)
        r = t[p:p + L].copy()
        r[rs.randint(0, L)] = (r[rs.randint(0, L)] + 1) % 4
        fwd[j] = r
    return fwd, lens


def entry(device="cuda"):
    """(step, example_args): one forward step of the pigeon engine on a
    20,000 bp index, 64 reads of 50 bp at k = 2 with one gap open.

    ``step(trows, buf)`` unpacks the fused upload and runs
    :func:`~hsa_tpu_torch.search.pigeon.pigeon_search`; it returns the
    candidate pool's ``(pos, nmm, valid)`` and the per-read ``fallback``.
    ``example_args`` are the packed text rows and the upload buffer, int32
    tensors on ``device``."""
    t, di = _tiny_index()
    idx = to_device(di, device)
    opt = AlnOpt(**STEP_OPT)
    fwd, _ = _reads(t, STEP_B, STEP_L)
    batch = pg.pack_pigeon_batch(list(fwd.astype(np.int8)), n_seg=N_SEG,
                                 seed_len=opt.seed_len, device_masks=True)
    buf, shape = pg.pack_pigeon_upload(batch,
                                       np.full(STEP_B, STEP_MD, np.int32))

    def step(trows, buf):
        (segs_rev, seg_lens, seg_off, _km, _ko, _ks, rw, nmask, lens,
         md) = pg.unpack_pigeon_upload(buf, shape)
        res = pg.pigeon_search(idx, trows, segs_rev, seg_lens, seg_off, rw,
                               nmask, None, None, lens, md, opt, n_seg=N_SEG,
                               cand_cap=CAND_CAP, gpool=2 * STEP_B)
        return res.pos, res.nmm, res.valid, res.fallback

    example_args = (words_to_device(pg.pack_text_rows(t), idx.device),
                    words_to_device(buf, idx.device))
    return step, example_args


def mesh_shape(n_devices: int):
    """(n_data, n_shard) of a dry run over ``n_devices`` ranks: data >= 2
    where it can be, the rest on shard (``__graft_entry__.py:90-92``)."""
    n_shard = max((d for d in (1, 2, 4, 8)
                   if n_devices % d == 0 and n_devices // d >= 2), default=1)
    return n_devices // n_shard, n_shard


def _dryrun(t, n_data, width, beam, locate, pigeon):
    """The dry run's searches through four entry points (a ShardedIndex's
    or the unsharded functions'), on ``4 * n_data`` reads of ``t``.
    Returns a dict: the finalized beam result, the best hits' positions,
    the pigeon occurrences and the two counts."""
    B = 4 * n_data
    fwd, lens = _reads(t, B, DRY_L, seed=3)
    md = np.full(B, DRY_BEAM_OPT["max_diff"], np.int32)
    D = width(fwd, lens)
    res = beam(fwd, lens, D, md)
    valid0 = res.hkey[0] < select.SENT
    ranks = torch.where(valid0, res.hit_k[0].long() & M32, 0)
    pos = locate(ranks)
    fin = finalize_any(res, AlnOpt(**DRY_BEAM_OPT).s_mm)
    n_hit = int(np.asarray(fin.hit_valid).any(axis=1).sum())
    if n_hit == 0:
        raise RuntimeError("the dry run's beam found no hit")

    popt = AlnOpt(**DRY_PIGEON_OPT)
    preads = [r[:DRY_L2].astype(np.int8) for r in fwd]
    both = preads + [alphabet.revcomp(r) for r in preads]
    batch = pg.pack_pigeon_batch(both, n_seg=N_SEG, seed_len=popt.seed_len)
    pmd = np.full(len(both), DRY_PIGEON_MD, np.int32)
    occs, _fb, _miss = pg.pigeon_occurrences(
        pg.fetch_result(pigeon(batch, pmd)), len(preads), popt, CAND_CAP)
    n_pig = sum(1 for o in occs if o)
    if n_pig == 0:
        raise RuntimeError("the dry run's pigeon search found no occurrence")
    return dict(reads=B, hits=n_hit, pigeon_mapped=n_pig, beam=fin,
                pos=pos.cpu().numpy(), occs=occs)


def dryrun_rank(mesh, device="cuda"):
    """One rank's body of :func:`dryrun_multichip`, in a world whose mesh
    exists: the 8,000 bp index sharded over ``mesh``, the dry run through
    its entry points.  Returns :func:`_dryrun`'s dict with the world's
    ``line`` and ``collectives`` (per entry point: name, all-reduces, bytes
    a shard)."""
    from .dist import COLLECTIVES, ShardedIndex
    t, di = _tiny_index(n=DRY_BP)
    sidx = ShardedIndex(di, mesh, device)
    COLLECTIVES.reset()
    out = _dryrun(
        t, mesh.n_data, sidx.width_fn(),
        sidx.beam_fn(AlnOpt(**DRY_BEAM_OPT), beam_width=DRY_W,
                     max_hits=DRY_H),
        sidx.locate_fn(),
        sidx.pigeon_fn(AlnOpt(**DRY_PIGEON_OPT), N_SEG, pg.pack_text_rows(t),
                       cand_cap=CAND_CAP))
    out["collectives"] = [list(c) for c in COLLECTIVES.calls]
    comm = " ".join(f"{name} all_reduces={n} bytes_per_shard={b}"
                    for name, n, b in out["collectives"])
    out["line"] = (f"[dryrun_multichip] mesh=({mesh.n_data}x{mesh.n_shard}) "
                   f"reads={out['reads']} hits={out['hits']} "
                   f"pigeon_mapped={out['pigeon_mapped']} {comm} ok")
    return out


def dryrun_unsharded(n_data: int, device="cuda"):
    """The dry run of a mesh with ``n_data`` data slices on one unsharded
    index on ``device``: what every rank's result must equal."""
    t, di = _tiny_index(n=DRY_BP)
    idx = to_device(di, device)
    dev = idx.device
    trows = words_to_device(pg.pack_text_rows(t), dev)

    def pigeon(batch, md):
        buf, shape = pg.pack_pigeon_upload(batch, md)
        (segs_rev, seg_lens, seg_off, _km, _ko, _ks, rw, nmask, lens,
         md_t) = pg.unpack_pigeon_upload(words_to_device(buf, dev), shape)
        return pg.pigeon_search(idx, trows, segs_rev, seg_lens, seg_off, rw,
                                nmask, None, None, lens, md_t,
                                AlnOpt(**DRY_PIGEON_OPT), n_seg=N_SEG,
                                cand_cap=CAND_CAP)

    return _dryrun(
        t, n_data,
        lambda f, ln: cal_width_device(idx, as_wide(f, dev), as_wide(ln, dev)),
        lambda f, ln, D, md: beam_search(
            idx, as_wide(f, dev), as_wide(ln, dev), as_wide(D, dev),
            as_wide(md, dev), AlnOpt(**DRY_BEAM_OPT), beam_width=DRY_W,
            max_hits=DRY_H),
        lambda r: fm.locate(idx, as_wide(r, dev)), pigeon)


def _rank_main(work, backend, device, n_data, n_shard, rank, world, addr):
    """One rank process of :func:`dryrun_multichip`: its result and
    select_topk's launches in this rank, as ``WORK/RANK.json``."""
    import torch.distributed as dist

    from .dist import init_multihost, make_mesh
    n_data, n_shard, rank, world = map(int, (n_data, n_shard, rank, world))
    if resolve_device(device).type == "cuda":
        torch.cuda.set_device(rank if backend == "nccl" else 0)
    init_multihost(addr, world, rank, backend)
    mesh = make_mesh(n_data, n_shard)
    n0, shapes0 = select.KERNEL.launches, Counter(select.KERNEL.launch_shapes)
    out = dryrun_rank(mesh, device)
    shapes = Counter(select.KERNEL.launch_shapes)
    shapes.subtract(shapes0)
    with open(os.path.join(work, f"{rank}.json"), "w") as fh:
        json.dump(dict({k: out[k] for k in ("line", "reads", "hits",
                                            "pigeon_mapped", "collectives")},
                       backend=dist.get_backend(), mesh=[n_data, n_shard],
                       select_launches=select.KERNEL.launches - n0,
                       select_shapes=[[*k, n] for k, n in shapes.items()
                                      if n]), fh)
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda"):
    """Run the sharded dry run over ``n_devices`` ranks, each a fresh
    process, and print its line.

    On ``cuda`` with at least ``n_devices`` cards: nccl, one rank a card;
    otherwise gloo, every rank on the same card (``cuda``) or on the CPU.
    Returns every rank's record (``_rank_main``'s JSON), rank 0 first."""
    n_data, n_shard = mesh_shape(n_devices)
    dev = resolve_device(device)
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= n_devices else "gloo")
    from .dist.launch import run_world
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with tempfile.TemporaryDirectory() as work:
        run_world([sys.executable, "-m", "hsa_tpu_torch.entry", "--rank",
                   work, backend, dev.type, str(n_data), str(n_shard)],
                  n_devices, timeout=WORLD_TIMEOUT_S, cwd=root)
        ranks = []
        for r in range(n_devices):
            with open(os.path.join(work, f"{r}.json")) as fh:
                ranks.append(json.load(fh))
    print(ranks[0]["line"], flush=True)
    return ranks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dryrun", type=int, metavar="N",
                    help="the sharded dry run over N ranks instead of the "
                         "forward step")
    # one rank of a dry-run world, as dryrun_multichip starts it
    ap.add_argument("--rank", nargs=8, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank:
        _rank_main(*a.rank)
    elif a.dryrun:
        dryrun_multichip(a.dryrun, a.device)
    else:
        step, args = entry(a.device)
        pos, nmm, valid, fallback = step(*args)
        print(f"[entry] device={args[0].device} pool={pos.shape[0]} "
              f"verified={int(valid.sum())} fallback={int(fallback.sum())}")


if __name__ == "__main__":
    main()
