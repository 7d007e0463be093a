"""Occ-gather headroom probe on the port's own index (counterpart of
``tools/occ_probe5.py``).

Questions, against the index's fused-row table, asked of the port's
``search/fm.py:occ_lt4_flat``:
 1. locality: does sorting/coalescing the rank batch change the
    row-gather throughput (static indices, no chain)?
 2. chain length: how much of the chained rate is launch amortization
    (length 8 / 32 / 128)?
 3. size: the TPU probe took a 64 or a 3,100 Mbp cache; this one takes
    the index it is given (``--index``).

Usage: python -m hsa_tpu_torch.tools.occ_probe5 --index PREFIX
[--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from ..index.layout import DeviceIndex, resolve_device, to_device
from ..search import fm
from . import _timing as tm

Q = 1 << 20                   # ranks per call
MASK = (1 << 25) - 1          # chained pointer domain (bench formula)


def load_index(prefix: str, dev):
    """The forward occ table of the index at ``prefix`` (or of the
    directory ``prefix``) on ``dev``; the reverse table and the suffix array
    stay on the host."""
    index_dir = prefix if os.path.isdir(prefix) else prefix + ".hsa"
    di = DeviceIndex.load(os.path.join(index_dir, "index.npz"))
    di = dataclasses.replace(di, rev_occ_blocks=None, sa_direct=None)
    return to_device(di, dev)


def make_queries(n: int, nq: int = Q):
    """(random, sorted, blocked) ranks as in the TPU probe, ``RandomState(3)``;
    blocked: random blocks of 128 consecutive ranks."""
    rs = np.random.RandomState(3)
    qs_rand = rs.randint(0, n, nq).astype(np.uint32)
    qs_sort = np.sort(qs_rand)
    nblk = nq // 128
    base = rs.randint(0, max(n - 129, 1), nblk).astype(np.uint32)
    qs_blk = ((base[:, None] + np.arange(128, dtype=np.uint32)[None, :])
              .reshape(-1) % np.uint32(n))
    return qs_rand, qs_sort, qs_blk


def occ_once(idx, p):
    o = fm.occ_lt4_flat(idx, p)
    return (o[0] ^ o[3]) & 0xFFFFFF


def occ_chain(idx, p, length, redux):
    """``length`` occ steps, each fed the last one's ``o[0] ^ o[3]`` reduced
    by ``redux`` ("mask25": to 25 bits; "full": modulo n)."""
    for _ in range(length):
        o = fm.occ_lt4_flat(idx, p)
        x = o[0] ^ o[3]
        p = x & MASK if redux == "mask25" else x % idx.n
    return p


def bench(fn, *args, iters=4, inner=1):
    """Least seconds of ``iters`` synced calls after a first one, / inner."""
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    tm.rb(fn(*args))
    ts = []
    for _ in range(iters):
        if dev.type == "cuda":
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn(*args)
            e1.record()
            torch.cuda.synchronize(dev)
            ts.append(e0.elapsed_time(e1) / 1e3)
        else:
            t0 = time.perf_counter()
            tm.rb(fn(*args))
            ts.append(time.perf_counter() - t0)
    return min(ts) / inner


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--index", required=True,
                    help="index prefix (PREFIX.hsa/) or index directory")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    tm.wait_idle(dev)
    idx = load_index(a.index, dev)
    n, nq = idx.n, Q
    tag = f"[{n / 1e6:.1f}M]"
    qs_rand, qs_sort, qs_blk = make_queries(n, nq)
    for name, q in (("random", qs_rand), ("sorted", qs_sort),
                    ("blocked", qs_blk)):
        p = torch.from_numpy(q.astype(np.int64)).to(dev)
        dt = bench(occ_once, idx, p)
        print(f"{tag} static occ [{name:8s}] {nq / dt / 1e6:7.1f} Mq/s",
              flush=True)
    # mask25 keeps bench.py's historical 2^25 pointer footprint; full spans
    # the whole table, separating footprint effects from table-size effects
    p = torch.from_numpy(qs_rand.astype(np.int64)).to(dev)
    for redux in ("mask25", "full"):
        for LEN in (8, 32, 128):
            dt = bench(occ_chain, idx, p, LEN, redux, inner=LEN)
            print(f"{tag} chained occ [{redux} len={LEN:3d}] "
                  f"{nq / dt / 1e6:7.1f} Mq/s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
