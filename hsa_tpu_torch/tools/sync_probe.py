"""Synced microbenchmarks of the constructs that matter, on the card
(counterpart of ``tools/sync_probe.py``): every timed call is bracketed by
CUDA events and synchronised before the next.

Usage: python -m hsa_tpu_torch.tools.sync_probe [--device cuda|cpu]
[test ...]
tests: idle matmul take scan dispatch dma vmemtake onehot sort
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..index.layout import words_to_device
from . import _timing as tm
from ._cases import Case, random_table, random_queries
from .gather_probe import onehot_chunks, sort_pairs
from .gather_probe2 import take_xor07


def test_idle(dev):
    tm.wait_idle(dev, quiet=False)


def matmul_chain(x):
    for _ in range(8):
        x = x @ x * 1e-3
    return x


def test_matmul(dev):
    n = 2048
    x = torch.from_numpy(np.random.RandomState(0).rand(n, n).astype(
        np.float32)).to(dev)
    dt = tm.timeit_sync(matmul_chain, x, iters=16)
    print(f"matmul f32 {n} (8-chain, synced): {2*n**3*8/dt/1e12:.1f} Tflop/s "
          f"({dt*1e3:.2f} ms/call)")


def tiny(v):
    return v * 3


def test_dispatch(dev):
    v = torch.arange(128, dtype=torch.int32, device=dev)
    dt = tm.timeit_sync(tiny, v, iters=50)
    print(f"dispatch+readback floor: {dt*1e3:.2f} ms")


def test_take(dev):
    # standalone row gather, one launch per measurement, synced
    for nb_log, tag in ((20, "32MB"), (23, "256MB")):
        nb = 1 << nb_log
        tab = words_to_device(random_table(nb, 8), dev)
        for q_log in (16, 20):
            Q = 1 << q_log
            q = tm.ints(random_queries(nb, Q), dev)
            dt = tm.timeit_sync(take_xor07, tab, q)
            print(f"take [{tag} x8w] Q=2^{q_log}: {Q/dt/1e6:8.1f} Mq/s "
                  f"({Q*32/dt/1e9:6.2f} GB/s) {dt*1e3:.2f} ms")


def chained_take(tab, q, steps=32):
    """``steps`` gathers, each row's words 0 and 7 XORed into the next
    query (the beam search's shape)."""
    nb = tab.shape[0]
    for _ in range(steps):
        q = take_xor07(tab, q) & (nb - 1)
    return q


def test_scan(dev):
    # gathers chained in one call (the beam-search shape), synced
    nb = 1 << 20
    tab = words_to_device(random_table(nb, 8), dev)
    for q_log in (16, 20):
        Q = 1 << q_log
        q0 = tm.ints(random_queries(nb, Q), dev)
        dt = tm.timeit_sync(chained_take, tab, q0, iters=4)
        print(f"in-scan take [32MB x8w] Q=2^{q_log} (32 steps): "
              f"{32*Q/dt/1e6:8.1f} Mq/s ({dt*1e3:.1f} ms/call)")


def _dma_inputs(NQ):
    nb = 1 << 20
    return lambda: (random_table(nb, 8), random_queries(nb, NQ))


def _vmemtake_inputs(nb_log):
    nb = 1 << nb_log
    return lambda: (random_table(nb, 8), random_queries(nb, 1 << 17))


KERNEL_CASES = {
    "dma": [Case(f"pallas DMA gather NQ={NQ}", "tools/sync_probe.py:178",
                 "gather_rows", _dma_inputs(NQ), pipe=16)
            for NQ in (4096, 65536)],
    "vmemtake": [Case(f"pallas VMEM take [{tag}] Q=2^17",
                      "tools/sync_probe.py:210", "table_take",
                      _vmemtake_inputs(nb_log))
                 for nb_log, tag in ((15, "1MB"), (17, "4MB"))],
}


def test_dma(dev):
    # per-query 32B row gather from device memory, 16 rows in flight
    for case in KERNEL_CASES["dma"]:
        tab_np, q_np, tab, q = case.tensors(dev)
        NQ = len(q_np)
        try:
            dt = tm.timeit_sync(case.run, tab, q, iters=4)
            ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
            print(f"{case.label}: {NQ/dt/1e6:8.2f} Mq/s "
                  f"(correct={ok}) {dt*1e3:.2f} ms")
        except Exception as e:
            print(f"{case.label}: FAILED {type(e).__name__}: "
                  f"{str(e)[:200]}")


def test_vmemtake(dev):
    # the table staged on chip, then gathered
    for case in KERNEL_CASES["vmemtake"]:
        tab_np, q_np, tab, q = case.tensors(dev)
        Q = len(q_np)
        try:
            dt = tm.timeit_sync(case.run, tab, q, iters=4)
            ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
            print(f"{case.label}: {Q/dt/1e6:8.1f} Mq/s "
                  f"(correct={ok}) {dt*1e3:.2f} ms")
        except Exception as e:
            print(f"{case.label}: FAILED {type(e).__name__}: "
                  f"{str(e)[:200]}")


def test_onehot(dev):
    # one-hot gather-equivalent: queries bucketed 128/chunk (ideal)
    for CH in (256, 512):
        nq = 1 << 17
        chunks = nq // 128
        oh = torch.from_numpy(np.random.RandomState(4).rand(
            chunks, 128, CH).astype(np.float32)).to(dev)
        tabs = torch.from_numpy(np.random.RandomState(5).rand(
            chunks, CH, 16).astype(np.float32)).to(dev)
        dt = tm.timeit_sync(onehot_chunks, oh, tabs)
        print(f"onehot chunk={CH:4d}: {nq/dt/1e6:8.1f} Mq/s-equiv "
              f"({2*chunks*128*CH*16/dt/1e12:.2f} Tflop/s)")


def test_sort(dev):
    Q = 1 << 20
    keys = tm.ints(np.random.RandomState(3).randint(0, 1 << 31, Q), dev)
    vals = tm.ints(np.arange(Q), dev)
    dt = tm.timeit_sync(sort_pairs, keys, vals)
    print(f"torch.sort 1M u32 k+v: {dt*1e3:7.2f} ms ({Q/dt/1e6:.1f} Mkeys/s)")


TESTS = dict(idle=test_idle, matmul=test_matmul, dispatch=test_dispatch,
             take=test_take, scan=test_scan, dma=test_dma,
             vmemtake=test_vmemtake, onehot=test_onehot, sort=test_sort)

if __name__ == "__main__":
    tm.main(TESTS, sys.argv[1:], __doc__,
            default=["matmul", "dispatch", "take", "scan"])
