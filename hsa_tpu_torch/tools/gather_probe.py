"""Calibrate candidate gather mechanisms on the card (counterpart of
``tools/gather_probe.py``).

The FM-index hot loop is a random row gather; this probe measures every
alternative:

  rowscale   index_select q/s vs row width and table size
  colmajor   gather along the minor axis of a [W, nb] table
  sort       torch.sort rate (enables sorted/coalesced strategies)
  onehot     one-hot chunk-gather equivalent rate (batched matmul)
  dma        per-query row gather from device memory (kernel gather_rows)
  vmemtake   gather from a table staged on chip (kernel table_take)

Usage: python -m hsa_tpu_torch.tools.gather_probe [--device cuda|cpu]
[test ...]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..index.layout import words_to_device
from . import _timing as tm
from ._cases import Case, random_table, random_queries

Q = 1 << 20


def take_xor(tab, q):
    """XOR of the words of each gathered row (the probes' ``g``)."""
    r = tab.index_select(0, q)
    acc = r[:, 0]
    for j in range(1, r.shape[1]):
        acc = acc ^ r[:, j]
    return acc


def take_cols_xor(tab, q):
    """XOR over the rows of the columns ``q`` of a [W, nb] table."""
    r = tab.index_select(1, q)
    acc = r[0]
    for j in range(1, r.shape[0]):
        acc = acc ^ r[j]
    return acc


def onehot_chunks(oh, tabs):
    """[chunks, 128, CH] @ [chunks, CH, 16] -> [chunks, 128, 16] (f32)."""
    return torch.matmul(oh, tabs)


def sort_keys(k):
    return torch.sort(k).values


def sort_pairs(k, v):
    """Keys sorted with their values carried (stable)."""
    sk, order = torch.sort(k, stable=True)
    return sk, v[order]


def argsort_keys(k):
    return torch.argsort(k, stable=True)


def test_rowscale(dev):
    for nb_log, tag in ((15, "1M"), (20, "32M")):
        nb = 1 << nb_log
        for w in (1, 2, 4, 8, 16):
            tab = words_to_device(random_table(nb, w), dev)
            q = tm.ints(random_queries(nb, Q), dev)
            dt = tm.timeit(take_xor, tab, q)
            print(f"take rows[{tag} x {w:2d}w]: {Q/dt/1e6:8.1f} Mq/s "
                  f"({Q*w*4/dt/1e9:6.2f} GB/s)")


def test_flat(dev):
    nb = 1 << 23
    tab = words_to_device(
        np.random.RandomState(1).randint(0, 1 << 30, nb), dev)
    q = tm.ints(random_queries(nb, Q), dev)
    dt = tm.timeit(torch.index_select, tab, 0, q)
    print(f"take flat [32MB x 1w]: {Q/dt/1e6:8.1f} Mq/s")


def test_colmajor(dev):
    nb = 1 << 20
    for w in (8,):
        tab = words_to_device(random_table(w, nb), dev)
        q = tm.ints(random_queries(nb, Q), dev)
        dt = tm.timeit(take_cols_xor, tab, q)
        print(f"take cols [{w}w x 1M]: {Q/dt/1e6:8.1f} Mq/s "
              f"({Q*w*4/dt/1e9:6.2f} GB/s)")


def test_sort(dev):
    keys = tm.ints(np.random.RandomState(3).randint(0, 1 << 31, Q), dev)
    dt = tm.timeit(sort_keys, keys)
    print(f"torch.sort 1M u32 keys: {dt*1e3:7.2f} ms ({Q/dt/1e6:.1f} Mkeys/s)")
    vals = tm.ints(np.arange(Q), dev)
    dt = tm.timeit(sort_pairs, keys, vals)
    print(f"torch.sort 1M u32 k+v:  {dt*1e3:7.2f} ms ({Q/dt/1e6:.1f} Mkeys/s)")
    dt = tm.timeit(argsort_keys, keys)
    print(f"argsort 1M u32:       {dt*1e3:7.2f} ms ({Q/dt/1e6:.1f} Mkeys/s)")


def test_onehot(dev):
    # equivalent-gather rate of onehot @ chunk for CH-row chunks:
    # queries presorted into buckets of 128 per chunk (ideal case).
    for CH in (128, 256, 512):
        nq = Q // 8  # 128K queries
        chunks = nq // 128
        oh = torch.from_numpy(np.random.RandomState(4).rand(
            chunks, 128, CH).astype(np.float32)).to(dev)
        tabs = torch.from_numpy(np.random.RandomState(5).rand(
            chunks, CH, 16).astype(np.float32)).to(dev)
        dt = tm.timeit(onehot_chunks, oh, tabs)
        print(f"onehot chunk={CH:4d}: {nq/dt/1e6:8.1f} Mq/s-equiv "
              f"({2*chunks*128*CH*16/dt/1e12:.2f} Tflop/s)")


def _dma_inputs():
    nb = 1 << 20
    return random_table(nb, 8), random_queries(nb, 4096)


def _vmemtake_inputs():
    nb = 1 << 15  # 32K rows x 32B = 1MB
    return random_table(nb, 8), random_queries(nb, Q // 8)


KERNEL_CASES = {
    "dma": [Case("pallas DMA gather", "tools/gather_probe.py:191",
                 "gather_rows", _dma_inputs, pipe=8)],
    "vmemtake": [Case("pallas VMEM take [1MB]", "tools/gather_probe.py:217",
                      "table_take", _vmemtake_inputs)],
}


def test_dma(dev):
    # per-query 32B row gather from a table in device memory (the TPU
    # probe's PIPE = 8 DMAs; on the card a block has its whole tile of rows
    # in flight)
    case, = KERNEL_CASES["dma"]
    tab_np, q_np, tab, q = case.tensors(dev)
    NQ = len(q_np)
    try:
        dt = tm.timeit(case.run, tab, q)
        ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
        print(f"{case.label}: {NQ/dt/1e6:8.2f} Mq/s (correct={ok})")
    except Exception as e:
        print(f"{case.label}: FAILED {type(e).__name__}: {str(e)[:200]}")


def test_vmemtake(dev):
    # the table staged on chip (a cluster's shared memory), then gathered
    case, = KERNEL_CASES["vmemtake"]
    tab_np, q_np, tab, q = case.tensors(dev)
    try:
        dt = tm.timeit(case.run, tab, q)
        ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
        print(f"{case.label}: {(Q//8)/dt/1e6:8.1f} Mq/s (correct={ok})")
    except Exception as e:
        print(f"pallas VMEM take: FAILED {type(e).__name__}: {str(e)[:200]}")


TESTS = dict(rowscale=test_rowscale, flat=test_flat, colmajor=test_colmajor,
             sort=test_sort, onehot=test_onehot, dma=test_dma,
             vmemtake=test_vmemtake)

if __name__ == "__main__":
    tm.main(TESTS, sys.argv[1:], __doc__, headers=False)
