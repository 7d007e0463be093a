"""Round-2 gather mechanism shootout on the card (counterpart of
``tools/gather_probe2.py``; every call synced and timed with CUDA events):

  widthscale   index_select Mq/s vs row width (is cost per-row or per-byte?)
  saturate     index_select Mq/s vs query-vector length (amortization curve)
  dmapipe      per-query 32B-row gather (gather_rows; the TPU's PIPE 8 and
               32 are kept as labels: the card's kernel is the same launch)
  rowloop      row loads from a table staged on chip (table_take)
  onehot       one-hot gather on the tensor cores from a staged chunk
               (onehot_gather)
  vmemsize     the largest table the chip can stage (table_take; coarse)

Usage: python -m hsa_tpu_torch.tools.gather_probe2 [--device cuda|cpu]
[test ...]
"""

from __future__ import annotations

import sys

import numpy as np

from ..index.layout import words_to_device
from . import _timing as tm
from ._cases import Case, random_table, random_queries
from .gather_probe import take_xor


def take_xor07(tab, q):
    r = tab.index_select(0, q)
    return r[:, 0] ^ r[:, 7]


def test_widthscale(dev):
    Q = 1 << 20
    for w in (1, 2, 4, 8, 16, 32):
        nb = (32 << 20) // (4 * w)  # constant 32MB table
        tab = words_to_device(random_table(nb, w), dev)
        q = tm.ints(random_queries(nb, Q), dev)
        dt = tm.timeit_sync(take_xor, tab, q)
        print(f"take w={w:2d} [32MB]: {Q/dt/1e6:8.1f} Mq/s "
              f"({Q*4*w/dt/1e9:6.2f} GB/s) {dt*1e3:7.2f} ms")


def test_saturate(dev):
    nb = 1 << 20
    tab = words_to_device(random_table(nb, 8), dev)
    for q_log in (14, 16, 18, 20, 22):
        Q = 1 << q_log
        q = tm.ints(random_queries(nb, Q), dev)
        dt = tm.timeit_sync(take_xor07, tab, q)
        print(f"take Q=2^{q_log}: {Q/dt/1e6:8.1f} Mq/s  {dt*1e3:7.2f} ms")


def _dmapipe_inputs():
    nb = 1 << 20
    return random_table(nb, 8), random_queries(nb, 1 << 14)


def _rowloop_inputs():
    nb = 1 << 15  # 1MB
    return random_table(nb, 8), random_queries(nb, 1 << 14)


def _onehot_inputs(R):
    return lambda: (random_table(R, 8), random_queries(R, 1 << 14))


def _vmemsize_inputs(mb):
    nb = (mb << 20) // 32
    return lambda: (np.zeros((nb, 8), np.uint32), np.arange(8, dtype=np.int32))


KERNEL_CASES = {
    "dmapipe": [Case(f"dma pipe={PIPE:2d} NQ=16K",
                     "tools/gather_probe2.py:134", "gather_rows",
                     _dmapipe_inputs, pipe=PIPE)
                for PIPE in (8, 32)],
    "rowloop": [Case("rowloop [1MB] Q=16K", "tools/gather_probe2.py:174",
                     "table_take", _rowloop_inputs)],
    "onehot": [Case(f"onehot-mxu R={R:4d} Q=16K", "tools/gather_probe2.py:210",
                    "onehot_gather", _onehot_inputs(R)) for R in (512, 2048)],
    "vmemsize": [Case(f"vmem table {mb} MB", "tools/gather_probe2.py:237",
                      "table_take", _vmemsize_inputs(mb))
                 for mb in (2, 4, 8, 16, 32, 64, 96)],
}


def test_dmapipe(dev):
    for case in KERNEL_CASES["dmapipe"]:
        tab_np, q_np, tab, q = case.tensors(dev)
        NQ = len(q_np)
        try:
            dt = tm.timeit_sync(case.run, tab, q, iters=4)
            ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
            print(f"{case.label}: {NQ/dt/1e6:8.2f} Mq/s "
                  f"(correct={ok}) {dt*1e3:.2f} ms")
        except Exception as e:
            print(f"dma pipe={case.pipe}: FAILED {type(e).__name__}: "
                  f"{str(e)[:160]}")


def test_rowloop(dev):
    case, = KERNEL_CASES["rowloop"]
    tab_np, q_np, tab, q = case.tensors(dev)
    Q = len(q_np)
    try:
        dt = tm.timeit_sync(case.run, tab, q, iters=4)
        ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
        print(f"{case.label}: {Q/dt/1e6:8.2f} Mq/s "
              f"(correct={ok}) {dt*1e3:.2f} ms")
    except Exception as e:
        print(f"rowloop: FAILED {type(e).__name__}: {str(e)[:160]}")


def test_onehot(dev):
    # one-hot [Q, R] x [R, 8] on the tensor cores, exact (int8 byte planes);
    # measures the ideal-case rate ONLY (bucketing cost excluded)
    for case in KERNEL_CASES["onehot"]:
        tab_np, q_np, tab, q = case.tensors(dev)
        Q, R = len(q_np), len(tab_np)
        try:
            dt = tm.timeit_sync(case.run, tab, q, iters=4)
            print(f"{case.label}: {Q/dt/1e6:8.2f} Mq/s "
                  f"({2*Q*R*8/dt/1e12:.2f} Tflop/s) {dt*1e3:.2f} ms")
        except Exception as e:
            print(f"onehot-mxu R={R}: FAILED {type(e).__name__}: "
                  f"{str(e)[:160]}")


def test_vmemsize(dev):
    # how big a table can the chip stage?
    for case in KERNEL_CASES["vmemsize"]:
        tab_np, q_np, tab, q = case.tensors(dev)
        try:
            tm.rb(case.run(tab, q))
            print(f"{case.label}: OK")
        except Exception as e:
            print(f"{case.label}: FAILED {type(e).__name__}")
            break


TESTS = dict(widthscale=test_widthscale, saturate=test_saturate,
             dmapipe=test_dmapipe, rowloop=test_rowloop,
             onehot=test_onehot, vmemsize=test_vmemsize)

if __name__ == "__main__":
    tm.main(TESTS, sys.argv[1:], __doc__)
