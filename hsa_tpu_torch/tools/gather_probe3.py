"""Round-3 DMA-gather variants on the card (counterpart of
``tools/gather_probe3.py``).

On the TPU each variant was another way of asking Mosaic for PIPE
outstanding row DMAs, because some forms failed to compile.  On the card
they all compute ``out[i] = tab[q[i]]`` with the one kernel
``gather_rows``; each is printed under its TPU label so that the two
probes' outputs line up.  The kernel keeps a block's whole tile of rows in
flight, so the TPU's PIPE (passed as ``pipe``) sets nothing: the variants
labelled by pipe are one launch, of 256-row tiles, and only ``grid`` and
``wide`` launch differently:

  orig       pipe 8 and 32
  pow2       pipe 8
  unroll     pipe 8 and 16
  grid       one block per CHUNK of queries, CHUNK rows in flight (8, 32)
  scoped     pipe 8
  wide       128B rows, pipe 8

Each prints Mrows/s.  Usage: python -m hsa_tpu_torch.tools.gather_probe3
[--device cuda|cpu] [test ...]
"""

from __future__ import annotations

import sys

from . import _timing as tm
from ._cases import Case, random_table, random_queries

NB = 1 << 20
NQ = 1 << 14


def _inputs(width=8):
    nb = NB if width == 8 else NB // 4
    return lambda: (random_table(nb, width), random_queries(nb, NQ))


def _case(label, line, pipe, chunk=None, width=8):
    return Case(label, f"tools/gather_probe3.py:{line}", "gather_rows",
                _inputs(width), pipe=pipe, chunk=chunk)


KERNEL_CASES = {
    "orig": [_case(f"orig pipe={PIPE}", 121, PIPE) for PIPE in (8, 32)],
    "pow2": [_case("pow2 pipe=8", 161, 8)],
    "unroll": [_case(f"unroll pipe={PIPE}", 210, PIPE) for PIPE in (8, 16)],
    "grid": [_case(f"grid chunk={CHUNK}", 245, CHUNK, CHUNK)
             for CHUNK in (8, 32)],
    "scoped": [_case("scoped pipe=8", 290, 8)],
    "wide": [_case("wide 128B pipe=8", 337, 8, width=32)],
}


def _run(case, dev):
    try:
        tab_np, q_np, tab, q = case.tensors(dev)
        dt = tm.timeit_sync(case.run, tab, q, iters=4)
        ok = tm.equal_rows(case.run(tab, q), tab_np, q_np)
        print(f"{case.label}: {NQ/dt/1e6:8.2f} Mrows/s (correct={ok}) "
              f"{dt*1e3:.2f} ms", flush=True)
    except Exception as e:
        print(f"{case.label}: FAILED {type(e).__name__}: {str(e)[:2500]}",
              flush=True)


def _test(name):
    def test(dev):
        for case in KERNEL_CASES[name]:
            _run(case, dev)
    test.__name__ = f"test_{name}"
    return test


TESTS = {name: _test(name) for name in KERNEL_CASES}

if __name__ == "__main__":
    tm.main(TESTS, sys.argv[1:], __doc__)
