"""hsa-tpu on PyTorch and CUDA: the port of :mod:`hsa_tpu` to an NVIDIA H100.

The package mirrors ``hsa_tpu``'s layout, one module per counterpart, and
imports ``torch`` but never ``jax`` and nothing of ``hsa_tpu``: the host
layer (``config``, ``alphabet``, ``refpack`` with its native sources under
``csrc/``, ``io``, ``resolve``, ``metrics``, the numpy index layout,
``ReadBatch`` and ``build_index``) is the port's own copy, under the same
module names.  The index directory format is unchanged, so both packages
read and write the same index.

Covered so far, from index to SAM, with every command of ``hsa-tpu``'s
CLI: single-end and paired-end alignment through the pigeonhole
seed-and-verify engine with the beam as its fallback (``engine="auto"``, the
default, ``search/pigeon.py``) or through the exhaustive beam engine alone
(``engine="beam"``, flat or adaptive), fused (``align``, ``align-pe``) or in
two phases (``aln`` to a ``.sai.npz`` that either package reads, then
``samse`` or ``sampe``).  Both Pallas kernels of
``hsa_tpu`` are hand-written CUDA kernels: the top-K selection of every beam
step (``kernels/select.py``, ``csrc/select_topk.cu``) and the glocal DP that
screens the paired-end mate rescues (``kernels/sw.py``,
``csrc/glocal_screen.cu``).  Every function takes an explicit ``device``; on
the CPU each kernel's plain PyTorch version runs instead, which is what the
test suite exercises against the JAX reference.

The reference path is here too (``pipeline.oracle_align``,
``oracle_align_pe``): the numpy FM index (``fmcore``), the branch-and-bound
search (``oracle.bnb``) and the per-read-list resolvers, the ground truth
of record parity, which ``chip_smoke.py`` holds the card's records against
where ``hsa_tpu`` cannot run.
"""

__version__ = "0.1.0"
