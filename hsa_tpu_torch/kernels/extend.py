"""One FM backward step as a CUDA kernel: ``fm.extend`` and
``fm.extend4_flat`` on the card.

Replaces the device work of ``hsa_tpu/search/fm.py:182-230`` (``occ_lt``,
``occ_lt4_flat``, ``extend``, ``extend4_flat``), which ``hsa_tpu`` leaves to
XLA inside its jitted searches.  The kernel is ``csrc/fm_extend.cu``: one
thread a lane, both interval ends, their two 32-byte occ rows and the
popcounts in registers, one launch a step (see the source's note).  Its
plain version is today's torch code in ``search/fm.py``
(:func:`~hsa_tpu_torch.search.fm.extend_plain`,
:func:`~hsa_tpu_torch.search.fm.extend4_flat_plain`), which ``fm.extend``
and ``fm.extend4_flat`` run for CPU tensors; for CUDA tensors they call
:func:`fm_extend` here, which launches the kernel or raises.

Contract of :func:`fm_extend` (``idx`` a ``TorchIndex`` or a shard's
index; ``a``, ``k``, ``l`` int64 ``[B]`` on the index's card, values in
``[0, 2^32)``, any stride):

- unsharded: int64 ``[2, B]`` (``a`` given: ``k'``, ``l'``) or ``[8, B]``
  (``a`` None: ``k'`` of bases 0..3, then ``l'`` of bases 0..3), equal to
  the plain version lane for lane, dead lanes included;
- sharded (``idx.shard_group`` set): int32 ``[2, B]`` or ``[8, B]``, the
  counts ``occ(a, k)`` and ``occ(a, l + 1)`` of the lanes whose row this
  shard holds and 0 elsewhere, as bit patterns: the caller merges them
  with one ``all_reduce`` and adds ``C`` (``fm.py``).

``KERNEL.launches`` counts the launches and ``KERNEL.launch_shapes`` their
``(B, "extend" or "extend4", rev, sharded)``.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel, launch


def _declare(lib):
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.hsa_fm_extend.argtypes = [vp, ll, vp, vp, ll, vp, ll, vp, ll, ll, ll,
                                  ll, ll, i, vp, vp]
    lib.hsa_fm_extend.restype = ctypes.c_int


KERNEL = CudaKernel("fm_extend.cu", _declare)


def _check(blocks, C, a, k, l):
    if blocks.dtype != torch.int32 or blocks.dim() != 2 or \
            blocks.shape[1] != 8 or not blocks.is_contiguous():
        raise TypeError(f"occ rows must be contiguous int32 [rows, 8], got "
                        f"{blocks.dtype} {tuple(blocks.shape)}")
    if blocks.data_ptr() % 16:
        raise ValueError("occ rows must start on a 16-byte boundary")
    if C.dtype != torch.int64 or C.numel() < 4 or not C.is_contiguous():
        raise TypeError(f"C must be contiguous int64 [>= 4], got {C.dtype}")
    lanes = (("a", a), ("k", k), ("l", l)) if a is not None else \
        (("k", k), ("l", l))
    for name, t in lanes:
        if t.dtype != torch.int64 or t.dim() != 1 or t.shape != k.shape:
            raise TypeError(f"{name} must be int64 [{k.shape[0]}], got "
                            f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("C", C), *lanes):
        if t.device != blocks.device:
            raise ValueError(f"{name} is on {t.device}, the occ rows on "
                             f"{blocks.device}")
    if blocks.device.type != "cuda":
        raise ValueError(f"fm_extend: unsupported device {blocks.device}")


def fm_extend(idx, a, k, l, *, rev: bool = False):
    """The kernel's results for lanes ``(a, k, l)`` (module doc); ``a``
    None extends by all four bases."""
    blocks = idx.rev_occ_blocks if rev else idx.occ_blocks
    _check(blocks, idx.C, a, k, l)
    sharded = getattr(idx, "shard_group", None) is not None
    name = "rev_occ_blocks" if rev else "occ_blocks"
    offset, grows = 0, blocks.shape[0]
    if sharded:
        offset = idx.rev_row_offset if rev else idx.row_offset
        grows = idx.global_rows[name]
    B = k.shape[0]
    out = torch.empty((2 if a is not None else 8, B),
                      dtype=torch.int32 if sharded else torch.int64,
                      device=k.device)
    if B == 0:                       # nothing to launch over
        return out
    launch("fm_extend", KERNEL.lib().hsa_fm_extend, out, (
        blocks.data_ptr(), blocks.shape[0], idx.C.data_ptr(),
        a.data_ptr() if a is not None else None,
        a.stride(0) if a is not None else 0, k.data_ptr(), k.stride(0),
        l.data_ptr(), l.stride(0), B,
        idx.rev_primary if rev else idx.primary, offset, grows, int(sharded),
        out.data_ptr()))
    KERNEL.count_launch((B, "extend" if a is not None else "extend4", rev,
                         sharded))
    return out
