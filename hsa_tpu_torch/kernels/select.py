"""Top-K selection for the beam engine: a CUDA kernel and its plain version.

Replaces the Pallas kernel ``hsa_tpu/kernels/select.py:_build_select``
(body ``kern``, :59-89) behind ``select_topk`` (:124-203).  The kernel is
``csrc/select_topk.cu``.  The function is bound by bytes: the keys read
once, the outputs written once, and each picked payload word: 4 compulsory
bytes, though the memory system moves a 32-byte sector for it, because
neighbouring columns pick different rows.  So the kernel reads the keys once: a block compacts the valid keys
of a tile of neighbouring columns into shared memory with coalesced loads,
one warp per column ranks them by counting smaller keys (exact, because
keys are unique within a column), and the winners' payloads are fetched by
their rows and written out by rows (see the source's note).  Where a tile
of 8 columns of ``C`` keys does not fit in a block's shared memory (the
beam's frontier above W = 355), a block of the tall variant owns one column
and all its warps rank it; :func:`_plan` picks the variant, and it covers
every ``(C, K)`` that the beam launches (``9W < 2^14``).

Contract (the JAX function's, on int32 tensors):

- ``key``: int32 [C, B], one column per read strand.  A valid key is
  ``score << KEY_SH | row``, unique within its column; ``SENT`` and above
  mark an invalid slot.  Keys are below 2^31.
- ``payloads``: up to three int32 [C, B] matrices of raw 32-bit patterns,
  carried with their keys.
- ``window``: optional int32 [B] or [1, B]; keys whose score is above it
  are invalid.
- ``drop_accum``: optional int32 [B] or [1, B] running drop counter.

Returns ``(okeyd [K+1, B], payload outs [K, B] each, ndrop [1, B])``: rows
0..K-1 of ``okeyd`` are the K smallest valid keys in order, row K is
``drop_accum + max(nvalid - K, 0)``, and ``ndrop`` is a view of that row.

Slots past the valid keys differ between the two versions, as they do
between the Pallas kernel and its sort reference: the kernel writes
``SENT`` and payload 0 there, the plain version the sorted invalid keys and
their payloads.  Valid slots, the drop row and ``nvalid`` agree exactly.

The wrapper runs the plain version only for CPU tensors.  For CUDA
tensors it builds the kernel at first use and launches it on the current
stream, or raises; ``KERNEL.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KEY_SH = 14                      # key = score << KEY_SH | row
SENT = 0x7FFF0000                # invalid-key sentinel
MAX_PAY = 3
THREADS = 512                    # a block, as in csrc/select_topk.cu
MAX_SMEM = 232_448               # shared memory a block may ask for (227 KB)
TILES = (16, 8, 1)               # columns a block, widest first


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hsa_select_topk.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                    i, i, i, i, vp]
    lib.hsa_select_topk.restype = ctypes.c_int


KERNEL = CudaKernel("select_topk.cu", _declare)


def smem_bytes(tx: int, C: int, K: int) -> int:
    """Shared memory of one block of the kernel (``smem_bytes`` in the
    source): a tile of ``tx`` = 16 or 8 columns keeps each column's valid
    keys and rows (``cap`` entries, at least C and 1 modulo 32) and a staged
    ``[K+1, tx+1]`` output tile; the tall variant (``tx`` = 1) keeps one
    column's list, the K kept keys with their rows and a few counters."""
    cap = (C + 31) // 32 * 32 + 1
    if tx == 1:
        return 4 * (2 * cap + 2 * K + 2 * (THREADS // 32) + 2)
    return 4 * (2 * tx * cap + (2 * K + 1) * (tx + 1) + tx)


def _plan(C: int, K: int):
    """Columns a block for a select of K out of C rows: the widest of
    ``TILES`` whose shared memory fits a block, or None."""
    return next((tx for tx in TILES if smem_bytes(tx, C, K) <= MAX_SMEM), None)


def _check(key, payloads, K, window, drop_accum):
    if key.dtype != torch.int32 or key.dim() != 2:
        raise TypeError(f"key must be a 2-D int32 tensor, got {key.dtype} "
                        f"{tuple(key.shape)}")
    C, B = key.shape
    if not 1 <= K <= C:
        raise ValueError(f"K={K} outside [1, C={C}]")
    if len(payloads) > MAX_PAY:
        raise ValueError(f"at most {MAX_PAY} payloads, got {len(payloads)}")
    for t in (key, *payloads):
        if t.dtype != torch.int32 or t.shape != key.shape:
            raise TypeError(f"payloads must be int32 {tuple(key.shape)}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != key.device or not t.is_contiguous():
            raise ValueError("key and payloads must be contiguous on one device")
    for name, t in (("window", window), ("drop_accum", drop_accum)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.numel() != B or t.dim() > 2:
            raise TypeError(f"{name} must be int32 [B] or [1, B] with B={B}")
        if t.device != key.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the key's device")


def select_topk_plain(key, payloads, K: int, window=None, drop_accum=None):
    """Plain PyTorch version: a stable sort along the rows carrying the
    payloads (``select_topk_reference`` in the JAX package)."""
    C, B = key.shape
    if window is not None:
        key = torch.where((key >> KEY_SH) > window.reshape(1, B), key | SENT, key)
    nvalid = (key < SENT).sum(dim=0)
    nd = (nvalid - K).clamp(min=0)
    if drop_accum is not None:
        nd = ((drop_accum.reshape(B).long() & 0xFFFFFFFF) + nd) & 0xFFFFFFFF
    sk, order = torch.sort(key, dim=0, stable=True)
    top = order[:K]
    pouts = tuple(p.gather(0, top) for p in payloads)
    okeyd = torch.cat([sk[:K], nd.reshape(1, B).to(torch.int32)], dim=0)
    return okeyd, pouts, okeyd[K:K + 1]


def _select_topk_cuda(key, payloads, K, window, drop_accum):
    C, B = key.shape
    tx = _plan(C, K)
    if tx is None:
        raise ValueError(f"select_topk: no kernel variant holds C={C} K={K} "
                         f"in a block's shared memory")
    lib = KERNEL.lib()
    okeyd = torch.empty((K + 1, B), dtype=torch.int32, device=key.device)
    pouts = tuple(torch.empty((K, B), dtype=torch.int32, device=key.device)
                  for _ in payloads)
    if B == 0:                       # nothing to launch over
        return okeyd, pouts, okeyd[K:K + 1]
    pin = [p.data_ptr() for p in payloads] + [None] * (MAX_PAY - len(payloads))
    pout = [p.data_ptr() for p in pouts] + [None] * (MAX_PAY - len(pouts))
    with torch.cuda.device(key.device):
        stream = torch.cuda.current_stream(key.device).cuda_stream
        err = lib.hsa_select_topk(
            key.data_ptr(), len(payloads), *pin, *pout,
            window.data_ptr() if window is not None else None,
            drop_accum.data_ptr() if drop_accum is not None else None,
            okeyd.data_ptr(), C, B, K, tx, stream)
    if err:
        raise RuntimeError(f"select_topk kernel launch failed: CUDA error {err} "
                           f"at C={C} B={B} K={K}")
    KERNEL.count_launch((C, B, K, window is not None))
    return okeyd, pouts, okeyd[K:K + 1]


def select_topk(key, payloads, K: int, window=None, drop_accum=None):
    """Top-K smallest-key rows of [C, B] int32 matrices (module doc)."""
    payloads = tuple(payloads)
    _check(key, payloads, K, window, drop_accum)
    if key.device.type == "cpu":
        return select_topk_plain(key, payloads, K, window, drop_accum)
    if key.device.type != "cuda":
        raise ValueError(f"select_topk: unsupported device {key.device}")
    return _select_topk_cuda(key, payloads, K, window, drop_accum)
