"""Top-K selection for the beam engine: two CUDA kernels and a plain version.

Replaces the Pallas kernel ``hsa_tpu/kernels/select.py:_build_select``
(body ``kern``, :59-89) behind ``select_topk`` (:124-203).  The kernels are
``csrc/select_topk.cu``.  The function is bound by bytes: the keys read
once, the outputs written once, and each picked payload word: 4 compulsory
bytes, though the memory system moves a 32-byte sector for it, because
neighbouring columns pick different rows.

- The tiled kernel (a tile of 16 or 8 columns a block) reads the keys once:
  a block compacts the valid keys of its tile into shared memory with
  coalesced loads, one warp per column ranks them by counting smaller keys
  (exact, because keys are unique within a column), and the winners'
  payloads are fetched by their rows and written out by rows.
- Where a tile of 8 columns of ``C`` keys does not fit in a block's shared
  memory (the beam's frontier above W = 355, its merge above W of about
  700), the tall kernel keeps no list of C keys: a radix select over two
  coalesced reads of the keys (a histogram of the score, then the keys at
  or below the K-th key's bin), and a stable counting sort of the kept keys,
  one warp a column.

:func:`_plan` picks the kernel and its launch (:class:`Plan`; see the
source's note), and covers every ``(C, K)`` that the beam launches (``9W <
2^14``).

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
import functools
from dataclasses import dataclass

import torch

from .build import CudaKernel, launch

KEY_SH = 14                      # key = score << KEY_SH | row
SENT = 0x7FFF0000                # invalid-key sentinel
MAX_PAY = 3
MAX_SMEM = 232_448               # shared memory a block may ask for (227 KB)
TILES = (16, 8)                  # the tiled kernel's columns a block
# the tall kernel (csrc/select_topk.cu): columns a block, widest first; bins
# of a digit, its per-column words and widest tile; and the shortest column
# list the plan gives it, so that the boundary score of a merge (K = 32 or
# 64 out of thousands of keys) fits without a further pass
TALL_COLS = (8, 4, 2, 1)
TALL_BINS = 1024
TALL_HIST = TALL_BINS + TALL_BINS // 32   # a histogram row, padded
TALL_FIELDS = 10
TALL_MAX_COLS = 8
TALL_MIN_LIST = 256
SMS = 132                        # SMs of an H100 SXM, where none is given


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hsa_select_topk.argtypes = [vp, i, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                    i, i, i, i, vp]
    lib.hsa_select_topk.restype = ctypes.c_int
    if hasattr(lib, "hsa_select_topk_trace"):    # the tall kernel's marks
        lib.hsa_select_topk_trace.argtypes = [vp]
        lib.hsa_select_topk_trace.restype = ctypes.c_int


KERNEL = CudaKernel("select_topk.cu", _declare)


@dataclass(frozen=True)
class Plan:
    """One launch of ``csrc/select_topk.cu``.  The tiled kernel: ``cols`` =
    16 or 8 columns a block, ``ls`` 0.  The tall kernel: ``cols`` = 8, 4, 2
    or 1 columns a block, lists of ``ls`` keys a column."""
    cols: int
    ls: int = 0

    @property
    def tall(self) -> bool:
        return self.ls > 0

    @property
    def code(self) -> int:
        """The plan as the C function's ``tx`` takes it."""
        return -(self.cols | self.ls << 4) if self.tall else self.cols

    def __str__(self):
        if not self.tall:
            return f"tiled, {self.cols} columns a block"
        return f"tall, {self.cols} columns a block, lists of {self.ls}"


def smem_bytes(tx: int, C: int, K: int) -> int:
    """Shared memory of one block of the tiled kernel (``smem_bytes`` in the
    source): a tile of ``tx`` = 16 or 8 columns keeps each column's valid
    keys and rows (``cap`` entries, at least C and 1 modulo 32) and a staged
    ``[K+1, tx+1]`` output tile."""
    cap = (C + 31) // 32 * 32 + 1
    return 4 * (2 * tx * cap + (2 * K + 1) * (tx + 1) + tx)


def tall_smem_bytes(cols: int, ls: int) -> int:
    """Shared memory of one block of the tall kernel (``tall_smem_bytes``
    in the source): a column's histogram of ``TALL_BINS`` (padded to
    ``TALL_HIST``), two lists of keys and rows (``ls`` entries each, rounded
    to 1 modulo 32), and the per-column words."""
    stride = (ls + 31) // 32 * 32 + 1
    return 4 * (cols * TALL_HIST + 4 * cols * stride
                + TALL_FIELDS * TALL_MAX_COLS)


def tall_list(C: int, K: int) -> int:
    """Keys a column list of the tall kernel holds: K and an eighth more (at
    least 64), at least ``TALL_MIN_LIST``, and no more than the column's C
    rows need.  A boundary bin that overflows it costs another pass over
    the keys."""
    return max(TALL_MIN_LIST, K, min(C, K + max(64, K // 8)))


def tall_plan(C: int, B: int, K: int, sms: int = SMS):
    """The tall kernel's launch for a select of K out of C rows over B
    columns: lists of :func:`tall_list` keys, and the widest tile whose
    block fits and whose tiles give at least half of the ``sms`` SMs a
    block, else the narrowest that fits.  None where no tile fits."""
    ls = tall_list(C, K)
    fits = [c for c in TALL_COLS if tall_smem_bytes(c, ls) <= MAX_SMEM]
    if not fits:
        return None
    return Plan(next((c for c in fits if 2 * -(-B // c) >= sms), fits[-1]),
                ls)


@functools.lru_cache(maxsize=None)
def _plan(C: int, B: int, K: int, sms: int = SMS):
    """The launch of a select of K out of C rows over B columns: the tiled
    kernel at the widest of ``TILES`` whose shared memory fits a block, else
    the tall kernel (:func:`tall_plan`); None where neither fits."""
    tx = next((t for t in TILES if smem_bytes(t, C, K) <= MAX_SMEM), None)
    return Plan(tx) if tx else tall_plan(C, B, K, sms)


@functools.lru_cache(maxsize=None)
def _sms(idx: int) -> int:
    return torch.cuda.get_device_properties(idx).multi_processor_count


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
    plan = _plan(C, B, K, _sms(key.get_device()))
    if plan is None:
        raise ValueError(f"select_topk: no kernel variant holds C={C} K={K} "
                         f"in a block's shared memory")
    okeyd = key.new_empty((K + 1, B))
    pouts = tuple(key.new_empty((K, B)) for _ in payloads)
    if B == 0:                       # nothing to launch over
        return okeyd, pouts, okeyd[K:K + 1]
    pin = [p.data_ptr() for p in payloads] + [None] * (MAX_PAY - len(payloads))
    pout = [p.data_ptr() for p in pouts] + [None] * (MAX_PAY - len(pouts))
    launch("select_topk", KERNEL.lib().hsa_select_topk, key, (
        key.data_ptr(), len(payloads), *pin, *pout,
        window.data_ptr() if window is not None else None,
        drop_accum.data_ptr() if drop_accum is not None else None,
        okeyd.data_ptr(), C, B, K, plan.code))
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
