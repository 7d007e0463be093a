"""The FM row gather three ways: three CUDA kernels, each beside its plain
PyTorch version.

Every ``extend``, ``lf`` and locate step of the FM index gathers one fused
occ row of 8 32-bit words per lane (``search/fm.py:_gather_rows``, which
calls ``index_select``).  The TPU probes under ``tools/`` asked which
mechanism moves such rows fastest; these kernels ask the same of the card:

- :func:`gather_rows` (``csrc/gather_rows.cu``): rows from device memory, a
  block a tile of ``chunk`` queries with all of its row loads in flight;
  rows of 8 or 32 words.  Replaces the per-row DMA probes
  (``tools/gather_probe.py:191``, ``gather_probe2.py:134``,
  ``gather_probe3.py:121, 161, 210, 245, 290, 337``, ``sync_probe.py:178``).
- :func:`table_take` (``csrc/table_take.cu``): the table staged on chip by
  the copy engine, a slice in the shared memory of each block of a group,
  then each row read from there by the block that holds it.  Replaces the
  VMEM probes (``gather_probe.py:217``, ``gather_probe2.py:174, 237``,
  ``sync_probe.py:210``).  A table larger than the card's largest
  thread-block cluster can hold is refused with ``ValueError`` before any
  launch (:func:`table_take_capacity`): that is the card's answer to
  ``gather_probe2.py``'s VMEM capacity bisect.
- :func:`onehot_gather` (``csrc/onehot_gather.cu``): ``uint32(float32(
  tab[q]))``, the function of ``gather_probe2.py:210``'s one-hot product.
  A one-hot row holds one 1, so the card computes the gather itself: a
  block a tile of queries, two lanes a row, each row read from the L1 and
  L2 caches where the table lies and rounded through float32; any number
  of rows.

Tables are int32 bit patterns of 32-bit words (the port's convention,
``index/layout.py``), indices int32.  Every index is clamped to the table,
as ``fm._gather_rows`` does; the plain versions clamp too.

Each wrapper runs the plain version only for CPU tensors.  For CUDA tensors
it builds its kernel at first use and launches it on the current stream, or
raises; ``GATHER_ROWS``, ``TABLE_TAKE`` and ``ONEHOT_GATHER`` each count
their own launches.  No path of the aligner calls them: they are the
probes' kernels.  Their launch plans are made here (:func:`rows_plan`,
:func:`take_plan`, :func:`onehot_plan`) and checked by the C functions.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from .build import CudaKernel, launch

ROW_WORDS = (8, 32)                  # row widths of gather_rows
# the probes' pipe depths gather_rows accepts; its kernel keeps a whole
# tile's rows in flight a block, so pipe sets nothing on the card
PIPES = (1, 2, 4, 8, 16, 32)
CHUNK = 256                          # gather_rows' rows a tile by default
MAX_SMEM = 232_448                   # shared memory a block may ask for
MAX_THREADS = 1024                   # threads a block
TAKE_THREADS = 512                   # table_take's block, as in its source
TAKE_MAX_ROWS = MAX_SMEM // 32       # rows of 32 bytes a block stages
SLICES = (1, 2, 4, 8, 16)            # table_take's slices of a table
# table_take adds a group (which stages the table once more) for every
# TAKE_ROWS_A_THREAD queries that each thread of a block would otherwise scan
TAKE_ROWS_A_THREAD = 2
ONEHOT_LANES = 2                     # onehot_gather's lanes a row (its source)
ONEHOT_TILE = 128                    # onehot_gather's rows a block
M32 = 0xFFFFFFFF


def _declare_rows(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hsa_gather_rows.argtypes = [vp, i, i, vp, i, i, i, i, vp, vp]
    lib.hsa_gather_rows.restype = ctypes.c_int


def _declare_take(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hsa_table_take.argtypes = [vp, i, vp, i, i, i, i, vp, vp]
    lib.hsa_table_take.restype = ctypes.c_int
    lib.hsa_table_take_capacity.argtypes = [ctypes.POINTER(i)]
    lib.hsa_table_take_capacity.restype = ctypes.c_int


def _declare_onehot(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hsa_onehot_gather.argtypes = [vp, i, vp, i, i, i, i, vp, vp]
    lib.hsa_onehot_gather.restype = ctypes.c_int


GATHER_ROWS = CudaKernel("gather_rows.cu", _declare_rows)
TABLE_TAKE = CudaKernel("table_take.cu", _declare_take)
ONEHOT_GATHER = CudaKernel("onehot_gather.cu", _declare_onehot)
KERNELS = {"gather_rows": GATHER_ROWS, "table_take": TABLE_TAKE,
           "onehot_gather": ONEHOT_GATHER}
_capacity = {}                       # device index -> rows table_take holds


def _check(name, tab, q, widths):
    if tab.dtype != torch.int32 or tab.dim() != 2 or \
            tab.shape[1] not in widths or tab.shape[0] < 1:
        raise TypeError(f"{name}: tab must be int32 [NB >= 1, W] with W in "
                        f"{widths}, got {tab.dtype} {tuple(tab.shape)}")
    if q.dtype != torch.int32 or q.dim() != 1:
        raise TypeError(f"{name}: q must be int32 [NQ], got {q.dtype} "
                        f"{tuple(q.shape)}")
    if q.device != tab.device or not (tab.is_contiguous() and
                                      q.is_contiguous()):
        raise ValueError(f"{name}: tab and q must be contiguous on one device")
    if tab.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tab.device}")


def check_aligned(name, *tensors):
    """The kernels move rows as 16-byte vectors: raise unless every tensor
    starts on a 16-byte boundary."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor at {t.data_ptr():#x} is not "
                             "16-byte aligned")


def rows_plain(tab, q):
    """Plain version of :func:`gather_rows` and :func:`table_take`:
    ``tab[clamp(q)]``."""
    return tab.index_select(0, q.clamp(0, tab.shape[0] - 1))


def _device_index(dev):
    dev = torch.device(dev)
    return dev.index if dev.index is not None else torch.cuda.current_device()


@dataclass(frozen=True)
class RowsPlan:
    """One launch of ``gather_rows.cu``: ``grid`` blocks of ``threads``
    threads, each block gathering a tile of ``tile`` rows (a thread a
    row)."""
    tile: int
    threads: int
    grid: int


def rows_plan(nq: int, chunk: int) -> RowsPlan:
    """The launch of :func:`gather_rows` for ``nq`` >= 1 rows: tiles of
    ``chunk`` rows, at most ``nq`` and a block's threads, a block each."""
    tile = max(1, min(chunk, nq, MAX_THREADS))
    return RowsPlan(tile, -(-tile // 32) * 32, -(-nq // tile))


def gather_rows(tab, q, pipe: int = 8, chunk: int | None = None):
    """``tab[clamp(q)]`` for ``tab`` int32 [NB, W] (W = 8 or 32) and ``q``
    int32 [NQ]: [NQ, W].  On the card a block gathers a tile of ``chunk``
    rows (default ``CHUNK``; :func:`rows_plan`) with all of its row loads
    in flight.  ``pipe``, the TPU probes' count of row copies in flight, is
    checked against ``PIPES`` and sets nothing on the card."""
    _check("gather_rows", tab, q, ROW_WORDS)
    chunk = CHUNK if chunk is None else chunk
    if pipe not in PIPES or chunk < 1:
        raise ValueError(f"gather_rows: pipe must be one of {PIPES} and "
                         f"chunk >= 1, got pipe={pipe} chunk={chunk}")
    if tab.device.type == "cpu":
        return rows_plain(tab, q)
    nb, w = tab.shape
    nq = q.shape[0]
    out = torch.empty((nq, w), dtype=torch.int32, device=tab.device)
    if nq == 0:
        return out
    check_aligned("gather_rows", tab, out)
    plan = rows_plan(nq, chunk)
    launch("gather_rows", GATHER_ROWS.lib().hsa_gather_rows, out,
            (tab.data_ptr(), nb, w, q.data_ptr(), nq, plan.tile,
             plan.threads, plan.grid, out.data_ptr()))
    GATHER_ROWS.count_launch((nb, w, nq, pipe, chunk))
    return out


def table_take_capacity(device) -> int:
    """Rows of 32 bytes that :func:`table_take` can stage on ``device``'s
    chip: the largest thread-block cluster the card schedules with a full
    block of shared memory, times the rows a block holds (the CUDA source
    keeps that limit)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"table_take_capacity: {dev} is not a CUDA device")
    idx = _device_index(dev)
    if idx not in _capacity:
        lib = TABLE_TAKE.lib()
        rows = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = lib.hsa_table_take_capacity(ctypes.byref(rows))
        if err:
            raise RuntimeError(f"table_take capacity query failed: CUDA error "
                               f"{err}")
        _capacity[idx] = rows.value
    return _capacity[idx]


@dataclass(frozen=True)
class TakePlan:
    """One launch of ``table_take.cu``: ``groups`` groups of ``slices``
    blocks, block b holding slice b % ``slices`` of the table (``rows``
    rows, ``smem`` bytes); every group stages the whole table and takes a
    contiguous share of the queries."""
    slices: int
    rows: int
    groups: int
    smem: int


def take_plan(nb: int, nq: int, sms: int) -> TakePlan | None:
    """The launch of :func:`table_take` for ``nb`` rows and ``nq`` >= 1
    queries: the fewest slices (a power of two, at most ``SLICES[-1]``) whose
    rows fit a block's shared memory; as many groups as leave each thread
    TAKE_ROWS_A_THREAD of its group's queries to scan, at most one block an
    SM of the ``sms``.  None when no such slices hold the table."""
    for cs in SLICES:
        rows = -(-nb // cs)
        if rows > TAKE_MAX_ROWS:
            continue
        want = -(-nq // (TAKE_THREADS * TAKE_ROWS_A_THREAD))
        return TakePlan(cs, rows, max(1, min(want, sms // cs)), rows * 32)
    return None


def take_launch(tab, q, plan: TakePlan):
    """Launches ``table_take.cu`` on CUDA tensors by ``plan`` (no checks
    but the C function's) and counts the launch."""
    out = torch.empty((q.shape[0], 8), dtype=torch.int32, device=tab.device)
    launch("table_take", TABLE_TAKE.lib().hsa_table_take, out,
            (tab.data_ptr(), tab.shape[0], q.data_ptr(), q.shape[0],
             plan.slices, plan.rows, plan.groups, out.data_ptr()))
    TABLE_TAKE.count_launch((tab.shape[0], q.shape[0]))
    return out


def table_take_plan(tab, q) -> TakePlan:
    """:func:`take_plan` on ``tab``'s card."""
    plan = take_plan(tab.shape[0], q.shape[0], torch.cuda.get_device_properties(
        _device_index(tab.device)).multi_processor_count)
    if plan is None:
        raise RuntimeError(f"table_take: no {SLICES[-1]} slices hold "
                           f"{tab.shape[0]} rows")
    return plan


def table_take(tab, q):
    """``tab[clamp(q)]`` for ``tab`` int32 [NB, 8] and ``q`` int32 [NQ], read
    from a copy of the table in on-chip memory.  Raises ``ValueError`` before
    any launch when the table is larger than the card can hold there."""
    _check("table_take", tab, q, (8,))
    if tab.device.type == "cpu":
        return rows_plain(tab, q)
    nb = tab.shape[0]
    cap = table_take_capacity(tab.device)
    if nb > cap:
        raise ValueError(
            f"table_take: a table of {nb} rows ({nb * 32 / 2 ** 20:.3f} MiB) "
            f"does not fit on chip; this card stages at most {cap} rows "
            f"({cap * 32 / 2 ** 20:.3f} MiB) in the shared memories of one "
            "thread-block cluster")
    if q.shape[0] == 0:
        return torch.empty((0, 8), dtype=torch.int32, device=tab.device)
    check_aligned("table_take", tab)
    return take_launch(tab, q, table_take_plan(tab, q))


def words_to_float(tab):
    """32-bit patterns (int32) -> their unsigned values rounded to float32."""
    return (tab.long() & M32).float()


def float_to_words(x):
    """float32 -> uint32 (saturating at 2^32 - 1) as int32 bit patterns."""
    return x.long().clamp(0, M32).to(torch.int32)


def onehot_gather_plain(q, tab):
    """Plain version of :func:`onehot_gather`: the literal product of the
    one-hot matrix of ``clamp(q)`` and the table, in float32.  On the card
    this needs full-float32 matrix products
    (``torch.backends.cuda.matmul.allow_tf32`` False, the default): TF32
    would round the table to 11 bits."""
    R = tab.shape[0]
    rows = torch.arange(R, dtype=torch.int32, device=tab.device)
    oh = (rows[None, :] == q.clamp(0, R - 1)[:, None]).float()
    return float_to_words(oh @ words_to_float(tab))


@dataclass(frozen=True)
class OnehotPlan:
    """One launch of ``onehot_gather.cu``: ``grid`` blocks of ``threads``
    threads, each block gathering a tile of ``tile`` rows (ONEHOT_LANES
    lanes a row)."""
    tile: int
    threads: int
    grid: int


@functools.lru_cache(maxsize=256)    # plans are immutable: built once a Q
def onehot_plan(nq: int) -> OnehotPlan:
    """The launch of :func:`onehot_gather` for ``nq`` >= 1 queries: tiles of
    ONEHOT_TILE rows (fewer when ``nq`` is), a block each."""
    tile = min(ONEHOT_TILE, nq)
    return OnehotPlan(tile, -(-ONEHOT_LANES * tile // 32) * 32,
                      -(-nq // tile))


def onehot_gather(q, tab):
    """``uint32(float32(tab[clamp(q)]))`` for ``q`` int32 [Q] and ``tab``
    int32 [R, 8]: [Q, 8] int32 bit patterns.  On the card a block gathers a
    tile of rows (:func:`onehot_plan`) and rounds each word through
    float32; R has no limit."""
    _check("onehot_gather", tab, q, (8,))
    if not tab.is_cuda:
        return onehot_gather_plain(q, tab)
    R, nq = tab.shape[0], q.shape[0]
    out = tab.new_empty((nq, 8))
    if nq == 0:
        return out
    check_aligned("onehot_gather", tab, out)
    plan = onehot_plan(nq)
    launch("onehot_gather", ONEHOT_GATHER.lib().hsa_onehot_gather, out,
            (tab.data_ptr(), R, q.data_ptr(), nq, plan.tile, plan.threads,
             plan.grid, out.data_ptr()))
    ONEHOT_GATHER.count_launch((R, nq))
    return out
