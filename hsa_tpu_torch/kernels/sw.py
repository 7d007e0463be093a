"""The mate-rescue screen: a batched glocal DP as a CUDA kernel and its
plain version.

Replaces the Pallas kernel ``hsa_tpu/kernels/sw.py:_glocal_kernel``
(:114-192, ``pallas_call`` :215) behind ``glocal_screen_pallas`` (:195).
The kernel is ``csrc/glocal_screen.cu``: one warp per rescue job, each lane
holding a run of consecutive window columns of the DP in registers for the
whole read, one loop over the read's bases with shuffles only (the left
neighbour's column, and each row's deletion recurrence as a warp-wide
exclusive prefix-min), and windows wider than one register tile cut into
column tiles that hand two values per row to their right neighbour
(:func:`_plan` chooses the tiles here, where the CPU tests reach it).

Contract (the JAX ``glocal_screen``'s, on int32 tensors):

- ``reads`` int32 [R, L], codes 0..4 (4 = N mismatches everything), read
  ``r`` is ``reads[r, :lens[r]]``; ``windows`` int32 [R, G], codes 0..3,
  window ``r`` is ``windows[r, :wlens[r]]``.  Values past the lengths are
  ignored.
- Costs: ``s_mm`` per mismatch, ``s_gapo + (g-1)*s_gape`` per gap of
  length ``g``; the whole read is aligned, the window's start and end are
  free.
- Returns ``(cost [R], end [R])`` int32: the least cost, and the window
  column (exclusive end) where it is reached.  Column 0, a whole-read
  insertion, wins ties, then the first column at the minimum.

The wrapper runs the plain version only for CPU tensors.  For CUDA tensors
it builds the kernel at first use and launches it on the current stream,
or raises; ``KERNEL.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

BIG = 1 << 28
MAX_CPL = 24                      # window columns a lane can hold (even, 2..24)
WARPS_PER_BLOCK = 4
MIN_TILED_CPL = 14                # the narrowest tiled kernel that is built
SCRATCH_BYTES = 256 << 20         # cap of the tiles' hand-over rows
MAX_WARPS = 132 * 16


def _declare(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.hsa_glocal_screen.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
                                      i, i, i, i, i, vp]
    lib.hsa_glocal_screen.restype = ctypes.c_int


KERNEL = CudaKernel("glocal_screen.cu", _declare)


def _check(reads, lens, windows, wlens):
    for name, t, dim in (("reads", reads, 2), ("lens", lens, 1),
                         ("windows", windows, 2), ("wlens", wlens, 1)):
        if t.dtype != torch.int32 or t.dim() != dim:
            raise TypeError(f"{name} must be a {dim}-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != reads.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the reads' device")
    R = reads.shape[0]
    if windows.shape[0] != R or lens.shape[0] != R or wlens.shape[0] != R:
        raise ValueError(f"row counts differ: reads {R}, lens {lens.shape[0]}, "
                         f"windows {windows.shape[0]}, wlens {wlens.shape[0]}")


def glocal_screen_plain(reads, lens, windows, wlens, s_mm: int, s_gapo: int,
                        s_gape: int):
    """Plain PyTorch version: ``hsa_tpu.kernels.sw.glocal_screen`` (:62-107)
    row by row, with ``torch.cummin`` for the deletion prefix-min."""
    dev = reads.device
    R, L = reads.shape
    G = windows.shape[1]
    i32 = torch.int32
    cols = torch.arange(1, G + 1, dtype=i32, device=dev)[None, :]
    col_ok = cols <= wlens[:, None]
    gape_ramp = cols * s_gape
    big = torch.full((R, G), BIG, dtype=i32, device=dev)
    big_col = big[:, :1]
    m = torch.zeros((R, G), dtype=i32, device=dev)
    ins, dele = big.clone(), big.clone()
    m0 = torch.zeros(R, dtype=i32, device=dev)
    ins0 = torch.full((R,), BIG, dtype=i32, device=dev)
    for i in range(L):
        rb = reads[:, i:i + 1]
        sub = torch.where((rb <= 3) & (rb == windows), 0, s_mm).to(i32)
        pm = torch.cat([m0[:, None], m[:, :-1]], dim=1)
        pi = torch.cat([ins0[:, None], ins[:, :-1]], dim=1)
        pd = torch.cat([big_col, dele[:, :-1]], dim=1)
        m_new = torch.where(col_ok, torch.minimum(torch.minimum(pm, pi), pd)
                            + sub, big)
        ins_new = torch.minimum(m + s_gapo, ins + s_gape)
        c = m_new - gape_ramp + (s_gapo - s_gape)
        cm = torch.cummin(c, dim=1).values
        cm_excl = torch.cat([big_col, cm[:, :-1]], dim=1)
        dele_new = torch.where(col_ok, cm_excl + gape_ramp, big)
        act = (i < lens)
        m = torch.where(act[:, None], m_new, m)
        ins = torch.where(act[:, None], ins_new, ins)
        dele = torch.where(act[:, None], dele_new, dele)
        ins0 = torch.where(act, torch.minimum(m0 + s_gapo, ins0 + s_gape), ins0)
        m0 = torch.where(act, BIG, m0)
    total = torch.where(col_ok, torch.minimum(torch.minimum(m, ins), dele), big)
    end0 = torch.minimum(ins0, m0)
    # column 0 (a whole-read insertion) wins ties, then the first column at
    # the minimum; with no window column, column 0 is the only one
    cost_in = torch.cat([total, big_col], dim=1).amin(dim=1)
    first = torch.where(total == cost_in[:, None], cols, G + 1).amin(dim=1)
    cost = torch.minimum(cost_in, end0)
    end = torch.where(end0 <= cost_in, 0, first)
    return cost, end.to(i32)


def _plan(R: int, L: int, G: int, max_cpl: int = MAX_CPL):
    """How the kernel covers ``R`` jobs of windows ``G`` wide: ``(cpl,
    n_tiles, n_warps, scratch)``.  A warp holds ``32 * cpl`` columns in
    registers (``cpl`` even, at most ``max_cpl``); a wider window is cut into
    ``n_tiles`` column tiles of equal width, and then ``scratch`` int32 hold
    the two values per row that a tile hands to the next (``2 * L`` for every
    launched warp), and only ``n_warps`` warps are launched, each looping
    over jobs: at most ``MAX_WARPS``, and fewer for long reads, so that the
    scratch stays within ``SCRATCH_BYTES`` (or one block's rows, where even
    those are more).  Equal tiles over more than ``32 * MAX_CPL`` columns are
    at least ``MIN_TILED_CPL`` a lane wide."""
    n_tiles = max(1, -(-G // (32 * max_cpl)))
    cpl = max(2, 2 * -(-G // (64 * n_tiles)))
    if n_tiles == 1:
        return cpl, 1, R, 0
    fit = SCRATCH_BYTES // (8 * max(L, 1)) // WARPS_PER_BLOCK * WARPS_PER_BLOCK
    n_warps = min(R, MAX_WARPS, max(WARPS_PER_BLOCK, fit))
    launched = -(-n_warps // WARPS_PER_BLOCK) * WARPS_PER_BLOCK
    return cpl, n_tiles, n_warps, launched * 2 * L


def _glocal_screen_cuda(reads, lens, windows, wlens, s_mm, s_gapo, s_gape):
    R, L = reads.shape
    G = windows.shape[1]
    lib = KERNEL.lib()
    cost = torch.empty(R, dtype=torch.int32, device=reads.device)
    end = torch.empty(R, dtype=torch.int32, device=reads.device)
    if R == 0:                        # nothing to launch over
        return cost, end
    cpl, n_tiles, n_warps, n_scratch = _plan(R, L, G)
    scratch = torch.empty(max(n_scratch, 1), dtype=torch.int32,
                          device=reads.device) if n_tiles > 1 else None
    with torch.cuda.device(reads.device):
        stream = torch.cuda.current_stream(reads.device).cuda_stream
        err = lib.hsa_glocal_screen(
            reads.data_ptr(), lens.data_ptr(), windows.data_ptr(),
            wlens.data_ptr(), cost.data_ptr(), end.data_ptr(),
            None if scratch is None else scratch.data_ptr(), R, L, G, cpl,
            n_tiles, n_warps, s_mm, s_gapo, s_gape, stream)
    if err:
        raise RuntimeError(f"glocal_screen kernel launch failed: CUDA error "
                           f"{err} at R={R} L={L} G={G}")
    KERNEL.count_launch((R, L, G))
    return cost, end


def glocal_screen(reads, lens, windows, wlens, s_mm: int, s_gapo: int,
                  s_gape: int):
    """(cost [R], end [R]) int32 of each read's best glocal placement in
    its window (module doc)."""
    _check(reads, lens, windows, wlens)
    if reads.device.type == "cpu":
        return glocal_screen_plain(reads, lens, windows, wlens, s_mm, s_gapo,
                                   s_gape)
    if reads.device.type != "cuda":
        raise ValueError(f"glocal_screen: unsupported device {reads.device}")
    return _glocal_screen_cuda(reads, lens, windows, wlens, s_mm, s_gapo,
                               s_gape)
