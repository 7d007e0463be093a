"""The table of peaks and each hand kernel's least time, copied from the
arithmetic of ``chip_smoke.py`` (``select_bound_ms``, ``glocal_compare``,
``extend_compare``, ``verify_compare``, ``gapped_compare``).

A bound is the larger of bytes over the memory rate and int32 operations
over the integer rate.  The ``*_bound_s`` functions take the terms that
depend on the data (distinct rows, reads, valid keys, DP cells) as
arguments; :func:`least_s` fills them with the least the launch shape
allows, so that a share of the roofline computed from launch shapes alone
never counts more work than the launch did.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s; int32 lanes, 132 SMs x 64,
# at the 1,980 MHz maximum SM clock
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9

EXTEND_OPS_PER_END, EXTEND_OPS_PER_BASE = 4, 8
VERIFY_OPS_PER_WORD = 8
GAPPED_OPS_PER_POS = 16
GLOCAL_FUSED_PER_CELL = 4.5

# the device functions of each hand kernel, as the profiler names them
KERNEL_FUNCS = {
    "fm_extend": ("fm_extend_kernel",),
    "window_verify": ("window_verify_kernel",),
    "gapped_screen": ("gapped_screen_kernel",),
    "select_topk": ("select_topk_kernel", "select_topk_tall_kernel"),
    "glocal_screen": ("glocal_screen_kernel",),
}


def _t(nbytes, ops):
    return max(nbytes / HBM_BYTES_S, ops / INT32_OPS_S)


def extend_bound_s(B, kind, unique_rows):
    """One FM step of ``B`` lanes: the lanes' inputs, each distinct 32-byte
    occ row once, two int64 ends a base out."""
    four = kind == "extend4"
    nb = 4 if four else 1
    nbytes = B * 4 * (2 if four else 3) + 32 * unique_rows + B * 2 * nb * 8
    ops = B * (2 * EXTEND_OPS_PER_END + 2 * nb * EXTEND_OPS_PER_BASE)
    return _t(nbytes, ops)


def verify_bound_s(P, B, RW, G, reads):
    """``window_verify`` over ``P`` candidates of ``reads`` distinct reads."""
    DW = RW - 1
    nbytes = (P * (4 + 4 + 1 + 1) + reads * (4 * RW + 1) * 4
              + P * (DW + 2) * 4 + P * (1 + 8 + 1) + B * 8)
    return _t(nbytes, P * DW * VERIFY_OPS_PER_WORD)


def gapped_bound_s(GP, P, B, RW, G):
    DW = RW - 1
    nbytes = GP * (4 + (4 * RW + 1) * 4 + (DW + 2) * 4 + 2 * 4 * 8 + 8 + 1)
    return _t(nbytes, GP * G * 16 * DW * GAPPED_OPS_PER_POS)


def select_bound_s(C, B, K, window, n_pay, valid, picks):
    """Keys and window read once, the K + 1 key rows and K rows a payload
    written once, 4 bytes a pick a payload; a test a key and a comparison a
    valid key."""
    fixed = C * B * 4 + (B * 4 if window else 0) + (K + 1 + n_pay * K) * B * 4
    nbytes = fixed + n_pay * min(picks * 4, C * B * 4)
    return _t(nbytes, 2 * C * B + valid)


def glocal_bound_s(R, L, G, cells):
    """Reads, lengths, windows and results once (int32), and the DP's cells
    at 4.5 integer instructions each."""
    nbytes = 4 * (R * L + R + R * G + R) + 8 * R
    return _t(nbytes, cells * GLOCAL_FUSED_PER_CELL)


def least_s(kernel, shape):
    """The least time of one launch of ``kernel`` at ``shape`` (the
    wrapper's ``launch_shapes`` key): one distinct row or read, no payload,
    no valid key, no DP cell."""
    if kernel == "fm_extend":
        return extend_bound_s(shape[0], shape[1], 1)
    if kernel == "window_verify":
        return verify_bound_s(*shape, reads=1)
    if kernel == "gapped_screen":
        return gapped_bound_s(*shape)
    if kernel == "select_topk":
        C, B, K, window = shape
        return select_bound_s(C, B, K, window, 0, 0, 0)
    if kernel == "glocal_screen":
        return glocal_bound_s(*shape, cells=0)
    raise KeyError(kernel)


def hand_kernels():
    """The port's hand kernels on the main paths, by name: their launch
    counters (``CudaKernel.launch_shapes``)."""
    from hsa_tpu_torch.kernels import extend, select, sw, verify
    return {"fm_extend": extend.KERNEL, "window_verify": verify.WINDOW_VERIFY,
            "gapped_screen": verify.GAPPED_SCREEN, "select_topk": select.KERNEL,
            "glocal_screen": sw.KERNEL}
