"""The port's native host library: ctypes loader and wrappers.

Counterpart of ``hsa_tpu/refpack/__init__.py``.  The sources are the port's
own copies, ``csrc/refpack.cpp`` and ``csrc/sais.hpp`` (SA-IS index build,
2-bit packing, the banded and glocal DPs, the FASTQ batcher, the pigeon
batch packer).  :func:`ensure_refpack` builds
``librefpack.so`` from them at first use into ``hsa_tpu_torch/_build/``
(listed in ``.gitignore``) and loads it from there.  Beside it lies
``librefpack.so.sha256``, a digest of the sources, the compiler flags and
the host's CPU flags (``-march=native`` binds the binary to them): a library
whose digest differs, because a source was edited or the build directory
came from another host, is rebuilt and never loaded.

Processes that start together on a fresh checkout (test workers, for one)
would each compile, and one could open the library while another is still
writing it.  So the build runs under an exclusive ``flock``, in a scratch
directory, and the library is moved into place with ``os.replace``: a
reader never sees a partial file, and the digest is written after it.  A
file that does not load is rebuilt once.  When the build or the load fails, :func:`ensure_refpack` raises:
the numpy fallbacks of the reference's wrapper are not part of the port,
whose index build is native only at genome scale and whose mate rescue
traces back with :func:`glocal_batch`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

from .kernels.build import BUILD_DIR, CSRC_DIR

_SOURCES = ("refpack.cpp", "sais.hpp")
_SO = os.path.join(BUILD_DIR, "librefpack.so")
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native")
_lib = None


def _digest() -> str:
    """sha256 over the sources, the flags and the host's CPU flags."""
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as fh:
            h.update(fh.read())
    h.update(" ".join((os.environ.get("CXX", "g++"), *CXXFLAGS)).encode())
    try:
        with open("/proc/cpuinfo") as fh:
            h.update(next((ln for ln in fh if ln.startswith("flags")),
                          "").encode())
    except OSError:
        pass
    return h.hexdigest()


def _built_digest() -> str | None:
    try:
        with open(_SO + ".sha256") as fh:
            return fh.read().strip()
    except OSError:
        return None


def _build(digest: str):
    """Compile a scratch copy of the sources, then an atomic move of the
    library and, after it, of its digest."""
    tmp = tempfile.mkdtemp(prefix="refpack.", dir=BUILD_DIR)
    try:
        for name in _SOURCES:
            shutil.copy2(os.path.join(CSRC_DIR, name), tmp)
        out = os.path.join(tmp, "librefpack.so")
        cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-shared", "-o", out,
               os.path.join(tmp, "refpack.cpp")]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"build of the native refpack library failed "
                               f"(rc {r.returncode}):\n{r.stderr[-2000:]}")
        with open(out + ".sha256", "w") as fh:
            fh.write(digest + "\n")
        os.replace(out, _SO)
        os.replace(out + ".sha256", _SO + ".sha256")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _declare(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rp_version.restype = ctypes.c_int
    lib.rp_suffix_array64.argtypes = [u8p, ctypes.c_int64, i64p]
    lib.rp_suffix_array64.restype = ctypes.c_int
    lib.rp_suffix_array64_force.argtypes = [u8p, ctypes.c_int64, i64p]
    lib.rp_suffix_array64_force.restype = ctypes.c_int
    lib.rp_build.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                             i64p, u8p, i64p, u8p, i64p, i64p]
    lib.rp_build.restype = ctypes.c_int
    lib.rp_pack_2bit.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.rp_pack_2bit.restype = ctypes.c_int
    lib.rp_unpack_2bit.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.rp_unpack_2bit.restype = ctypes.c_int
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.rp_fastq_batch.argtypes = [u8p, ctypes.c_int64, i64p,
                                   ctypes.c_int32, ctypes.c_int32,
                                   u8p, i32p, i64p, i32p, i64p, i32p]
    lib.rp_fastq_batch.restype = ctypes.c_int
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.rp_pigeon_pack.argtypes = [u8p, i32p, i32p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int32,
                                   ctypes.c_int32, ctypes.c_int32, u32p]
    lib.rp_pigeon_pack.restype = ctypes.c_int
    lib.rp_glocal_batch.argtypes = [u8p, i64p, i32p, u8p, i64p, i32p,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32,
                                    u8p, ctypes.c_int32, i32p, i32p, i32p]
    lib.rp_glocal_batch.restype = ctypes.c_int
    lib.rp_banded_global.argtypes = [u8p, ctypes.c_int32, u8p,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, u8p, i32p, i32p, i32p]
    lib.rp_banded_global.restype = ctypes.c_int


def ensure_refpack():
    """The loaded native library (a ``ctypes.CDLL``); raises if it cannot be
    built or loaded.  Never falls back to numpy."""
    global _lib
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "refpack.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        digest = _digest()
        # a second round rebuilds: the file found may be cut short
        for rebuild in (not os.path.exists(_SO)
                        or _built_digest() != digest, True):
            if rebuild:
                _build(digest)
            try:
                lib = ctypes.CDLL(_SO)
                _declare(lib)
            except (OSError, AttributeError):
                continue
            _lib = lib
            return _lib
    raise RuntimeError(f"the native refpack library {_SO} does not load")


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def suffix_array(text: np.ndarray) -> np.ndarray:
    """SA of text+$ by the native SA-IS."""
    lib = ensure_refpack()
    t = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(t) + 1, dtype=np.int64)
    rc = lib.rp_suffix_array64(_u8(t), len(t), _i64(sa))
    if rc != 0:
        raise RuntimeError(f"rp_suffix_array64 failed: {rc}")
    return sa


def suffix_array_force64(text: np.ndarray) -> np.ndarray:
    """Test hook: int64 SA-IS instantiation regardless of size (the one a
    genome over 2^31 bp takes)."""
    lib = ensure_refpack()
    t = np.ascontiguousarray(text, dtype=np.uint8)
    sa = np.empty(len(t) + 1, dtype=np.int64)
    rc = lib.rp_suffix_array64_force(_u8(t), len(t), _i64(sa))
    if rc != 0:
        raise RuntimeError(f"rp_suffix_array64_force failed: {rc}")
    return sa


def build(text: np.ndarray, sa_intv: int = 32, want_sa: bool = False):
    """Fused native build: (sa|None, bwt, primary, marks, samples).

    ``marks`` is uint8[n+1] over ranks (SA[r] % sa_intv == 0), ``samples``
    the marked SA values in rank order — the text-position-sampled locate
    structure that ``fm.locate`` walks.
    """
    t = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(t)
    lib = ensure_refpack()
    sa = np.empty(n + 1, dtype=np.int64) if want_sa else None
    bwt = np.empty(n, dtype=np.uint8)
    primary = np.empty(1, dtype=np.int64)
    marks = np.empty(n + 1, dtype=np.uint8)
    samples = np.empty(n // sa_intv + 2, dtype=np.int64)
    n_samples = np.empty(1, dtype=np.int64)
    rc = lib.rp_build(_u8(t), n, sa_intv,
                      _i64(sa) if sa is not None else None,
                      _u8(bwt), _i64(primary), _u8(marks), _i64(samples),
                      _i64(n_samples))
    if rc != 0:
        raise RuntimeError(f"rp_build failed: {rc}")
    return sa, bwt, int(primary[0]), marks, samples[:int(n_samples[0])].copy()


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    t = np.ascontiguousarray(codes, dtype=np.uint8)
    out = np.empty((len(t) + 3) // 4, dtype=np.uint8)
    ensure_refpack().rp_pack_2bit(_u8(t), len(t), _u8(out))
    return out


def pigeon_upload_shape(B: int, Lmax: int, n_seg: int, K: int, tail: int):
    """(buffer_words, (R, SL, B2, RW)) of the fused pigeon upload layout."""
    B2 = 2 * B
    seg_max = (Lmax + n_seg - 1) // n_seg + 1
    SL = max(min(seg_max - K, tail) if K else seg_max, 1)
    RW = (Lmax + 15) // 16 + 1
    S4 = (SL + 3) // 4
    R = n_seg * B2
    return R * S4 + 2 * R + 2 * B2 * RW + B2, (R, SL, B2, RW)


def pigeon_pack(codes: np.ndarray, lens: np.ndarray, md: np.ndarray,
                n_seg: int, K: int, tail: int):
    """Native both-strand pigeon batch pack -> (uint32 buffer, shape).

    ``codes`` uint8 [B, Lmax] forward-strand reads; the reverse-complement
    lanes [B, 2B) are generated in C.  Bit-identical to
    ``pack_pigeon_batch(device_masks=True)`` + ``pack_pigeon_upload``
    (tested).
    """
    lib = ensure_refpack()
    c = np.ascontiguousarray(codes, np.uint8)
    ln = np.ascontiguousarray(lens, np.int32)
    mdv = np.ascontiguousarray(md, np.int32)
    B, Lmax = c.shape
    if ln.shape != (B,) or mdv.shape != (B,):
        raise ValueError("pigeon_pack: lens and md must have one entry a read")
    words, shape = pigeon_upload_shape(B, Lmax, n_seg, K, tail)
    buf = np.empty(words, np.uint32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u32 = ctypes.POINTER(ctypes.c_uint32)
    rc = lib.rp_pigeon_pack(_u8(c), ln.ctypes.data_as(i32),
                            mdv.ctypes.data_as(i32), B, Lmax, n_seg, K,
                            tail, buf.ctypes.data_as(u32))
    if rc != 0:
        raise RuntimeError(f"rp_pigeon_pack failed: {rc}")
    return buf, shape


_OPS = ("M", "I", "D")


def banded_global(read: np.ndarray, ref: np.ndarray, s_mm: int, s_gapo: int,
                  s_gape: int, band: int):
    """Native banded global DP -> (cost, cigar, jend).

    The alignment starts at (0, 0), the read is fully consumed and the end
    column is free; traceback prefers M over D over I on ties.
    """
    lib = ensure_refpack()
    r = np.ascontiguousarray(read, np.uint8)
    g = np.ascontiguousarray(ref, np.uint8)
    L, G = len(r), len(g)
    ops = np.empty(L + G + 2, np.uint8)
    n_ops = np.zeros(1, np.int32)
    cost = np.zeros(1, np.int32)
    jend = np.zeros(1, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    rc = lib.rp_banded_global(_u8(r), L, _u8(g), G, s_mm, s_gapo, s_gape,
                              band, _u8(ops), n_ops.ctypes.data_as(i32),
                              cost.ctypes.data_as(i32),
                              jend.ctypes.data_as(i32))
    if rc != 0:
        raise RuntimeError(f"rp_banded_global failed: {rc}")
    cigar = []
    for op in ops[:int(n_ops[0])]:
        c = _OPS[op]
        if cigar and cigar[-1][0] == c:
            cigar[-1] = (c, cigar[-1][1] + 1)
        else:
            cigar.append((c, 1))
    return int(cost[0]), cigar, int(jend[0])


def banded_batch(reads_buf: np.ndarray, r_off: np.ndarray, r_len: np.ndarray,
                 text: np.ndarray, g_off: np.ndarray, g_len: np.ndarray,
                 s_mm: int, s_gapo: int, s_gape: int, bands: np.ndarray):
    """Batched native banded DP + gapped record stats.

    One C call for every gapped record core of a batch, in place of a
    ctypes round trip per record.  ``reads_buf`` is a flat uint8 code
    buffer addressed by ``r_off``; ``text`` likewise by ``g_off`` (no
    window copies).  Returns (cigar_strs, md_strs, nm,
    glen, gap_bases) with cigar_stats-identical semantics.
    """
    lib = ensure_refpack()
    n = int(len(r_len))
    z = np.zeros(0, np.int32)
    if n == 0:
        return [], [], z, z, z
    rb = (reads_buf.view(np.uint8) if reads_buf.dtype.itemsize == 1
          and reads_buf.flags.c_contiguous
          else np.ascontiguousarray(reads_buf, np.uint8))
    t8 = (text.view(np.uint8) if text.dtype.itemsize == 1
          and text.flags.c_contiguous
          else np.ascontiguousarray(text, np.uint8))
    r_off = np.ascontiguousarray(r_off, np.int64)
    g_off = np.ascontiguousarray(g_off, np.int64)
    r_len = np.ascontiguousarray(r_len, np.int32)
    g_len = np.ascontiguousarray(g_len, np.int32)
    bands = np.ascontiguousarray(bands, np.int32)
    span = int(r_len.max()) + int(g_len.max())
    cig_cap = 4 * span + 16
    md_cap = 6 * span + 16
    cig = np.empty((n, cig_cap), np.uint8)
    md = np.empty((n, md_cap), np.uint8)
    cig_n = np.zeros(n, np.int32)
    md_n = np.zeros(n, np.int32)
    nm = np.zeros(n, np.int32)
    glen = np.zeros(n, np.int32)
    gapb = np.zeros(n, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.rp_banded_batch(
        _u8(rb), r_off.ctypes.data_as(i64), r_len.ctypes.data_as(i32),
        _u8(t8), g_off.ctypes.data_as(i64), g_len.ctypes.data_as(i32),
        n, s_mm, s_gapo, s_gape, bands.ctypes.data_as(i32),
        _u8(cig), cig_cap, cig_n.ctypes.data_as(i32),
        _u8(md), md_cap, md_n.ctypes.data_as(i32),
        nm.ctypes.data_as(i32), glen.ctypes.data_as(i32),
        gapb.ctypes.data_as(i32))
    if rc != 0:
        raise RuntimeError(f"rp_banded_batch failed: {rc}")
    cbytes = cig.tobytes()
    mbytes = md.tobytes()
    cigs = [cbytes[i * cig_cap:i * cig_cap + int(cig_n[i])].decode()
            for i in range(n)]
    mds = [mbytes[i * md_cap:i * md_cap + int(md_n[i])].decode()
           for i in range(n)]
    return cigs, mds, nm, glen, gapb


def unpack_2bit(packed: np.ndarray, n: int) -> np.ndarray:
    p = np.ascontiguousarray(packed, dtype=np.uint8)
    out = np.empty(n, dtype=np.uint8)
    ensure_refpack().rp_unpack_2bit(_u8(p), n, _u8(out))
    return out


def glocal_batch(reads_buf: np.ndarray, r_off: np.ndarray, r_len: np.ndarray,
                 text: np.ndarray, w_off: np.ndarray, w_len: np.ndarray,
                 s_mm: int, s_gapo: int, s_gape: int):
    """Batched native glocal DP (free ref start/end, full read) — the
    mate-rescue aligner (lineage: ``bwa_paired_sw``/``stdaln.c``).

    Exact twin of ``resolve.sampe.fit_in_window`` (tested
    equal on cost/start/ops).  ``reads_buf`` is a flat uint8 code buffer
    addressed by ``r_off``; windows are TEXT SLICES addressed by
    ``w_off``/``w_len`` (no copies).  Returns (cost int32[n],
    start int32[n], ops list of uint8 arrays with 0=M 1=I 2=D).
    """
    lib = ensure_refpack()
    n = int(len(r_len))
    if n == 0:
        z = np.zeros(0, np.int32)
        return z, z, []
    rb = np.ascontiguousarray(reads_buf, np.uint8)
    t8 = (text.view(np.uint8) if text.dtype.itemsize == 1
          and text.flags.c_contiguous
          else np.ascontiguousarray(text, np.uint8))
    r_off = np.ascontiguousarray(r_off, np.int64)
    r_len = np.ascontiguousarray(r_len, np.int32)
    w_off = np.ascontiguousarray(w_off, np.int64)
    w_len = np.ascontiguousarray(w_len, np.int32)
    ops_cap = int(r_len.max()) + int(w_len.max()) + 8
    ops = np.empty((n, ops_cap), np.uint8)
    n_ops = np.zeros(n, np.int32)
    cost = np.zeros(n, np.int32)
    start = np.zeros(n, np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    rc = lib.rp_glocal_batch(
        _u8(rb), r_off.ctypes.data_as(i64), r_len.ctypes.data_as(i32),
        _u8(t8), w_off.ctypes.data_as(i64), w_len.ctypes.data_as(i32),
        n, s_mm, s_gapo, s_gape, _u8(ops), ops_cap,
        n_ops.ctypes.data_as(i32), cost.ctypes.data_as(i32),
        start.ctypes.data_as(i32))
    if rc != 0:
        raise RuntimeError(f"rp_glocal_batch failed: {rc}")
    return cost, start, [ops[i, :n_ops[i]].copy() for i in range(n)]
