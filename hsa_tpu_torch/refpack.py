"""The native ``hsa_tpu.refpack`` library, loaded for the port, or an error.

``hsa_tpu.refpack`` builds ``librefpack.so`` at first use with ``make``,
which writes the library in place, and remembers a failed load for the
rest of the process (``_build_failed``), falling back to numpy from then
on.  Processes that start together on a fresh checkout (test workers, for
one) each run that ``make``; one of them can open the library while
another is still writing it ("file too short") and stays on numpy for
good.  The port has no numpy fallback: its index build is native only at
genome scale, and its mate rescue traces back with ``glocal_batch``.

:func:`ensure_refpack` builds the library under an exclusive lock, in a
directory of its own, and moves it into place with ``os.replace``, so a
reader never sees a partial file.  It forgets a failed load that this
process cached earlier, loads again, and raises if the library still
cannot be loaded.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile

from hsa_tpu import refpack

from .kernels.build import BUILD_DIR

_SOURCES = ("Makefile", "refpack.cpp", "sais.hpp")


def _build():
    """``make`` in a scratch copy of the sources, then an atomic move."""
    tmp = tempfile.mkdtemp(prefix="refpack.", dir=BUILD_DIR)
    try:
        for name in _SOURCES:
            shutil.copy2(os.path.join(refpack._DIR, name), tmp)
        r = subprocess.run(["make", "-C", tmp, "-s", "librefpack.so"],
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError(f"make of the native refpack library failed "
                               f"(rc {r.returncode}):\n{r.stderr[-2000:]}")
        os.replace(os.path.join(tmp, "librefpack.so"), refpack._SO)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def ensure_refpack():
    """The loaded native library (a ``ctypes.CDLL``); raises if it cannot be
    built or loaded.  Never falls back to numpy."""
    if refpack._lib is not None:
        return refpack._lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "refpack.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        # a second round rebuilds: the file found may be another process's
        # in-place make, still being written
        for rebuild in (not os.path.exists(refpack._SO), True):
            if rebuild:
                _build()
            refpack._build_failed = False      # forget a failed earlier load
            if refpack._load() is not None:
                return refpack._lib
    raise RuntimeError(f"the native refpack library {refpack._SO} does not "
                       "load")


def glocal_batch(*args):
    """``hsa_tpu.refpack.glocal_batch`` (the native glocal DP with
    traceback) on the library that :func:`ensure_refpack` loads."""
    ensure_refpack()
    return refpack.glocal_batch(*args)
