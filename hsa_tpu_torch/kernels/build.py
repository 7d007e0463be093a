"""Build a CUDA source of the package into a shared library and load it.

Each ``csrc/*.cu`` file exports plain C functions.  At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into ``hsa_tpu_torch/_build/``
(listed in ``.gitignore``) and loaded with ``ctypes``; the library's name
carries a hash of the source and flags, so an edited source never loads a
stale build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin): the CUDA kernels cannot be built")


class CudaKernel:
    """One ``csrc`` source: its library, built once per process, and the
    launch count that its Python wrapper keeps."""

    def __init__(self, source: str, declare):
        self.source = os.path.join(CSRC_DIR, source)
        self._declare = declare          # sets argtypes/restype on the CDLL
        self._lib = None
        self._lock = threading.Lock()
        self.launches = 0
        # launches by what count_launch was given (the launch's shape); read
        # only by chip_smoke.py, to time a kernel at the shapes the main
        # paths gave it
        self.launch_shapes = Counter()
        self.build_log = ""
        self.build_s = None              # seconds spent in nvcc, None if cached

    def lib(self):
        if self._lib is None:            # the lock only until the first build
            with self._lock:
                if self._lib is None:
                    self._lib = self._build()
        return self._lib

    def count_launch(self, shape=None):
        with self._lock:
            self.launches += 1
            if shape is not None:
                self.launch_shapes[shape] += 1

    def _build(self):
        with open(self.source, "rb") as fh:
            src = fh.read()
        digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
        stem = os.path.splitext(os.path.basename(self.source))[0]
        so = os.path.join(BUILD_DIR, f"lib{stem}_{digest[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, capture_output=True, text=True)
            self.build_s = time.perf_counter() - t0
            self.build_log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source} "
                                   f"(rc {r.returncode}):\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        self._declare(lib)
        return lib


def launch(name, fn, out, args):
    """``fn(*args, stream)`` on the current stream of ``out``'s card, under
    a device guard only when that card is not the current one; raises on a
    CUDA error.  The stream is the raw handle, as torch's own compiled
    kernels take it, with no ``torch.cuda.Stream`` built.  Imports torch
    here, so that the native host code's build can import this module
    without it."""
    import torch
    idx = out.get_device()
    if idx == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    else:
        with torch.cuda.device(idx):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
