"""Builds ``hsa_tpu``'s native library once, under a lock on its Makefile,
before any test loads it.

``hsa_tpu.refpack`` runs ``make`` in place where the git-ignored library
is missing.  Under xdist every worker would do so at once, and a worker
that opens the file while another's ``make`` still writes it gives up on
the library for its whole life.  pytest loads this file in each process
before ``tests/conftest.py`` and before any test module, so the first
process builds and the others wait, then find the library.
"""

import fcntl
import os
import subprocess

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hsa_tpu",
                    "refpack")


def _build_reference_library():
    try:
        fd = os.open(os.path.join(_DIR, "Makefile"), os.O_RDONLY)
    except OSError:
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not os.path.exists(os.path.join(_DIR, "librefpack.so")):
            subprocess.run(["make", "-C", _DIR, "-s"], capture_output=True,
                           timeout=600)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        os.close(fd)


_build_reference_library()
