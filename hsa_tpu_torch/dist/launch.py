"""Start a world of rank processes on this host and wait for all of them.

``run_world(argv, n)`` starts ``n`` copies of ``argv`` with three more
arguments each, ``RANK WORLD_SIZE ADDRESS`` (``127.0.0.1:<free port>``),
for :func:`hsa_tpu_torch.dist.init_multihost`.  Processes are started
fresh (never forked: a parent that has touched CUDA cannot fork a rank
that uses it).  The world fails as a whole: if any rank exits non-zero or
the world outlives ``timeout`` seconds, every rank still running is killed
and ``RuntimeError`` carries each rank's exit code and the end of its
output.  Ranks return their results through files of their own.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time

# rank 0's store could not bind the port: another process took it between
# free_port() and the bind, so the world is started again on a new port
_PORT_TAKEN = "EADDRINUSE"
_ATTEMPTS = 3


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(argv, world_size, timeout, env, cwd, tmp):
    """One attempt -> (exit codes, each rank's output, timed out)."""
    addr = f"127.0.0.1:{free_port()}"
    logs = [open(os.path.join(tmp, f"{r}.log"), "w+")
            for r in range(world_size)]
    procs = [subprocess.Popen([*argv, str(r), str(world_size), addr],
                              stdout=log, stderr=subprocess.STDOUT, env=env,
                              cwd=cwd)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while True:
            rcs = [p.poll() for p in procs]       # every rank, each round
            if None not in rcs or any(rcs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    return [p.returncode for p in procs], outs, timed_out


def run_world(argv, world_size: int, *, timeout: float, env=None,
              cwd=None) -> None:
    """Run ``argv + [rank, world_size, address]`` for every rank and wait;
    raise ``RuntimeError`` unless every rank exits 0 within ``timeout``."""
    env = dict(os.environ if env is None else env)
    for _ in range(_ATTEMPTS):
        with tempfile.TemporaryDirectory() as tmp:
            rcs, outs, timed_out = _start(argv, world_size, timeout, env, cwd,
                                          tmp)
        if not timed_out and not any(rcs):
            return
        if timed_out or _PORT_TAKEN not in outs[0]:
            break
    why = f"timed out after {timeout} s" if timed_out else "a rank failed"
    tails = "\n".join(f"--- rank {r} (exit {rc}) output:\n{out[-3000:]}"
                      for r, (rc, out) in enumerate(zip(rcs, outs)))
    raise RuntimeError(f"world of {world_size} ranks ({' '.join(argv)}): "
                       f"{why}; exit codes {rcs}\n{tails}")
