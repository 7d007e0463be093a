"""Timing and command line of the probes: the counterparts of ``rb``,
``wait_idle``, ``timeit`` and ``timeit_sync`` of the TPU probes
(``tools/gather_probe2.py:30-53``, ``tools/gather_probe.py:37-45``).

On the card a timed call is bracketed by CUDA events and followed by
``torch.cuda.synchronize()``; on the CPU (only when asked for) by the host
clock.  Times are seconds per call.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..index.layout import resolve_device


def _first_tensor(x):
    while isinstance(x, (tuple, list)):
        x = x[0]
    return x


def rb(x):
    """Read back the first two elements of ``x`` (or of its first leaf)."""
    return _first_tensor(x).flatten()[:2].cpu().numpy()


def wait_idle(dev, limit_s=60.0, quiet=True):
    """Synchronise, then check that a trivial operation and its readback
    return within 50 ms; retry (printing why) until ``limit_s``."""
    t_start = time.perf_counter()
    while True:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rb(torch.arange(8, device=dev) * 2)
        dt = time.perf_counter() - t0
        if dt < 0.05:
            if not quiet:
                print(f"[idle] device responsive ({dt * 1e3:.1f} ms)")
            return
        print(f"[idle] busy ({dt:.1f}s readback); retrying")
        if time.perf_counter() - t_start > limit_s:
            raise RuntimeError("device never went idle")


def _device_of(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def timeit(fn, *args, iters=8, warm=1):
    """Seconds per call over ``iters`` calls queued back to back, after
    ``warm`` calls and a synchronise (``gather_probe.py``'s ``timeit``)."""
    dev = _device_of(args)
    for _ in range(warm):
        out = fn(*args)
    rb(out)
    if dev.type == "cuda":
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(iters):
            out = fn(*args)
        e1.record()
        torch.cuda.synchronize(dev)
        return e0.elapsed_time(e1) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    rb(out)
    return (time.perf_counter() - t0) / iters


def timeit_sync(fn, *args, iters=6, warm=2):
    """Mean seconds per call, each call bracketed by CUDA events and
    synchronised before the next (``gather_probe2.py``'s ``timeit_sync``)."""
    dev = _device_of(args)
    for _ in range(warm):
        rb(fn(*args))
    total = 0.0
    for _ in range(iters):
        if dev.type == "cuda":
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            fn(*args)
            e1.record()
            torch.cuda.synchronize(dev)
            total += e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            rb(fn(*args))
            total += time.perf_counter() - t0
    return total / iters


def ints(a: np.ndarray, dev):
    """int32 numpy array -> int32 tensor on ``dev``."""
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def equal_rows(r, tab: np.ndarray, q: np.ndarray) -> bool:
    """The probes' own check: ``r`` equals ``tab[q]`` (numpy, on the host)."""
    return np.array_equal(r.cpu().numpy().view(np.uint32),
                          tab.astype(np.uint32)[q])


def main(tests, argv, doc, default=None, headers=True):
    """``[--device cuda|cpu] [test ...]``: run the named tests (all, or
    ``default``) on the device, each after ``--- name`` when ``headers``."""
    ap = argparse.ArgumentParser(description=doc.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("tests", nargs="*", metavar="test",
                    help=f"any of {', '.join(tests)}")
    a = ap.parse_args(argv)
    bad = [nm for nm in a.tests if nm not in tests]
    if bad:
        ap.error(f"unknown test {bad}; choose from {', '.join(tests)}")
    dev = resolve_device(a.device)
    wait_idle(dev)
    for nm in a.tests or default or list(tests):
        if headers:
            print(f"--- {nm}", flush=True)
        tests[nm](dev)
