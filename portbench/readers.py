"""What the per-layer metrics' readers share: a run's window record
(``spans.Recorder.run_window``) reduced to spans a batch, counters a unit,
and the profiled sub-window."""

from __future__ import annotations

# the layers that run on the stream's main thread (``rescue`` is inside
# ``resolve``)
MAIN = ("finish", "resolve", "retry", "beam")


def span_s_per_batch(win, *labels):
    """Seconds a yielded batch spent in the named spans (on any thread)."""
    if not win.get("spans") or not win["n_batches"]:
        return None
    tot = sum(t1 - t0 for lab, _tid, t0, t1 in win["spans"] if lab in labels)
    return tot / win["n_batches"]


def stream_self_s_per_batch(win):
    """The window's seconds not covered by the main thread's layer spans,
    a yielded batch."""
    if not win.get("spans") or not win["n_batches"]:
        return None
    lo, hi = win["t_open"], win["t_close"]
    busy = sum(min(t1, hi) - max(t0, lo) for lab, tid, t0, t1 in win["spans"]
               if tid == win["main_thread"] and lab in MAIN)
    return (hi - lo - busy) / win["n_batches"]


def escalated_share(win):
    """Percent of the batches' reads sent to the retry or the beam (the
    port's per-batch fractions, read after each yield)."""
    ys = win["yields"]
    units = sum(n for _t, n, _s in ys)
    if not units:
        return None
    return 100.0 * sum(n * (st[0] + st[1]) for _t, n, st in ys) / units


def rescue_jobs_per_kunit(win):
    ys = win["yields"]
    units = sum(n for _t, n, _s in ys)
    return 1000.0 * sum(st[3] for _t, _n, st in ys) / units if units else None


def kernels_roofline(win):
    """Percent: the hand kernels' least times over their device times in
    the profiled sub-window."""
    p = win.get("profile")
    if not p:
        return None
    dev = sum(p["kernel_s"].values())
    if dev <= 0:
        return None
    return 100.0 * sum(v for k, v in p["least_s"].items()
                       if p["kernel_s"][k] > 0) / dev


def idle_share(win):
    p = win.get("profile")
    if not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
