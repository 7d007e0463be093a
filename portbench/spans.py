"""The measured window, and the spans and counters the benchmark records
from its own code around the calls into each layer of the port.

The aligner's methods are wrapped on its instance.  Every run counts the
batches finished (``_align_occ`` / ``_align_pe_occ``) and the escalations
(``_pigeon_retry``, ``_beam_rerun``): a yield after which every finished
batch has been yielded leaves nothing staged, and only at such a yield does
the window open or close, so that a pooled flush is counted whole or not at
all.  With ``trace`` each call is also kept as a span (name, thread, start,
end), and ``torch.profiler`` records the device over the window.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import Counter

from . import bounds

# layer -> the aligner's method, by mode
METHODS = {
    "se": {"search": "_align_device", "finish": "_align_occ",
           "resolve": "_resolve_occ", "retry": "_pigeon_retry",
           "beam": "_beam_rerun"},
    "pe": {"search": "_pe_search", "finish": "_align_pe_occ",
           "resolve": "_resolve_pe", "rescue": "_rescue",
           "retry": "_pigeon_retry", "beam": "_beam_rerun"},
}
COUNTED = ("finish", "retry", "beam")


class Recorder:
    def __init__(self, al, paired: bool, trace: bool):
        self.al = al
        self.paired = paired
        self.trace = trace
        self.lock = threading.Lock()
        self.calls = Counter()
        self.spans = []
        self.methods = METHODS["pe" if paired else "se"]
        for label, meth in self.methods.items():
            if trace or label in COUNTED:
                setattr(al, meth, self._wrap(label, getattr(al, meth)))

    def _wrap(self, label, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                t1 = time.perf_counter()
                with self.lock:
                    self.calls[label] += 1
                    if self.trace:
                        self.spans.append((label, threading.get_ident(), t0,
                                           t1))
        return wrapped

    def detach(self):
        for meth in self.methods.values():
            self.al.__dict__.pop(meth, None)

    def _stats(self):
        al = self.al
        return (al.last_fallback_frac, al.last_retry_frac, al.last_trunc_frac,
                getattr(al, "last_rescue_jobs", 0), al._pigeon_profile)

    def run_window(self, stream, seconds, params, t_start, tmp, device):
        """Warm the stream up (at least ``warm_batches`` yields and one pooled
        escalation, or ``warm_max_batches`` yields), then measure from one
        clean yield to the first clean yield ``seconds`` later; with
        ``trace``, under the profiler."""
        yielded = 0
        sam_bytes = 0

        def take():
            # each batch's SAM text as the port's CLI writes it, encoded
            nonlocal yielded, sam_bytes
            s, (lines, _flags) = next(stream)
            yielded += 1
            sam_bytes += len(("\n".join(lines) + "\n").encode())
            return s, lines

        def clean():
            with self.lock:
                return self.calls["finish"] == yielded

        while True:
            take()
            escal = self.calls["retry"] + self.calls["beam"]
            if clean() and yielded >= params["warm_batches"] and (
                    escal > 0 or yielded >= params["warm_max_batches"]):
                break
        setup_s = time.perf_counter() - t_start
        cpu0 = os.times()
        # the traced run profiles the device over the whole window
        prof = Profile(device, tmp) if self.trace else None
        t_open = time.perf_counter()
        bytes0 = sam_bytes
        win = dict(setup_s=setup_s, t_open=t_open, yields=[], batches=[],
                   paired=self.paired, warm_escalations=escal,
                   main_thread=threading.get_ident())
        while True:
            s, lines = take()
            t = time.perf_counter()
            n = len(lines) // 2 if self.paired else len(lines)
            win["yields"].append((t, n, self._stats()))
            win["batches"].append((s, lines))
            if t - t_open >= seconds and clean():
                break
        # the window closes at its last yield, before the profiler's stop
        t_close = time.perf_counter()
        cpu1 = os.times()
        if prof is not None:
            prof.stop()
        win["cpu_user_s"] = cpu1.user - cpu0.user
        win["cpu_sys_s"] = cpu1.system - cpu0.system
        win["cpu_s"] = win["cpu_user_s"] + win["cpu_sys_s"]
        win.update(t_close=t_close, window_s=t_close - t_open,
                   units=sum(y[1] for y in win["yields"]),
                   sam_bytes=sam_bytes - bytes0,
                   n_batches=len(win["yields"]))
        if self.trace:
            with self.lock:
                win["spans"] = [sp for sp in self.spans
                                if sp[3] > t_open and sp[2] < t_close]
            win["profile"] = prof.read(win["spans"]) if prof else None
        return win


class Profile:
    """``torch.profiler`` over the device, from construction to ``stop()``,
    with the hand kernels' launch shapes counted over the same span."""

    def __init__(self, device, tmp):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        self.tmp = tmp
        self.kernels = bounds.hand_kernels()
        acts = [ProfilerActivity.CUDA] if device == "cuda" else \
            [ProfilerActivity.CPU]
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if device == "cuda":
            torch.cuda.synchronize()
        self.shapes0 = {k: Counter(v.launch_shapes)
                        for k, v in self.kernels.items()}
        self.t0 = time.perf_counter()
        self.epoch0 = time.time()
        self.done = False

    def stop(self):
        import torch
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.shapes = {k: Counter(v.launch_shapes) - self.shapes0[k]
                       for k, v in self.kernels.items()}
        self.prof.__exit__(None, None, None)
        self.done = True

    def read(self, spans):
        """Device busy seconds, the window, the kernels' device and least
        times, and the breakdown (top device operations, longest idle gaps
        by the host spans open across them)."""
        path = os.path.join(self.tmp, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as fh:
            tr = json.load(fh)
        os.remove(path)
        evs = [e for e in tr.get("traceEvents", [])
               if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        base = tr.get("baseTimeNanoseconds")
        # device timestamps on the host's perf_counter: the trace's µs are
        # since the epoch, or since ``baseTimeNanoseconds`` where given
        shift = (base / 1e3 if base is not None and evs
                 and evs[0]["ts"] < 1e14 else 0.0)
        off = self.t0 - self.epoch0        # perf_counter minus epoch seconds
        lo, hi = self.t0, self.t1
        if evs:
            first = min(e["ts"] for e in evs)
            if not lo - 1.0 <= (first + shift) * 1e-6 + off <= hi + 1.0:
                # a clock the epoch does not give: the first device event
                # is taken to start with the profiler
                shift, off = -first, lo
        iv, by_name = [], Counter()
        for e in evs:
            a = (e["ts"] + shift) * 1e-6 + off
            b = a + e.get("dur", 0) * 1e-6
            by_name[e["name"]] += e.get("dur", 0) * 1e-6
            a, b = max(a, lo), min(b, hi)
            if b > a:
                iv.append((a, b))
        iv.sort()
        merged = []
        for a, b in iv:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged)
        gaps, prev = Counter(), lo
        for a, b in merged + [[hi, hi]]:
            if a > prev:
                mid = (a + prev) / 2
                open_ = sorted({sp[0] for sp in spans if sp[2] <= mid <= sp[3]})
                gaps["+".join(open_) or "no span"] += a - prev
            prev = max(prev, b)
        kern_s = {k: sum(v for n, v in by_name.items() if any(
            f in n for f in bounds.KERNEL_FUNCS[k])) for k in self.kernels}
        least_s = {k: sum(c * bounds.least_s(k, shape)
                          for shape, c in self.shapes[k].items())
                   for k in self.kernels}
        return dict(busy_s=busy, window_s=hi - lo, events=len(evs),
                    kernel_s=kern_s, least_s=least_s,
                    launches={k: sum(v.values())
                              for k, v in self.shapes.items()},
                    breakdown={
                        "device_ops": [[n, v] for n, v in
                                       by_name.most_common(10)],
                        "idle_gaps": [[n, v] for n, v in
                                      gaps.most_common(10)]})
