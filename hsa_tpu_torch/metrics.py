"""Run metrics, structured logging and the tracer (SURVEY.md §5
observability row).

The reference's only observability is stderr progress lines; here every
pipeline run can emit a structured JSON metrics file: read counts, mapped
fractions, per-stage wall time, and the beam-overflow counters — the
parity-risk signal called out in SURVEY.md §7.3.1 (a nonzero overflow on a
read means its hit set may be incomplete at the configured beam width).

The tracer is process-wide and off by default.  Where it is on
(:func:`enable`), :func:`span` records a named interval of the calling
thread on :data:`clock` (``time.perf_counter_ns``), with its parent (the
innermost span open on the same thread), the batch it serves (the batch's
first read ordinal, from :func:`batch` or the parent) and the pooled flush
it belongs to; :func:`stage` opens the next of a run of consecutive child
spans.  Records stay in per-thread lists until :func:`collect` reads
them.  Where it is off, :func:`span` and :func:`batch` return the shared
:data:`NOOP` and nothing else happens: no object, no clock reading, no
record.
"""

from __future__ import annotations

import functools
import itertools
import json
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

clock = time.perf_counter_ns

_on = False
_gen = 0                    # enable() count: a thread's stale records go
_listener = None
_local = threading.local()
_threads: list = []         # every thread's record since the last enable()
_reg = threading.Lock()     # held only when a thread first records
_ids = itertools.count(1)


class _Noop:
    """What :func:`span` and :func:`batch` return where the tracer is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


NOOP = _Noop()


class _Thread:
    """One thread's open spans and its records."""

    __slots__ = ("tid", "gen", "stack", "spans", "batch")

    def __init__(self):
        self.tid = threading.get_ident()
        self.gen = _gen
        self.stack = []
        self.spans = []
        self.batch = None


def _rec() -> _Thread:
    r = getattr(_local, "rec", None)
    if r is None or r.gen != _gen:
        r = _local.rec = _Thread()
        with _reg:
            _threads.append(r)
    return r


class Span:
    """A span of the calling thread, open from ``__enter__`` to
    ``__exit__``.  ``batch`` and ``flush`` are inherited from the parent
    where not given; any other attribute is the caller's."""

    __slots__ = ("name", "id", "parent", "tid", "t0", "t1", "batch", "flush",
                 "attrs", "stage", "_thread")

    def __init__(self, name, attrs, stage=False):
        self.name = name
        self.batch = attrs.pop("batch", None) if attrs else None
        self.flush = attrs.pop("flush", None) if attrs else None
        self.attrs = attrs or None
        self.stage = stage
        self.t1 = None

    def __bool__(self):
        return True

    def set(self, **attrs):
        if "batch" in attrs:
            self.batch = attrs.pop("batch")
        if "flush" in attrs:
            self.flush = attrs.pop("flush")
        if attrs:
            if self.attrs is None:
                self.attrs = {}
            self.attrs.update(attrs)

    def __enter__(self):
        r = self._thread = _rec()
        st = r.stack
        p = st[-1] if st else None
        self.id = next(_ids)
        self.tid = r.tid
        self.parent = p.id if p is not None else None
        if self.batch is None:
            self.batch = p.batch if p is not None else r.batch
        if self.flush is None and p is not None:
            self.flush = p.flush
        st.append(self)
        if _listener is not None:
            _listener("open", self)
        self.t0 = clock()
        # listed only once it has a start: collect() reads the lists from
        # another thread
        r.spans.append(self)
        return self

    def __exit__(self, *exc):
        st = self._thread.stack
        # a run of stages inside this span ends with it
        while st and st[-1] is not self and st[-1].stage:
            st[-1].__exit__(None, None, None)
        if _listener is not None:
            _listener("close", self)
        self.t1 = clock()
        if st and st[-1] is self:
            st.pop()
        elif self in st:
            st.remove(self)
        return False

    def record(self) -> dict:
        return dict(name=self.name, id=self.id, parent=self.parent,
                    tid=self.tid, t0=self.t0, t1=self.t1, batch=self.batch,
                    flush=self.flush, attrs=dict(self.attrs or {}))


def span(name: str, **attrs):
    """A span named ``name`` (a context manager); :data:`NOOP` where the
    tracer is off."""
    if not _on:
        return NOOP
    return Span(name, attrs)


def stage(name: str | None, **attrs):
    """Close the calling thread's open stage, if its innermost span is one,
    and open the stage ``name`` (none for None).  The stages of a span are
    its children one after another; the last ends with the span, or with
    ``stage(None)``."""
    if not _on:
        return
    r = _rec()
    if r.stack and r.stack[-1].stage:
        r.stack[-1].__exit__(None, None, None)
    if name is not None:
        Span(name, attrs, stage=True).__enter__()


def traced(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*a, **k):
            if not _on:
                return fn(*a, **k)
            with Span(name, None):
                return fn(*a, **k)
        return call
    return wrap


def note(**attrs):
    """Set attributes on the calling thread's innermost open span."""
    if _on:
        st = _rec().stack
        if st:
            st[-1].set(**attrs)


class _Batch:
    __slots__ = ("s", "prev")

    def __init__(self, s):
        self.s = s

    def __enter__(self):
        r = _rec()
        self.prev, r.batch = r.batch, self.s
        return self

    def __exit__(self, *exc):
        _rec().batch = self.prev
        return False


def batch(s: int):
    """Context: the calling thread's spans without a parent serve the batch
    whose first read ordinal is ``s``."""
    if not _on:
        return NOOP
    return _Batch(s)


def enable(listener=None):
    """Turn the tracer on with empty records.  ``listener(event, span)``,
    where given, is called where a span opens (``"open"``, before its start
    is read) and closes (``"close"``, before its end is read)."""
    global _on, _gen, _listener
    with _reg:
        _gen += 1
        _threads.clear()
    _listener = listener
    _on = True


def disable():
    """Turn the tracer off; the records stay for :func:`collect`."""
    global _on, _listener
    _on = False
    _listener = None


def enabled() -> bool:
    return _on


def collect() -> dict:
    """The records since :func:`enable`: ``spans``, dicts in start order
    with ``t0`` and ``t1`` in nanoseconds of :data:`clock` (``t1`` None
    where still open)."""
    with _reg:
        threads = list(_threads)
    spans = [s.record() for r in threads for s in list(r.spans)]
    spans.sort(key=lambda s: s["t0"])
    return dict(spans=spans)


def totals(records: dict | None = None) -> dict:
    """Seconds and count of each span name (closed spans), by name."""
    out: dict = {}
    for s in (records or collect())["spans"]:
        if s["t1"] is not None:
            e = out.setdefault(s["name"], {"s": 0.0, "n": 0})
            e["s"] += (s["t1"] - s["t0"]) / 1e9
            e["n"] += 1
    return {k: {"s": round(v["s"], 6), "n": v["n"]}
            for k, v in sorted(out.items())}


@dataclass
class RunMetrics:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    timers: dict = field(default_factory=lambda: defaultdict(float))
    config: dict = field(default_factory=dict)
    started: int = field(default_factory=clock)
    # seconds and count of each span name (the tracer, where it was on)
    spans: dict = field(default_factory=dict)

    def count(self, name: str, n: int = 1):
        self.counters[name] += int(n)

    @contextmanager
    def timer(self, name: str):
        t0 = clock()
        try:
            yield
        finally:
            self.timers[name] += (clock() - t0) / 1e9

    def log(self, msg: str):
        print(f"[hsa-tpu] {msg}", file=sys.stderr)

    batches: list = field(default_factory=list)

    def note_batch(self, n_reads: int, records, overflow=None, flags=None,
                   aligner=None):
        """``records`` may be AlnRecords, or SAM lines with ``flags`` the
        parallel flag list (the direct-emission fast path).  ``aligner``
        (optional) snapshots its per-batch engine stats — capacity
        profile, fallback/truncation/retry fractions — into a per-batch
        series (VERDICT r4 weak #5 observability)."""
        self.count("reads_in", n_reads)
        if flags is not None:
            mapped = sum(1 for f in flags if not (f & 4))
        else:
            mapped = sum(1 for r in records if not (r.flag & 4))
        self.count("records_out", len(records))
        self.count("reads_mapped", mapped)
        if overflow is not None:
            live_drop, hit_drop = overflow
            self.count("beam_overflow_reads", int((live_drop > 0).sum()))
            self.count("beam_overflow_states", int(live_drop.sum()))
            self.count("hitbuf_overflow_reads", int((hit_drop > 0).sum()))
        if aligner is not None:
            self.batches.append(dict(
                n=n_reads,
                profile=getattr(aligner, "_pigeon_profile", "base"),
                fallback=round(getattr(aligner, "last_fallback_frac",
                                       0.0), 4),
                trunc=round(getattr(aligner, "last_trunc_frac", 0.0), 4),
                retry=round(getattr(aligner, "last_retry_frac", 0.0), 4)))

    def summary(self) -> dict:
        out = dict(self.counters)
        out.update({f"t_{k}_s": round(v, 3) for k, v in self.timers.items()})
        out["wall_s"] = round((clock() - self.started) / 1e9, 3)
        if out.get("reads_in"):
            out["mapped_frac"] = round(out.get("reads_mapped", 0)
                                       / out["reads_in"], 4)
        if self.batches:
            out["batches"] = self.batches
        if self.spans:
            out["spans"] = self.spans
        out["config"] = self.config
        return out

    def dump(self, path: str | None):
        s = self.summary()
        if path:
            with open(path, "w") as fh:
                json.dump(s, fh, indent=1)
        return s
