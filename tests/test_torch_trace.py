"""The port's tracer (``hsa_tpu_torch/metrics.py``) on the CPU: off, it is
one shared no-op that records nothing and reads no clock; on, spans nest
per thread with their parents, batches and flushes, the served streams
give the same SAM as untraced, every stage of the resolvers lies under its
``resolve``, a pooled flush's patch resolve under ``stream.flush``, and
the main thread's spans follow one another without overlap.  The streams
are the small corpora of ``test_torch_pigeon_pipeline.py`` and
``test_torch_pe_stream.py``; every check is of structure, none of
durations."""

import importlib.util
import json
import os
import sys
import threading
import time

import numpy as np
import pytest

from hsa_tpu_torch import cli as tcli
from hsa_tpu_torch import metrics
from hsa_tpu_torch.alphabet import revcomp
from hsa_tpu_torch.pipeline import Aligner as TAligner
from test_torch_pe_pigeon import CAPS
from test_torch_pe_pigeon import OPT as PE_OPT
from test_torch_pe_pigeon import fam  # noqa: F401 (fixture)
from test_torch_pe_stream import _stream_batches
from test_torch_pigeon import OPT_GAP, sample_reads
from test_torch_pigeon_pipeline import TINY
from test_torch_pigeon_pipeline import divergent  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the main thread's spans that no other span holds
MAIN_TOP = {"stream.wait_input", "stream.wait_search", "finish.occ",
            "resolve", "stream.flush", "stream.splice", "stream.yield"}
SEARCH_STAGES = ["search.upload", "search.anchor", "search.extend",
                 "search.order_slots", "search.compact", "search.locate",
                 "search.verify", "search.gapped"]


@pytest.fixture
def tracer():
    """The tracer on for one test, and off after it whatever happens."""
    metrics.enable()
    try:
        yield metrics
    finally:
        metrics.disable()


def _traced(run):
    """``run()`` with the tracer on: (its result, the records)."""
    metrics.enable()
    try:
        out = run()
    finally:
        metrics.disable()
    return out, metrics.collect()


def test_off_records_nothing_and_span_is_the_shared_noop(monkeypatch):
    metrics.enable()
    metrics.disable()

    def no_clock():
        raise AssertionError("a clock reading while the tracer is off")

    monkeypatch.setattr(metrics, "clock", no_clock)
    assert not metrics.enabled()
    for sp in (metrics.span("resolve"), metrics.span("stream.flush", batch=3,
                                                     reads=7)):
        assert sp is metrics.NOOP and not sp
        with sp as inner:
            assert inner is metrics.NOOP
            inner.set(flush=1)
    assert metrics.batch(5) is metrics.NOOP
    metrics.stage("resolve.prep")
    metrics.stage(None)
    metrics.note(steps=3)

    @metrics.traced("finish.occ")
    def f(x):
        return x + 1

    assert f(1) == 2
    rec = metrics.collect()
    assert rec == dict(spans=[])


def test_nesting_parents_stages_batches_and_threads(tracer):
    events = []
    tracer.disable()
    tracer.enable(listener=lambda ev, sp: events.append((ev, sp.name)))
    with tracer.batch(100):
        with tracer.span("finish.occ"):
            pass
        with tracer.span("resolve", jobs=1) as r:
            tracer.stage("resolve.prep")
            tracer.note(rows=4)
            tracer.stage("resolve.cores")
            with tracer.span("inner"):
                pass
            tracer.stage("resolve.emit")
        assert r.attrs == dict(jobs=1)
    with tracer.span("stream.flush", flush=7, batches=[100, 200]):
        with tracer.span("fallback.beam"):
            tracer.stage("fallback.beam.search")
            tracer.stage(None)

    def worker(s):
        with tracer.batch(s):
            with tracer.span("search.pack"):
                pass
            tracer.stage("search.upload")
            tracer.stage("search.anchor")
            tracer.stage(None)
            with tracer.span("search.fetch"):
                pass

    ts = [threading.Thread(target=worker, args=(s,)) for s in (200, 300)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    with tracer.span("stream.yield", batch=100):
        rec = tracer.collect()
    spans = {(s["name"], s["batch"]): s for s in rec["spans"]}
    by_id = {s["id"]: s for s in rec["spans"]}
    main = threading.get_ident()
    res = spans["resolve", 100]
    assert res["parent"] is None and res["attrs"] == dict(jobs=1)
    kids = [s for s in rec["spans"] if s["parent"] == res["id"]]
    assert [s["name"] for s in kids] == ["resolve.prep", "resolve.cores",
                                         "resolve.emit"]
    assert kids[0]["attrs"] == dict(rows=4)
    assert by_id[spans["inner", 100]["parent"]]["name"] == "resolve.cores"
    # a run of stages tiles its parent; the last ends with it
    assert kids[0]["t0"] >= res["t0"] and kids[-1]["t1"] <= res["t1"]
    for a, b in zip(kids, kids[1:]):
        assert a["t1"] <= b["t0"]
    # the flush's id is inherited, its batches are an attribute
    fl = spans["stream.flush", None]
    assert fl["flush"] == 7 and fl["attrs"] == dict(batches=[100, 200])
    beam = spans["fallback.beam", None]
    st = spans["fallback.beam.search", None]
    assert beam["parent"] == fl["id"] and st["parent"] == beam["id"]
    assert beam["flush"] == st["flush"] == 7
    assert st["t1"] < beam["t1"]
    # each worker's spans: its own thread, its own batch, no parent
    for s in (200, 300):
        ws = [x for x in rec["spans"] if x["batch"] == s]
        assert [x["name"] for x in ws] == ["search.pack", "search.upload",
                                           "search.anchor", "search.fetch"]
        assert len({x["tid"] for x in ws}) == 1
        assert ws[0]["tid"] != main
        assert all(x["parent"] is None for x in ws)
    # a span still open reads no end
    assert spans["stream.yield", 100]["t1"] is None
    assert spans["finish.occ", 100]["tid"] == main
    # the listener saw each span open and close, stages in turn
    main_ev = [e for e in events if e[1] in ("resolve", "resolve.prep",
                                             "resolve.cores", "resolve.emit")]
    assert main_ev == [("open", "resolve"), ("open", "resolve.prep"),
                       ("close", "resolve.prep"), ("open", "resolve.cores"),
                       ("close", "resolve.cores"), ("open", "resolve.emit"),
                       ("close", "resolve.emit"), ("close", "resolve")]


def test_traced_function_and_enable_clears(tracer):
    @metrics.traced("finish.occ")
    def f():
        metrics.note(n=1)
        return 5

    assert f() == 5
    assert [(s["name"], s["attrs"]) for s in tracer.collect()["spans"]] == \
        [("finish.occ", dict(n=1))]
    tracer.enable()
    assert tracer.collect()["spans"] == []


def test_collect_while_workers_open_spans():
    """``collect`` on one thread while others open and close spans lists
    only spans that have their start.  The listener widens the window
    between a span's opening and its start's reading."""
    def slow_open(event, sp):
        if event == "open":
            time.sleep(0.0002)

    def worker(s):
        with metrics.batch(s):
            for _ in range(100):
                with metrics.span("search.pack"):
                    with metrics.span("search.fetch"):
                        pass

    n = 2 * (os.cpu_count() or 4)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    metrics.enable(listener=slow_open)
    ts = [threading.Thread(target=worker, args=(s,)) for s in range(n)]
    try:
        for t in ts:
            t.start()
        reads = 0
        while any(t.is_alive() for t in ts):
            for s in metrics.collect()["spans"]:
                assert isinstance(s["t0"], int), s
            reads += 1
    finally:
        for t in ts:
            t.join(timeout=120)
        metrics.disable()
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    rec = metrics.collect()
    assert reads > 0 and len(rec["spans"]) == n * 2 * 100
    assert all(s["t1"] >= s["t0"] for s in rec["spans"])


def _check_main_thread(rec, main):
    """The main thread's outermost spans are the stream's layers and follow
    one another without overlap; every span's parent is on its thread;
    every ``resolve.*`` lies under a ``resolve``."""
    by_id = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        assert s["t1"] is not None and s["t1"] >= s["t0"], s
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["tid"] == s["tid"] and p["t0"] <= s["t0"]
            assert s["t1"] <= p["t1"]
        if s["name"].startswith("resolve."):
            assert by_id[s["parent"]]["name"] == "resolve", s
    top = sorted((s for s in rec["spans"] if s["tid"] == main
                  and s["parent"] is None), key=lambda s: s["t0"])
    assert {s["name"] for s in top} <= MAIN_TOP
    for a, b in zip(top, top[1:]):
        assert a["t1"] <= b["t0"], (a, b)
    return by_id, top


def _check_search_stages(rec, main, batches):
    """Each searched batch's worker spans: pack, the engine's stages in
    order, fetch, all on one thread other than the main one."""
    for s in batches:
        ws = [x for x in rec["spans"] if x["batch"] == s
              and x["name"].startswith("search.")]
        assert [x["name"] for x in ws] == (["search.pack"] + SEARCH_STAGES
                                           + ["search.fetch"]), s
        assert len({x["tid"] for x in ws}) == 1 and ws[0]["tid"] != main


@pytest.mark.parametrize("emit", ["sam", "records"])
def test_align_stream_traced_is_untraced(divergent, emit):  # noqa: F811
    """``test_torch_pigeon_pipeline.py``'s pooled stream: a flush with a
    seg_phase retry, a beam and one patch resolve."""
    caps = dict(TINY, _PIGEON_RETRY_CAPS=(6, 8, 4))
    long_read = divergent.text[41_000:41_200].copy()
    rs = np.random.RandomState(3)
    clean = sample_reads(divergent.text, rs, 4, L=90, lo=45_000, hi=59_000)
    reads = divergent.reads + [long_read] + clean

    def run():
        ta = TAligner.from_arrays(divergent.di, divergent.text, opt=OPT_GAP,
                                  engine="auto", device="cpu")
        for k, v in caps.items():
            setattr(ta, k, v)
        gen = ((s, None, reads[s:s + 5], None) for s in (0, 5, 10))
        out = list(ta.align_stream(gen, emit=emit, fb_group=2))
        return [(s, p if emit == "sam" else [r.to_sam() for r in p])
                for s, p in out]

    want = run()
    got, rec = _traced(run)
    assert got == want
    main = threading.get_ident()
    by_id, top = _check_main_thread(rec, main)
    _check_search_stages(rec, main, (0, 5, 10))
    names = [s["name"] for s in top]
    assert names.count("stream.yield") == 3
    assert [s["batch"] for s in top if s["name"] == "stream.yield"] == \
        [0, 5, 10]
    for s in (0, 5, 10):
        assert [x["name"] for x in top if x["batch"] == s
                and x["name"] in ("finish.occ", "resolve")] == \
            ["finish.occ", "resolve"]
    # the pooled flush: its retry, its beam and the patch resolve inside
    flushes = [s for s in top if s["name"] == "stream.flush"]
    assert len(flushes) == 1
    fl = flushes[0]
    assert fl["flush"] is not None and fl["attrs"]["batches"] == [0, 5]
    assert fl["attrs"]["retry_reads"] > 0
    kids = [s["name"] for s in rec["spans"] if s["parent"] == fl["id"]]
    assert kids == ["fallback.retry", "fallback.beam", "resolve"]
    patch = [s for s in rec["spans"] if s["parent"] == fl["id"]
             and s["name"] == "resolve"][0]
    assert patch["flush"] == fl["flush"] and patch["batch"] is None
    beam = [s for s in rec["spans"] if s["parent"] == fl["id"]
            and s["name"] == "fallback.beam"][0]
    parts = [s for s in rec["spans"] if s["parent"] == beam["id"]]
    assert [s["name"] for s in parts] == ["fallback.beam.search",
                                          "fallback.beam.locate"]
    assert parts[0]["attrs"]["reads"] >= 1 and parts[0]["attrs"]["steps"] > 0
    assert parts[0]["attrs"]["padded"] >= parts[0]["attrs"]["reads"]
    assert "located" in parts[1]["attrs"]
    # the retry's own pigeon search, on the main thread under it
    retry = [s for s in rec["spans"] if s["parent"] == fl["id"]
             and s["name"] == "fallback.retry"][0]
    assert [s["name"] for s in rec["spans"] if s["parent"] == retry["id"]] \
        == ["search.pack"] + SEARCH_STAGES + ["search.fetch"]


def test_align_pe_stream_traced_is_untraced(fam):  # noqa: F811
    """``test_torch_pe_stream.py``'s six batches, staged and clean in turn:
    the resolver's four stages, the rescue's jobs, the flushes."""
    batches = _stream_batches(fam, (1, "clean", "mixed", 3, "clean", 2))

    def run():
        ta = TAligner.from_arrays(fam.di, fam.text, opt=PE_OPT,
                                  engine="auto", device="cpu")
        for k, v in CAPS.items():
            setattr(ta, k, v)
        gen = ((100 * i, None, r1, None, r2, None)
               for i, (r1, r2) in enumerate(batches))
        return list(ta.align_pe_stream(gen, emit="sam", fb_group=2))

    want = run()
    got, rec = _traced(run)
    assert got == want
    main = threading.get_ident()
    by_id, top = _check_main_thread(rec, main)
    starts = [100 * i for i in range(6)]
    _check_search_stages(rec, main, starts)
    # each batch resolves right before its own yield
    res = [s for s in top if s["name"] in ("resolve", "stream.yield")]
    assert [(s["name"], s["batch"]) for s in res] == [
        (n, b) for b in starts for n in ("resolve", "stream.yield")]
    for r in (s for s in top if s["name"] == "resolve"):
        kids = [s for s in rec["spans"] if s["parent"] == r["id"]]
        assert [s["name"] for s in kids] == ["resolve.pair", "resolve.rescue",
                                             "resolve.cores", "resolve.emit"]
        assert all(k["batch"] == r["batch"] for k in kids)
        assert "jobs" in kids[1]["attrs"]
    assert sum(s["attrs"]["jobs"] for s in rec["spans"]
               if s["name"] == "resolve.rescue") > 0
    flushes = [s for s in top if s["name"] == "stream.flush"]
    staged = sorted(b for f in flushes for b in f["attrs"]["batches"])
    assert staged == [0, 200, 300, 500]
    assert len({f["flush"] for f in flushes}) == len(flushes)
    for f in flushes:
        kids = {s["name"] for s in rec["spans"] if s["parent"] == f["id"]}
        assert kids <= {"fallback.retry", "fallback.beam"} and kids
        assert all(s["flush"] == f["flush"] for s in rec["spans"]
                   if s["parent"] == f["id"])


def _fastq(path, reads):
    with open(path, "w") as fh:
        for j, r in enumerate(reads):
            fh.write(f"@r{j}\n{''.join('ACGT'[c] for c in r)}\n+\n"
                     f"{'I' * len(r)}\n")


@pytest.mark.parametrize("cmd", ["align", "align-pe"])
def test_cli_metrics_hold_the_span_totals(tmp_path, cmd):
    """With ``--metrics`` the command writes each span name's seconds and
    count; the tracer is off again after it; the SAM is the untraced one."""
    rs = np.random.RandomState(2)
    text = rs.randint(0, 4, 30_000).astype(np.int8)
    fa = tmp_path / "ref.fa"
    fa.write_text(">c\n" + "".join("ACGT"[c] for c in text) + "\n")
    assert tcli.main(["index", str(fa)]) == 0
    r1 = [text[p:p + 70].copy() for p in rs.randint(0, 29_000, 40)]
    r2 = [revcomp(text[p + 200:p + 270]) for p in rs.randint(0, 29_000, 40)]
    _fastq(tmp_path / "r1.fq", r1)
    _fastq(tmp_path / "r2.fq", r2)
    ins = ([str(tmp_path / "r1.fq")] if cmd == "align"
           else [str(tmp_path / "r1.fq"), str(tmp_path / "r2.fq")])
    sams = []
    for met in (None, str(tmp_path / "m.json")):
        out = tmp_path / f"{bool(met)}.sam"
        args = [cmd, str(fa)] + ins + ["--device", "cpu", "--batch", "16",
                                       "-f", str(out)]
        assert tcli.main(args + (["--metrics", met] if met else [])) == 0
        sams.append(out.read_text())
        assert not metrics.enabled()
    assert sams[0] == sams[1]
    spans = json.load(open(tmp_path / "m.json"))["spans"]
    for name in ("stream.wait_search", "finish.occ", "resolve",
                 "search.anchor", "stream.yield"):
        assert spans[name]["n"] == 3 and spans[name]["s"] >= 0, name
    stages = (["resolve.prep", "resolve.cores", "resolve.emit"]
              if cmd == "align" else
              ["resolve.pair", "resolve.rescue", "resolve.cores",
               "resolve.emit"])
    for name in stages:
        assert spans[name]["n"] == 3, name


def test_run_metrics_timer_reads_the_tracers_clock(monkeypatch):
    ticks = iter([10, 2_500_000_010, 2_600_000_010])
    monkeypatch.setattr(metrics, "clock", lambda: next(ticks))
    met = metrics.RunMetrics()
    with met.timer("resolve"):
        pass
    assert met.timers["resolve"] == 2.5
    assert "spans" not in met.summary()


def _chip_smoke():
    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pigeon_stages_reach_a_listener(divergent):  # noqa: F811
    """``pigeon_search``'s stages, where ``chip_smoke.py``'s profile phase
    listens for them: each opens after the one before closes, in the order
    and under the names that phase prints."""
    ta = TAligner.from_arrays(divergent.di, divergent.text, opt=OPT_GAP,
                              engine="auto", device="cpu")
    n_seg, elig = ta._pigeon_split(divergent.reads)
    buf, shape = ta._pigeon_pack(divergent.reads, n_seg)
    seen, open_ = [], []

    def on_span(event, sp):
        if event == "open":
            assert not open_
            open_.append(sp.name)
            seen.append(sp.name)
        else:
            assert open_ == [sp.name]
            open_.pop()

    metrics.enable(listener=on_span)
    try:
        ta._pigeon_device(buf, shape, n_seg)
    finally:
        metrics.disable()
    assert not open_ and seen == SEARCH_STAGES
    labels = _chip_smoke().PIGEON_STAGES
    assert list(labels) == SEARCH_STAGES
    assert [labels[s] for s in seen] == [
        "upload", "anchor", "extend", "order+slots", "compact", "locate",
        "window+verify", "gapped"]
