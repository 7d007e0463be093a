"""The port's staged ``align_pe_stream`` against ``hsa_tpu``'s, on the CPU:
batches with ``seg_phase`` retries or beam fallbacks are staged unresolved,
one pooled retry and one pooled beam run per flush, a clean batch between
staged ones, each batch's own statistics after its yield, and the worker
threads beside the flush.  Every SAM byte-equal (tolerance 0).  The inputs
are ``test_torch_pe_pigeon.py``'s: 8 pairs of 70 bp a batch on the diverged
repeat family at small caps."""

import sys

import pytest

from hsa_tpu.pipeline import Aligner as JAligner
from hsa_tpu_torch.pipeline import Aligner as TAligner
from test_torch_pe_pigeon import (FRACS, OPT, _aligners, _mixed_batch, _spy,
                                  fam, mk_batch)  # noqa: F401 (fixture)


def _stream_batches(g, kinds):
    out = []
    for i, kind in enumerate(kinds):
        if kind == "clean":
            out.append(mk_batch(g, 10 + i, n_fam=0))
        elif kind == "mixed":
            out.append(_mixed_batch(g))
        else:
            out.append(mk_batch(g, kind))
    return out


@pytest.mark.parametrize("kinds,knobs,pools", [
    # the reference's own case: three staged batches, one flush
    ((1, 2, 3), dict(fb_group=3, fb_flush=10_000), 1),
    # a clean batch between two staged ones flushes mid-stream
    (("mixed", "clean", 1), dict(), 2),
    # the pending count reaches fb_flush at the second batch
    ((3, "mixed", "clean"), dict(fb_flush=4), 1),
])
def test_align_pe_stream_pooled(fam, kinds, knobs, pools):
    """Pooled escalations give the records of per-batch ``align_pe``, in
    input order, and each yield leaves that batch's own statistics."""
    batches = _stream_batches(fam, kinds)
    ja, ta = _aligners(fam)
    per_batch, jobs = [], []
    for i, (r1, r2) in enumerate(batches):
        recs = ta.align_pe(r1, r2, read_offset=100 * i)
        per_batch.append([r.to_sam() for r in recs])
        jobs.append(ta.last_rescue_jobs)

    def gen():
        for i, (r1, r2) in enumerate(batches):
            yield 100 * i, None, r1, None, r2, None

    want, stats = [], []
    for item in ja.align_pe_stream(gen(), emit="sam", **knobs):
        want.append(item)
        stats.append(tuple(getattr(ja, a) for a in FRACS))
    ja2, ta2 = _aligners(fam)
    calls = _spy(ta2)
    got, seen, seen_jobs = [], [], []
    for s, payload in ta2.align_pe_stream(gen(), emit="sam", **knobs):
        got.append((s, payload))
        seen.append(tuple(getattr(ta2, a) for a in FRACS))
        seen_jobs.append(ta2.last_rescue_jobs)
        assert ta2.last_overflow[0].shape == (16,)
    assert [s for s, _ in got] == [0, 100, 200]
    assert got == want
    assert [p[0] for _, p in got] == per_batch
    assert seen == stats and seen_jobs == jobs
    assert calls == dict(retry=pools, beam=pools)
    recs = list(ta2.align_pe_stream(gen(), **knobs))
    assert [[r.to_sam() for r in p] for _, p in recs] == per_batch
    if "mixed" in kinds:
        assert any("XT:Z:M" in ln for _, p in got for ln in p[0])
        assert any(seen_jobs) and any(st[1] > 0 for st in seen)


def test_align_pe_stream_beam_route_is_never_staged(fam):
    """``engine="beam"`` and batches without an eligible read resolve at
    once; the stream's knobs change nothing there."""
    batches = _stream_batches(fam, (1, "mixed"))
    ja = JAligner.from_arrays(fam.di, fam.text, opt=OPT, engine="beam")
    ta = TAligner.from_arrays(fam.di, fam.text, opt=OPT, engine="beam",
                              device="cpu")

    def gen():
        for i, (r1, r2) in enumerate(batches):
            yield 100 * i, None, r1, None, r2, None

    calls = _spy(ta)
    got = list(ta.align_pe_stream(gen(), emit="sam", fb_group=1))
    assert got == list(ja.align_pe_stream(gen(), emit="sam", fb_group=1))
    assert calls == dict(retry=0, beam=0) and ta.last_ineligible_frac == 1.0


def test_align_pe_stream_workers_and_flush_share_the_aligner(fam):
    """Searches run ahead on worker threads while the main thread flushes
    (pooled retry and beam on the same device state): with the interpreter
    switching threads every few bytecodes, six batches (staged and clean in
    turns) still give the records of per-batch ``align_pe``."""
    batches = _stream_batches(fam, (1, "clean", "mixed", 3, "clean", 2))
    ta = _aligners(fam)[1]
    per_batch = [[r.to_sam() for r in ta.align_pe(r1, r2, read_offset=100 * i)]
                 for i, (r1, r2) in enumerate(batches)]

    def gen():
        for i, (r1, r2) in enumerate(batches):
            yield 100 * i, None, r1, None, r2, None

    ta2 = _aligners(fam)[1]
    ta2._text_rows = ta2._ktabs = None       # the lazy builds race too
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        got = list(ta2.align_pe_stream(gen(), emit="sam", fb_group=2))
    finally:
        sys.setswitchinterval(before)
    assert [s for s, _ in got] == [0, 100, 200, 300, 400, 500]
    assert [p[0] for _, p in got] == per_batch
