"""The port's adaptive beam ladder against ``hsa_tpu``'s, on the CPU:
``ladder_core`` rung by rung, ``finalize_ladder``, ``primary_ranks``,
``AdaptiveBeam`` (the twins of ``tests/test_adaptive.py``) and ``align``
with a ladder.  Integer work: tolerance 0."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu import alphabet
from hsa_tpu.config import AlnOpt
from hsa_tpu.index.layout import build_device_index
from hsa_tpu.pipeline import Aligner as JAligner
from hsa_tpu.search import adaptive as jad
from hsa_tpu.search import beam as jbeam
from hsa_tpu.search.widths import cal_width_device as jwidth
from hsa_tpu_torch.index.layout import to_device
from hsa_tpu_torch.kernels.select import SENT
from hsa_tpu_torch.pipeline import Aligner as TAligner
from hsa_tpu_torch.search import adaptive as tad
from hsa_tpu_torch.search import beam as tbeam


def _u32(x):
    """A raw result field of either package as uint32 on the host."""
    if isinstance(x, torch.Tensor):
        return x.numpy().view(np.uint32)
    return np.asarray(x).astype(np.uint32)


def assert_same_raw(want, got, what):
    """Keys, best score and both counters everywhere; the payload rows
    where the key is valid (dead slots carry arbitrary ranks)."""
    hkey = _u32(want.hkey)
    for f in ("hkey", "best_raw", "n_live_dropped", "n_hits_dropped"):
        np.testing.assert_array_equal(_u32(getattr(want, f)),
                                      _u32(getattr(got, f)), f"{what}.{f}")
    valid = hkey < SENT
    for f in ("hit_k", "hit_l", "hit_meta"):
        np.testing.assert_array_equal(_u32(getattr(want, f))[valid],
                                      _u32(getattr(got, f))[valid],
                                      f"{what}.{f}")


def assert_same_result(want, got):
    valid = np.asarray(want.hit_valid)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.shape == valid.shape and f != "hit_valid":
            a, b = np.where(valid, a, 0), np.where(valid, b, 0)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def repetitive():
    """A 200 bp unit 25 times over: narrow beams overflow on most reads.
    16 reads of 40 bp with one substitution, the last four from an iid
    tail (they never overflow)."""
    rs = np.random.RandomState(10)
    t = np.concatenate([np.tile(rs.randint(0, 4, 200), 25),
                        rs.randint(0, 4, 3000)]).astype(np.int8)
    di = build_device_index(t)
    rr = np.random.RandomState(9)
    reads = [t[p:p + 40].copy() for p in rr.randint(0, 4900, 12)]
    reads += [t[p:p + 40].copy() for p in rr.randint(5100, 7900, 4)]
    for r in reads:
        r[20] = (r[20] + 1) % 4
    fwd, lens = jbeam.pack_read_batch(reads)
    opt = AlnOpt(max_diff=2)
    md = np.full(len(reads), 2, np.int32)
    dj, dt = di.as_jax(), to_device(di, "cpu")
    D = np.asarray(jwidth(dj, jnp.asarray(fwd), jnp.asarray(lens)))
    return dict(dj=dj, dt=dt, fwd=fwd, lens=lens, D=D, md=md, opt=opt,
                reads=reads, text=t, di=di)


def _ladders(c, ladder, H, ESC):
    B = len(c["lens"])
    want = jad.ladder_core(c["dj"], jnp.asarray(c["fwd"]),
                           jnp.asarray(c["lens"]), jnp.asarray(c["D"]),
                           jnp.asarray(c["md"]), c["opt"], ladder, H, ESC, B)
    T = lambda x: torch.from_numpy(np.array(x)).long()
    got = tad.ladder_core(c["dt"], T(c["fwd"]), T(c["lens"]), T(c["D"]),
                          T(c["md"]), c["opt"], ladder, H, ESC, B)
    return want, got


@pytest.mark.parametrize("ESC", [2, 16])
def test_ladder_core_matches_jax(repetitive, ESC):
    """Rung by rung: raw results, escalation ids and their validity.  With
    ESC = 2 far more reads are flagged than a rung can take: the rest keep
    their results and stay flagged."""
    c = repetitive
    want, got = _ladders(c, (2, 8, 32), 4, ESC)
    assert len(got.raws) == 3 and len(got.esc_idx) == len(got.esc_valid) == 2
    for r, (w, g) in enumerate(zip(want.raws, got.raws)):
        assert tuple(g.hkey.shape) == (4, 16 if r == 0 else ESC)
        assert_same_raw(w, g, f"rung{r}")
    for w, g in zip(want.esc_idx, got.esc_idx):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    for w, g in zip(want.esc_valid, got.esc_valid):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())
    flagged0 = int(((_u32(got.raws[0].n_live_dropped) > 0)
                    | (_u32(got.raws[0].n_hits_dropped) > 0)).sum())
    assert flagged0 > 2
    if ESC == 2:
        assert got.esc_valid[0].all() and got.esc_idx[0].max() < 16
    else:
        # spare lanes carry the out-of-range fill and run as empty reads
        assert (got.esc_idx[0][flagged0:] == 16).all()
        assert not got.esc_valid[0][flagged0:].any()
    fj = jad.finalize_ladder(want, c["opt"].s_mm)
    ft = tad.finalize_ladder(got, c["opt"].s_mm)
    assert_same_result(fj, ft)
    assert_same_result(fj, tad.finalize_any(got, c["opt"].s_mm))
    still = (ft.n_live_dropped > 0) | (ft.n_hits_dropped > 0)
    if ESC == 2:
        # reads beyond the capacity stay flagged, at their rung-0 results
        first = tbeam.finalize_result(got.raws[0], c["opt"].s_mm)
        kept = np.setdiff1d(np.nonzero(still)[0],
                            np.concatenate([i.numpy() for i in got.esc_idx]))
        assert kept.size > 0
        for f in first._fields:
            np.testing.assert_array_equal(getattr(first, f)[kept],
                                          getattr(ft, f)[kept])
    np.testing.assert_array_equal(
        np.asarray(jad.primary_ranks(want, 16)).astype(np.int64),
        tad.primary_ranks(got, 16).numpy())
    np.testing.assert_array_equal(
        np.asarray(jad.primary_ranks(want.raws[0], 16)).astype(np.int64),
        tad.primary_ranks(got.raws[0], 16).numpy())
    assert (tad.primary_ranks(got, 16) > 0).sum() >= 12


def test_ladder_matches_flat_top_width():
    """tests/test_adaptive.py's case through the port: wherever neither run
    overflowed at the top width the hit sets agree; and the port's ladder
    equals the reference's."""
    t = np.random.RandomState(7).randint(0, 4, 60_000).astype(np.int8)
    di = build_device_index(t)
    dt = to_device(di, "cpu")
    opt = AlnOpt(max_diff=2)
    rs = np.random.RandomState(1)
    B, L = 48, 60
    fwd = np.full((B, L), 5, np.uint8)
    for j in range(B):
        p = rs.randint(0, len(t) - L)
        r = t[p:p + L].copy()
        r[rs.randint(0, L)] = (r[rs.randint(0, L)] + 1) % 4
        fwd[j] = r
    lens = np.full(B, L, np.int32)
    md = np.full(B, 2, np.int32)
    from hsa_tpu_torch.search.widths import cal_width_device as twidth
    D = twidth(dt, torch.from_numpy(fwd).long(), torch.from_numpy(lens))
    T = lambda x: torch.from_numpy(x).long()
    flat = tad.finalize_any(
        tbeam.beam_search(dt, T(fwd), T(lens), D, T(md), opt, beam_width=512,
                          max_hits=16), opt.s_mm)
    ladder = tad.finalize_any(
        tad.AdaptiveBeam(dt, opt, ladder=(8, 64, 512), max_hits=16,
                         esc_frac=1.0)(fwd, lens, D.numpy(), md), opt.s_mm)

    def hitsets(res):
        return [{(int(res.hit_score[j, h]), int(res.hit_k[j, h]),
                  int(res.hit_l[j, h]))
                 for h in range(res.hit_valid.shape[1]) if res.hit_valid[j, h]}
                for j in range(B)]

    flat_sets, lad_sets = hitsets(flat), hitsets(ladder)
    flat_of = (flat.n_live_dropped > 0) | (flat.n_hits_dropped > 0)
    lad_of = (ladder.n_live_dropped > 0) | (ladder.n_hits_dropped > 0)
    for j in range(B):
        if not flat_of[j] and not lad_of[j]:
            assert flat_sets[j] == lad_sets[j], j
    assert lad_of.mean() <= flat_of.mean() + 1e-9
    assert sum(map(len, lad_sets)) >= B
    want = jad.finalize_any(
        jad.AdaptiveBeam(di.as_jax(), opt, ladder=(8, 64, 512), max_hits=16,
                         esc_frac=1.0)(fwd, lens, D.numpy().astype(np.int32),
                                       md), opt.s_mm)
    assert_same_result(want, ladder)


def test_ladder_single_rung_equals_beam():
    t = np.random.RandomState(9).randint(0, 4, 20_000).astype(np.int8)
    dt = to_device(build_device_index(t), "cpu")
    opt = AlnOpt(max_diff=1, max_gapo=0)
    rs = np.random.RandomState(2)
    B, L = 16, 40
    fwd = np.full((B, L), 5, np.uint8)
    for j in range(B):
        p = rs.randint(0, len(t) - L)
        fwd[j] = t[p:p + L]
    lens = np.full(B, L, np.int32)
    md = np.full(B, 1, np.int32)
    D = np.zeros((B, L), np.int32)
    T = lambda x: torch.from_numpy(x).long()
    a = tad.finalize_any(tad.AdaptiveBeam(dt, opt, ladder=(64,), max_hits=8)(
        fwd, lens, D, md), opt.s_mm)
    b = tad.finalize_any(tbeam.beam_search(dt, T(fwd), T(lens), T(D), T(md),
                                           opt, beam_width=64, max_hits=8),
                         opt.s_mm)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a.hit_valid.any(axis=1).all()


def test_align_batch_with_a_ladder_matches_jax(repetitive):
    """``search_device`` routes ``ladder`` to the adaptive beam (capacity
    B/8 = 2 a rung, so reads overflow it)."""
    c = repetitive
    hj, rj = jbeam.align_batch(c["dj"], c["reads"], c["opt"], max_hits=4,
                               ladder=(2, 8))
    ht, rt = tbeam.align_batch(c["dt"], c["reads"], c["opt"], max_hits=4,
                               ladder=(2, 8))
    assert_same_result(rj, rt)
    from dataclasses import astuple
    assert [[astuple(h) for h in hits] for hits in ht] == \
        [[astuple(h) for h in hits] for hits in hj]
    assert ((rt.n_live_dropped > 0) | (rt.n_hits_dropped > 0)).sum() > 2


@pytest.mark.parametrize("engine", ["beam", "auto"])
def test_align_with_a_ladder_sam_byte_equal(repetitive, engine):
    """``Aligner(ladder=(8, 64))``: on the beam route every read climbs the
    ladder; on ``auto`` the reads the router refuses (200 bp, and 40 bp at
    the default budget) go straight to its widest rung, beside three 70 bp
    reads on the pigeon engine."""
    c = repetitive
    rs = np.random.RandomState(4)
    reads = [r.copy() for r in c["reads"][8:]]
    for p in rs.randint(5100, 7700, 3):
        reads.append(c["text"][p:p + 200].copy())
        reads.append(alphabet.revcomp(c["text"][p + 20:p + 90]))
    names = [f"q{j}" for j in range(len(reads))]
    quals = ["I" * len(r) for r in reads]
    ja = JAligner.from_arrays(c["di"], c["text"], ladder=(8, 64),
                              engine=engine)
    ta = TAligner.from_arrays(c["di"], c["text"], ladder=(8, 64),
                              engine=engine, device="cpu")
    want = [r.to_sam() for r in ja.align(reads, names, quals)]
    got = [r.to_sam() for r in ta.align(reads, names, quals)]
    assert got == want
    assert sum(int(s.split("\t")[1]) & 4 == 0 for s in got) >= 12
    np.testing.assert_array_equal(ta.last_overflow[0], ja.last_overflow[0])
    np.testing.assert_array_equal(ta.last_overflow[1], ja.last_overflow[1])
    if engine == "auto":
        assert ta.last_ineligible_frac == ja.last_ineligible_frac == 11 / 14
