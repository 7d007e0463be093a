"""The port's gather probes (``hsa_tpu_torch/tools``) and their three kernels
(``hsa_tpu_torch/kernels/gather.py``, plain versions on the CPU) against the
TPU probes under ``tools/``, run as the JAX package's own tests run Pallas on
the CPU: in interpret mode.

Each TPU probe is imported by path, ``pallas_call`` is patched to add
``interpret=True``, and the probe's timer is replaced by a capture that runs
the jitted function once, at once (so that a kernel which reads its loop
variable at trace time sees the right one), records its arguments and its
output, and raises :class:`Captured`, which the probe's own ``try`` prints
as a failure and passes over.  The port's case for that launch must hand
its kernel the same arrays, and the port's plain version must give the
Pallas kernel's output bit for bit (tolerance 0).  The probes' library
bodies are held against their jitted JAX functions the same way: integer
ones bit for bit, float products to a relative 1e-5 (the sums run in
another order).
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hsa_tpu_torch.kernels import build, gather
from hsa_tpu_torch.tools import _timing as tm
from hsa_tpu_torch.tools import (gather_probe, gather_probe2, gather_probe3,
                                 occ_probe5, sync_probe)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"gather_probe": gather_probe, "gather_probe2": gather_probe2,
        "gather_probe3": gather_probe3, "sync_probe": sync_probe}


class Captured(Exception):
    """Raised in place of a timing once the call is recorded."""


def _tpu_probe(name):
    spec = importlib.util.spec_from_file_location(
        f"tpu_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    real = pl.pallas_call

    def pallas_call(*args, **kw):
        kw["interpret"] = True
        return real(*args, **kw)
    monkeypatch.setattr(pl, "pallas_call", pallas_call)


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def capture(monkeypatch, mod, run=True, stop=True):
    """Replace the probe's timers; each call is appended as (fn, numpy
    args, numpy output or None).  ``run``: call the function now;
    ``stop``: raise :class:`Captured` after, else return a time of 1 s."""
    calls = []

    def timer(fn, *args, **kw):
        calls.append((fn, [np.asarray(a) for a in args],
                      _np(fn(*args)) if run else None))
        if stop:
            raise Captured()
        return 1.0
    for name in ("timeit", "timeit_sync"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, timer)
    return calls


def _t(a):
    """numpy -> CPU tensor: uint32 as int32 bit patterns, int32 as is."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _u(t):
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


# ---------------------------------------------------------------------------
# the 14 pallas_calls, each at its probe's own shapes
KERNEL_TESTS = [("gather_probe", "dma"), ("gather_probe", "vmemtake"),
                ("gather_probe2", "dmapipe"), ("gather_probe2", "rowloop"),
                ("gather_probe2", "onehot"), ("gather_probe2", "vmemsize"),
                ("gather_probe3", "orig"), ("gather_probe3", "pow2"),
                ("gather_probe3", "unroll"), ("gather_probe3", "grid"),
                ("gather_probe3", "scoped"), ("gather_probe3", "wide"),
                ("sync_probe", "dma"), ("sync_probe", "vmemtake")]


@pytest.mark.parametrize("probe,test", KERNEL_TESTS,
                         ids=[f"{p}.{t}" for p, t in KERNEL_TESTS])
def test_pallas_kernel_equals_port(probe, test, interpret, monkeypatch,
                                   capsys):
    mod = _tpu_probe(probe)
    cases = PORT[probe].KERNEL_CASES[test]
    if test == "vmemsize":
        # the probe reads each table's kernel output back through rb()
        outs = []
        monkeypatch.setattr(mod, "rb", lambda x: outs.append(np.asarray(x)))
        getattr(mod, f"test_{test}")()
        calls = [(None, None, o) for o in outs]
    else:
        calls = capture(monkeypatch, mod)
        getattr(mod, f"test_{test}")()
    printed = capsys.readouterr().out.splitlines()
    assert len(calls) == len(cases) and len(printed) == len(cases), printed
    for case, (_, args, out), line in zip(cases, calls, printed):
        tab, q = case.make()
        if args is None:
            assert line == f"{case.label}: OK"
        else:
            assert line.endswith("FAILED Captured: "), line
            jq, jtab = args     # every probe's kernel takes (q, tab)
            np.testing.assert_array_equal(jq, q)
            np.testing.assert_array_equal(jtab, tab)
        assert out.dtype == np.uint32
        got = _u(case.run(_t(tab), _t(q)))
        np.testing.assert_array_equal(got, out)
        np.testing.assert_array_equal(case.expected(tab, q), out)
        np.testing.assert_array_equal(_u(case.run(_t(tab), _t(q), plain=True)),
                                      out)


def test_every_pallas_call_has_a_case():
    """One port case per pallas_call of the TPU probes, each naming the
    line of its pallas_call."""
    seen = set()
    for probe, test in KERNEL_TESTS:
        for case in PORT[probe].KERNEL_CASES[test]:
            path, line = case.replaces.split(":")
            with open(os.path.join(REPO, path)) as fh:
                assert "pl.pallas_call(" in fh.readlines()[int(line) - 1]
            assert case.kernel in gather.KERNELS
            seen.add(case.replaces)
    assert len(seen) == 14
    for probe, mod in PORT.items():
        assert set(mod.KERNEL_CASES) == {t for p, t in KERNEL_TESTS
                                         if p == probe}


# ---------------------------------------------------------------------------
# the probes' library bodies against their jitted JAX functions
# small inputs of the captured kinds: (shapes, scale, relative tolerance).
# onehot: sums of 32 products in another order.  matmul: 8 chained products,
# each about doubling the relative error of the last; at n = 256, values in
# [0, 16) stay near the chain's fixed point as the probe's n = 2048 in [0, 1)
# do, so nothing underflows.
SMALL = {"onehot": ([(4, 128, 32), (4, 32, 16)], 1.0, 1e-5),
         "matmul": ([(256, 256)], 16.0, 2e-3)}


LIBRARY = [
    # probe, test, port function, compare on: "captured" or a small size
    ("gather_probe", "rowscale", gather_probe.take_xor, "captured"),
    ("gather_probe", "flat",
     lambda t, q: torch.index_select(t, 0, q), "captured"),
    ("gather_probe", "colmajor", gather_probe.take_cols_xor, "captured"),
    ("gather_probe2", "widthscale", gather_probe.take_xor, "captured"),
    ("gather_probe2", "saturate", gather_probe2.take_xor07, "captured"),
    ("sync_probe", "take", gather_probe2.take_xor07, "captured"),
    ("sync_probe", "scan", sync_probe.chained_take, "captured"),
    ("sync_probe", "dispatch", sync_probe.tiny, "captured"),
    ("gather_probe", "onehot", gather_probe.onehot_chunks, "small"),
    ("sync_probe", "onehot", gather_probe.onehot_chunks, "small"),
    ("sync_probe", "matmul", sync_probe.matmul_chain, "small"),
]


@pytest.mark.parametrize("probe,test,port_fn,size", LIBRARY,
                         ids=[f"{p}.{t}" for p, t, _, _ in LIBRARY])
def test_library_body_equals_port(probe, test, port_fn, size, monkeypatch):
    mod = _tpu_probe(probe)
    calls = capture(monkeypatch, mod, run=size == "captured")
    with pytest.raises(Captured):
        getattr(mod, f"test_{test}")()
    (fn, args, out), = calls
    if size == "small":
        # the same jitted function on small inputs of the captured kinds
        rs = np.random.RandomState(7)
        shapes, scale, rtol = SMALL[test]
        args = [(rs.rand(*s) * scale).astype(np.float32) for s in shapes]
        out = np.asarray(fn(*args))
        got = port_fn(*[torch.from_numpy(a) for a in args]).numpy()
        np.testing.assert_allclose(got, out, rtol=rtol)
        return
    got = port_fn(*[_t(a) for a in args])
    np.testing.assert_array_equal(_u(got), out)


def test_sorts_equal_port(monkeypatch):
    """gather_probe's three sorts (keys, keys with values, argsort) and
    sync_probe's key-value sort, at the probes' 2^20 keys."""
    mod = _tpu_probe("gather_probe")
    calls = capture(monkeypatch, mod, stop=False)
    mod.test_sort()
    ports = [gather_probe.sort_keys, gather_probe.sort_pairs,
             gather_probe.argsort_keys]
    assert len(calls) == 3
    for port_fn, (_, args, out) in zip(ports, calls):
        got = port_fn(*[_t(a.astype(np.int32)) for a in args])
        got = [got] if isinstance(got, torch.Tensor) else list(got)
        want = [out] if isinstance(out, np.ndarray) else list(out)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
    smod = _tpu_probe("sync_probe")
    calls = capture(monkeypatch, smod, stop=False)
    smod.test_sort()
    (_, args, out), = calls
    got = gather_probe.sort_pairs(*[_t(a.astype(np.int32)) for a in args])
    for g, w in zip(got, out):
        np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))


# ---------------------------------------------------------------------------
# the port's probe modules, run as a user runs them, on the CPU
PORT_RUNS = [("gather_probe", ["dma", "vmemtake"]),
             ("gather_probe2", ["dmapipe", "rowloop", "onehot", "vmemsize"]),
             ("gather_probe3", []),
             ("sync_probe", ["dma", "vmemtake", "dispatch"])]


@pytest.mark.parametrize("probe,tests", PORT_RUNS,
                         ids=[p for p, _ in PORT_RUNS])
def test_port_probe_runs_on_cpu(probe, tests, capsys):
    mod = PORT[probe]
    tm.main(mod.TESTS, ["--device", "cpu", *tests], mod.__doc__)
    out = capsys.readouterr().out
    assert "FAILED" not in out and "correct=False" not in out, out
    cases = [c for t in (tests or mod.KERNEL_CASES) if t in mod.KERNEL_CASES
             for c in mod.KERNEL_CASES[t]]
    for case in cases:
        assert f"{case.label}:" in out, out
    assert out.count("correct=True") == sum(
        c.kernel != "onehot_gather" and "vmem table" not in c.label
        for c in cases)


@pytest.mark.parametrize("probe", sorted(PORT) + ["occ_probe5"])
def test_probe_on_cuda_raises_without_a_card(probe, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if probe == "occ_probe5":
            occ_probe5.main(["--index", "unused"])
        else:
            tm.main(PORT[probe].TESTS, [], PORT[probe].__doc__)


# ---------------------------------------------------------------------------
# the wrappers
def test_rows_clamp_and_check():
    rs = np.random.RandomState(5)
    tab = rs.randint(0, 2 ** 32, (37, 8), dtype=np.int64).astype(np.uint32)
    q = np.array([-5, 0, 36, 37, 1 << 30, 12], np.int32)
    want = tab[np.clip(q, 0, 36)]
    for pipe in gather.PIPES:
        np.testing.assert_array_equal(
            _u(gather.gather_rows(_t(tab), _t(q), pipe, chunk=3)), want)
    np.testing.assert_array_equal(_u(gather.table_take(_t(tab), _t(q))), want)
    wide = rs.randint(0, 2 ** 32, (9, 32), dtype=np.int64).astype(np.uint32)
    np.testing.assert_array_equal(
        _u(gather.gather_rows(_t(wide), _t(q))), wide[np.clip(q, 0, 8)])
    assert gather.gather_rows(_t(tab), _t(q[:0])).shape == (0, 8)
    with pytest.raises(TypeError):
        gather.gather_rows(_t(tab).long(), _t(q))
    with pytest.raises(TypeError):
        gather.gather_rows(_t(tab[:, :4]), _t(q))
    with pytest.raises(TypeError):
        gather.table_take(_t(wide), _t(q))
    with pytest.raises(TypeError):
        gather.gather_rows(_t(tab), _t(q).long())
    with pytest.raises(ValueError):
        gather.gather_rows(_t(tab), _t(q), pipe=3)
    with pytest.raises(ValueError):
        gather.gather_rows(_t(tab).t().contiguous().t(), _t(q))
    with pytest.raises(ValueError, match="unsupported device"):
        gather.gather_rows(torch.empty((4, 8), dtype=torch.int32,
                                       device="meta"),
                           torch.empty(2, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        gather.table_take_capacity("cpu")


def test_check_aligned():
    t = torch.zeros(64, dtype=torch.int32)
    gather.check_aligned("x", t, t[4:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        gather.check_aligned("x", t[1:])


def test_onehot_plain_rounds_through_float32():
    """Words of every size, the top ones included: uint32 -> float32
    (nearest, ties to even) -> uint32, saturating at 2^32 - 1."""
    rs = np.random.RandomState(9)
    tab = rs.randint(0, 2 ** 32, (70, 8), dtype=np.int64).astype(np.uint32)
    tab[0] = [0, 1, (1 << 24) + 1, (1 << 25) + 3, 0x7FFFFFFF, 0x80000001,
              0xFFFFFF7F, 0xFFFFFFFF]
    q = np.concatenate([np.arange(70), [-3, 99]]).astype(np.int32)
    f = tab[np.clip(q, 0, 69)].astype(np.float32).astype(np.float64)
    want = np.minimum(f, 2 ** 32 - 1).astype(np.uint32)
    np.testing.assert_array_equal(_u(gather.onehot_gather(_t(q), _t(tab))),
                                  want)
    assert want[0, 7] == 0xFFFFFFFF and want[0, 2] == 1 << 24
    # no row limit: neither the kernel nor the plain version has one (the
    # first card design's byte planes held at most 7,232 rows)
    big = np.zeros((7233, 8), np.uint32)
    big[7232] = tab[0]
    np.testing.assert_array_equal(
        _u(gather.onehot_gather(_t(np.array([7232, 0, 9999], np.int32)),
                                _t(big))), np.stack([want[0], big[0], want[0]]))


def test_kernels_are_built_from_the_ports_sources_at_first_use():
    for name, k in gather.KERNELS.items():
        assert k.source == os.path.join(build.CSRC_DIR, f"{name}.cu")
        assert os.path.isfile(k.source)
        assert k._lib is None            # nothing is built on import
