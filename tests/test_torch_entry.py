"""The port's entry points (``hsa_tpu_torch.entry``) against
``__graft_entry__.py``'s.

``entry(device="cpu")``'s step on its example arguments gives the JAX
step's ``(pos, nmm, valid, fallback)`` bit for bit (one module fixture, so
the JAX step compiles once); ``dryrun_multichip(2)`` starts a world of two
gloo ranks on the CPU, prints its line and equals the unsharded dry run.
The dry run's rank body inside a world of four is in
``tests/test_torch_dist.py``.
"""

import re

import numpy as np
import pytest

import jax

import __graft_entry__ as jentry
from hsa_tpu_torch import entry as tentry


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


@pytest.fixture(scope="module")
def steps():
    """Both packages' step outputs on their own example arguments, and the
    port's arguments."""
    jstep, jargs = jentry.entry()
    want = jax.jit(jstep)(*jargs)
    tstep, targs = tentry.entry(device="cpu")
    return [np.asarray(x) for x in want], tstep(*targs), jargs, targs


def test_entry_example_args_match(steps):
    """The packed text rows and the upload buffer are the reference's,
    as int32 bit patterns on the CPU."""
    _, _, jargs, targs = steps
    for j, t in zip(jargs, targs):
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(_u32(j), _u32(t.numpy()))


@pytest.mark.parametrize("field", ["pos", "nmm", "valid", "fallback"])
def test_entry_step_matches_jax(steps, field):
    want, got, _, _ = steps
    i = ["pos", "nmm", "valid", "fallback"].index(field)
    w, g = want[i], got[i].numpy()
    assert w.shape == g.shape
    if w.dtype == bool:
        np.testing.assert_array_equal(w, g)
    else:
        np.testing.assert_array_equal(_u32(w), _u32(g))
    if field == "valid":
        assert w.sum() > 0


def test_dryrun_multichip_two_ranks(capsys):
    """A world of two gloo ranks, mesh (2, 1): the line is printed, every
    rank holds the unsharded dry run's counts and made the same merges."""
    ranks = tentry.dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    ref = tentry.dryrun_unsharded(2, device="cpu")
    assert line == ranks[0]["line"]
    assert re.match(r"\[dryrun_multichip\] mesh=\(2x1\) reads=8 hits=\d+ "
                    r"pigeon_mapped=\d+ width_fn .* ok$", line)
    for r in ranks:
        assert (r["backend"], r["mesh"]) == ("gloo", [2, 1])
        assert (r["reads"], r["hits"], r["pigeon_mapped"]) == (
            ref["reads"], ref["hits"], ref["pigeon_mapped"])
        assert r["collectives"] == ranks[0]["collectives"]
    names = [c[0] for c in ranks[0]["collectives"]]
    assert names == ["width_fn", "beam_fn", "locate_fn", "pigeon_fn"]
    assert all(n > 0 and b > 0 for _, n, b in ranks[0]["collectives"])


@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (2, (2, 1)), (4, (2, 2)),
                                     (8, (2, 4))])
def test_mesh_shape_is_the_references(n, shape):
    """(n_data, n_shard) as __graft_entry__.py:90-92 picks them."""
    assert tentry.mesh_shape(n) == shape
