"""The port's ``occ_probe5`` (``hsa_tpu_torch/tools/occ_probe5.py``) on the
CPU against the JAX package's ``occ_lt4_flat``, on one small synthetic index
that the port builds and both packages load.

The static occ of the probe's random, sorted and blocked ranks and the
chained occ (8 steps, each fed ``(o[0] ^ o[3]) % n``) are bit-equal.  The
``mask25`` chain is not compared: on an index this small its pointers run
past the table, where ``jnp.take`` fills and the port's gathers clamp.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsa_tpu.index.layout import DeviceIndex as JDeviceIndex
from hsa_tpu.search import fm as jfm
from hsa_tpu_torch.pipeline import build_index
from hsa_tpu_torch.search import fm as tfm
from hsa_tpu_torch.tools import occ_probe5

N_BP, NQ = 50_003, 4_096


@pytest.fixture(scope="module")
def index(tmp_path_factory):
    d = tmp_path_factory.mktemp("occ")
    g = np.random.RandomState(17).randint(0, 4, N_BP)
    fa = d / "ref.fa"
    fa.write_text(">c\n" + "".join("ACGT"[c] for c in g) + "\n")
    prefix = str(d / "ref")
    build_index(str(fa), prefix)
    jidx = JDeviceIndex.load(os.path.join(prefix + ".hsa",
                                          "index.npz")).as_jax()
    return prefix, jidx, occ_probe5.load_index(prefix, "cpu")


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def test_queries_and_load(index):
    prefix, jidx, tidx = index
    assert tidx.n == int(jidx.n) == N_BP
    assert tidx.rev_occ_blocks is None and tidx.sa_direct is None
    np.testing.assert_array_equal(_u32(tidx.occ_blocks.numpy()),
                                  _u32(jidx.occ_blocks))
    rand, srt, blk = occ_probe5.make_queries(tidx.n, NQ)
    assert len(rand) == len(srt) == len(blk) == NQ
    assert rand.max() < N_BP and blk.max() < N_BP
    np.testing.assert_array_equal(np.sort(rand), srt)
    assert (np.diff(blk.reshape(-1, 128).astype(np.int64), axis=1) % N_BP
            == 1).all()


@pytest.mark.parametrize("kind", ["random", "sorted", "blocked"])
def test_static_occ_equals_jax(index, kind):
    _, jidx, tidx = index
    q = occ_probe5.make_queries(tidx.n, NQ)[
        ["random", "sorted", "blocked"].index(kind)]
    want = jfm.occ_lt4_flat(jidx, jnp.asarray(q))
    got = tfm.occ_lt4_flat(tidx, torch.from_numpy(q.astype(np.int64)))
    for a in range(4):
        np.testing.assert_array_equal(got[a].numpy(), _u32(want[a]))
    got = occ_probe5.occ_once(tidx, torch.from_numpy(q.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), _u32((want[0] ^ want[3]) & jnp.uint32(0xFFFFFF)))


def test_chained_occ_equals_jax(index):
    _, jidx, tidx = index
    q = occ_probe5.make_queries(tidx.n, NQ)[0]
    p = jnp.asarray(q)
    for _ in range(8):
        o = jfm.occ_lt4_flat(jidx, p)
        p = (o[0] ^ o[3]) % jnp.uint32(tidx.n)
    got = occ_probe5.occ_chain(tidx, torch.from_numpy(q.astype(np.int64)), 8,
                               "full")
    np.testing.assert_array_equal(got.numpy(), _u32(p))


def test_probe_runs_on_cpu(index, capsys, monkeypatch):
    prefix, _, _ = index
    monkeypatch.setattr(occ_probe5, "Q", NQ)
    occ_probe5.main(["--index", prefix, "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(" Mq/s")[0].rsplit(" ", 1)[0].strip() for ln in lines] \
        == ["[0.1M] static occ [random  ]", "[0.1M] static occ [sorted  ]",
            "[0.1M] static occ [blocked ]"] + [
        f"[0.1M] chained occ [{r} len={n:3d}]" for r in ("mask25", "full")
        for n in (8, 32, 128)]
