"""Port select_topk (plain PyTorch version on the CPU) vs the JAX package's
sort reference and its Pallas kernel in interpret mode.

Bit-exact everywhere: against the sort reference on every slot (both are
sorts of unique keys), against the Pallas kernel on valid slots, the drop
row and nvalid (its invalid slots differ by design, as in
tests/test_select_kernel.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hsa_tpu.kernels.select import select_topk as jselect
from hsa_tpu.kernels.select import select_topk_reference
from hsa_tpu_torch.kernels import build, select
from hsa_tpu_torch.kernels.select import KEY_SH, SENT, select_topk


def make_case(C, B, seed, frac_valid=0.7, with_window=False, with_accum=False,
              n_pay=2):
    rs = np.random.RandomState(seed)
    score = rs.randint(0, 50, (C, B)).astype(np.uint32)
    row = np.arange(C, dtype=np.uint32)[:, None]
    key = (score << KEY_SH) | row
    invalid = rs.rand(C, B) > frac_valid
    key = np.where(invalid, (SENT | row).astype(np.uint32), key)
    pays = [rs.randint(0, 2 ** 32, (C, B), dtype=np.int64).astype(np.uint32)
            for _ in range(n_pay)]
    win = rs.randint(5, 40, B).astype(np.uint32) if with_window else None
    acc = (rs.randint(0, 2 ** 32, (1, B), dtype=np.int64).astype(np.uint32)
           if with_accum else None)
    return key, pays, win, acc


def _t32(a):
    return None if a is None else torch.from_numpy(
        np.ascontiguousarray(a).view(np.int32))


def _u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def run_port(key, pays, K, win, acc):
    okeyd, pouts, nd = select_topk(_t32(key), [_t32(p) for p in pays], K,
                                   _t32(win), _t32(acc))
    return _u32(okeyd.numpy()), [_u32(p.numpy()) for p in pouts], _u32(nd.numpy())


SHAPES = [(32, 64, 8, False), (72, 128, 8, True), (56, 96, 16, False),
          (17, 33, 4, True), (576, 40, 64, True), (352, 40, 32, False)]


@pytest.mark.parametrize("C,B,K,window", SHAPES)
def test_plain_matches_sort_reference(C, B, K, window):
    key, pays, win, _ = make_case(C, B, seed=C + B, with_window=window, n_pay=3)
    rk, rp, rd = select_topk_reference(
        jnp.asarray(key), tuple(jnp.asarray(p) for p in pays), K,
        None if win is None else jnp.asarray(win))
    okeyd, pouts, nd = run_port(key, pays, K, win, None)
    np.testing.assert_array_equal(okeyd[:K], _u32(rk))
    for a, b in zip(rp, pouts):
        np.testing.assert_array_equal(_u32(a), b)
    np.testing.assert_array_equal(okeyd[K], _u32(rd))
    np.testing.assert_array_equal(nd.reshape(-1), _u32(rd))


@pytest.mark.parametrize("C,B,K,window", SHAPES[:4])
@pytest.mark.parametrize("accum", [False, True])
def test_plain_matches_pallas_interpret(C, B, K, window, accum):
    key, pays, win, acc = make_case(C, B, seed=C * B, with_window=window,
                                    with_accum=accum)
    kkd, kp, kd = jselect(jnp.asarray(key), tuple(jnp.asarray(p) for p in pays),
                          K, None if win is None else jnp.asarray(win),
                          None if acc is None else jnp.asarray(acc),
                          interpret=True, lanes=32)
    kk = _u32(kkd)
    okeyd, pouts, nd = run_port(key, pays, K, win, acc)
    kvalid, pvalid = kk[:K] < SENT, okeyd[:K] < SENT
    np.testing.assert_array_equal(kvalid, pvalid)
    np.testing.assert_array_equal(np.where(kvalid, kk[:K], 0),
                                  np.where(pvalid, okeyd[:K], 0))
    for a, b in zip(kp, pouts):
        np.testing.assert_array_equal(np.where(kvalid, _u32(a), 0),
                                      np.where(pvalid, b, 0))
    np.testing.assert_array_equal(kk[K], okeyd[K])
    np.testing.assert_array_equal(_u32(kd).reshape(-1), nd.reshape(-1))


def test_nvalid_and_drop_row():
    key, pays, win, acc = make_case(40, 24, seed=3, with_window=True,
                                    with_accum=True)
    okeyd, _, _ = run_port(key, pays, 8, win, acc)
    valid = (key < SENT) & ((key >> KEY_SH) <= win[None, :])
    nvalid = valid.sum(axis=0)
    np.testing.assert_array_equal(
        okeyd[8], (acc[0].astype(np.int64) + np.maximum(nvalid - 8, 0))
        & 0xFFFFFFFF)
    np.testing.assert_array_equal((okeyd[:8] < SENT).sum(axis=0),
                                  np.minimum(nvalid, 8))


def test_all_invalid_column():
    key, pays, _, _ = make_case(16, 32, seed=1, frac_valid=0.0)
    kkd, _, kd = jselect(jnp.asarray(key), tuple(jnp.asarray(p) for p in pays),
                         4, None, interpret=True, lanes=32)
    okeyd, _, nd = run_port(key, pays, 4, None, None)
    assert not (okeyd[:4] < SENT).any()
    np.testing.assert_array_equal(_u32(kd).reshape(-1), nd.reshape(-1))
    assert (nd == 0).all()


def test_cpu_path_launches_no_kernel():
    before = select.KERNEL.launches
    key, pays, _, _ = make_case(24, 16, seed=2)
    run_port(key, pays, 4, None, None)
    assert select.KERNEL.launches == before


@pytest.mark.parametrize("bad", ["dtype", "K", "n_pay", "strided", "window"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    key = torch.zeros((8, 4), dtype=torch.int32)
    pays = [torch.zeros((8, 4), dtype=torch.int32)]
    K, win = 2, None
    err = TypeError
    if bad == "dtype":
        key = key.long()
    elif bad == "K":
        K, err = 9, ValueError
    elif bad == "n_pay":
        pays, err = pays * 4, ValueError
    elif bad == "strided":
        pays, err = [torch.zeros((4, 8), dtype=torch.int32).t()], ValueError
    else:
        win = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(err):
        select_topk(key, pays, K, window=win)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A kernel build that fails raises; nothing falls back."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    k = build.CudaKernel("select_topk.cu", select._declare)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k.lib()


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
