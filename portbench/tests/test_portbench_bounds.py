"""The copied bound arithmetic, pinned to the bounds that PERF.md's kernel
tables record at the same shapes (chip_smoke.py's phase 13a and phase 2).
Terms that depend on the data (distinct rows, reads, picks, DP cells) lie
between the least the shape allows and the most: the recorded bound must lie
in that range, and where the data term is known, equal it."""

import pytest

from portbench import bounds as b


def ms(s):
    return s * 1e3


def within(lo, recorded, hi):
    """``recorded`` (printed to 4 decimals) in [lo, hi]."""
    return lo - 5e-5 <= recorded <= hi + 5e-5


@pytest.mark.parametrize("shape,recorded", [
    ((2_097_152, "extend4"), 0.0561),      # beam step, extend4
    ((4_194_304, "extend4"), 0.1035),      # PE beam
    ((8_388_608, "extend4"), 0.1942),      # W=512 batch
    ((193_584, "extend"), 0.0035),         # anchor scan
])
def test_fm_extend(shape, recorded):
    B, kind = shape
    lo = ms(b.extend_bound_s(B, kind, 1))
    hi = ms(b.extend_bound_s(B, kind, 2 * B))
    assert within(lo, recorded, hi)
    assert ms(b.least_s("fm_extend", (B, kind, False, False))) == lo


@pytest.mark.parametrize("shape,recorded", [
    ((129_056, 32_264, 8, 5), 0.0035),
    ((260_112, 65_028, 11, 6), 0.0089),
])
def test_window_verify(shape, recorded):
    # every read of the batch has a candidate in these pools
    assert round(ms(b.verify_bound_s(*shape, reads=shape[1])), 4) == recorded
    assert ms(b.least_s("window_verify", shape)) <= recorded


@pytest.mark.parametrize("shape,recorded", [
    ((32_264, 129_056, 32_264, 8, 5), 0.0173),
    ((65_028, 260_112, 65_028, 11, 6), 0.0597),
])
def test_gapped_screen(shape, recorded):
    assert round(ms(b.gapped_bound_s(*shape)), 4) == recorded
    assert ms(b.least_s("gapped_screen", shape)) == ms(b.gapped_bound_s(*shape))


@pytest.mark.parametrize("shape,recorded", [
    ((576, 32_768, 64, True), 0.0395),     # tiled frontier, align beam
    ((352, 32_768, 32, False), 0.0226),    # tiled merge
    ((4608, 16_384, 512, True), 0.1578),   # tall, W=512
    ((16_380, 2048, 1820, True), 0.0701),  # tall, W=1820
])
def test_select_topk(shape, recorded):
    C, B, K, window = shape
    lo = ms(b.select_bound_s(C, B, K, window, 0, 0, 0))
    hi = ms(b.select_bound_s(C, B, K, window, 3, C * B, B * K))
    assert within(lo, recorded, hi)
    assert ms(b.least_s("select_topk", shape)) == lo


@pytest.mark.parametrize("shape,recorded", [
    ((2_035, 150, 519), 0.0420),
    ((16_384, 150, 576), 0.3756),
])
def test_glocal_screen(shape, recorded):
    R, L, G = shape
    lo = ms(b.glocal_bound_s(R, L, G, 0))
    hi = ms(b.glocal_bound_s(R, L, G, R * L * G))
    assert within(lo, recorded, hi)
    assert ms(b.least_s("glocal_screen", shape)) == lo


def test_every_kernel_has_a_name_and_a_counter():
    ks = b.hand_kernels()
    assert set(ks) == set(b.KERNEL_FUNCS)
    for k in ks.values():
        assert hasattr(k, "launch_shapes")
