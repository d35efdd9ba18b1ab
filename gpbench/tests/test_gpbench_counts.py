"""The operation and byte counts, by hand at small sizes and against the
bounds the kernel table in PERF.md used."""
import json

import pytest

from gpbench import harness, roofline


def _cfg(name):
    with open(harness.ROOT / "configs" / f"{name}.json") as f:
        return json.load(f)


def _counts(name):
    return harness._module("counts", name)


def test_gram_bounds_match_the_kernel_table():
    # PERF.md's kernel table: 0.0108 ms at n = 3000, d = 10 (bytes); 0.0063 ms
    # for 128 batched Matern grams at n = 200, d = 5, inputs per chain
    assert roofline.gram_bound_s(3000, 3000, 10, "float32", True) * 1e3 == pytest.approx(
        0.0108, abs=5e-5)
    assert roofline.gram_bound_s(200, 200, 5, "float32", True, 128, True) * 1e3 == pytest.approx(
        0.0063, abs=5e-5)
    assert roofline.gram_vjp_bound_s(3000, 3000, 10, "float32", True, False) * 1e3 == (
        pytest.approx(0.0108, abs=5e-5))


@pytest.mark.parametrize("n,d,sym", [(4, 2, True), (3, 5, False)])
def test_gram_bound_by_hand(n, d, sym):
    nbytes = 4 * (n * d + (0 if sym else n * d) + 3 + n * n)
    ops = n * n * (3 * d + 4)
    want = max(nbytes / roofline.HBM_BYTES_PER_S, ops / roofline.F32_FLOPS)
    assert roofline.gram_bound_s(n, n, d, "float32", sym) == pytest.approx(want)


def test_gpe_counts_by_hand():
    cfg, c = _cfg("gpe_se_d10"), _counts("gpe_se_d10")
    n, d = 10, cfg["d"]
    pairs = n * (n + 1) / 2
    want = n ** 3 + 7 * n ** 2 + pairs * (3 * d + 4) + pairs * (3 * d + 16)
    assert c.evaluation_flops(cfg, n) == pytest.approx(want)
    # the headline's evaluation: ~n^3 = 2.7e10
    assert 2.7e10 < c.evaluation_flops(cfg, 3000) < 2.8e10


def test_gpa_counts_by_hand():
    cfg, c = _cfg("gpa_bern_mat32"), _counts("gpa_bern_mat32")
    n, d, s = 7, cfg["d"], cfg["sampler"]
    ev = c.evaluation_flops(cfg, n)
    pairs = n * (n + 1) / 2
    assert ev == pytest.approx(n ** 3 + 4 * n ** 2 + pairs * (3 * d + 4)
                               + pairs * (3 * d + 16 + 4 * d + 4))
    steps = (s["Lmin"] + s["Lmax"]) / 2
    a = n ** 3 / 3 + pairs * (3 * d + 4) + (s["a_iters"] * steps + 1) * 4 * n ** 2
    assert c.outer_iteration_flops(cfg, n, 3) == pytest.approx(3 * (a + (steps + 1) * ev))


def test_launch_bounds_take_the_shapes():
    for name, chains in (("gpe_se_d10", 1), ("gpa_bern_mat32", 128)):
        cfg, c = _cfg(name), _counts(name)
        for kernel in ("gram", "gram_vjp"):
            sym = c.launch_bound_s(cfg, kernel, 200, 200, False, chains)
            cross = c.launch_bound_s(cfg, kernel, 200, 200, True, chains)
            assert 0 < sym <= cross
