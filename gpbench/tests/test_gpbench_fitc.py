"""The cell fitc_se.fit100k (configuration #4, FITC, under the traffic
fit100k) on the CPU at a small size given here: it runs end to end and
reads correct; a fault of the timed path and the TF32 control read not
correct; the counts file's QR and evaluation counts by hand; the readers of
the QR's device brackets (`gpbench/brackets.py` and the `fitc.*` metrics)
on synthetic traces. On the card: the markers around each QR in a profiler
trace of a graphed evaluation."""
import json
from types import SimpleNamespace

import pytest
import torch

import gaussianprocesses_jl_tpu_torch.models.sparse as sparse
from gpbench import brackets, harness
from gpbench.profile import Trace, union_s
from gpbench.tests.test_gpbench_faults import _altered_fit, _half_data, _unchanged_step

CELL = "fitc_se.fit100k"
# n = 400 rows, m = 16 inducing rows; a pool of 2 starts, 5 iterations a restart
SMALL = {"config": {"n": 400, "m": 16}, "traffic": {"pool": 2, "maxiter": 5}}


def small_run(seed=12345, seconds=1.0, trace=False, make_program=None):
    spec = harness.load_spec()
    cell = harness.resolve(spec, CELL, seed, seconds, trace, torch.device("cpu"), SMALL,
                           make_program)
    return harness.run(cell)


def test_cell_runs_and_is_correct_on_the_cpu():
    result = small_run(seed=2 ** 31 + 17)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"fit_iters_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["checks"]) == {"lbfgs_dir_gap", "lbfgs_rise", "failed"}


def test_traced_run_reads_its_counters():
    result = small_run(seed=99, trace=True)
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    spec = harness.load_spec()
    names = {m["name"] for m in spec["per_layer"] if CELL in m["workloads"]}
    assert len(names) == 6
    # on the CPU only the program's counter has something to read
    assert set(result["metrics"]) == {"lbfgs.evals_per_iter.fitc"}


def _half_fitc_data(monkeypatch):
    import gaussianprocesses_jl_tpu_torch.models.gpe as gpe

    _half_data(monkeypatch, gpe, "gpe_target")


@pytest.mark.parametrize("fault", [_unchanged_step, _half_fitc_data, _altered_fit],
                         ids=["unchanged_step", "half_data", "altered_answer"])
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    assert small_run(seed=4242)["correct"] is False


def test_control_is_not_correct():
    probe = harness.resolve(harness.load_spec(), CELL, 5, 1.0, False, torch.device("cpu"), SMALL)
    assert small_run(seed=5, make_program=probe.reference.Control)["correct"] is False


def _counts():
    return harness._module("counts", "fitc_se_n100k")


def _cfg():
    with open(harness.ROOT / "configs" / "fitc_se_n100k.json") as f:
        return json.load(f)


def test_qr_counts_by_hand():
    c = _counts()
    # a 10 x 3 QR: 2 N m^2 + m^3 / 3 = 180 + 9; its VJP 5 N m^2 = 450
    assert c.qr_flops("fwd", 10, 3) == pytest.approx(189.0)
    assert c.qr_flops("vjp", 10, 3) == pytest.approx(450.0)
    # bytes: A read, Q and R written (4 (30 + 30 + 9)); Q, dQ read, dA written, R, dR (4 (90 + 18))
    assert c.qr_bytes("fwd", 10, 3) == 276 and c.qr_bytes("vjp", 10, 3) == 432
    assert c.qr_bound_s("fwd", 10, 3) == pytest.approx(276 / 3.35e12)
    # the configuration's QR is bound by its operations: 5.27e10 at 67 TFLOP/s
    assert c.qr_bound_s("fwd", 100_512, 512) * 1e3 == pytest.approx(0.7872, abs=1e-4)
    assert c.qr_bound_s("vjp", 100_512, 512) * 1e3 == pytest.approx(1.9663, abs=1e-4)


def test_evaluation_counts_by_hand():
    cfg, c = _cfg(), _counts()
    cfg["m"] = m = 3
    n, d = 7, cfg["d"]
    N = n + m
    grams = 6 * (3 * d + 4) + m * n * (3 * d + 4)
    vjps = 6 * (3 * d + 16) + m * n * (3 * d + 16)
    want = (grams + m ** 3 / 3 + m * m * n + 2 * m * n + 2 * N * m * m + m ** 3 / 3
            + 5 * N * m * m + 2 * m * m * n + 2 * m ** 3 / 3 + vjps + 10 * m * n)
    assert c.evaluation_flops(cfg, n) == pytest.approx(want)
    # the configuration's evaluation: ~7 N m^2 + 3 m^2 n = 2.6e11
    assert 2.6e11 < c.evaluation_flops(_cfg(), 100_000) < 2.7e11


def test_launch_bounds_take_the_shapes():
    cfg, c = _cfg(), _counts()
    for kernel in ("gram", "gram_vjp"):
        sym = c.launch_bound_s(cfg, kernel, 512, 512, False, 1)
        cross = c.launch_bound_s(cfg, kernel, 512, 100_000, True, 1)
        assert 0 < sym < cross
    # the kernel table's bound of the cross gram, 512 x 100 000 (bytes)
    assert c.launch_bound_s(cfg, "gram", 512, 100_000, True, 1) * 1e3 == pytest.approx(
        0.0616, abs=5e-5)


def _trace(ops, window_us=1000.0):
    t = Trace(window_us * 1e-6, None, {}, [], ops=ops, host=[])
    t.busy_s = union_s(ops)
    return t


# two forward brackets (one whose end was lost) and one VJP; busy but for 100-110 and 400-500
OPS = [("gp_qr_fwd_begin", 0, 2), ("geqrf", 2, 100), ("orgqr", 110, 150),
       ("gp_qr_fwd_end", 150, 152), ("gemm", 152, 400), ("gp_qr_vjp_begin", 500, 502),
       ("trsm", 502, 700), ("gp_qr_vjp_end", 700, 702), ("gp_qr_fwd_begin", 702, 704),
       ("geqrf", 704, 1000)]


def test_brackets_pair_begin_and_end():
    t = _trace(OPS)
    assert brackets.intervals(t, "gp.qr.fwd") == [(2, 150)]
    assert brackets.intervals(t, "gp.qr.vjp") == [(502, 700)]
    assert brackets.busy_inside_s(t, [(2, 150)]) == pytest.approx(138e-6)  # the gap 100-110
    assert brackets.intervals(_trace([("geqrf", 0, 10)]), "gp.qr.fwd") is None
    assert brackets.intervals(None, "gp.qr.fwd") is None


def _ctx(trace):
    return SimpleNamespace(trace=trace, config=_cfg(), traffic={}, counts=_counts(),
                           peak_flops=67e12)


def test_qr_readers_on_a_synthetic_trace():
    t = _trace(OPS)
    share = harness._module("metrics", "fitc.qr_share").read(_ctx(t))
    assert share == pytest.approx(100.0 * (138 + 198) / 890)  # busy 0-100, 110-400, 500-1000
    roof = harness._module("metrics", "fitc.qr_roofline").read(_ctx(t))
    c = _counts()
    want = c.qr_bound_s("fwd", 100_512, 512) + c.qr_bound_s("vjp", 100_512, 512)
    assert roof == pytest.approx(100.0 * want / ((138 + 198) * 1e-6))


def test_qr_readers_say_nothing_without_markers():
    t = _trace([("geqrf", 0, 100)])
    for name in ("fitc.qr_share", "fitc.qr_roofline"):
        assert harness._module("metrics", name).read(_ctx(t)) is None
        assert harness._module("metrics", name).read(_ctx(None)) is None


@pytest.mark.card
def test_markers_bracket_each_qr_on_the_card(card):
    """A graphed value and gradient of a FITC model on the card, traced:
    each QR's kernels lie between the markers of `gp.qr.fwd`, the VJP's
    between those of `gp.qr.vjp`, one pair of each an evaluation, and the
    counter counts one of each."""
    from torch.profiler import ProfilerActivity, profile

    cfg = _cfg()
    cfg["m"] = 64
    conf = harness._module("configs", "fitc_se_n100k")
    X, y = conf.make_data(cfg, 4000, torch.Generator(device=card))
    model = conf.Program(cfg, X, y).model
    vg, x0, _, _ = model.make_objective()
    vg(x0)
    torch.cuda.synchronize()
    sparse.QR_SHAPES.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            vg(x0)
        torch.cuda.synchronize()
    ops = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.device_type != torch.autograd.DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)]
    t = _trace(ops)
    fwd, vjp = brackets.intervals(t, "gp.qr.fwd"), brackets.intervals(t, "gp.qr.vjp")
    assert len(fwd) == len(vjp) == 3
    assert all(brackets.busy_inside_s(t, [s]) > 0 for s in fwd + vjp)
    assert dict(sparse.QR_SHAPES) == {("qr", 4064, 64): 3, ("qr_vjp", 4064, 64): 3}
