"""The readers of the program's spans (`gpbench/spans.py` and the metrics
that use it) on synthetic traces: times in microseconds, device
operations and host events as `profile.Trace` holds them."""
from types import SimpleNamespace

import pytest

from gpbench import harness, spans
from gpbench.profile import Trace, union_s
from gpbench.readers import idle_share

IDLE = ["graphs.idle_share.fit", "graphs.idle_share.map", "graphs.idle_share.hmc",
        "trainer.idle_share.fit", "trainer.idle_share.map", "sampler.idle_share.hmc"]


def _read(name, trace):
    return harness._module("metrics", name).read(SimpleNamespace(trace=trace))


def _trace(ops, host, window_us=1000.0):
    t = Trace(window_us * 1e-6, None, {}, [], ops=ops, host=host)
    t.busy_s = union_s(ops)
    return t


# device busy 0-100, 200-300, 300-350 (overlapping 320-340), 600-1000: gaps 100-200, 350-600
OPS = [("k", 0, 100), ("k", 200, 300), ("k", 300, 350), ("k", 320, 340), ("k", 600, 1000)]


def test_gaps_merge_the_device_intervals():
    assert spans.gaps(OPS) == [(100, 200), (350, 600)]


def test_innermost_takes_each_spans_self_time():
    pieces = spans.innermost([("gp.lbfgs.iteration", 0, 100), ("gp.graph.lbfgs_start", 10, 40),
                              ("gp.graph.value_and_grad", 12, 20),
                              ("gp.graph.lbfgs_block", 50, 60)])
    assert pieces == [(0, 10, "gp.lbfgs.iteration"), (10, 12, "gp.graph.lbfgs_start"),
                      (12, 20, "gp.graph.value_and_grad"), (20, 40, "gp.graph.lbfgs_start"),
                      (40, 50, "gp.lbfgs.iteration"), (50, 60, "gp.graph.lbfgs_block"),
                      (60, 100, "gp.lbfgs.iteration")]


def test_a_gap_under_a_graph_span_nested_in_an_iteration_counts_to_the_graph_layer():
    """The gap 100-200 lies under a block's graph span (110-190, its replay
    120-180) inside `gp.lbfgs.iteration` (50-250): 80 us go to the graph
    layer, the 20 us around the block to the trainer; the gap 350-600 lies
    outside every span and goes to neither."""
    host = [("gp.lbfgs.iteration", 50, 250), ("gp.graph.lbfgs_block", 110, 190),
            ("cudaGraphLaunch", 120, 180), ("cudaMemcpyAsync", 112, 115)]
    t = _trace(OPS, host)
    assert _read("graphs.idle_share.fit", t) == pytest.approx(100 * 80 / 1000)
    assert _read("trainer.idle_share.fit", t) == pytest.approx(100 * 20 / 1000)
    whole = _trace(OPS, [("gp.lbfgs.iteration", 50, 250), ("gp.graph.lbfgs_block", 100, 200)])
    assert _read("graphs.idle_share.map", whole) == pytest.approx(10.0)
    assert _read("trainer.idle_share.map", whole) == 0.0


def test_a_gap_outside_every_span_counts_to_no_layer():
    t = _trace(OPS, [("gp.split.outer", 360, 590), ("gpbench.hmc.chunk", 0, 1000),
                     ("cudaGraphLaunch", 100, 200)])
    assert _read("graphs.idle_share.hmc", t) == 0.0
    assert _read("sampler.idle_share.hmc", t) == pytest.approx(100 * 230 / 1000)
    t = _trace(OPS, [("gp.split.outer", 600, 900)])
    assert _read("sampler.idle_share.hmc", t) == 0.0


def test_the_layers_shares_add_up_to_at_most_the_devices():
    host = [("gp.split.outer", 0, 900), ("gp.graph.transition", 90, 150),
            ("gp.graph.start", 340, 420)]
    t = _trace(OPS, host)
    device = idle_share(SimpleNamespace(trace=t))
    graph, sampler = _read("graphs.idle_share.hmc", t), _read("sampler.idle_share.hmc", t)
    assert graph == pytest.approx(100 * (50 + 70) / 1000)
    assert sampler == pytest.approx(100 * (50 + 180) / 1000)
    assert graph + sampler <= device + 1e-9
    assert device == pytest.approx(100 * (100 + 250) / 1000)


def test_launches_under_a_graph_launch_are_not_eager():
    host = [("gp.split.outer", 0, 400), ("gp.split.outer", 500, 900),
            ("cudaLaunchKernel", 10, 12), ("cudaLaunchKernelExC", 20, 22),
            ("cudaMemcpyAsync", 30, 32), ("cudaMemsetAsync", 40, 42),
            ("cudaGraphLaunch", 100, 200), ("cudaLaunchKernel", 150, 152),
            ("cudaStreamSynchronize", 300, 310), ("cudaLaunchKernel", 600, 602),
            ("cudaLaunchKernel", 450, 452)]  # the last between the spans
    t = _trace(OPS, host)
    assert _read("hmc.eager_launches_per_iter", t) == pytest.approx((4 + 1) / 2)


@pytest.mark.parametrize("name", IDLE + ["hmc.eager_launches_per_iter"])
def test_a_trace_without_program_spans_reads_none(name):
    """A trace without `gp.*` spans (a program without them), without
    device operations, or no trace at all: None, not 0."""
    host = [("gpbench.fit.restart", 0, 1000), ("cudaGraphLaunch", 100, 200),
            ("cudaLaunchKernel", 10, 12), ("gpbench.hmc.chunk", 0, 1000)]
    assert _read(name, _trace(OPS, host)) is None
    assert _read(name, _trace([], [("gp.split.outer", 0, 1000)])) is None
    assert _read(name, None) is None
