"""The port's spans (`utils/profiling.span`) on the CPU, f64: a no-op
without a profiler session; under one, the L-BFGS loop's, the split
sampler's and the graph layer's spans, nested as the layers call each
other, on the eager path and on the graph path (its capture emulated as in
tests/test_torch_graphs.py); and none inside a captured function."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gaussianprocesses_jl_tpu_torch.inference import lbfgs
from gaussianprocesses_jl_tpu_torch.inference.split import split_hmc
from gaussianprocesses_jl_tpu_torch.utils import graphs, profiling

from test_torch_graphs import _gpa, _gpe, emulated  # noqa: F401  (a fixture)


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _spans(prof, name=None) -> list:
    """The session's `gp.*` events (of one name, if given)."""
    return [e for e in prof.events()
            if e.name.startswith("gp.") and (name is None or e.name == name)]


def _parent(e):
    """The innermost `gp.*` event that encloses e, or None."""
    p = e.cpu_parent
    while p is not None and not p.name.startswith("gp."):
        p = p.cpu_parent
    return p


def _children(prof, parent, name) -> list:
    return [e for e in _spans(prof, name) if _parent(e) is parent]


@pytest.fixture(params=["eager", "graphs"])
def path(request):
    """The eager path, or the graph path with its capture emulated."""
    if request.param == "graphs":
        request.getfixturevalue("emulated")
    return request.param


def test_span_without_a_profiler_is_the_shared_no_op(monkeypatch):
    """No session: `span` enters no `record_function`, here or anywhere on
    the L-BFGS and split-HMC paths."""
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: calls.append(name))
    assert not torch.autograd._profiler_enabled()
    first, second = profiling.span("gp.a"), profiling.span("gp.b")
    assert first is second is profiling._NO_SPAN
    with first:
        pass
    vg, x0, _, _ = _gpe().make_objective()
    lbfgs.minimize(vg, x0, 3)
    precompute, la, lb, a0, b0 = _gpa().make_split_logprob()
    split_hmc(precompute, la, lb, a0[None].repeat(2, 1), b0[None].repeat(2, 1),
              torch.Generator().manual_seed(0), n_iter=1, a_iters=2, Lmin=2, Lmax=3)
    assert calls == []


def test_span_under_a_profiler_is_a_range_of_the_session():
    with _session() as prof:
        with profiling.span("gp.outer"):
            with profiling.span("gp.inner"):
                torch.ones(4).sum()
    (outer,), (inner,) = _spans(prof, "gp.outer"), _spans(prof, "gp.inner")
    assert _parent(inner) is outer and _parent(outer) is None
    assert any(c.name == "aten::sum" for c in inner.cpu_children)


def test_graph_span_takes_the_static_tag_or_the_functions_name():
    def value_and_grad(x):
        return x

    assert graphs._span_name(("lbfgs_start", 4), value_and_grad) == "gp.graph.lbfgs_start"
    assert graphs._span_name("precompute", value_and_grad) == "gp.graph.precompute"
    assert graphs._span_name((), value_and_grad) == "gp.graph.value_and_grad"
    with _session() as prof:
        graphs.run(value_and_grad, value_and_grad, torch.ones(2))
    assert len(_spans(prof, "gp.graph.value_and_grad")) == 1


def test_graph_span_name_is_built_only_under_a_profiler(monkeypatch):
    """No session: `graphs.run` builds no span name; under one, one a call."""
    built = []
    span_name = graphs._span_name
    monkeypatch.setattr(graphs, "_span_name", lambda *a: built.append(a) or span_name(*a))

    def value_and_grad(x):
        return x

    graphs.run(value_and_grad, value_and_grad, torch.ones(2))
    assert built == []
    with _session():
        graphs.run(value_and_grad, value_and_grad, torch.ones(2))
    assert len(built) == 1


def _direct(span) -> set:
    return {c.name for c in span.cpu_children}


def test_lbfgs_spans(path):
    """One `gp.lbfgs.iteration` an iteration, holding one start graph and a
    block graph for each further host read; on the graph path each graph
    span holds its replay's copies in and out."""
    vg, x0, _, _ = _gpe().make_objective()
    lbfgs.minimize(vg, x0, 6)  # captures outside the session
    with _session() as prof:
        r = lbfgs.minimize(vg, x0, 6)
    iterations = _spans(prof, "gp.lbfgs.iteration")
    assert len(iterations) == r.n_iter and r.host_reads > r.n_iter
    assert all(_parent(e) is None for e in iterations)
    blocks = 0
    for it in iterations:
        assert len(_children(prof, it, "gp.graph.lbfgs_start")) == 1
        blocks += len(_children(prof, it, "gp.graph.lbfgs_block"))
    assert blocks == r.host_reads - r.n_iter
    graph_spans = _spans(prof, "gp.graph.lbfgs_start") + _spans(prof, "gp.graph.lbfgs_block")
    assert len(graph_spans) == r.host_reads
    if path == "graphs":
        assert all({"aten::copy_", "aten::clone"} <= _direct(g) for g in graph_spans)


def test_split_hmc_spans(path):
    """One `gp.split.outer` an outer iteration, holding in time order the A
    sweep's graphs (the cached factor, A's start, `a_iters` transitions)
    and the B update's (its start and transition)."""
    m = _gpa()
    precompute, la, lb, a0, b0 = m.make_split_logprob()
    rng = np.random.RandomState(2)
    a = a0 + 0.1 * torch.as_tensor(rng.randn(3, a0.numel()))
    b = b0 + 0.1 * torch.as_tensor(rng.randn(3, b0.numel()))

    def sweep():
        split_hmc(precompute, la, lb, a, b, torch.Generator().manual_seed(6), n_iter=2,
                  n_warmup=1, a_iters=2, eps_a=0.2, eps_b=0.1, Lmin=2, Lmax=4)

    sweep()
    with _session() as prof:
        sweep()
    outers = _spans(prof, "gp.split.outer")
    assert len(outers) == 3 and all(_parent(e) is None for e in outers)
    for outer in outers:
        inner = sorted((e for e in _spans(prof) if _parent(e) is outer),
                       key=lambda e: e.time_range.start)
        assert [e.name for e in inner] == [
            "gp.graph.precompute", "gp.graph.start", "gp.graph.transition",
            "gp.graph.transition", "gp.graph.start", "gp.graph.transition"]
        if path == "graphs":
            assert all({"aten::copy_", "aten::clone"} <= _direct(e) for e in inner)


def test_no_span_opens_inside_a_capture(emulated, monkeypatch):  # noqa: F811
    """With a session running through the captures too, no span opens while
    `graphs.run` warms up or captures a function: the L-BFGS loop, the
    split sampler and the headline's value and gradient; their replays
    open the graph layer's spans."""
    opened = []
    record_function = torch.profiler.record_function

    def recorded(name):
        opened.append((name, graphs.capturing()))
        return record_function(name)

    monkeypatch.setattr(torch.profiler, "record_function", recorded)
    m = _gpe()
    with _session():
        vg, x0, _, _ = m.make_objective()
        lbfgs.minimize(vg, x0, 4)
        precompute, la, lb, a0, b0 = _gpa().make_split_logprob()
        split_hmc(precompute, la, lb, a0[None].repeat(2, 1), b0[None].repeat(2, 1),
                  torch.Generator().manual_seed(0), n_iter=2, a_iters=2, Lmin=2, Lmax=3)
        m.target_and_dtarget()
    names = {name for name, _ in opened}
    assert {"gp.lbfgs.iteration", "gp.split.outer", "gp.graph.lbfgs_start",
            "gp.graph.transition", "gp.graph._gpe_value_and_grad"} <= names
    assert not [name for name, inside in opened if inside]
