"""The port's profiling helpers (utils/profiling.py), mirroring
tests/test_profiling.py on CPU tensors."""
import json
import os

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.utils import profiling


def test_device_time_returns_positive_and_consistent():
    X = torch.as_tensor(np.random.RandomState(0).randn(64, 3))
    kern = gp.SE(0.0, 0.0).to(dtype=torch.float64, device="cpu")
    calls = []

    def fn(X):
        calls.append(1)
        return kern.gram(X)

    t = profiling.device_time(fn, [X], reps=4, trials=2)
    assert np.isfinite(t) and t > 0
    assert len(calls) == 1 + 4 * 2  # one warm-up call, then reps x trials


def test_trace_writes_profile(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    found = []
    for root, _, files in os.walk(d):
        found.extend(files)
    assert found, "torch.profiler trace produced no files"
    with open(os.path.join(d, "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)


def test_device_ms_by_name_counts_calls_and_sees_no_card_on_cpu():
    calls = []

    def fn(x):
        calls.append(1)
        return x @ x

    kernels, ops = profiling.device_ms_by_name(fn, [torch.ones((16, 16))], reps=3, warmup=2)
    assert len(calls) == 2 + 3
    assert isinstance(kernels, dict) and isinstance(ops, dict)
    if not torch.cuda.is_available():
        assert kernels == {} and ops == {}  # no device time without a card


def test_device_profile_ranks_and_sums_kernels_alone():
    calls = []
    x = torch.ones((16, 16))

    def fn():
        calls.append(1)
        return x @ x

    busy, kernels, ops = profiling.device_profile(fn, reps=4, top=3)
    assert len(calls) == 4
    assert len(kernels) <= 3 and len(ops) <= 3
    assert busy >= sum(ms for _, ms, _ in kernels) - 1e-9  # the top kernels, of all
    assert [ms for _, ms, _ in kernels] == sorted((ms for _, ms, _ in kernels), reverse=True)
    if not torch.cuda.is_available():
        assert (busy, kernels, ops) == (0, [], [])


class _Event:
    def __init__(self, key, device_ms):
        from torch.autograd import DeviceType

        self.key, self.count = key, 1
        self.self_device_time_total = 1e3 * device_ms
        self.device_type = DeviceType.CUDA


class _Session:
    """A stand-in profiler session whose records are `events`."""
    def __init__(self, events):
        self.events = events

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def key_averages(self):
        return self.events


def _card_sessions(monkeypatch, records):
    """Profile as on a card, each session holding the next of `records`;
    returns the list of sessions opened."""
    opened = []

    def session():
        opened.append(1)
        return _Session(records[len(opened) - 1])

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(profiling, "_profiler", session)
    return opened


def test_device_ms_by_name_runs_a_session_that_lost_its_kernels_again(monkeypatch):
    """On a card, a session that saw no kernel is run again, up to
    `sessions` in all, and the first that saw one is returned; on the CPU
    (no card) the one session is all."""
    calls = []
    opened = _card_sessions(monkeypatch, [[], [], [_Event("gram_kernel<float>", 0.5)]])
    kernels, _ = profiling.device_ms_by_name(lambda: calls.append(1), reps=2, warmup=1)
    assert len(opened) == 3 and len(calls) == 1 + 3 * 2
    assert kernels == {"gram_kernel<float>": (0.25, 0.5)}
    opened = _card_sessions(monkeypatch, [[], [], [], [_Event("late", 1.0)]])
    assert profiling.device_ms_by_name(lambda: None, reps=1) == ({}, {})
    assert len(opened) == 3  # gave up after three sessions
    opened = _card_sessions(monkeypatch, [[_Event("k", 1.0)], []])
    profiling.device_ms_by_name(lambda: None, reps=1)
    assert len(opened) == 1


def test_profiler_check_counts_sessions_that_saw_no_kernel(monkeypatch):
    """`perf/profiler_check.count_empty` counts, for each case, the plain
    sessions and the rerun measurements that saw no kernel named like its
    match; on the CPU every one is empty, and main() refuses to run."""
    from gaussianprocesses_jl_tpu_torch.perf import profiler_check

    calls, between = [], []
    x = torch.ones((8, 8))
    empty = profiler_check.count_empty([(lambda: calls.append(x @ x), "mm"),
                                        (lambda: calls.append(x + x), "")], 2,
                                       between=lambda: between.append(1))
    assert len(calls) == 2 * 2 * 2 * profiler_check.REPS and len(between) == 2
    if not torch.cuda.is_available():
        assert empty == [[2, 2], [2, 2]]
        assert profiler_check.main(["--sessions", "1"]) == 1
    # on a card: a plain session lost, the measurement's rerun saw the kernel
    _card_sessions(monkeypatch, [[], [], [_Event("gram_kernel", 1.0)]])
    assert profiler_check.count_empty([(lambda: None, "gram_kernel")], 1) == [[1, 0]]
