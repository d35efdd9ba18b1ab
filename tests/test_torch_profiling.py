"""The port's profiling helpers (utils/profiling.py), mirroring
tests/test_profiling.py on CPU tensors."""
import json
import os

import numpy as np
import torch

import gaussianprocesses_jl_tpu_torch as gp
from gaussianprocesses_jl_tpu_torch.utils import profiling


def test_step_timer_records_and_summarizes():
    timer = profiling.StepTimer(warmup=1)

    def f(x):
        return torch.sum(x * x)

    x = torch.arange(64.0)
    for _ in range(4):
        with timer.step() as s:
            out = f(x)
            s.block_on(out)
    summ = timer.summary()
    assert summ["steps"] == 3  # warmup discarded
    assert summ["min_ms"] > 0
    assert summ["compile_ms"] > 0
    assert summ["min_ms"] <= summ["median_ms"] <= summ["p95_ms"] + 1e-9


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


def test_live_device_bytes_nonnegative():
    x = torch.ones((128, 128))
    assert profiling.live_device_bytes() >= 0
    if not torch.cuda.is_available():
        assert profiling.live_device_bytes() == 0
    del x
