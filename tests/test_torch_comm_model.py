"""The port's communication model (perf/comm_model.py) on one process, on
the CPU. Its counts over 4 gloo processes are held in
tests/test_torch_parallel_ranks.py, inside the job that file already
starts; here: an axis of size 1 counts nothing, the counter's grouping, the
efficiency model's arithmetic, and the JAX record it is set beside."""
import collections
import json
import math

import pytest

from gaussianprocesses_jl_tpu_torch.parallel import collectives
from gaussianprocesses_jl_tpu_torch.perf import comm_model


def test_size_one_axes_count_nothing():
    """On one process every collective is the identity: each path runs and
    hands torch.distributed no byte."""
    out = comm_model.measure_paths(1)
    assert set(out) == set(comm_model.PATHS)
    assert all(rec["ops"] == {} for rec in out.values())
    assert not collectives.BYTES and not collectives.CALLS


def test_by_op_sums_axes_and_dtypes():
    b = collections.Counter({("allreduce", "j", "float32"): 8, ("allreduce", "data", "int32"): 4,
                             ("shift", "j", "float64"): 64})
    c = collections.Counter({("allreduce", "j", "float32"): 2, ("allreduce", "data", "int32"): 1,
                             ("shift", "j", "float64"): 3})
    assert comm_model.by_op(b, c) == {"allreduce": {"count": 3, "bytes": 12},
                                      "shift": {"count": 3, "bytes": 64}}


def test_efficiency_model_arithmetic():
    """t_comm = calls * latency * log2(P) + bytes / bandwidth, at the
    configuration's width; efficiency t_comp / (t_comp + t_comm), falling
    with P."""
    measured = {p: {"per_iter": {"allreduce": {"count": 2.0, "bytes": 1000.0}}}
                for p in comm_model.CONFIGS}
    rows = comm_model.efficiency_model({P: measured for P in (2, 4, 8)})
    assert len(rows) == len(comm_model.CONFIGS) * len(comm_model.LINKS) * 3
    row = next(r for r in rows if r["path"] == "sharded_fitc_vg" and r["link"] == "NDR_IB"
               and r["processes"] == 4)
    cfg, link = comm_model.CONFIGS["sharded_fitc_vg"], comm_model.LINKS["NDR_IB"]
    t_comm = (2.0 * link["latency_s"] * math.log2(4)
              + 1000.0 * cfg["bytes_scale"] / link["bw_B_per_s"])
    assert row["t_comm_per_iter_ms"] == pytest.approx(1e3 * t_comm, rel=1e-12)
    t = cfg["t_comp_ms"] * 1e-3
    assert row["efficiency_pct"] == pytest.approx(100 * t / (t + t_comm), rel=1e-12)
    for path in comm_model.CONFIGS:
        effs = [r["efficiency_pct"] for r in rows if r["path"] == path and r["link"] == "NVLink4"]
        assert effs == sorted(effs, reverse=True)


def test_jax_record_holds_every_path():
    """Each path is set beside the JAX model's payload of the same name."""
    payloads = json.loads(comm_model.JAX_JSON.read_text())["payloads"]
    assert all(comm_model.JAX_KEYS[p] in payloads for p in comm_model.PATHS)
