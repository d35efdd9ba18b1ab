"""The port's process meshes (parallel/mesh.py): the JAX package's
validation of a multi-process configuration (tests/test_parallel.py), on
torch.distributed's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
RANK); an unconfigured job stays single-process with a warning; the
layouts of make_mesh and make_pod_mesh in one process (two processes:
tests/test_torch_chains.py)."""
import warnings

import pytest
import torch.distributed as dist

from gaussianprocesses_jl_tpu_torch.parallel import mesh as mesh_mod
from gaussianprocesses_jl_tpu_torch.parallel.mesh import (
    _distributed_kwargs,
    initialize_distributed,
    make_mesh,
    make_pod_mesh,
)

ENV = {"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "2", "RANK": "0"}


@pytest.mark.parametrize("args,env,expected", [
    (("host:1234", 4, 2), {}, {"init_method": "tcp://host:1234", "world_size": 4, "rank": 2}),
    ((), ENV, {"init_method": "tcp://h:1", "world_size": 2, "rank": 0}),
    (("file:///tmp/x", 2, 1), {}, {"init_method": "file:///tmp/x", "world_size": 2, "rank": 1}),
    ((None, 3, 1), {"MASTER_ADDR": "h", "MASTER_PORT": "9"},
     {"init_method": "tcp://h:9", "world_size": 3, "rank": 1}),
    ((), {}, {}),
])
def test_configurations_resolve(args, env, expected):
    assert _distributed_kwargs(*args, env=env) == expected


@pytest.mark.parametrize("args,env,match", [
    (("h:1",), {}, "requires"),
    (("h:1", 2), {}, "requires"),
    ((None, 2), {}, "together"),
    ((None, None, 0), {}, "together"),
    ((None, 2, 0), {}, "address"),
    ((), {"MASTER_ADDR": "h"}, "together"),
    ((), {"MASTER_PORT": "1"}, "together"),
    ((), {**ENV, "WORLD_SIZE": "four"}, "must be an int"),
    ((), {**ENV, "RANK": "x"}, "must be an int"),
    ((), {**ENV, "MASTER_PORT": "p"}, "must be an int"),
    (("h:1", 2, 5), {}, "out of range"),
    (("h:1", 0, 0), {}, "out of range"),
])
def test_half_or_malformed_configurations_raise(args, env, match):
    with pytest.raises(ValueError, match=match):
        _distributed_kwargs(*args, env=env)


def test_an_unconfigured_job_warns_and_stays_single_process(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert initialize_distributed() is False
    assert any("single-process" in str(r.message) for r in rec)
    assert not dist.is_initialized()


def test_an_explicit_configuration_whose_rendezvous_fails_raises(tmp_path):
    """A rank out of the job's range is refused before any rendezvous; an
    init URL torch cannot use re-raises torch's error."""
    with pytest.raises(ValueError, match="out of range"):
        initialize_distributed(f"file://{tmp_path}/r", 1, 3)
    with pytest.raises((RuntimeError, ValueError)):
        initialize_distributed("nosuchscheme://x", 1, 0)
    assert not dist.is_initialized()


def test_one_process_meshes():
    m = make_mesh(device="cpu")
    assert m.axis_names == ("chains",) and m.shape == {"chains": 1}
    assert m.coords == {"chains": 0} and m.groups == {"chains": None}
    named = make_mesh({"data": 1}, device="cpu")
    assert named.axis_names == ("data",)
    pod = make_pod_mesh({"j": 1}, device="cpu")
    assert pod.axis_names == ("chains", "j") and pod.shape == {"chains": 1, "j": 1}
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh({"chains": 2}, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_pod_mesh({"j": 4}, device="cpu")


def test_the_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(mesh_mod.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
