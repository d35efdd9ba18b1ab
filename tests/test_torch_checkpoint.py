"""The port's checkpoints (utils/checkpoint.py): a nested state of tensors
and Python scalars round-trips through one .npz, with each leaf's dtype,
device and type; a file written for another structure, leaf count or leaf
shape is refused; the write is atomic."""
import os

import numpy as np
import pytest
import torch

from gaussianprocesses_jl_tpu_torch.utils import checkpoint
from gaussianprocesses_jl_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def _state(seed=0):
    rng = np.random.RandomState(seed)
    return {"carry": {"theta": torch.as_tensor(rng.randn(4, 3)),
                      "da": (torch.tensor(0.1), torch.tensor(2.5, dtype=torch.float64)),
                      "acc": torch.arange(4), "n_win": 7},
            "it_done": 12, "rate": 0.25, "flag": True,
            "samples": [torch.as_tensor(rng.randn(2, 5).astype(np.float32)), None]}


def test_round_trip(tmp_path):
    path = str(tmp_path / "c.npz")
    st = _state()
    save_checkpoint(path, st)
    got = load_checkpoint(path, _state(1))
    flat_got, flat_ref = [], []
    assert checkpoint._flatten(got, flat_got) == checkpoint._flatten(st, flat_ref)
    for g, r in zip(flat_got, flat_ref):
        if isinstance(r, torch.Tensor):
            assert g.dtype == r.dtype and g.device == r.device and torch.equal(g, r)
        else:
            assert type(g) is type(r) and g == r
    assert got["samples"][1] is None and isinstance(got["carry"]["da"], tuple)


@pytest.mark.parametrize("change", ["structure", "extra_leaf", "missing_leaf", "shape"])
def test_a_different_state_is_refused(tmp_path, change):
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, _state())
    like = _state()
    if change == "structure":  # the same leaf count, another nesting
        like["carry"]["da"] = [like["carry"]["da"][0], like["carry"]["da"][1]]
    elif change == "extra_leaf":
        like["extra"] = torch.zeros(1)
    elif change == "missing_leaf":
        del like["rate"]
    else:
        like["carry"]["theta"] = torch.zeros(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        load_checkpoint(path, like)
    # without the stored structure, the leaf count and shapes are still held
    if change in ("extra_leaf", "missing_leaf", "shape"):
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files if k != "__treedef__"}
        np.savez(path, **arrays)
        with pytest.raises(ValueError):
            load_checkpoint(path, like)


def test_the_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves the previous checkpoint whole."""
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, _state(0))

    def failing(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", failing)
    with pytest.raises(OSError):
        save_checkpoint(path, _state(1))
    monkeypatch.undo()
    got = load_checkpoint(path, _state(1))
    assert torch.equal(got["carry"]["theta"], _state(0)["carry"]["theta"])
    assert not any(p.endswith(".npz") and p != "c.npz" for p in os.listdir(tmp_path))


def test_an_unknown_leaf_type_is_refused(tmp_path):
    with pytest.raises(TypeError):
        save_checkpoint(str(tmp_path / "c.npz"), {"a": "text"})
