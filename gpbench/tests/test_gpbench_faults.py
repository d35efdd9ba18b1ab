"""A run whose timed path is broken underneath comes out as not correct:
for each cell, a step that returns its state unchanged, half of the data
or of the chains left out, and an answer altered where it is produced.
(One card, so no exchange between chips to leave out.) The control, the
plain reference in TF32 in the program's place, comes out as not correct
too. On the CPU, at the cells' small sizes."""
import pytest
import torch

import gaussianprocesses_jl_tpu_torch.inference.lbfgs as lbfgs
import gaussianprocesses_jl_tpu_torch.inference.split as split
import gaussianprocesses_jl_tpu_torch.models.gpa as gpa
import gaussianprocesses_jl_tpu_torch.models.gpe as gpe
from gaussianprocesses_jl_tpu_torch.utils.modules import replace
from gpbench import harness
from gpbench.tests.helpers import SMALL, small_run


def _unchanged_step(monkeypatch):
    orig = lbfgs.iteration

    def iteration(vg, x, mem, rounds=lbfgs.TRIAL_BLOCK):
        return orig(vg, x, mem, rounds)._replace(x=x)

    monkeypatch.setattr(lbfgs, "iteration", iteration)


def _altered_fit(monkeypatch):
    orig = lbfgs.minimize

    def minimize(*args, **kwargs):
        r = orig(*args, **kwargs)
        return r._replace(x=r.x + 1e-2)

    monkeypatch.setattr(lbfgs, "minimize", minimize)


def _half_data(monkeypatch, module, name):
    orig = getattr(module, name)

    def target(params, X, y, *rest):
        h = X.shape[0] // 2
        if name == "gpa_target":  # the latents follow the data
            params = replace(params, v=params.v[:h])
        return orig(params, X[:h], y[:h], *rest)

    monkeypatch.setattr(module, name, target)


def _hmc(monkeypatch, how):
    orig = split.hmc_iteration

    def hmc_iteration(vg, theta, tgt, grad, stream, *args, **kwargs):
        new = orig(vg, theta, tgt, grad, stream, *args, **kwargs)
        th = new[0]
        if how == "unchanged":
            th = theta
        elif how == "half":
            th = torch.cat([th[: th.shape[0] // 2], theta[th.shape[0] // 2:]])
        else:
            th = th + 1e-2
        return (th,) + tuple(new[1:])

    monkeypatch.setattr(split, "hmc_iteration", hmc_iteration)


FAULTS = {
    "gpe_se.fit3000": {
        "unchanged_step": _unchanged_step,
        "half_data": lambda mp: _half_data(mp, gpe, "gpe_target"),
        "altered_answer": _altered_fit},
    "gpa_bern.map": {
        "unchanged_step": _unchanged_step,
        "half_data": lambda mp: _half_data(mp, gpa, "gpa_target"),
        "altered_answer": _altered_fit},
    "gpa_bern.hmc128": {
        "unchanged_step": lambda mp: _hmc(mp, "unchanged"),
        "half_data": lambda mp: _hmc(mp, "half"),
        "altered_answer": lambda mp: _hmc(mp, "altered")},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    FAULTS[cell][fault](monkeypatch)
    assert small_run(cell, seed=4242)["correct"] is False


# hmc128's control runs one chunk (a window of 0 s), whatever the host's speed, with the cell's
# own 128 chains: at the small size's 8 its gap sat near the limit (0.007-0.10 over ten seeds)
CONTROL_RUN = {"gpa_bern.hmc128": {"seconds": 0.0, "overrides": {"traffic": {"chains": 128}}}}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct(cell):
    spec = harness.load_spec()
    probe = harness.resolve(spec, cell, 5, 1.0, False, torch.device("cpu"), SMALL[cell])
    run = CONTROL_RUN.get(cell, {})
    assert small_run(cell, seed=5, make_program=probe.reference.Control, **run)["correct"] is False


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_is_not_correct_on_the_card(card, cell):
    """The control at the cell's own size, on three seeds."""
    from gpbench import control

    for row in control.readings(cell, [101, 102, 103], 3.0, False, card):
        assert row["correct"] is False, row
