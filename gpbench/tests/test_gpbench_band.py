"""The accept band of the "hmc" check (`gpbench/loops/hmc.py`): a decision
that the program makes the other way from the reference is excused where the
reference's margin lies inside the band that float32's error sets at that
state, and reads as a fault beyond it; the band reads the reference's inputs
alone. On the CPU at the cell's small size, whose start is so well
conditioned that s is ~1e-8: KAPPA is raised there so that bands cover
margins of 0.03-0.4, and the window is 0 s (one chunk, whatever the host)."""
import json

import pytest
import torch

import gaussianprocesses_jl_tpu_torch.inference.split as split
from gpbench import harness
from gpbench.loops import hmc
from gpbench.profile import Tracer
from gpbench.tests.helpers import SMALL, small_run

CELL, SEED, KAPPA = "gpa_bern.hmc128", 4242, 1e7
with open(harness.ROOT / "traffic" / "hmc128.json") as f:
    LIMIT = json.load(f)["limits"]["hmc_gap"]


def _first_iteration(make_program=None):
    """(gaps, margins, bands, moves) (a_iters + 1, C) of the burn-in's first
    outer iteration, which the check always follows; a move is the size of
    the update as the program made it, the gap it would read if the program
    had rejected it."""
    spec = harness.load_spec()
    cell = harness.resolve(spec, CELL, SEED, 0.0, False, torch.device("cpu"), SMALL[CELL],
                           make_program)
    state = cell.loop.setup(cell)
    record = cell.loop.window(cell, state, Tracer(False, 1, dict))
    it, args = hmc._inputs(cell, state, record)[0]
    g, m = hmc._gaps(cell, state, *args)
    a_in, b_in, _, _, rows, b_out = args
    n = a_in.shape[1]
    before = torch.cat([a_in[:, None], rows[:, :-1, :n]], 1)
    moves = (rows[:, :, :n] - before).abs().amax(-1) / rows[:, :, :n].abs().amax(-1).clamp_min(1)
    moves = torch.cat([moves.T.double(), torch.zeros_like(m[:1])])  # the B update's left out
    return g, m, hmc.band(cell, state, it, args, m), moves


def _flip(monkeypatch, update: int, chain: int):
    """The program's accept test decides the other way at one A update of
    one chain in its first outer iteration: the proposal it accepted is
    rejected (the chain keeps its position, target and gradient)."""
    orig = split.hmc_iteration
    calls = []

    def hmc_iteration(vg, theta, tgt, grad, stream, *args, **kwargs):
        new = orig(vg, theta, tgt, grad, stream, *args, **kwargs)
        calls.append(None)
        if len(calls) - 1 != update:
            return new
        keep = torch.arange(theta.shape[0], device=theta.device) == chain
        th, t, g = (torch.where(keep.view(-1, *[1] * (x.ndim - 1)), old, x)
                    for x, old in zip(new[:3], (theta, tgt, grad)))
        return (th, t, g) + tuple(new[3:])

    monkeypatch.setattr(split, "hmc_iteration", hmc_iteration)


@pytest.fixture
def first(monkeypatch):
    monkeypatch.setattr(hmc, "KAPPA", KAPPA)
    return _first_iteration()


def _pick(first, inside: bool):
    """(update, chain) of an A update that the program accepted with a move
    over twice the limit, its margin outside ACCEPT_BAND and inside its
    band or beyond it."""
    _, m, bands, moves = first
    ok = (m > hmc.ACCEPT_BAND) & (moves > 2 * LIMIT) & ((m <= bands) if inside else (m > bands))
    u, c = ok.nonzero()[0].tolist()
    return u, c


def test_flip_inside_the_band_is_correct(monkeypatch, first):
    update, chain = _pick(first, inside=True)
    _flip(monkeypatch, update, chain)
    spec = harness.load_spec()
    cell = harness.resolve(spec, CELL, SEED, 0.0, False, torch.device("cpu"), SMALL[CELL])
    result = harness.run(cell)
    assert result["correct"] is True
    notes = cell.notes["hmc_band"]
    assert notes["excused"] >= 1 and notes["fixed_band_gap"] > LIMIT  # the fixed band fails it


def test_flip_beyond_the_band_is_not_correct(monkeypatch, first):
    update, chain = _pick(first, inside=False)
    _flip(monkeypatch, update, chain)
    assert small_run(CELL, seed=SEED, seconds=0.0)["correct"] is False


def test_band_reads_the_reference_inputs_alone(monkeypatch):
    """The control in the program's place starts the first update from the
    same state with the same draws: that update's bands are the program's
    to the bit, though its gaps differ."""
    monkeypatch.setattr(hmc, "KAPPA", KAPPA)
    g, _, bands, _ = _first_iteration()
    spec = harness.load_spec()
    control = harness.resolve(spec, CELL, SEED, 0.0, False, torch.device("cpu"),
                              SMALL[CELL]).reference.Control
    g_c, _, bands_c, _ = _first_iteration(control)
    assert torch.equal(bands[0], bands_c[0]) and (bands[0] > hmc.ACCEPT_BAND).any()
    assert not torch.equal(g[0], g_c[0])


def test_band_of_keeps_the_floor_where_a_margin_is_not_finite_in_float32():
    """KAPPA s where every margin is finite; the floor where the margin or a
    perturbed one is not finite, or beyond float32's range (a path that blew
    up); never under the floor."""
    inf = float("inf")
    m = torch.tensor([[0.5, 0.5, 0.5, -1e200, inf, 0.5]], dtype=torch.float64)
    perturbed = torch.tensor([[[0.6, 0.5001, 0.6, -1e226, inf, -1e39]],
                              [[0.3, 0.5002, inf, -1e227, inf, 0.4]]], dtype=torch.float64)
    band = hmc.band_of(m, perturbed)
    expect = [hmc.KAPPA * 0.2, hmc.ACCEPT_BAND] + [hmc.ACCEPT_BAND] * 4
    assert band[0].tolist() == pytest.approx(expect)
