"""Small sizes at which the benchmark's cells run on the CPU in a test."""
from __future__ import annotations

import torch

from gpbench import harness

SMALL = {
    "gpe_se.fit3000": {"traffic": {"n": 200, "warmup_restarts": 1, "pool": 4}},
    "gpa_bern.map": {"config": {"n": 60, "layout": {"latent": 60}},
                     "traffic": {"warmup_restarts": 1, "pool": 4}},
    "gpa_bern.hmc128": {"config": {"n": 40, "layout": {"latent": 40}},
                        "traffic": {"chains": 8, "burn_in": 2, "chunk": 2}},
}


def small_run(cell: str, seed: int = 12345, seconds: float = 1.0, trace: bool = False,
              make_program=None, overrides: dict | None = None) -> dict:
    """One run of the cell on the CPU at its small size (`overrides` on top)."""
    spec = harness.load_spec()
    c = harness.resolve(spec, cell, seed, seconds, trace, torch.device("cpu"),
                        harness._merge(SMALL[cell], overrides), make_program)
    return harness.run(c)
