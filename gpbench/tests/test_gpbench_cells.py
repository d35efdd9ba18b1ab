"""A later change adds a cell, a traffic mix and a per-layer metric with new
files and new entries alone; each cell runs end to end on the CPU at a
small size and prints its result as the contract asks."""
import json
import shutil
import subprocess
import sys

import pytest

from gpbench import harness
from gpbench.tests.helpers import SMALL, small_run


def test_a_new_cell_from_new_files_only(tmp_path):
    """A copy of the benchmark gains a traffic file, a metric reader and
    their entries in BENCHMARK.json, and no other edit; its new cell runs
    and reports the new metric."""
    shutil.copytree(harness.ROOT, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    spec = harness.load_spec()
    with open(harness.ROOT / "traffic" / "fit3000.json") as f:
        traffic = json.load(f)
    traffic.update(n=150, pool=2, warmup_restarts=1, maxiter=5)
    (tmp_path / "gpbench" / "traffic" / "fit150.json").write_text(json.dumps(traffic))
    (tmp_path / "gpbench" / "metrics" / "dummy.restarts.py").write_text(
        "def read(ctx):\n    return float(ctx.record.attempted)\n")
    spec["workloads"].append({"name": "gpe_se.fit150", "config": "gpe_se_d10",
                              "traffic": "fit150", "chips": 1, "why": "a test's cell"})
    next(m for m in spec["end_to_end"] if m["name"] == "fit_iters_per_s")["workloads"].append(
        "gpe_se.fit150")
    spec["per_layer"].append({"name": "dummy.restarts", "unit": "restarts", "better": "higher",
                              "source": "program_counter", "layer": "trainer (test)",
                              "moves": "fit_iters_per_s", "workloads": ["gpe_se.fit150"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json, torch\n"
            f"sys.path[:0] = [{str(tmp_path)!r}, {str(harness.CHECKOUT)!r}]\n"
            "from gpbench import harness\n"
            "assert harness.CHECKOUT.resolve() == __import__('pathlib').Path("
            f"{str(tmp_path)!r}).resolve()\n"
            "cell = harness.resolve(harness.load_spec(), 'gpe_se.fit150', 7, 0.2, True,"
            " torch.device('cpu'))\n"
            "print(json.dumps(harness.run(cell)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["metrics"]["dummy.restarts"]["value"] == result["attempted"] > 0
    assert result["correct"] is True


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_and_is_correct_on_the_cpu(cell):
    result = small_run(cell, seed=2 ** 31 + 17)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    spec = harness.load_spec()
    e2e = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == e2e
    assert all(v["value"] > 0 for v in result["metrics"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_run_reads_its_counters(cell):
    result = small_run(cell, seed=99, trace=True)
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    spec = harness.load_spec()
    names = {m["name"] for m in spec["per_layer"] if cell in m["workloads"]}
    # on the CPU only the program's counters have something to read
    assert set(result["metrics"]) <= names
    assert list(result)[-1] == "checks"


def test_main_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "gpa_bern.hmc128", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_main_refuses_when_jax_is_loaded_after_the_window(monkeypatch, capsys):
    """A module named jax that turns up after the window (a reader or the
    reference loading it) leaves no result line."""
    import types

    monkeypatch.setattr(harness.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(harness.torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "resolve", lambda *a, **k: None)

    def run(cell):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return {"correct": True}

    monkeypatch.setattr(harness, "run", run)
    rc = harness.main(["--workload", "gpa_bern.map", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 4 and out.out == "" and "jax" in out.err


def test_main_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copytree(harness.ROOT, tmp_path / "gpbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(harness.CHECKOUT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "gpbench.run", "--workload", "gpa_bern.map",
                          "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                         text=True)
    assert out.returncode != 0 and out.stdout == ""
