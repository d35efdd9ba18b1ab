"""BENCHMARK.json keeps the benchmark's contract, and every name in it has
its files."""
import json
import re
from pathlib import Path

import pytest

from gpbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]


def test_keys_and_sizes():
    assert list(SPEC) == TOP
    raw = (harness.CHECKOUT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32 and all(TEXT.match(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p and not p.startswith("/")
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 seconds
    cells = 24
    assert (2 + 14 * cells) * (SPEC["run_seconds"] + 60) + cells * 2 * 90 + 1200 <= 43200


def test_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for c in SPEC["configs"]:
        assert set(c) == keys["configs"]
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and NAME.match(c["name"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert (harness.CHECKOUT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        with open(harness.CHECKOUT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] and len(cfg["source"]) <= 200
        for kind in ("configs", "reference", "counts"):
            assert (harness.ROOT / kind / f"{c['name']}.py").is_file()
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == keys["workloads"] and NAME.match(w["name"]) and TEXT.match(w["why"])
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert (harness.ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert 1 <= len(SPEC["end_to_end"]) <= 16 and 1 <= len(SPEC["per_layer"]) <= 128
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    layers = {}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and TEXT.match(
            m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells and cell in e2e[m["moves"]].get("workloads", cells)
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers
    for cell in cells:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        reports = [m for m in SPEC["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reports) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


@pytest.mark.parametrize("name", sorted(p.stem for p in (harness.ROOT / "traffic").glob("*.json")))
def test_traffic_names_a_loop_and_limits(name):
    with open(harness.ROOT / "traffic" / f"{name}.json") as f:
        traffic = json.load(f)
    loop = harness.importlib.import_module(f"gpbench.loops.{traffic['kind']}")
    assert callable(loop.setup) and callable(loop.check)
    assert traffic["limits"] and all(v > 0 for v in traffic["limits"].values())
    assert traffic["source"]  # where the mix comes from


def test_paths_hold_the_benchmark_only():
    for p in SPEC["paths"]:
        assert Path(harness.CHECKOUT / p).resolve() == harness.ROOT
