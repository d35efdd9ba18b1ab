"""The benchmark's driver: one cell, one run, one result line.

    python3 -m gpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

`BENCHMARK.json` at the root of the checkout names the cells. A cell is a
configuration under a traffic mix, and the harness finds everything of it
by name:

  * `gpbench/configs/<config>.json`: the configuration's sizes (the path
    `BENCHMARK.json` gives); `gpbench/configs/<config>.py`: its data, made
    from the run's generator, and the program under test (`Program`);
  * `gpbench/reference/<config>.py`: its plain reference and its control;
  * `gpbench/counts/<config>.py`: its operations and bytes;
  * `gpbench/traffic/<traffic>.json`: the mix's parameters; its "kind"
    names the loop in `gpbench/loops/<kind>.py` that generates it;
  * `gpbench/metrics/<metric>.py`: each per-layer metric's reader.

A run: set-up (timed: `setup_s`), the measured window, the device's peak
memory, a look for JAX in the process, then, with the program's state
freed, the comparison with the reference that decides `correct`, and a
second look for JAX just before the result line is printed. With
`--trace 0` the result's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a torch.profiler session over
the window's first `trace_items` work items and from the program's
counters. The numbers compared print last on standard error, each with
its limit, and under "checks", the result line's last key.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace
from typing import Callable

import torch

from . import port, roofline
from .profile import Tracer, idle_gaps, top_ops

__all__ = ["ROOT", "CHECKOUT", "FORBIDDEN", "Cell", "load_spec", "resolve", "run", "main",
           "forbidden_modules", "cache_env"]

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
# top-level module names that no run of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaussianprocesses_jl_tpu")


def cache_env(checkout: Path = CHECKOUT) -> None:
    """Every build and kernel cache of the run at a fixed path inside the
    checkout. The package builds its CUDA kernels into its own `_build`
    directory, inside the checkout too."""
    cache = checkout / "gpbench" / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def load_spec(checkout: Path = CHECKOUT) -> dict:
    with open(checkout / "BENCHMARK.json") as f:
        return json.load(f)


def _module(kind: str, name: str):
    """gpbench/<kind>/<name>.py, imported once."""
    modname = f"gpbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    path = ROOT / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    chips: int
    builder: object
    reference: object
    counts: object
    loop: object
    end_to_end: list  # BENCHMARK.json's entries that this cell reports
    per_layer: list
    make_program: Callable = None
    notes: dict = field(default_factory=dict)  # what a loop's check found beside its numbers


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _reports(entry: dict, cell: str, e2e_names: set | None = None) -> bool:
    """Whether the cell reports the metric: the cells its "workloads" list,
    else every cell (a per-layer metric: every cell that reports the
    end-to-end metric it moves)."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry["moves"] in e2e_names


def resolve(spec: dict, workload: str, seed: int, seconds: float, trace: bool,
            device: torch.device, overrides: dict | None = None,
            make_program: Callable | None = None, checkout: Path = CHECKOUT) -> Cell:
    """The cell `workload` of the spec, with its files loaded; `overrides`
    ({"config": {...}, "traffic": {...}}) replace parts of them (the tests
    run cells at small sizes), `make_program` the program (the control and
    the tests' faults stand in for it)."""
    w = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    centry = next(c for c in spec["configs"] if c["name"] == w["config"])
    with open(checkout / centry["file"]) as f:
        config = _merge(json.load(f), (overrides or {}).get("config"))
    with open(ROOT / "traffic" / f"{w['traffic']}.json") as f:
        traffic = _merge(json.load(f), (overrides or {}).get("traffic"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, {m["name"] for m in e2e})]
    builder = _module("configs", centry["name"])
    return Cell(
        name=workload, config=config, traffic=traffic, seed=seed % (1 << 64), seconds=seconds,
        trace=trace,
        device=device, chips=w["chips"], builder=builder,
        reference=_module("reference", centry["name"]), counts=_module("counts", centry["name"]),
        loop=importlib.import_module(f"gpbench.loops.{traffic['kind']}"), end_to_end=e2e,
        per_layer=per_layer, make_program=make_program or builder.Program)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_and_card(cpu_s: float, window_s: float) -> str:
    """What the host and the card were doing as the window closed, for the
    log (a whole run that reads slow shows here): the host's load, the
    process's CPU seconds over the window's, and the card's SM clock
    against its maximum, its power and the reasons it is held back."""
    out = f"loadavg {' '.join(f'{v:.2f}' for v in os.getloadavg())} cpu_share {cpu_s / window_s:.3f}"
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                            "temperature.gpu,clocks_throttle_reasons.active",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        out += f" card {q.stdout.strip()}"
    except (OSError, subprocess.SubprocessError):
        pass
    return out


def _per_layer(cell: Cell, state, record, trace) -> dict:
    if trace is not None:
        trace.read()
    ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic, counts=cell.counts,
                          state=state, record=record, trace=trace,
                          peak_flops=roofline.peak_flops(cell.config["precision"]))
    out = {}
    for m in cell.per_layer:
        value = _module("metrics", m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(cell: Cell, log=sys.stderr) -> dict:
    """One run of the cell: the result as a dict ("checks" last)."""
    dev = cell.device
    if dev.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = cell.loop.setup(cell)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    tracer = Tracer(cell.trace, cell.traffic["trace_items"], port.launch_counters)
    cpu0 = time.process_time()
    record = cell.loop.window(cell, state, tracer)
    _sync(dev)
    host_and_card = _host_and_card(time.process_time() - cpu0, record.window_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run loaded {', '.join(found)}")
    state.program = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": int(record.attempted),
              "failed": int(record.failed), "metrics": {}, "device": device}
    if cell.trace:
        trace = tracer.trace
        result["metrics"] = _per_layer(cell, state, record, trace)
        if trace is not None:
            device["busy_s"], device["window_s"] = trace.busy_s, trace.window_s
            result["breakdown"] = {"device_ops": top_ops(trace.ops),
                                   "idle_gaps": idle_gaps(trace.ops, trace.host)}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(cell.loop.end_to_end(cell, state, record), setup_s=setup_s)
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                             if k in units}
    for key, value in getattr(record, "diagnostics", {}).items():
        print(f"{key} {value}", file=log)
    checks = cell.loop.check(cell, state, record)
    result["correct"] = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    print(f"window_s {record.window_s} setup_s {setup_s} {host_and_card}", file=log)
    for name, v, lim in checks:
        print(f"check {name} {v} limit {lim} {'ok' if v <= lim else 'FAILED'}", file=log)
    return result


def _args(argv):
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    cache_env()
    spec = load_spec()
    w = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if w is None:
        print(f"gpbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"gpbench: the cell needs {w['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    try:
        import gaussianprocesses_jl_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"gpbench: the program under test is missing: {e}", file=sys.stderr)
        return 2
    cell = resolve(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0))
    try:
        result = run(cell)
    except RuntimeError as e:
        if forbidden_modules():
            print(f"gpbench: {e}", file=sys.stderr)
            return 4
        raise
    found = forbidden_modules()  # again: the readers and the reference ran after the window
    if found:
        print(f"gpbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
