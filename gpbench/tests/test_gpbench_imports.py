"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""
import ast
import json
import subprocess
import sys
from pathlib import Path

from gpbench import harness

GPBENCH = Path(harness.__file__).resolve().parent
PORT = "gaussianprocesses_jl_tpu_torch"


def _imports(path: Path):
    """Top-level names of the modules a file imports (absolute imports)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in GPBENCH.rglob("*.py") if "tests" not in p.relative_to(GPBENCH).parts)


def test_no_source_imports_jax():
    for path in _sources():
        bad = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    for path in sorted((GPBENCH / "reference").glob("*.py")):
        names = set(_imports(path))
        assert PORT not in names, path
        assert not names & set(harness.FORBIDDEN), path


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted(sys.modules)))"],
                         cwd=GPBENCH.parent, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_program_module():
    mods = _modules_after("import gpbench.reference.gpe_se_d10, gpbench.reference.gpa_bern_mat32, "
                          "gpbench.reference.diagnostics")
    tops = {m.split(".")[0] for m in mods}
    assert PORT not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_a_whole_run_loads_no_jax():
    """A CPU run of every cell at a small size, in a fresh process, then the
    top-level names of everything it loaded, compared whole."""
    code = ("import sys; sys.argv = ['x']\n"
            "from gpbench.tests.helpers import small_run, SMALL\n"
            "for cell in SMALL: small_run(cell, seconds=0.2)\n")
    tops = {m.split(".")[0] for m in _modules_after(code)}
    assert PORT in tops  # the program ran
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)
