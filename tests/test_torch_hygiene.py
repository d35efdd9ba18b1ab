"""The PyTorch port stands alone: it and chip_smoke.py import neither JAX
nor the JAX package, and importing them builds nothing."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "gaussianprocesses_jl_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "gaussianprocesses_jl_tpu")


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import gaussianprocesses_jl_tpu_torch\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "from gaussianprocesses_jl_tpu_torch.ops import cuda\n"
        "assert not cuda._loaded, 'importing loaded a kernel library'\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(
                node.func, "id", None)) in ("import_module", "__import__")
                and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_source_scan_finds_no_jax_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        bad = [m for m in _imported_roots(path) if m in FORBIDDEN]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
