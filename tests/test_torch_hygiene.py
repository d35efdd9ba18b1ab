"""The PyTorch port stands alone: it and chip_smoke.py import neither JAX
nor the JAX package, and importing them builds nothing. Its lowest layer,
`utils/`, imports nothing from the layers above it, and the argument types
`ops/cuda.py` binds the kernels' C entries with are those the sources
declare."""
import ast
import ctypes
import pathlib
import subprocess
import sys

import pytest

from gaussianprocesses_jl_tpu_torch.ops import cuda

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


def _imported_modules(path):
    """The port's modules `path` imports from, relative to the package
    (`ops.cuda`, `models`, ...)."""
    pkg = list(path.relative_to(PORT).parent.parts)
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level > 0:
            base = pkg[:len(pkg) - node.level + 1] + (node.module.split(".") if node.module else [])
            for alias in node.names:
                yield ".".join(base + [alias.name])
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module]
            for name in names:
                if name and name.startswith(PORT.name + "."):
                    yield name[len(PORT.name) + 1:]


def test_utils_import_nothing_from_the_layers_above():
    files = sorted((PORT / "utils").glob("*.py"))
    assert len(files) > 3
    for path in files:
        for mod in _imported_modules(path):
            parts = mod.split(".")
            above = parts[0] in ("models", "inference", "parallel") or (
                parts[0] == "ops" and parts[1:2] != ["cuda"])
            assert not above, f"{path.relative_to(ROOT)} imports {mod}"


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the argument types the launchers bound each entry with by hand, by source
# (every pointer c_void_p, the stream last where an entry takes one)
BOUND = {
    "gram.cu": {
        "gram_f32": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I, _P],
        "gram_f64": [_P] * 4 + [_I] * 6 + [_L] * 3 + [_I, _P],
        "gram_vjp_f32": [_P] * 8 + [_I] * 9 + [_L] * 3 + [_I, _P],
        "gram_vjp_f64": [_P] * 8 + [_I] * 9 + [_L] * 3 + [_I, _P],
    },
    "cholesky.cu": {
        "launch_probe_f32": [_P, _I, _P, _I, _P],
        "panel_max_blocks": [_P],
        "chol_inv_panel_f32": [_P, _P, _P, _I, _I, _P, _P],
        "single_launch_max_blocks": [_P],
        "single_launch_cholesky_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    },
    "leapfrog.cu": {
        "leapfrog_probit_f32": [_P] * 12 + [_I, _I, _I] + [_P] * 5 + [_P],
        "leapfrog_probit_f64": [_P] * 12 + [_I, _I, _I] + [_P] * 5 + [_P],
    },
    "marker.cu": {"gp_mark": [_I, _P]},
    "panel_parts.cu": {
        "tile_bench_f32": [_P, _P, _P, _I],
        "gemm_bench_f32": [_P, _P, _P, _I, _I, _I],
        "sync_bench_max_blocks": [_P],
        "sync_bench_run": [_I, _I],
    },
    "single_parts.cu": {
        "deep_bench_max_blocks": [_P],
        "gemm_bench_max_blocks": [_P],
        "deep_bench_run": [_P, _P, _P, _I, _I, _I, _I, _I],
        "gemm_bench_run": [_P, _P, _I, _I, _I, _I, _I],
    },
}


@pytest.mark.parametrize("source", cuda.SOURCES + ("panel_parts.cu", "single_parts.cu"))
def test_entries_take_the_argument_types_their_sources_declare(source):
    """Each entry's types as `ops/cuda.py` reads them from the source, every
    pointer as c_void_p; the stream parameter, last, of every launch of the
    package's own sources and of no occupancy query or perf part."""
    assert set(BOUND) == set(cuda.SOURCES) | {"panel_parts.cu", "single_parts.cu"}
    for name, want in BOUND[source].items():
        got = cuda._arg_types(source, name)
        assert [_P if issubclass(t, _P) else t for t in got] == want, name
        streamed = source in cuda.SOURCES and not name.endswith("_max_blocks")
        assert (got[-1] is cuda._Stream) == streamed, name


def test_an_undeclared_parameter_type_is_refused(monkeypatch):
    """A parameter type with no ctypes type here raises, naming the source
    and the entry; so does an entry the source does not declare."""
    monkeypatch.setattr(cuda, "_source_bytes", lambda source: (
        b'extern "C" int scale_f32(float* x, float alpha, int n, void* stream) {}'))
    with pytest.raises(ValueError, match=r"fake\.cu: scale_f32: .*'float alpha'"):
        cuda._arg_types("fake.cu", "scale_f32")
    with pytest.raises(ValueError, match="no declaration"):
        cuda._arg_types("fake.cu", "shift_f32")
