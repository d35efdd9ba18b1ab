"""Build and load the package's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into
a shared library with a plain C interface, loaded with `ctypes`. Nothing
is built when the package is imported: a kernel's library is built at its
first launch, or ahead of time by `build()`. The library's file name holds
a hash of its source and flags, so a stale build is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build", "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source of the package
SOURCES = ("gram.cu", "cholesky.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}_{digest}.so"


def build(sources=SOURCES) -> dict:
    """Compile every source whose library is missing, all nvcc processes
    at once. Returns {source: compiler log} for the sources it compiled
    (the log holds ptxas's register and spill counts)."""
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for src in sources:
        so = library_path(src)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for src, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode != 0:
            failed.append(f"{src}:\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if missing."""
    lib = _loaded.get(source)
    if lib is None:
        build((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        _loaded[source] = lib
    return lib
