"""Build and load the package's CUDA kernels.

Each source under `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into
a shared library with a plain C interface, loaded with `ctypes`. Nothing
is built when the package is imported: a kernel's library is built at its
first launch, or ahead of time by `build()`. The library's file name holds
a hash of its source, the `csrc` files it includes, and the flags, so a
stale build is never loaded.

Every C entry of those libraries is called through `call`: `entry` binds it
once with the argument types of its `extern "C" int name(...)` declaration
in the source; `call` passes the current stream to an entry that takes one
and raises on the `cudaError_t` it returns. `max_blocks` asks a cooperative
kernel's occupancy query how large a grid the card takes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["SOURCES", "build", "load", "entry", "call", "max_blocks"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# every kernel source of the package
SOURCES = ("gram.cu", "cholesky.cu", "leapfrog.cu", "marker.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.M)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _source_bytes(source: str) -> bytes:
    """The source's text, then that of each `csrc` file it includes."""
    text = (CSRC / source).read_bytes()
    return text + b"".join(_source_bytes(name.decode()) for name in _INCLUDE.findall(text))


def library_path(source: str) -> Path:
    text = _source_bytes(source) + " ".join(NVCC_FLAGS).encode()
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


# ctypes types of the declarations' non-pointer parameters
_PARAM_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong}


class _Stream(ctypes.c_void_p):
    """An entry's last parameter `void* stream`: `call` passes the current
    stream there."""


def _arg_types(source: str, name: str) -> list:
    """The ctypes argument types of `extern "C" int name(...)` in `source`
    or a `csrc` file it includes: every pointer c_void_p (`_Stream` for a
    last `void* stream`), `int` c_int, `long long` c_longlong. Raises on
    any other type, or where no such declaration is found."""
    decl = re.search(r'extern "C" int\s+' + re.escape(name) + r"\s*\(([^)]*)\)",
                     _source_bytes(source).decode())
    if decl is None:
        raise ValueError(f'{source}: no declaration extern "C" int {name}(...)')
    params = [p.strip() for p in decl.group(1).split(",") if p.strip()]
    types = []
    for i, param in enumerate(params):
        if "*" in param:
            stream = i == len(params) - 1 and re.fullmatch(r"void\s*\*\s*stream", param)
            types.append(_Stream if stream else ctypes.c_void_p)
            continue
        t = _PARAM_TYPES.get(" ".join(re.sub(r"\bconst\b", " ", param).split()[:-1]))
        if t is None:
            raise ValueError(f"{source}: {name}: no ctypes type for the parameter {param!r}")
        types.append(t)
    return types


_ENTRIES: dict = {}  # (source, name) -> the bound C function


def entry(source: str, name: str):
    """The C function `name` of `source`'s library (built first if missing),
    bound once: it returns a cudaError_t, and its argument types are those
    of its declaration."""
    fn = _ENTRIES.get((source, name))
    if fn is None:
        fn = getattr(load(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _arg_types(source, name)
        _ENTRIES[source, name] = fn
    return fn


def call(source: str, name: str, *args, device: torch.device | None = None) -> None:
    """Call the C entry `name` of `source` with `args` and raise on a nonzero
    cudaError_t. An entry whose last parameter is the stream gets the
    current stream of `device` (a CUDA device), the current device switched
    only when it is another; any other entry is called as it is."""
    fn = entry(source, name)
    if fn.argtypes and fn.argtypes[-1] is _Stream:
        if device.index == torch.cuda.current_device():
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError_t {err}")


def max_blocks(source: str, name: str) -> int:
    """The most blocks of a cooperative kernel that fit on the current
    device at once, from its occupancy query `int name(int* blocks)`;
    raises when not one fits."""
    blocks = ctypes.c_int(0)
    call(source, name, ctypes.byref(blocks))
    if blocks.value < 1:
        raise RuntimeError(f"{name}: no block of the kernel fits on the card")
    return blocks.value
