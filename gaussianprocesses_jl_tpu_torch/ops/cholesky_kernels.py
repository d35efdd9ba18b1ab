"""The Cholesky study's kernels: `chol_inv_panel`, `single_launch_cholesky`
and `launch_probe`.

Counterparts of the Pallas kernels in `perf/pallas_cholesky_study.py`. On a
CUDA tensor each wrapper launches its hand-written kernel in
`csrc/cholesky.cu`; on a CPU tensor it runs its plain version, the study's
algorithm in plain PyTorch. The kernels take f32 only, like the TPU ones:
inputs are cast to f32 as the study casts them. Nothing in the package
routes its own factorization through these kernels; the study
(`perf/cholesky_study.py`) and `chip_smoke.py` drive them.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda

__all__ = ["LAUNCHES", "TILE", "launch_probe", "launch_probe_plain",
           "chol_inv_panel", "chol_inv_panel_plain", "chol_inv_panel_on_grid",
           "panel_grid_blocks", "panel_grid_syncs", "max_grid_blocks",
           "single_launch_cholesky", "single_launch_cholesky_plain",
           "single_launch_cholesky_on_grid", "single_launch_grid_syncs", "single_launch_phases",
           "single_launch_split"]

# kernel launches by name; each wrapper adds one where it launches
LAUNCHES = {"launch_probe": 0, "chol_inv_panel": 0, "single_launch_cholesky": 0}

# the CUDA kernels' tile edge and micro-panel width: every size they take is
# a multiple of it
TILE = 64

_F32 = torch.float32


_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of csrc/cholesky.cu and their argument types
_ARGTYPES = {
    "launch_probe_f32": [_P, _I, _P, _I, _P],
    "panel_max_blocks": [ctypes.POINTER(_I)],
    "chol_inv_panel_f32": [_P, _P, _P, _I, _I, _P, _P],
    "single_launch_max_blocks": [ctypes.POINTER(_I)],
    "single_launch_cholesky_f32": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
}
_ENTRIES: dict = {}


def _entry(name: str):
    """The bound C function `name`, the library built at first use."""
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(cuda.load("cholesky.cu"), name)
        fn.restype = _I
        fn.argtypes = _ARGTYPES[name]
        _ENTRIES[name] = fn
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError_t {err}")


def _launch(entry: str, kernel: str, device: torch.device, *args) -> None:
    """Call the C entry on `device`'s current stream, raise on a nonzero
    cudaError_t, and count one launch of `kernel`."""
    with torch.cuda.device(device):
        err = _entry(entry)(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, kernel)
    LAUNCHES[kernel] += 1


def _square(name: str, A: torch.Tensor) -> int:
    if A.ndim != 2 or A.shape[0] != A.shape[1] or A.shape[0] == 0:
        raise ValueError(f"{name}: need a non-empty square matrix, got shape {tuple(A.shape)}")
    if not A.dtype.is_floating_point:
        raise TypeError(f"{name}: need a floating-point matrix, got {A.dtype}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {A.device}")
    return A.shape[0]


# ---------------------------------------------------------------------------
# launch probe (study_launch_overhead's inner kernel)
# ---------------------------------------------------------------------------


def launch_probe_plain(A: torch.Tensor, n_iter: int) -> torch.Tensor:
    """A[:8, :128] + n_iter: what the probe computes."""
    return A[:8, :128] + float(n_iter)


def launch_probe(A: torch.Tensor, n_iter: int) -> torch.Tensor:
    """A chain of `n_iter` dependent scalar adds, then A[:8, :128] + n_iter,
    in one launch of one block: the time is one launch plus the chain."""
    if A.ndim != 2 or A.shape[0] < 8 or A.shape[1] < 128:
        raise ValueError(f"launch_probe: need at least 8 x 128, got shape {tuple(A.shape)}")
    if int(n_iter) != n_iter or not 0 <= n_iter < 2**24:
        raise ValueError(f"launch_probe: n_iter must be an integer in [0, 2^24), got {n_iter}")
    A = A.to(_F32)
    if A.device.type == "cpu":
        return launch_probe_plain(A, n_iter)
    if A.device.type != "cuda":
        raise ValueError(f"launch_probe: no kernel for device {A.device}")
    if A.stride(1) != 1:
        A = A.contiguous()
    out = torch.empty((8, 128), dtype=_F32, device=A.device)
    _launch("launch_probe_f32", "launch_probe", A.device,
            A.data_ptr(), A.stride(0), out.data_ptr(), int(n_iter))
    return out


# ---------------------------------------------------------------------------
# fused Cholesky + triangular inverse of one panel
# ---------------------------------------------------------------------------


def chol_inv_panel_plain(A: torch.Tensor, T: int = 128) -> tuple:
    """(L, L^-1) of the SPD matrix A by the study's `_panel_kernel`
    algorithm: for each T-wide micro-panel, a correction by the finished
    columns, the column chain of rank-1 updates, forward substitution on
    the diagonal tile; then the off-diagonal tiles of L^-1 assembled block
    row by block row. NaN on an indefinite panel."""
    B = A.shape[0]
    nt = B // T
    L = A.new_zeros((B, B))
    Linv = A.new_zeros((B, B))
    eye = torch.eye(T, dtype=A.dtype, device=A.device)
    for kt in range(nt):
        j0 = kt * T
        P = A[j0:, j0:j0 + T].clone()
        if kt > 0:
            P -= L[j0:, :j0] @ L[j0:j0 + T, :j0].T
        for j in range(T):  # the column chain
            col = P[:, j] * torch.rsqrt(P[j, j])
            col[:j] = 0.0
            P[:, j + 1:] -= col[:, None] * col[j + 1:T][None, :]
            P[:, j] = col
        L[j0:, j0:j0 + T] = P
        Ld = P[:T]
        X = eye.clone()
        for i in range(T):  # forward substitution
            X[i] = (eye[i] - Ld[i, :i] @ X[:i]) / Ld[i, i]
        Linv[j0:j0 + T, j0:j0 + T] = X
    for i in range(1, nt):
        for j in range(i):
            S = L[i * T:(i + 1) * T, j * T:i * T] @ Linv[j * T:i * T, j * T:(j + 1) * T]
            Di = Linv[i * T:(i + 1) * T, i * T:(i + 1) * T]
            Linv[i * T:(i + 1) * T, j * T:(j + 1) * T] = -(Di @ S)
    return L, Linv


def panel_grid_blocks(B: int, max_blocks: int) -> int:
    """The panel kernel's grid: the most tile products any of its phases
    has, capped by the blocks that fit on the card at once. That phase is
    step 1's (a): the diagonal tile, the trailing tiles and the L^-1 sums,
    (nt - 1)(nt + 2) / 2 with nt = B / 64. A grid sync costs more the
    larger the grid, so no block is launched to stay idle."""
    nt = B // TILE
    return max(1, min(max_blocks, (nt - 1) * (nt + 2) // 2))


def panel_grid_syncs(B: int) -> int:
    """Grid syncs the panel schedule has: two a 64-wide step, none after
    the last. The kernel counts those it passes (`chol_inv_panel_on_grid`'s
    `syncs`)."""
    return 2 * (B // TILE) - 1


def chol_inv_panel_on_grid(A: torch.Tensor, grid: int, syncs: torch.Tensor | None = None) -> tuple:
    """(L, L^-1) of the f32 CUDA matrix A (B % 64 == 0) from one cooperative
    launch of the panel kernel over `grid` blocks (1 <= grid <=
    max_grid_blocks("panel")). `chol_inv_panel` sizes the grid itself; this
    entry lets a measurement choose it. `syncs`, an int32 tensor of one
    element on A's device, gains the grid syncs the kernel passed."""
    B = _square("chol_inv_panel", A)
    if A.device.type != "cuda" or A.dtype != _F32 or B % TILE or not 1 <= grid:
        raise ValueError(f"chol_inv_panel_on_grid: need an f32 CUDA matrix with B % {TILE} == 0 "
                         f"and grid >= 1, got {A.dtype} on {A.device}, B = {B}, grid = {grid}")
    if syncs is not None and (syncs.dtype != torch.int32 or syncs.numel() != 1
                              or syncs.device != A.device):
        raise ValueError(f"chol_inv_panel_on_grid: syncs must be one int32 on {A.device}, got "
                         f"{syncs.dtype} of {syncs.numel()} elements on {syncs.device}")
    A = A.contiguous()
    L = torch.empty((B, B), dtype=_F32, device=A.device)
    Linv = torch.empty((B, B), dtype=_F32, device=A.device)
    _launch("chol_inv_panel_f32", "chol_inv_panel", A.device,
            A.data_ptr(), L.data_ptr(), Linv.data_ptr(), B, int(grid),
            None if syncs is None else syncs.data_ptr())
    return L, Linv


def chol_inv_panel(A: torch.Tensor, T: int = 128) -> tuple:
    """(L, L^-1) of one SPD B x B panel, f32, with exact zeros above the
    diagonal (NaN on an indefinite panel), in one cooperative launch over
    the card (`panel_grid_blocks` blocks).

    `T` is the study's micro-panel width: the plain version runs its
    algorithm with it, and B % T must be 0 (the study silently dropped the
    tail). The CUDA kernel's tiles are 64 wide whatever T is, so on the
    card B must also be a multiple of 64."""
    B = _square("chol_inv_panel", A)
    if T <= 0 or B % T:
        raise ValueError(f"chol_inv_panel: B = {B} is not a multiple of T = {T}")
    A = A.to(_F32)
    if A.device.type == "cpu":
        return chol_inv_panel_plain(A, T)
    if B % TILE:
        raise ValueError(f"chol_inv_panel: the kernel needs B % {TILE} == 0, got B = {B}")
    with torch.cuda.device(A.device):
        grid = panel_grid_blocks(B, max_grid_blocks("panel"))
    return chol_inv_panel_on_grid(A, grid)


# ---------------------------------------------------------------------------
# whole left-looking factorization in one launch
# ---------------------------------------------------------------------------

_STUDY_T = 128  # the study's micro-panel width inside the diagonal block
_DEEP_TILE = 128  # the single launch's product tile edge


def single_launch_cholesky_plain(K: torch.Tensor, B: int = 256, R: int = 1024) -> torch.Tensor:
    """The study's `_single_launch_kernel` in plain PyTorch: for each B-wide
    panel column, the left-looking correction by the finished columns, the
    diagonal block's L and L^-1 (`chol_inv_panel_plain`), the rows below
    times L^-1^T, zeros above. R, the study's row tile, changes no value."""
    n = K.shape[0]
    out = K.clone()
    for c in range(0, n, B):
        acc = out[c:, c:c + B].clone()
        if c > 0:
            acc -= out[c:, :c] @ out[c:c + B, :c].T
        Ld, Linv = chol_inv_panel_plain(acc[:B], _STUDY_T)
        out[c + B:, c:c + B] = acc[B:] @ Linv.T
        out[c:c + B, c:c + B] = Ld
        out[:c, c:c + B] = 0.0
    return out


_MAX_BLOCKS: dict = {}  # (kernel, device index) -> largest cooperative grid


def max_grid_blocks(kernel: str) -> int:
    """The most blocks of the cooperative kernel `kernel` ("panel" or
    "single_launch") that fit on the current CUDA device at once: the
    largest grid its launch accepts. Queried once per device."""
    key = (kernel, torch.cuda.current_device())
    if key not in _MAX_BLOCKS:
        blocks = ctypes.c_int(0)
        _raise_on(_entry(f"{kernel}_max_blocks")(ctypes.byref(blocks)),
                  f"{kernel} occupancy query")
        if blocks.value < 1:
            raise RuntimeError(f"{kernel}: no block of the kernel fits on the card")
        _MAX_BLOCKS[key] = blocks.value
    return _MAX_BLOCKS[key]


def single_launch_grid_syncs(n: int, B: int) -> int:
    """Grid syncs the single launch's schedule has: for each of the n / B
    panels, two for the correction (its pieces, their sum), the diagonal
    block's 2 nt - 1 (nt = B / 64) and one after it, two for the apply; none
    after the last panel. The kernel counts those it passes."""
    return (n // B) * (2 * (B // TILE) + 4) - 1


def single_launch_phases(n: int, B: int) -> list:
    """The part of the factorization each phase between two grid syncs
    belongs to, in order ("correction", "diagonal" or "apply"): one more
    than `single_launch_grid_syncs(n, B)`."""
    panel = ["correction"] * 2 + ["diagonal"] * (2 * (B // TILE)) + ["apply"] * 2
    return panel * (n // B)


def single_launch_split(stamps: torch.Tensor, n: int, B: int) -> dict:
    """{part + "_ms": milliseconds} of one launch from its block-0 stamps
    (`single_launch_cholesky_on_grid(..., stamps=...)`, nanoseconds): each
    phase's time, from its start to the next stamp, summed by part."""
    t = stamps.detach().to("cpu", torch.float64)
    phases = single_launch_phases(n, B)
    if t.numel() != len(phases) + 1:
        raise ValueError(f"single_launch_split: need {len(phases) + 1} stamps for n = {n}, "
                         f"B = {B}, got {t.numel()}")
    split = {"correction_ms": 0.0, "diagonal_ms": 0.0, "apply_ms": 0.0}
    for part, ns in zip(phases, (t[1:] - t[:-1]).tolist()):
        split[f"{part}_ms"] += ns / 1e6
    return split


def _device_int(name: str, t: torch.Tensor | None, dtype, numel: int, device) -> None:
    if t is not None and (t.dtype != dtype or t.numel() != numel or t.device != device
                          or not t.is_contiguous()):
        raise ValueError(f"single_launch_cholesky_on_grid: {name} must be {numel} contiguous "
                         f"{dtype} on {device}, got {t.dtype} of {t.numel()} on {t.device}")


def single_launch_cholesky_on_grid(K: torch.Tensor, grid: int, syncs: torch.Tensor | None = None,
                                   stamps: torch.Tensor | None = None, B: int = 256) -> torch.Tensor:
    """L of the f32 CUDA matrix K (n % B == 0, B % 128 == 0) from one
    cooperative launch of the single-launch kernel over `grid` blocks
    (1 <= grid <= max_grid_blocks("single_launch")). `single_launch_cholesky`
    takes the largest grid; this entry lets a measurement choose it.
    `syncs`, one int32 on K's device, gains the grid syncs the kernel
    passed; `stamps`, single_launch_grid_syncs(n, B) + 2 int64 on K's device,
    receives block 0's %globaltimer after each (`single_launch_split`)."""
    n = _square("single_launch_cholesky", K)
    if (K.device.type != "cuda" or K.dtype != _F32 or B <= 0 or n % B or B % _DEEP_TILE
            or not 1 <= grid):
        raise ValueError(f"single_launch_cholesky_on_grid: need an f32 CUDA matrix with n % B == 0, "
                         f"B % {_DEEP_TILE} == 0 and grid >= 1, got {K.dtype} on {K.device}, "
                         f"n = {n}, B = {B}, grid = {grid}")
    _device_int("syncs", syncs, torch.int32, 1, K.device)
    _device_int("stamps", stamps, torch.int64, single_launch_grid_syncs(n, B) + 2, K.device)
    out = torch.empty((n, n), dtype=_F32, device=K.device)
    out.copy_(K)
    acc = torch.empty((n, B), dtype=_F32, device=K.device)
    linv = torch.empty((B, B), dtype=_F32, device=K.device)
    part = torch.empty((2 * grid, _DEEP_TILE, _DEEP_TILE), dtype=_F32, device=K.device)
    _launch("single_launch_cholesky_f32", "single_launch_cholesky", K.device,
            out.data_ptr(), acc.data_ptr(), linv.data_ptr(), part.data_ptr(), n, B, int(grid),
            None if syncs is None else syncs.data_ptr(),
            None if stamps is None else stamps.data_ptr())
    return out


def single_launch_cholesky(K: torch.Tensor, B: int = 256, R: int = 1024) -> torch.Tensor:
    """Lower Cholesky factor of the SPD matrix K, f32, with exact zeros above
    the diagonal (NaN from an indefinite pivot on), from one cooperative
    launch over the card: K is copied into the output and factorized there
    in place (the caller's K is left as it was).

    The study's signature and asserts: n % B == n % R == R % B == 0. R (the
    study's row tile) changes no value; the kernel streams 128-row tiles.
    The diagonal blocks follow the study's 128-wide micro-panels, so B must
    be a multiple of 128."""
    n = _square("single_launch_cholesky", K)
    if B <= 0 or R <= 0 or n % B or n % R or R % B:
        raise ValueError(f"single_launch_cholesky: need n % B == n % R == R % B == 0, "
                         f"got n = {n}, B = {B}, R = {R}")
    if B % _STUDY_T:
        raise ValueError(f"single_launch_cholesky: B = {B} is not a multiple of {_STUDY_T}")
    K = K.to(_F32)
    if K.device.type == "cpu":
        return single_launch_cholesky_plain(K, B, R)
    with torch.cuda.device(K.device):
        grid = max_grid_blocks("single_launch")
    return single_launch_cholesky_on_grid(K, grid, B=B)
