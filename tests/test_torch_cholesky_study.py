"""The port's Cholesky study (ops/cholesky_kernels.py, perf/cholesky_study.py)
against the JAX study `perf/pallas_cholesky_study.py`.

The study's Pallas kernels run in interpret mode on the CPU; the port's CPU
path is each kernel's plain version. The CUDA kernels run only on the card,
where chip_smoke.py holds them against these plain versions. Inputs are made
with numpy from a seed and handed to both.

`single_launch_cholesky` in the study divides an int32 program id by a
Python int, which fails under this suite's x64 mode; it runs under
`jax.enable_x64(False)`, as on the TPU.
"""
import collections
import functools
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gaussianprocesses_jl_tpu_torch.ops import cholesky_kernels as ck
from gaussianprocesses_jl_tpu_torch.ops import gram as gram_op
from gaussianprocesses_jl_tpu_torch.perf import cholesky_study as cs
from gaussianprocesses_jl_tpu_torch.perf import panel_parts, single_parts

ROOT = pathlib.Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location(
    "pallas_cholesky_study", ROOT / "perf" / "pallas_cholesky_study.py")
study = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(study)


def _spd(n, rank=64, seed=0):
    """The study's test matrix W W^T + n I, f32."""
    W = np.random.RandomState(seed).randn(n, rank).astype(np.float32)
    return W @ W.T + n * np.eye(n, dtype=np.float32)


def _close(got, ref, rel):
    """max|got - ref| <= rel * max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= rel, err


# f32 factorizations of the same well-conditioned matrix by two summation
# orders: each is within ~5e-7 of f64 at these sizes, so 1e-5 of max|.|
@pytest.mark.parametrize("B", [256, 512])
def test_chol_inv_panel_matches_pallas(B):
    A = _spd(B, seed=B)
    L_pl, Linv_pl = study.chol_inv_panel(jnp.asarray(A), T=128)
    L, Linv = ck.chol_inv_panel(torch.from_numpy(A), T=128)
    assert L.dtype == torch.float32 and L.shape == (B, B)
    _close(L, L_pl, 1e-5)
    _close(Linv, Linv_pl, 1e-5)
    assert not torch.triu(L, 1).any() and not torch.triu(Linv, 1).any()


def test_single_launch_cholesky_matches_pallas():
    K = _spd(512, seed=3)
    with jax.enable_x64(False):
        L_pl = np.asarray(study.single_launch_cholesky(jnp.asarray(K), B=128, R=256))
    Kt = torch.from_numpy(K)
    L = ck.single_launch_cholesky(Kt, B=128, R=256)
    _close(L, L_pl, 1e-5)
    assert not torch.triu(L, 1).any()  # exact zeros above the diagonal
    assert torch.equal(Kt, torch.from_numpy(K))  # the caller's K untouched
    # and the study's own check against an f64 factorization
    _close(L, np.linalg.cholesky(K.astype(np.float64)), 1e-4)


def test_cholesky_blocked_panels_matches_pallas():
    K = _spd(512, seed=4)
    L_pl = study.cholesky_blocked_pallas(jnp.asarray(K), block=256)
    L = cs.cholesky_blocked_panels(torch.from_numpy(K), block=256)
    _close(L, L_pl, 1e-5)
    assert not torch.triu(L, 1).any()


def test_se_gram_study_matches_pallas():
    """Tolerance 1e-5 e^p0: the Pallas kernel clamps the expansion
    s1 + s2 - 2 x.x', which rounds r2 to a few ulp of |x|^2; the port's
    diagonal is exactly e^p0."""
    X = np.random.RandomState(0).randn(300, 10).astype(np.float32)
    params = cs.study_params("cpu")
    assert params.dtype == torch.float32
    np.testing.assert_allclose(params.numpy(), [2 * 0.2, math.exp(-2 * 0.3)], rtol=1e-7)
    K_pl = np.asarray(study.pallas_se_gram(jnp.asarray(X), jnp.asarray(params.numpy())))
    K = cs.se_gram_study(torch.from_numpy(X), params)
    assert K.dtype == torch.float32 and K.shape == (300, 300)
    p0 = float(params[0])
    np.testing.assert_allclose(K.numpy(), K_pl, rtol=0, atol=1e-5 * math.exp(p0))
    assert torch.equal(K.diagonal(), torch.exp(params[:1]).expand(300))
    with pytest.raises(ValueError, match="params"):
        cs.se_gram_study(torch.from_numpy(X), params[:1])


def _pallas_probe(n_iter):
    """The study's `study_launch_overhead` pallas_call, as written there."""

    def kern(n_iter, a_ref, o_ref):
        acc = jax.lax.fori_loop(0, n_iter, lambda j, x: x + 1.0, jnp.float32(0.0))
        o_ref[:] = a_ref[0:8, 0:128] + acc

    return pl.pallas_call(
        functools.partial(kern, n_iter),
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )


@pytest.mark.parametrize("n_iter", [512, 4096])
def test_launch_probe_matches_pallas(n_iter):
    A = np.random.RandomState(n_iter).randn(512, 512).astype(np.float32)
    o_pl = np.asarray(_pallas_probe(n_iter)(jnp.asarray(A)))
    o = ck.launch_probe(torch.from_numpy(A), n_iter)
    assert o.shape == (8, 128) and o.dtype == torch.float32
    np.testing.assert_array_equal(o.numpy(), o_pl)  # the same f32 add


def test_indefinite_panel_gives_nan_in_both():
    A = _spd(256, seed=5)
    A[200, 200] = -1e4  # pivot 200 goes negative
    L_pl, Linv_pl = (np.asarray(t) for t in study.chol_inv_panel(jnp.asarray(A)))
    L, Linv = ck.chol_inv_panel(torch.from_numpy(A))
    for port, ref in ((L.numpy(), L_pl), (Linv.numpy(), Linv_pl)):
        assert np.isnan(ref).any() and np.isnan(port).any()
        # the micro-panel before the bad pivot is finite and agrees
        assert not np.isnan(port[:128, :128]).any()
        _close(port[:128, :128], ref[:128, :128], 1e-5)
    assert not np.isnan(L.numpy()[:, :128]).any()


# ---------------------------------------------------------------------------
# CPU models of the CUDA kernels' schedules (csrc/cholesky.cu): the same
# phases on tiles. Each task of a phase (one block's work) reads the state as
# it stood at the phase's start, and no task may read or write a 64-wide
# tile another task of the phase writes, so a missing grid sync shows as an
# error, not as luck.
#
# The panel (panel_kernel, chol_inv_grid): for each 64-wide step, the
# look-ahead diagonal tile beside the trailing update and the L^-1 sums W,
# then the panel apply and row k of L^-1.
# ---------------------------------------------------------------------------

_T = 64


def _factor_tile(P):
    """The kernel's `chol_inv_tile`: the column chain on the lower triangle,
    then the inverse by row elimination. NaN on a non-positive pivot."""
    P = P.clone()
    for j in range(_T):
        P[j:, j] = P[j:, j] * torch.rsqrt(P[j, j])
        P[j + 1:, j + 1:] -= torch.tril(P[j + 1:, j:j + 1] * P[j + 1:, j][None, :])
    Ld = torch.tril(P)
    X = torch.eye(_T, dtype=P.dtype)
    for k in range(_T):
        X[k] = X[k] * (1.0 / Ld[k, k])
        X[k + 1:] -= Ld[k + 1:, k:k + 1] * X[k][None, :]
    return Ld, X


def _tile_keys(name, r0, r1, c0, c1):
    return {(name, i, j) for i in range(r0 // _T, -(-r1 // _T))
            for j in range(c0 // _T, -(-c1 // _T))}


class _Phases:
    """Named matrices and the phases run on them. A task is get -> {(name,
    row, col): block written there}, where get(name, r0, r1, c0, c1) reads
    the state at the phase's start."""

    def __init__(self, **state):
        self.state = {k: v.clone() for k, v in state.items()}
        self.n_phases = 0
        self.widest = 0

    def run(self, tasks, width=None):
        snap = {k: v.clone() for k, v in self.state.items()}
        done = []
        for task in tasks:
            reads = set()

            def get(name, r0, r1, c0, c1, reads=reads):
                reads |= _tile_keys(name, r0, r1, c0, c1)
                return snap[name][r0:r1, c0:c1]

            writes = task(get)
            keys = set()
            for (name, r0, c0), v in writes.items():
                keys |= _tile_keys(name, r0, r0 + v.shape[0], c0, c0 + v.shape[1])
            done.append((reads, keys, writes))
        writers = collections.Counter(k for _, keys, _ in done for k in keys)
        for reads, keys, _ in done:
            assert all(writers[k] == (k in keys) for k in reads | keys), \
                "a tile is shared within a phase"
        for _, _, writes in done:
            for (name, r0, c0), v in writes.items():
                self.state[name][r0:r0 + v.shape[0], c0:c0 + v.shape[1]] = v
        self.n_phases += 1
        self.widest = max(self.widest, len(tasks) if width is None else width)


def _panel_phases(B, at, dtype):
    """The panel schedule on tiles, step by step: (phase (a)'s tasks, its
    width without the set-up, phase (b)'s tasks). `at(m, i, j)` places tile
    (i, j) of the panel's matrix m ("A", "L" or "Li") in the state as
    (name, row, col)."""
    nt = B // _T
    zero = torch.zeros((_T, _T), dtype=dtype)

    def tile(get, m, i, j):
        name, r, c = at(m, i, j)
        return get(name, r, r + _T, c, c + _T)

    def diag(k):  # block 0: step k-1's update of tile (k, k), then its factor
        def task(get):
            if k == 0:
                d = tile(get, "A", 0, 0)
            else:
                p = tile(get, "L", k, k - 1)
                d = tile(get, "L", k, k) - p @ p.T
            Ld, X = _factor_tile(d)
            return {at("L", k, k): Ld, at("Li", k, k): X}
        return task

    def setup(i, j):  # A's lower tiles into L, zeros above the diagonal and in W
        if j > i:
            return lambda get: {at("L", i, j): zero, at("Li", i, j): zero}
        return lambda get: {at("L", i, j): tile(get, "A", i, j), at("Li", i, j): zero}

    def trailing(k, i, j):  # step k-1's update of tile (i, j)
        return lambda get: {at("L", i, j): tile(get, "L", i, j)
                            - tile(get, "L", i, k - 1) @ tile(get, "L", j, k - 1).T}

    def gather(k, i, j):  # W[i, j] += L[i, k-1] L^-1[k-1, j], in L^-1's tile
        return lambda get: {at("Li", i, j): tile(get, "Li", i, j)
                            + tile(get, "L", i, k - 1) @ tile(get, "Li", k - 1, j)}

    def panel(k, r):
        return lambda get: {at("L", r, k): tile(get, "L", r, k) @ tile(get, "Li", k, k).T}

    def inv_row(k, j):  # L^-1[k, j] = -D_k W[k, j]
        return lambda get: {at("Li", k, j): -(tile(get, "Li", k, k) @ tile(get, "Li", k, j))}

    for k in range(nt):
        a = [diag(k)]
        if k > 0:
            a += [trailing(k, i, j) for i in range(k, nt) for j in range(k, i + 1)
                  if (i, j) != (k, k)]
            a += [gather(k, i, j) for i in range(k, nt) for j in range(k)]
        width = len(a)
        if k == 0:
            a += [setup(i, j) for i in range(nt) for j in range(nt) if (i, j) != (0, 0)]
        b = [inv_row(k, j) for j in range(k)] + [panel(k, r) for r in range(k + 1, nt)]
        yield a, width, b


def _panel_schedule_model(A, merge_phases=False):
    """(L, L^-1, tile tasks in the widest phase, phases) of the f32 matrix A
    by the kernel's schedule. The set-up is not counted in the width: the
    kernel spreads it element by element over whatever grid it has.
    `merge_phases` drops the grid sync between each step's phases (a) and
    (b), to show that the model catches it."""
    ph = _Phases(A=A, L=torch.empty_like(A), Li=torch.empty_like(A))
    for a, width, b in _panel_phases(A.shape[0], lambda m, i, j: (m, i * _T, j * _T), A.dtype):
        if merge_phases:
            ph.run(a + b, width + len(b))
        else:
            ph.run(a, width)
            ph.run(b, len(b))
    return ph.state["L"], ph.state["Li"], ph.widest, ph.n_phases


@functools.lru_cache(maxsize=None)
def _panel_refs(B):
    """The Pallas panel (interpret mode) and the plain version on _spd(B)."""
    A = _spd(B, seed=B)
    pallas = tuple(np.asarray(t) for t in study.chol_inv_panel(jnp.asarray(A), T=128))
    plain = tuple(t.numpy() for t in ck.chol_inv_panel_plain(torch.from_numpy(A)))
    return A, {"pallas": pallas, "plain": plain}


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("B", [256, 512])
def test_panel_schedule_model_matches(B, ref):
    """The kernel's schedule gives the factors of the Pallas panel and of the
    plain version within 1e-5 of max|.| (two f32 summation orders of a
    well-conditioned factorization), exact zeros above the diagonal."""
    A, refs = _panel_refs(B)
    L, Linv, widest, n_phases = _panel_schedule_model(torch.from_numpy(A))
    for got, want in zip((L, Linv), refs[ref]):
        _close(got, want, 1e-5)
        assert not torch.triu(got, 1).any()
    # the wrapper's grid is the widest phase (step 1's (a): the diagonal
    # tile, the trailing tiles, the sums), capped by what fits; a sync
    # between phases
    assert widest == ck.panel_grid_blocks(B, 10**6) == (B // _T - 1) * (B // _T + 2) // 2
    assert ck.panel_grid_blocks(B, 5) == 5 and ck.panel_grid_blocks(64, 5) == 1
    assert n_phases - 1 == ck.panel_grid_syncs(B)


def test_panel_schedule_model_on_an_indefinite_panel():
    """The panel of test_indefinite_panel_gives_nan_in_both: NaN where the
    plain version has NaN on and below the diagonal, the leading 128 x 128
    finite and equal to the Pallas panel's and the plain version's."""
    A = _spd(256, seed=5)
    A[200, 200] = -1e4
    L, Linv, _, _ = _panel_schedule_model(torch.from_numpy(A))
    L_pl, Linv_pl = (np.asarray(t) for t in study.chol_inv_panel(jnp.asarray(A)))
    L0, Linv0 = (t.numpy() for t in ck.chol_inv_panel_plain(torch.from_numpy(A)))
    for got, pal, plain in ((L.numpy(), L_pl, L0), (Linv.numpy(), Linv_pl, Linv0)):
        assert np.isnan(got).any()
        np.testing.assert_array_equal(np.isnan(np.tril(got)), np.isnan(np.tril(plain)))
        assert not np.isnan(got[:128, :128]).any()
        _close(got[:128, :128], pal[:128, :128], 1e-5)
        _close(got[:128, :128], plain[:128, :128], 1e-5)


def test_panel_schedule_model_catches_a_missing_grid_sync():
    """Without the sync between phases (a) and (b), step k's panel apply
    would read column k while the trailing update writes it."""
    with pytest.raises(AssertionError, match="shared within a phase"):
        _panel_schedule_model(torch.from_numpy(_spd(256)), merge_phases=True)


# ---------------------------------------------------------------------------
# The single launch (single_launch_kernel): for each B-wide panel column c,
# the correction as a deep product (pieces, then their sums), the diagonal
# block by the panel's phases, the apply as a deep product (pieces, then
# their sums beside the zeros above the block). A deep product cuts its
# (tile, slice) iterations into one range a block (stream-K): a block writes
# a tile its range holds whole and leaves a piece of any other in its slot
# 2b (its range's head) or 2b + 1 (its tail); the sums add a tile's pieces in
# block order.
# ---------------------------------------------------------------------------

_DT, _DK = 128, 16  # the deep product's tile edge and slice depth


def _sk_start(I, b, G):
    return I * b // G


def _sk_block_of(x, I, G):
    """The block whose range holds iteration x."""
    return ((x + 1) * G + I - 1) // I - 1


def _stream_k(T, nk, G):
    """{block: [(tile, first slice, end slice, slot or None if whole)]}."""
    I = T * nk
    out = {}
    for b in range(G):
        s, e = _sk_start(I, b, G), _sk_start(I, b + 1, G)
        segs, it = [], s
        while it < e:
            t = it // nk
            stop = min(e, (t + 1) * nk)
            k0, k1 = it - t * nk, stop - t * nk
            segs.append((t, k0, k1, None if (k0, k1) == (0, nk) else 2 * b + (it != s)))
            it = stop
        out[b] = segs
    return out


def _pieces_of(t, nk, T, G):
    """The slots the sums add for tile t, in order; None if one block wrote
    it whole; [] at depth 0 (the tile is cin)."""
    if nk == 0:
        return []
    I, t0 = T * nk, t * nk
    bf, bl = _sk_block_of(t0, I, G), _sk_block_of(t0 + nk - 1, I, G)
    if bf == bl:
        return None
    return [2 * b + (_sk_start(I, b, G) < t0) for b in range(bf, bl + 1)
            if _sk_start(I, b + 1, G) > _sk_start(I, b, G)]


def _product_phases(G, out, cin, A, Bm, rows, cols, K, sign):
    """The deep product out = cin + sign A Bm^T (each operand given as
    (name, row, col) of its first element): its pieces' phase, then its
    sums' phase."""
    ct, nk = cols // _DT, K // _DK
    T = rows // _DT * ct

    def at(ref, r0, r1, c0, c1, get):
        name, r, c = ref
        return get(name, r + r0, r + r1, c + c0, c + c1)

    def piece_task(segs):
        def task(get):
            writes = {}
            for t, k0, k1, slot in segs:
                r0, c0 = t // ct * _DT, t % ct * _DT
                prod = (at(A, r0, r0 + _DT, k0 * _DK, k1 * _DK, get)
                        @ at(Bm, c0, c0 + _DT, k0 * _DK, k1 * _DK, get).T)
                if slot is None:
                    v = sign * prod
                    if cin is not None:
                        v = v + at(cin, r0, r0 + _DT, c0, c0 + _DT, get)
                    writes[(out[0], out[1] + r0, out[2] + c0)] = v
                else:
                    writes[("part", slot * _DT, 0)] = prod
            return writes
        return task

    def sum_task(t, slots):
        def task(get):
            r0, c0 = t // ct * _DT, t % ct * _DT
            v = torch.zeros((_DT, _DT), dtype=torch.float32)
            for slot in slots:
                v = v + get("part", slot * _DT, (slot + 1) * _DT, 0, _DT)
            v = sign * v
            if cin is not None:
                v = v + at(cin, r0, r0 + _DT, c0, c0 + _DT, get)
            return {(out[0], out[1] + r0, out[2] + c0): v}
        return task

    pieces = [piece_task(segs) for segs in _stream_k(T, nk, G).values() if segs]
    sums = [sum_task(t, slots) for t in range(T)
            if (slots := _pieces_of(t, nk, T, G)) is not None]
    return pieces, sums


def _single_launch_schedule_model(K, B, G, drop_sync=None):
    """(L, phases) of the f32 matrix K by the single launch's schedule on a
    grid of G blocks. `drop_sync` drops that grid sync (merges the phases
    on either side of it), to show that the model catches it."""
    n = K.shape[0]
    phases = []
    for c in range(0, n, B):
        phases += _product_phases(G, ("acc", c, 0), ("out", c, c), ("out", c, 0), ("out", c, 0),
                                  n - c, B, c, -1.0)

        def at(m, i, j, c=c):
            return {"A": ("acc", c + i * _T, j * _T), "L": ("out", c + i * _T, c + j * _T),
                    "Li": ("linv", i * _T, j * _T)}[m]

        for a, _, b in _panel_phases(B, at, K.dtype):
            phases += [a, b]
        pieces, sums = _product_phases(G, ("out", c + B, c), None, ("acc", c + B, 0),
                                       ("linv", 0, 0), n - c - B, B, B, 1.0)
        if c > 0:
            sums.append(lambda get, c=c: {("out", 0, c): torch.zeros((c, B))})
        phases += [pieces, sums]
    if drop_sync is not None:
        phases[drop_sync:drop_sync + 2] = [phases[drop_sync] + phases[drop_sync + 1]]
    ph = _Phases(out=K, acc=torch.zeros((n, B)), linv=torch.zeros((B, B)),
                 part=torch.zeros((2 * G * _DT, _DT)))
    for tasks in phases:
        ph.run(tasks)
    return ph.state["out"], ph.n_phases


@functools.lru_cache(maxsize=None)
def _single_refs(B):
    """The Pallas single launch (interpret mode, R = 256) and the plain
    version on _spd(512)."""
    K = _spd(512, seed=3)
    with jax.enable_x64(False):
        pallas = np.asarray(study.single_launch_cholesky(jnp.asarray(K), B=B, R=256))
    plain = ck.single_launch_cholesky_plain(torch.from_numpy(K), B=B, R=256).numpy()
    return K, {"pallas": pallas, "plain": plain}


@pytest.mark.parametrize("ref", ["pallas", "plain"])
@pytest.mark.parametrize("B", [128, 256])
def test_single_launch_schedule_model_matches(B, ref):
    """The kernel's schedule on 7 blocks gives the Pallas single launch's
    and the plain version's L within 1e-5 of max|.| (f32 summation orders of
    a well-conditioned factorization), exact zeros above the diagonal, and
    its phases less one are the grid syncs the kernel counts."""
    K, refs = _single_refs(B)
    L, n_phases = _single_launch_schedule_model(torch.from_numpy(K), B, 7)
    _close(L, refs[ref], 1e-5)
    assert not torch.triu(L, 1).any()
    assert n_phases - 1 == ck.single_launch_grid_syncs(512, B)
    assert len(ck.single_launch_phases(512, B)) == n_phases


@pytest.mark.parametrize("G", [1, 2, 264])
def test_single_launch_schedule_model_on_any_grid(G):
    """One block, two, and more blocks than the products have iterations
    (empty ranges): the same factor within 1e-5 of max|.|."""
    K, refs = _single_refs(128)
    L, _ = _single_launch_schedule_model(torch.from_numpy(K), 128, G)
    _close(L, refs["plain"], 1e-5)


@pytest.mark.parametrize("G", [1, 2, 7, 264])
def test_single_launch_split_covers_each_depth_once(G):
    """On each grid, for products of 1-160 tiles and depths 0-640 slices:
    every slice of every tile falls in exactly one block's range; a tile is
    written whole by one block or summed from exactly its pieces' slots,
    each slot holding one piece; a block leaves at most two pieces."""
    for T, nk in ((1, 1), (4, 16), (7, 3), (156, 16), (160, 640), (3, 0)):
        cover = collections.Counter()
        whole, pieces = set(), collections.defaultdict(set)
        slots = collections.Counter()
        for b, segs in _stream_k(T, nk, G).items():
            assert sum(slot is not None for *_, slot in segs) <= 2
            for t, k0, k1, slot in segs:
                cover.update((t, k) for k in range(k0, k1))
                if slot is None:
                    whole.add(t)
                else:
                    assert slot in (2 * b, 2 * b + 1)
                    pieces[t].add(slot)
                    slots[slot] += 1
        assert cover == collections.Counter({(t, k): 1 for t in range(T) for k in range(nk)})
        assert all(v == 1 for v in slots.values())
        for t in range(T):
            got = _pieces_of(t, nk, T, G)
            if nk == 0:
                assert got == []
            elif got is None:
                assert t in whole and t not in pieces
            else:
                assert t not in whole and got == sorted(pieces[t], key=lambda s: (s // 2, s))
                assert len(got) >= 2


@pytest.mark.parametrize("drop", ["correction", "diagonal", "apply"])
def test_single_launch_schedule_model_catches_a_dropped_sync(drop):
    """Without the sync after the correction's pieces (the sums read slots
    being written), after the diagonal block (the apply reads L^-1 while it
    is formed) or after the apply's pieces of panel 1, the model fails."""
    nt = 128 // _T
    per_panel = 2 * nt + 4
    sync = {"correction": per_panel, "diagonal": per_panel + 2 + 2 * nt - 1,
            "apply": per_panel + 2 * nt + 2}[drop]
    with pytest.raises(AssertionError, match="shared within a phase"):
        _single_launch_schedule_model(torch.from_numpy(_spd(512, seed=3)), 128, 7, drop_sync=sync)


def test_single_launch_schedule_model_on_an_indefinite_matrix():
    """Pivot 300 of 512 negative: the launch's schedule gives NaN from that
    pivot on and finite values before it, equal to the plain version's."""
    K = _spd(512, seed=3)
    K[300, 300] = -1e4
    L, _ = _single_launch_schedule_model(torch.from_numpy(K), 128, 7)
    L0 = ck.single_launch_cholesky_plain(torch.from_numpy(K), B=128, R=256)
    assert torch.isnan(L[300, 300]) and torch.isnan(L[300:, 300]).all()
    assert torch.isfinite(L[:300, :300]).all()
    _close(L[:300, :300], L0[:300, :300], 1e-5)
    np.testing.assert_array_equal(torch.tril(L).isnan().numpy(), torch.tril(L0).isnan().numpy())


def test_single_launch_split_sums_the_stamps():
    """single_launch_split adds each phase's time (stamp to next stamp) to
    its part; the phase list has one entry more than the grid syncs."""
    n, B = 512, 256
    phases = ck.single_launch_phases(n, B)
    assert len(phases) == ck.single_launch_grid_syncs(n, B) + 1 == 2 * (2 * 4 + 4)
    ns = {"correction": 1000, "diagonal": 20000, "apply": 300000}
    stamps = torch.tensor([0] + [ns[p] for p in phases], dtype=torch.int64).cumsum(0)
    split = ck.single_launch_split(stamps, n, B)
    assert split == pytest.approx({"correction_ms": 4 * 1e-3, "diagonal_ms": 16 * 0.02,
                                   "apply_ms": 4 * 0.3})
    with pytest.raises(ValueError, match="stamps"):
        ck.single_launch_split(stamps[:-1], n, B)


def test_panel_fit_recovers_its_terms():
    """Times made from c_step = 20 us and 10 TFLOP/s give them back."""
    cases = [cs.PanelCase(2 * (B // 64) * 0.02 + 2 * B**3 / 3 / 1e13 * 1e3, 0, 0, 0, 0, None,
                          None, B)
             for B in (512, 1024, 3072)]
    c_step, rate = cs.panel_fit(cases)
    assert c_step == pytest.approx(0.02, rel=1e-9) and rate == pytest.approx(10.0, rel=1e-9)


def test_panel_parts_needs_the_card(monkeypatch, capsys):
    """The parts measurement refuses to run without a CUDA device and
    builds nothing on the way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert panel_parts.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_single_parts_needs_the_card(monkeypatch, capsys):
    """The single launch's parts measurement refuses to run without a CUDA
    device and builds nothing on the way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert single_parts.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("device, match", [("cpu", "single_launch_cholesky_on_grid"),
                                           ("meta", "no kernel")])
def test_single_launch_on_grid_refuses_off_the_card(device, match):
    """The chosen-grid entry launches only on a CUDA tensor: no plain
    version stands in for it."""
    with pytest.raises(ValueError, match=match):
        ck.single_launch_cholesky_on_grid(torch.eye(512, device=device), 2)
    assert ck.LAUNCHES["single_launch_cholesky"] == 0


@pytest.mark.parametrize("call", [
    lambda: ck.chol_inv_panel(torch.eye(200), T=128),  # B % T != 0
    lambda: ck.chol_inv_panel(torch.zeros(4, 5)),  # not square
    lambda: ck.single_launch_cholesky(torch.eye(384), B=256, R=384),  # n % B != 0
    lambda: ck.single_launch_cholesky(torch.eye(1024), B=256, R=768),  # n % R != 0
    lambda: ck.single_launch_cholesky(torch.eye(768), B=256, R=384),  # R % B != 0
    lambda: ck.single_launch_cholesky(torch.eye(512), B=64, R=256),  # B % 128 != 0
    lambda: ck.launch_probe(torch.ones(8, 64), 512),  # narrower than 8 x 128
    lambda: ck.launch_probe(torch.ones(8, 128), -1),
    lambda: cs.cholesky_blocked_panels(torch.eye(640), block=256),  # n % block != 0
], ids=["panel-B%T", "panel-shape", "single-n%B", "single-n%R", "single-R%B",
        "single-B%128", "probe-shape", "probe-n_iter", "blocked-n%block"])
def test_wrappers_raise_where_the_study_truncated(call):
    with pytest.raises(ValueError):
        call()


def test_kernel_entries_raise_off_the_cpu_without_cuda():
    """A tensor neither on the CPU nor on CUDA has no kernel; the CUDA-only
    entries (the gram launch, the panel on a chosen grid, the study's
    command line) refuse a CPU run."""
    meta = torch.empty((256, 256), device="meta")
    for call in (lambda: ck.chol_inv_panel(meta),
                 lambda: ck.single_launch_cholesky(meta, B=128, R=256),
                 lambda: ck.launch_probe(meta, 8)):
        with pytest.raises(ValueError, match="no kernel"):
            call()
    X = torch.zeros((16, 10))
    p = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        gram_op.launch_gram(gram_op.SE, p, X)
    with pytest.raises(ValueError, match="CUDA"):
        ck.chol_inv_panel_on_grid(torch.eye(128), 2, torch.zeros(1, dtype=torch.int32))
    if not torch.cuda.is_available():
        assert cs.main(["launch"]) == 1
    assert ck.LAUNCHES == {"launch_probe": 0, "chol_inv_panel": 0,
                           "single_launch_cholesky": 0}


def test_study_experiments_run_on_the_cpu_at_small_size(capsys):
    """Each study experiment end to end on CPU tensors (plain versions, host
    clock), at sizes cut to fit a unit test."""
    probe = cs.study_launch_overhead("cpu", n_iters=(8,), reps=1)
    assert probe[8][0] > 0 and probe[8][1] is None
    gram = cs.study_gram("cpu", ns=(64,), reps=1)
    assert gram[64][1] is None and gram[64][3] <= 1e-5
    panel = cs.study_panel("cpu", Bs=(128,), gram_B=128, reps=1)
    assert all(v[3] < 1e-5 and v[4] < 1e-4 for v in panel.values())
    single = cs.study_single_launch("cpu", n=1024, n_check=512, reps=1)
    assert single["rel_err"] < 1e-4
    full = cs.study_full("cpu", n=1024, reps=1)
    assert len(full) == 4 and all(v > 0 for v in full.values())
    assert "TFLOP/s" in capsys.readouterr().out
