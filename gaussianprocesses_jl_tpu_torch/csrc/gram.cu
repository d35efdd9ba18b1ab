// Stationary gram K(X1, X2)[i, j] = profile(|x1_i - x2_j|^2) and its
// vector-Jacobian product, for Hopper (sm_90a).
//
// `gram_kernel` replaces the TPU kernel `_gram_kernel` in
// gaussianprocesses_jl_tpu/ops/pallas_gram.py (launched by `_pallas_forward`);
// `gram_vjp_kernel` with `gram_vjp_reduce` replaces its backward
// `_gram_cv_bwd`, which is `jax.vjp` of `_xla_reference` and which XLA fused
// on the TPU. The TPU kernel ran the module's own Python `_r2profile` on a
// 256x256 tile; here there is one compiled branch per profile family (SE,
// Matern 1/2, 3/2, 5/2, RQ, Periodic), chosen by an integer argument. ARD
// kernels pre-scale their inputs by exp(-ll) before the call and use the iso
// profile at unit length scale. The hyperparameters arrive as a small device
// vector p = [lsigma, ll, extra] (extra = lalpha for RQ, lp for Periodic), so
// no host read is needed per call.
//
// What bounds them. The forward writes n1 x n2 outputs once: n^2 * 4 bytes at
// 3.35 TB/s is ~11 us at n = 3000 and ~320 us at n = 16384 (f32). Each output
// costs ~3d flops of distance plus one profile; the 67 TFLOP/s non-tensor f32
// rate needs ~5 us for those at n = 3000, half that on a symmetric gram. The
// VJP reads the n1 x n2 cotangent G once (the same ~11 us at n = 3000) and
// writes 3 + (n1 + n2) d numbers; its operations per output are the distance,
// the profile and its derivatives, and with the inputs' gradient two length-64
// dot products per tile row and column and feature.
//
// Forward design:
// - A persistent grid: as many blocks as fit on the card at once walk a
//   linear list of 64 x 64 output tiles (block b takes tiles b, b + grid, ...),
//   so there is no partial last wave and no limit on the grid's y extent.
// - A symmetric gram (X2 = X1) lists only the tiles on and below the
//   diagonal. An off-diagonal tile writes itself and, through shared memory,
//   its transpose, so the distance and profile work is halved while the
//   bytes written stay n^2. Both writes are 16-byte stores (a thread holds
//   4 consecutive columns of 4 rows) where the row length allows it.
// - The squared distance is accumulated directly as sum_k (x1_k - x2_k)^2
//   over exactly d features, staged in shared memory 64 / sizeof(T) at a
//   time: unlike the expansion s1 + s2 - 2 x1.x2 (which the TPU kernel fed to
//   its matrix unit) it has no cancellation and needs no clamp. Ragged edges
//   are masked, and the symmetric diagonal is pinned to r2 = 0: it holds
//   profile(0) = exp(2 lsigma), computed once at full precision.
// - The per-output exponential of f32 is `__expf` (ex2.approx): ~2 ulp,
//   against the 1e-5 sigma^2 the kernel is held to; log1p, sqrt and sin stay
//   at full precision.
// - Measured on an H100 (f32, d = 10): 0.0195 ms at n = 3000 (55% of the
//   byte bound) and 0.437 ms at n = 16384 (73%). At n = 3000 the 1128 tiles
//   give each resident block one or two, so a block's start
//   (hyperparameters, staging) is not hidden behind another tile's stores.
//
// A batch of chains (one gram per chain, as a sampler's chains need them):
// both kernels take a chain count C and, for X1, X2 and p, a stride between
// chains in elements, 0 where the chains share the operand (an iso kernel's
// inputs; ARD inputs are scaled per chain). The walk runs over (chain, tile)
// pairs u = c ntiles + t, so one launch serves every chain: at n = 200 one
// chain has 10 tiles, 128 chains 1280, enough to fill the card. Outputs,
// cotangents and gradients are (C, ...) contiguous. C = 1 launches the
// kernels' BATCHED = false instantiations, compiled without the chain
// arithmetic: a single gram runs, and sums, as it did before chains.
//
// VJP design (one pass over G, nothing n x n written):
// - The same tile walk: lower-triangle tiles for a symmetric gram, where an
//   off-diagonal tile reads G's tile and the transposed tile (staged in shared
//   memory, so both reads are coalesced) and uses S = G_ij + G_ji.
// - r2, the profile and its closed-form derivatives in (lsigma, ll, extra)
//   and in r2 are recomputed in registers. The pinned diagonal, and r = 0 for
//   the families of r (Matern, Periodic: the plain version's safe_dist), give
//   no distance gradient.
// - With W = S * 2 dK/dr2 staged in shared memory, a tile's row i gets
//   x1_i sum_j W_ij - sum_j W_ij x2_j, and its column j gets
//   x2_j sum_i W_ij - sum_i W_ij x1_i: the gradient of X1 (rows, and on a
//   symmetric gram columns too) and of X2 (columns).
// - Deterministic sums, no atomics: each block adds its hyperparameter terms
//   in registers, reduces them in a fixed order and writes one partial for
//   each chain it walked (a block's tiles are in increasing u, so it meets
//   each chain in one run); each tile writes its row and column partials.
//   `gram_vjp_reduce` (one gram) and `gram_vjp_reduce_chains` (a batch) add
//   a chain's partials in block order, over the blocks whose walk met that
//   chain (`walked`), and its tiles' partials in tile order (a gradient element's tiles as four interleaved sums, so that four
//   loads are in flight), so a run gives the same bits every time on the
//   same card and grid.
// - What holds the input gradient back (measured on an H100: 0.048 ms at
//   n = 3000, d = 10, against 0.023 ms for the hyperparameters alone): the
//   row and column products read about one shared-memory word per FMA, and
//   the partials, 2 x 64 d numbers a tile, go through device memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;                 // output tile edge
constexpr int THREADS = 256;             // threads a block
constexpr int TX = 16;                   // threads along columns, 4 columns each
constexpr int TY = 16;                   // threads along rows, rows ty + 16 i
constexpr int RM = TILE / TY;            // rows a thread
constexpr int RN = TILE / TX;            // consecutive columns a thread
constexpr int MAX_BLOCKS_PER_SM = 2048 / THREADS;  // the wrappers size scratch by it

template <typename T>
struct Chunk {
  static constexpr int DK = 64 / sizeof(T);  // features staged at once: 16 f32, 8 f64
};

enum Family { SE = 0, MAT12 = 1, MAT32 = 2, MAT52 = 3, RQ = 4, PERIODIC = 5 };

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
// the per-output exponential: ex2.approx in f32
__device__ __forceinline__ float d_fexp(float x) { return __expf(x); }
__device__ __forceinline__ double d_fexp(double x) { return exp(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double d_log1p(double x) { return log1p(x); }
__device__ __forceinline__ void d_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void d_sincos(double x, double* s, double* c) { sincos(x, s, c); }
__device__ __forceinline__ float d_sin(float x) { return sinf(x); }
__device__ __forceinline__ double d_sin(double x) { return sin(x); }
__device__ __forceinline__ float d_fma(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double d_fma(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
struct Hyper {
  T two_lsig;  // 2 lsigma
  T sig2;      // exp(2 lsigma)
  T il;        // exp(-ll)
  T il2;       // exp(-2 ll)
  T alpha;     // exp(lalpha)       (RQ)
  T iper;      // exp(-lp)          (Periodic)
};

template <typename T>
__device__ __forceinline__ Hyper<T> load_hyper(const T* __restrict__ p) {
  const T lsig = p[0], ll = p[1], extra = p[2];
  Hyper<T> h;
  h.two_lsig = T(2) * lsig;
  h.sig2 = d_exp(h.two_lsig);
  h.il = d_exp(-ll);
  h.il2 = d_exp(T(-2) * ll);
  h.alpha = d_exp(extra);
  h.iper = d_exp(-extra);
  return h;
}

constexpr double PI = 3.141592653589793;
constexpr double SQRT3 = 1.7320508075688772;
constexpr double SQRT5 = 2.23606797749979;

// The profiles, written as ops/kernels.py writes them (and as the plain
// version `profile` in ops/gram.py does).
template <typename T, int F>
__device__ __forceinline__ T profile(T r2, const Hyper<T>& h) {
  if constexpr (F == SE) {
    return d_fexp(h.two_lsig - T(0.5) * r2 * h.il2);
  } else if constexpr (F == RQ) {
    const T z = r2 * h.il2 / (T(2) * h.alpha);
    return d_fexp(h.two_lsig - h.alpha * d_log1p(z));
  } else {
    const T r = r2 > T(0) ? d_sqrt(r2) : T(0);
    if constexpr (F == MAT12) {
      return d_fexp(h.two_lsig - r * h.il);
    } else if constexpr (F == MAT32) {
      const T s = T(SQRT3) * r * h.il;
      return h.sig2 * (T(1) + s) * d_fexp(-s);
    } else if constexpr (F == MAT52) {
      const T s = T(SQRT5) * r * h.il;
      return h.sig2 * (T(1) + s + s * s / T(3)) * d_fexp(-s);
    } else {  // PERIODIC
      const T s = d_sin(T(PI) * r * h.iper);
      return d_fexp(h.two_lsig - T(2) * s * s * h.il2);
    }
  }
}

// u - lz = z/(1+z) - log1p(z), u = z/(1+z), lz = log1p(z): RQ's
// dK/dlalpha over K alpha. Below u = 0.05 the two terms cancel to ~-u^2/2
// and their difference keeps only ~eps/u of its relative accuracy (a
// switched-off RQ term, its length scale ~e^17, has u ~ 1e-11), so there
// it is summed as -u^2 sum_{k=2..17} u^(k-2)/k, whose terms share one sign.
template <typename T>
__device__ __forceinline__ T rq_dlalpha(T u, T lz) {
  if (u < T(0.05)) {
    T s = T(1) / T(17);
#pragma unroll
    for (int k = 16; k >= 2; --k) s = s * u + T(1) / T(k);
    return -u * u * s;
  }
  return u - lz;
}

// The profile K and its derivatives in ll, extra and r2 at one r2, written
// out in closed form as `gram_derivs` in ops/gram.py writes them (dK/dlsigma
// is 2K). dr2 is 0 at r = 0 for the families of r, as the plain version's
// safe_dist makes it.
template <typename T, int F>
__device__ __forceinline__ void derivs(T r2, const Hyper<T>& h, T& K, T& dll, T& dex, T& dr2) {
  dex = T(0);
  if constexpr (F == SE) {
    K = d_fexp(h.two_lsig - T(0.5) * r2 * h.il2);
    dll = K * r2 * h.il2;
    dr2 = T(-0.5) * h.il2 * K;
  } else if constexpr (F == RQ) {
    const T z = r2 * h.il2 / (T(2) * h.alpha);
    const T lz = d_log1p(z);
    K = d_fexp(h.two_lsig - h.alpha * lz);
    const T q = T(1) / (T(1) + z);
    dll = T(2) * K * h.alpha * z * q;
    dex = K * h.alpha * rq_dlalpha(z * q, lz);
    dr2 = T(-0.5) * K * h.il2 * q;
  } else {
    const bool pos = r2 > T(0);
    const T r = pos ? d_sqrt(r2) : T(0);
    const T half_ir = pos ? T(0.5) / r : T(0);  // dr/dr2, 0 at r = 0
    if constexpr (F == MAT12) {
      K = d_fexp(h.two_lsig - r * h.il);
      dll = K * r * h.il;
      dr2 = -h.il * K * half_ir;
    } else if constexpr (F == MAT32) {
      const T s = T(SQRT3) * r * h.il;
      const T e = h.sig2 * d_fexp(-s);
      K = (T(1) + s) * e;
      dll = s * s * e;
      dr2 = pos ? T(-1.5) * h.il2 * e : T(0);
    } else if constexpr (F == MAT52) {
      const T s = T(SQRT5) * r * h.il;
      const T e = h.sig2 * d_fexp(-s);
      K = (T(1) + s + s * s / T(3)) * e;
      dll = s * s * (T(1) + s) * e / T(3);
      dr2 = pos ? T(-5.0 / 6.0) * h.il2 * (T(1) + s) * e : T(0);
    } else {  // PERIODIC
      const T u = T(PI) * r * h.iper;
      T sn, cs;
      d_sincos(u, &sn, &cs);
      K = d_fexp(h.two_lsig - T(2) * sn * sn * h.il2);
      dll = T(4) * K * sn * sn * h.il2;
      dex = T(4) * K * sn * cs * h.il2 * u;
      dr2 = T(-4) * K * sn * cs * h.il2 * T(PI) * h.iper * half_ir;
    }
  }
}

// tile t of the walk: the lower triangle t = bi (bi + 1) / 2 + bj (bj <= bi)
// of a symmetric gram, row-major (bi, bj) over nb2 tile columns otherwise
__device__ __forceinline__ void tile_of(long long t, int sym, int nb2, int& bi, int& bj) {
  if (sym) {
    long long b = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
    while (b * (b + 1) / 2 > t) --b;
    while ((b + 1) * (b + 2) / 2 <= t) ++b;
    bi = (int)b;
    bj = (int)(t - b * (b + 1) / 2);
  } else {
    bi = (int)(t / nb2);
    bj = (int)(t % nb2);
  }
}

// s[k][r] = X[row0 + r, k0 + k] for k < kc, 0 past the last row
template <typename T>
__device__ __forceinline__ void stage(T (*s)[TILE], const T* __restrict__ X, int row0,
                                      int n, int d, int k0, int kc) {
  for (int idx = threadIdx.x; idx < TILE * kc; idx += THREADS) {
    const int r = idx / kc, k = idx - (idx / kc) * kc;
    const int gr = row0 + r;
    s[k][r] = gr < n ? X[(int64_t)gr * d + k0 + k] : T(0);
  }
}

// acc[i][j] = |x1_(row0 + ty + TY i) - x2_(col0 + 4 tx + j)|^2 over all d
// features; ends with the block synchronised
template <typename T>
__device__ __forceinline__ void tile_r2(T (&acc)[RM][RN], T (*s1)[TILE], T (*s2)[TILE],
                                        const T* __restrict__ X1, const T* __restrict__ X2,
                                        int row0, int col0, int n1, int n2, int d) {
  constexpr int DK = Chunk<T>::DK;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = T(0);
  for (int k0 = 0; k0 < d; k0 += DK) {
    const int kc = min(DK, d - k0);
    stage(s1, X1, row0, n1, d, k0, kc);
    stage(s2, X2, col0, n2, d, k0, kc);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      T a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = s1[k][ty + TY * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = s2[k][RN * tx + j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) {
          const T diff = a[i] - b[j];
          acc[i][j] = d_fma(diff, diff, acc[i][j]);
        }
    }
    __syncthreads();
  }
}

// 4 consecutive values of a row: one or two 16-byte accesses when `vec`
// (the matrix is 16-byte aligned and its row length keeps every row so)
// and all 4 lie inside the row; `left` is what is left of the row
__device__ __forceinline__ void store4(float* dst, const float (&v)[4], int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < left) dst[j] = v[j];
  }
}
__device__ __forceinline__ void store4(double* dst, const double (&v)[4], int left, bool vec) {
  if (vec && left >= 4) {
    reinterpret_cast<double2*>(dst)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(dst)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < left) dst[j] = v[j];
  }
}
__device__ __forceinline__ void load4(float (&v)[4], const float* src, int left, bool vec) {
  if (vec && left >= 4) {
    const float4 q = *reinterpret_cast<const float4*>(src);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < left ? src[j] : 0.f;
  }
}
__device__ __forceinline__ void load4(double (&v)[4], const double* src, int left, bool vec) {
  if (vec && left >= 4) {
    const double2 a = reinterpret_cast<const double2*>(src)[0];
    const double2 b = reinterpret_cast<const double2*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = j < left ? src[j] : 0.0;
  }
}

template <typename T>
__host__ __device__ constexpr bool vec_rows(int n2) {
  return n2 % (16 / (int)sizeof(T)) == 0;
}

template <typename T, int F, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
gram_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
            const T* __restrict__ p, T* __restrict__ out,
            int n1, int n2, int d, int sym, long long ntiles, int nb2,
            int chains, long long sx1, long long sx2, long long sp) {
  constexpr int DK = Chunk<T>::DK;
  // the feature chunks, then (aliased) the transposed tile
  __shared__ __align__(16) T smem[TILE * (TILE + 1)];
  static_assert(2 * DK * TILE <= TILE * (TILE + 1), "chunks fit the tile buffer");
  T(*s1)[TILE] = reinterpret_cast<T(*)[TILE]>(smem);
  T(*s2)[TILE] = reinterpret_cast<T(*)[TILE]>(smem + DK * TILE);
  T(*sT)[TILE + 1] = reinterpret_cast<T(*)[TILE + 1]>(smem);
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  // a chain's gram starts 16-byte aligned when its rows are
  const bool vec = vec_rows<T>(n2) && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long total = BATCHED ? ntiles * chains : ntiles;
  long long cur = 0;
  Hyper<T> h = load_hyper(p);

  for (long long u = blockIdx.x; u < total; u += gridDim.x) {
    long long c = 0, t = u;
    if (BATCHED) {
      c = u / ntiles;
      t = u - c * ntiles;
      if (c != cur) {
        h = load_hyper(p + c * sp);
        cur = c;
      }
    }
    const T* __restrict__ A = BATCHED ? X1 + c * sx1 : X1;
    const T* __restrict__ B = BATCHED ? X2 + c * sx2 : X2;
    T* __restrict__ o = BATCHED ? out + c * (int64_t)n1 * n2 : out;
    int bi, bj;
    tile_of(t, sym, nb2, bi, bj);
    const int row0 = bi * TILE, col0 = bj * TILE;
    T v[RM][RN];
    tile_r2(v, s1, s2, A, B, row0, col0, n1, n2, d);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gr = row0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gc = col0 + RN * tx + j;
        // profile(0) = exp(2 lsigma) in every family, at full precision
        v[i][j] = (sym && gr == gc) ? h.sig2 : profile<T, F>(v[i][j], h);
      }
      if (gr < n1) store4(o + (int64_t)gr * n2 + col0 + RN * tx, v[i], n2 - col0 - RN * tx, vec);
    }
    if (sym && bi != bj) {
      // the mirror tile: out[col0 + c, row0 + r] = v(r, c)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) sT[RN * tx + j][ty + TY * i] = v[i][j];
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int cc = ty + TY * i;
        T w[RN];
#pragma unroll
        for (int j = 0; j < RN; ++j) w[j] = sT[cc][RN * tx + j];
        // col0 + cc < n: the tile column lies left of this tile row's start
        store4(o + (int64_t)(col0 + cc) * n2 + row0 + RN * tx, w, n2 - row0 - RN * tx, vec);
      }
    }
    __syncthreads();  // the next tile's chunks overwrite the buffer
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block's hyperparameter terms for one chain, reduced in a fixed order
// (warps by shuffles, then warp 0..7), into part_dp[chain][block][3] (the
// dK/dlsigma column already 2K); ends with the block synchronised.
template <typename T>
__device__ __forceinline__ void flush_dp(T dp0, T dp1, T dp2, T (*red)[3],
                                         T* __restrict__ part_dp, long long chain) {
  const int tid = threadIdx.x;
  const T mine[3] = {T(2) * dp0, dp1, dp2};
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const T v = warp_sum(mine[m]);
    if (tid % 32 == 0) red[tid / 32][m] = v;
  }
  __syncthreads();
  if (tid < 3) {
    T a = T(0);
    for (int w = 0; w < THREADS / 32; ++w) a += red[w][tid];
    part_dp[(chain * gridDim.x + blockIdx.x) * 3 + tid] = a;
  }
  __syncthreads();  // red is rewritten at the next chain
}

// Partials: part_dp[chain][block][3] for each chain the block walked (the
// dK/dlsigma column already 2K); for each (chain, tile) pair u,
// part_rows[u][k][r] and part_cols[u][k][c] over its 64 rows and columns and
// d features, where needed.
template <typename T, int F, bool BATCHED>
__global__ void __launch_bounds__(THREADS)
gram_vjp_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
                const T* __restrict__ p, const T* __restrict__ G,
                T* __restrict__ part_dp, T* __restrict__ part_rows, T* __restrict__ part_cols,
                int n1, int n2, int d, int sym, long long ntiles, int nb2,
                int need_dp, int need_rows, int need_cols,
                int chains, long long sx1, long long sx2, long long sp) {
  constexpr int DK = Chunk<T>::DK;
  __shared__ __align__(16) T s1[DK][TILE];
  __shared__ __align__(16) T s2[DK][TILE];
  __shared__ T sW[TILE][TILE + 1];
  __shared__ T red[THREADS / 32][3];
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const bool vec = vec_rows<T>(n2) && reinterpret_cast<uintptr_t>(G) % 16 == 0;
  const bool need_dx = need_rows || need_cols;
  const long long total = BATCHED ? ntiles * chains : ntiles;
  // the chain of the block's first pair: blockIdx.x < total, so every block
  // walks at least one pair and flushes at least one partial
  long long cur = BATCHED ? blockIdx.x / ntiles : 0;
  Hyper<T> h = load_hyper(p + cur * sp);
  T dp0 = T(0), dp1 = T(0), dp2 = T(0);

  for (long long u = blockIdx.x; u < total; u += gridDim.x) {
    long long c = 0, t = u;
    if (BATCHED) {
      c = u / ntiles;
      t = u - c * ntiles;
      if (c != cur) {
        if (need_dp) flush_dp(dp0, dp1, dp2, red, part_dp, cur);
        h = load_hyper(p + c * sp);
        cur = c;
        dp0 = dp1 = dp2 = T(0);
      }
    }
    const T* __restrict__ A = BATCHED ? X1 + c * sx1 : X1;
    const T* __restrict__ B = BATCHED ? X2 + c * sx2 : X2;
    const T* __restrict__ Gc = BATCHED ? G + c * (int64_t)n1 * n2 : G;
    int bi, bj;
    tile_of(t, sym, nb2, bi, bj);
    const int row0 = bi * TILE, col0 = bj * TILE;
    const bool mirror = sym && bi != bj;
    T r2[RM][RN];
    tile_r2(r2, s1, s2, A, B, row0, col0, n1, n2, d);

    // S = G on this tile, plus the transposed tile of G where it mirrors
    T S[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gr = row0 + ty + TY * i;
      const int left = gr < n1 ? n2 - col0 - RN * tx : 0;
      load4(S[i], Gc + (int64_t)gr * n2 + col0 + RN * tx, left, vec);
    }
    if (mirror) {
      // sW[r][c] = G[col0 + c, row0 + r]
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int cc = ty + TY * i;
        T g[RN];
        load4(g, Gc + (int64_t)(col0 + cc) * n2 + row0 + RN * tx, n2 - row0 - RN * tx, vec);
#pragma unroll
        for (int j = 0; j < RN; ++j) sW[RN * tx + j][cc] = g[j];
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) S[i][j] += sW[ty + TY * i][RN * tx + j];
      __syncthreads();  // sW is rewritten with W below
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int gr = row0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int gc = col0 + RN * tx + j;
        const bool pinned = sym && gr == gc;
        T K, dll, dex, dr2;
        derivs<T, F>(pinned ? T(0) : r2[i][j], h, K, dll, dex, dr2);
        const T s = S[i][j];  // 0 outside the gram
        dp0 = d_fma(s, K, dp0);
        dp1 = d_fma(s, dll, dp1);
        dp2 = d_fma(s, dex, dp2);
        if (need_dx) sW[ty + TY * i][RN * tx + j] = pinned ? T(0) : T(2) * s * dr2;
      }
    }
    if (!need_dx) continue;
    __syncthreads();
    // thread: rows (columns) q and q + 32, features kq and kq + 8 of a chunk;
    // each thread also adds its two rows' (columns') sums of W, in the same
    // order in every thread
    const int q = tid % 32, kq = tid / 32;
    constexpr int KPT = DK / 8;
    for (int k0 = 0; k0 < d; k0 += DK) {
      const int kc = min(DK, d - k0);
      if (d > DK) {  // the last chunk staged by tile_r2 is the only one held
        __syncthreads();
        stage(s1, A, row0, n1, d, k0, kc);
        stage(s2, B, col0, n2, d, k0, kc);
        __syncthreads();
      }
      if (need_rows) {
        T a[2][KPT] = {}, sum[2] = {};
#pragma unroll 4
        for (int c = 0; c < TILE; ++c) {
          const T w0 = sW[q][c], w1 = sW[q + 32][c];
          sum[0] += w0;
          sum[1] += w1;
#pragma unroll
          for (int f = 0; f < KPT; ++f)
            if (kq + 8 * f < kc) {
              const T x = s2[kq + 8 * f][c];
              a[0][f] = d_fma(w0, x, a[0][f]);
              a[1][f] = d_fma(w1, x, a[1][f]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int f = 0; f < KPT; ++f) {
            const int k = kq + 8 * f, r = q + 32 * h;
            if (k < kc)
              part_rows[((int64_t)u * d + k0 + k) * TILE + r] = s1[k][r] * sum[h] - a[h][f];
          }
      }
      if (need_cols) {
        T a[2][KPT] = {}, sum[2] = {};
#pragma unroll 4
        for (int r = 0; r < TILE; ++r) {
          const T w0 = sW[r][q], w1 = sW[r][q + 32];
          sum[0] += w0;
          sum[1] += w1;
#pragma unroll
          for (int f = 0; f < KPT; ++f)
            if (kq + 8 * f < kc) {
              const T x = s1[kq + 8 * f][r];
              a[0][f] = d_fma(w0, x, a[0][f]);
              a[1][f] = d_fma(w1, x, a[1][f]);
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int f = 0; f < KPT; ++f) {
            const int k = kq + 8 * f, c = q + 32 * h;
            if (k < kc)
              part_cols[((int64_t)u * d + k0 + k) * TILE + c] = s2[k][c] * sum[h] - a[h][f];
          }
      }
    }
    __syncthreads();  // the next tile restages s1, s2 and rewrites sW
  }
  if (need_dp) flush_dp(dp0, dp1, dp2, red, part_dp, cur);
}

// term(0) + ... + term(n - 1) as four interleaved sums added in a fixed
// order, so that four loads are in flight at once
template <typename T, typename Term>
__device__ __forceinline__ T sum4(int n, Term term) {
  T a0 = T(0), a1 = T(0), a2 = T(0), a3 = T(0);
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    a0 += term(j);
    a1 += term(j + 1);
    a2 += term(j + 2);
    a3 += term(j + 3);
  }
  for (; j < n; ++j) a0 += term(j);
  return (a0 + a1) + (a2 + a3);
}

// Whether block b of a walk over `grid` blocks met chain c, whose pairs are
// u = c ntiles .. (c + 1) ntiles - 1: block b takes u = b, b + grid, ...
__device__ __forceinline__ bool walked(int b, long long c, long long ntiles, int grid) {
  long long r = ((long long)b - c * ntiles) % grid;
  if (r < 0) r += grid;
  return r < ntiles;
}

// Adds the partials in block and tile order: dp from `nparts` block
// partials (block 0 of this grid), dX1 and dX2 element by element.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_vjp_reduce(const T* __restrict__ part_dp, int nparts, const T* __restrict__ part_rows,
                const T* __restrict__ part_cols, T* __restrict__ dp, T* __restrict__ dX1,
                T* __restrict__ dX2, int n1, int n2, int d, int sym, int nb1, int nb2,
                int need_dp, int need_dx1, int need_dx2) {
  __shared__ T red[THREADS];
  const int tid = threadIdx.x;
  if (need_dp && blockIdx.x == 0) {
    for (int m = 0; m < 3; ++m) {
      T a = T(0);
      for (int b = tid; b < nparts; b += THREADS) a += part_dp[b * 3 + m];
      red[tid] = a;
      __syncthreads();
      for (int s = THREADS / 2; s > 0; s >>= 1) {
        if (tid < s) red[tid] += red[tid + s];
        __syncthreads();
      }
      if (tid == 0) dp[m] = red[0];
      __syncthreads();
    }
  }
  const int64_t e1 = need_dx1 ? (int64_t)n1 * d : 0;
  const int64_t e2 = need_dx2 ? (int64_t)n2 * d : 0;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + tid; e < e1 + e2;
       e += (int64_t)gridDim.x * THREADS) {
    if (e < e1) {
      // feature-major, so neighbouring threads read neighbouring rows
      const int k = (int)(e / n1), i = (int)(e % n1);
      const int b = i / TILE, r = i % TILE;
      T a;
      if (sym) {
        const long long base = (long long)b * (b + 1) / 2;
        a = sum4<T>(b + 1, [&](int bj) { return part_rows[((base + bj) * d + k) * TILE + r]; }) +
            sum4<T>(nb1 - b, [&](int j) {
              const long long bi = b + j;
              return part_cols[((bi * (bi + 1) / 2 + b) * d + k) * TILE + r];
            });
      } else {
        a = sum4<T>(nb2, [&](int bj) {
          return part_rows[(((long long)b * nb2 + bj) * d + k) * TILE + r];
        });
      }
      dX1[(int64_t)i * d + k] = a;
    } else {
      const int64_t e2i = e - e1;
      const int k = (int)(e2i / n2), j = (int)(e2i % n2);
      const int b = j / TILE, c = j % TILE;
      dX2[(int64_t)j * d + k] = sum4<T>(nb1, [&](int bi) {
        return part_cols[(((long long)bi * nb2 + b) * d + k) * TILE + c];
      });
    }
  }
}

// gram_vjp_reduce over a batch of chains: each chain's dp from the partials
// of the `nparts` blocks that walked it (block c of this grid for chain c,
// and so on), dX1 and dX2 element by element. A single gram keeps the
// reduction above: written over chains, it ran twice as slow at C = 1 on an
// H100 (0.0157 against 0.0075 ms at n = 3000, d = 10, with dX).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_vjp_reduce_chains(const T* __restrict__ part_dp, int nparts, const T* __restrict__ part_rows,
                const T* __restrict__ part_cols, T* __restrict__ dp, T* __restrict__ dX1,
                T* __restrict__ dX2, int n1, int n2, int d, int sym, int nb1, int nb2,
                int need_dp, int need_dx1, int need_dx2, int chains, long long ntiles) {
  __shared__ T red[THREADS];
  const int tid = threadIdx.x;
  if (need_dp) {
    for (int c = blockIdx.x; c < chains; c += gridDim.x) {
      for (int m = 0; m < 3; ++m) {
        T a = T(0);
        for (int b = tid; b < nparts; b += THREADS)
          if (walked(b, c, ntiles, nparts)) a += part_dp[((long long)c * nparts + b) * 3 + m];
        red[tid] = a;
        __syncthreads();
        for (int s = THREADS / 2; s > 0; s >>= 1) {
          if (tid < s) red[tid] += red[tid + s];
          __syncthreads();
        }
        if (tid == 0) dp[(long long)c * 3 + m] = red[0];
        __syncthreads();
      }
    }
  }
  const int64_t e1 = need_dx1 ? (int64_t)n1 * d : 0;
  const int64_t e2 = need_dx2 ? (int64_t)n2 * d : 0;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + tid; e < (e1 + e2) * chains;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t c = e / (e1 + e2), ec = e - c * (e1 + e2);
    const long long u0 = c * ntiles;  // the chain's first pair
    if (ec < e1) {
      // feature-major, so neighbouring threads read neighbouring rows
      const int k = (int)(ec / n1), i = (int)(ec % n1);
      const int b = i / TILE, r = i % TILE;
      T a;
      if (sym) {
        const long long base = u0 + (long long)b * (b + 1) / 2;
        a = sum4<T>(b + 1, [&](int bj) { return part_rows[((base + bj) * d + k) * TILE + r]; }) +
            sum4<T>(nb1 - b, [&](int j) {
              const long long bi = b + j;
              return part_cols[((u0 + bi * (bi + 1) / 2 + b) * d + k) * TILE + r];
            });
      } else {
        a = sum4<T>(nb2, [&](int bj) {
          return part_rows[((u0 + (long long)b * nb2 + bj) * d + k) * TILE + r];
        });
      }
      dX1[c * e1 + (int64_t)i * d + k] = a;
    } else {
      const int64_t e2i = ec - e1;
      const int k = (int)(e2i / n2), j = (int)(e2i % n2);
      const int b = j / TILE, cc = j % TILE;
      dX2[c * e2 + (int64_t)j * d + k] = sum4<T>(nb1, [&](int bi) {
        return part_cols[((u0 + (long long)bi * nb2 + b) * d + k) * TILE + cc];
      });
    }
  }
}

// blocks of `kernel` that fit on the current device at once, found once a
// device
template <typename Kernel>
int resident_blocks(Kernel kernel, int* cache) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 16) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

long long tile_count(int n1, int n2, int sym) {
  const long long nb1 = (n1 + TILE - 1) / TILE, nb2 = (n2 + TILE - 1) / TILE;
  return sym ? nb1 * (nb1 + 1) / 2 : nb1 * nb2;
}

// the walk's grid: `want` blocks (all that fit on the card at once when
// want <= 0), at most `most` and at most one a tile
int walk_grid(int want, int most, long long ntiles) {
  const long long g = want > 0 && want < most ? want : most;
  return (int)(g < ntiles ? g : ntiles);
}

// A batch of `chains` grams: X1, X2 and p of chain c start at c sx1, c sx2
// and c sp elements (a stride of 0 shares the operand); out, G and the
// gradients are (chains, ...) contiguous.
struct Batch {
  int chains;
  long long sx1, sx2, sp;
};

template <typename T, int F, bool BATCHED>
int launch_gram(const T* X1, const T* X2, const T* p, T* out, int n1, int n2, int d, int sym,
                Batch bt, int want, cudaStream_t stream) {
  static int cache[16] = {0};
  const int most = resident_blocks(gram_kernel<T, F, BATCHED>, cache);
  if (most <= 0) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = tile_count(n1, n2, sym);
  const int grid = walk_grid(want, most, ntiles * bt.chains);
  gram_kernel<T, F, BATCHED><<<grid, THREADS, 0, stream>>>(
      X1, X2, p, out, n1, n2, d, sym, ntiles, (n2 + TILE - 1) / TILE, bt.chains, bt.sx1,
      bt.sx2, bt.sp);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch_gram(const T* X1, const T* X2, const T* p, T* out, int n1, int n2, int d, int sym,
                Batch bt, int want, cudaStream_t stream) {
  return bt.chains == 1
             ? launch_gram<T, F, false>(X1, X2, p, out, n1, n2, d, sym, bt, want, stream)
             : launch_gram<T, F, true>(X1, X2, p, out, n1, n2, d, sym, bt, want, stream);
}

template <typename T>
int gram_any(const T* X1, const T* X2, const T* p, T* out, int n1, int n2, int d, int family,
             int sym, Batch bt, int g, cudaStream_t s) {
  switch (family) {
    case SE: return launch_gram<T, SE>(X1, X2, p, out, n1, n2, d, sym, bt, g, s);
    case MAT12: return launch_gram<T, MAT12>(X1, X2, p, out, n1, n2, d, sym, bt, g, s);
    case MAT32: return launch_gram<T, MAT32>(X1, X2, p, out, n1, n2, d, sym, bt, g, s);
    case MAT52: return launch_gram<T, MAT52>(X1, X2, p, out, n1, n2, d, sym, bt, g, s);
    case RQ: return launch_gram<T, RQ>(X1, X2, p, out, n1, n2, d, sym, bt, g, s);
    case PERIODIC: return launch_gram<T, PERIODIC>(X1, X2, p, out, n1, n2, d, sym, bt, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// scratch, in elements of T: [dp partials: 3 a block and chain, for up to
// MAX_BLOCKS_PER_SM blocks an SM][rows: chains ntiles d 64][cols: the same]
template <typename T, int F, bool BATCHED>
int launch_vjp(const T* X1, const T* X2, const T* p, const T* G, T* dp, T* dX1, T* dX2,
               T* scratch, int n1, int n2, int d, int sym, int need_dp, int need_dx1,
               int need_dx2, Batch bt, int want, cudaStream_t stream) {
  static int cache[16] = {0};
  const int most = resident_blocks(gram_vjp_kernel<T, F, BATCHED>, cache);
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (most <= 0 || most > MAX_BLOCKS_PER_SM * sms) return (int)cudaErrorInvalidConfiguration;
  const long long ntiles = tile_count(n1, n2, sym);
  const long long pairs = ntiles * bt.chains;
  const int grid = walk_grid(want, most, pairs);
  const int nb1 = (n1 + TILE - 1) / TILE, nb2 = (n2 + TILE - 1) / TILE;
  const int need_rows = need_dx1, need_cols = sym ? need_dx1 : need_dx2;
  T* part_dp = scratch;
  T* part_rows = part_dp + 3LL * bt.chains * MAX_BLOCKS_PER_SM * sms;
  T* part_cols = part_rows + (need_rows ? pairs * d * TILE : 0);
  gram_vjp_kernel<T, F, BATCHED><<<grid, THREADS, 0, stream>>>(
      X1, X2, p, G, part_dp, part_rows, part_cols, n1, n2, d, sym, ntiles, nb2, need_dp,
      need_rows, need_cols, bt.chains, bt.sx1, bt.sx2, bt.sp);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long elems =
      ((need_dx1 ? (long long)n1 * d : 0) + (need_dx2 ? (long long)n2 * d : 0)) * bt.chains;
  long long rgrid = (elems + THREADS - 1) / THREADS;
  if (need_dp && rgrid < bt.chains) rgrid = bt.chains;  // a block a chain's dp
  rgrid = rgrid < 1 ? 1 : (rgrid > 4096 ? 4096 : rgrid);
  if (BATCHED)
    gram_vjp_reduce_chains<T><<<(int)rgrid, THREADS, 0, stream>>>(
        part_dp, grid, part_rows, part_cols, dp, dX1, dX2, n1, n2, d, sym, nb1, nb2, need_dp,
        need_dx1, need_dx2, bt.chains, ntiles);
  else
    gram_vjp_reduce<T><<<(int)rgrid, THREADS, 0, stream>>>(
        part_dp, grid, part_rows, part_cols, dp, dX1, dX2, n1, n2, d, sym, nb1, nb2, need_dp,
        need_dx1, need_dx2);
  return (int)cudaGetLastError();
}

template <typename T, int F>
int launch_vjp(const T* X1, const T* X2, const T* p, const T* G, T* dp, T* dX1, T* dX2,
               T* scratch, int n1, int n2, int d, int sym, int need_dp, int need_dx1,
               int need_dx2, Batch bt, int want, cudaStream_t stream) {
  return bt.chains == 1
             ? launch_vjp<T, F, false>(X1, X2, p, G, dp, dX1, dX2, scratch, n1, n2, d, sym,
                                       need_dp, need_dx1, need_dx2, bt, want, stream)
             : launch_vjp<T, F, true>(X1, X2, p, G, dp, dX1, dX2, scratch, n1, n2, d, sym,
                                      need_dp, need_dx1, need_dx2, bt, want, stream);
}

template <typename T>
int vjp_any(const T* X1, const T* X2, const T* p, const T* G, T* dp, T* dX1, T* dX2,
            T* scratch, int n1, int n2, int d, int family, int sym, int need_dp,
            int need_dx1, int need_dx2, Batch bt, int g, cudaStream_t s) {
#define GRAM_VJP_CASE(F)                                                                   \
  case F:                                                                                  \
    return launch_vjp<T, F>(X1, X2, p, G, dp, dX1, dX2, scratch, n1, n2, d, sym, need_dp, \
                            need_dx1, need_dx2, bt, g, s);
  switch (family) {
    GRAM_VJP_CASE(SE)
    GRAM_VJP_CASE(MAT12)
    GRAM_VJP_CASE(MAT32)
    GRAM_VJP_CASE(MAT52)
    GRAM_VJP_CASE(RQ)
    GRAM_VJP_CASE(PERIODIC)
    default: return (int)cudaErrorInvalidValue;
  }
#undef GRAM_VJP_CASE
}

}  // namespace

// C interface, bound with ctypes by ops/gram.py. For each of `chains` chains
// c: X1 + c sx1 (n1, d), X2 + c sx2 (n2, d) and p + c sp (3 values), strides
// in elements (0: shared by the chains), and out (chains, n1, n2), all
// contiguous row-major; grid is the walk's number of blocks (<= 0: as many
// as fit on the card at once); stream is the caller's CUDA stream. Each
// returns the launch's cudaError_t (0 on success).
extern "C" int gram_f32(const float* X1, const float* X2, const float* p, float* out, int n1,
                        int n2, int d, int family, int sym, int chains, long long sx1,
                        long long sx2, long long sp, int grid, void* stream) {
  return gram_any<float>(X1, X2, p, out, n1, n2, d, family, sym, Batch{chains, sx1, sx2, sp},
                         grid, static_cast<cudaStream_t>(stream));
}

extern "C" int gram_f64(const double* X1, const double* X2, const double* p, double* out,
                        int n1, int n2, int d, int family, int sym, int chains, long long sx1,
                        long long sx2, long long sp, int grid, void* stream) {
  return gram_any<double>(X1, X2, p, out, n1, n2, d, family, sym, Batch{chains, sx1, sx2, sp},
                          grid, static_cast<cudaStream_t>(stream));
}

// The VJP of gram_*: G (chains, n1, n2) contiguous; dp (chains, 3), dX1
// (chains, n1, d), dX2 (chains, n2, d) written where need_* is set (dX2 never
// when sym: X1's gradient takes both sides), one gradient a chain even where
// the chains share an operand. scratch holds chains * (3 * 8 * (the card's
// SMs) + s * ntiles * d * 64) elements, s the sides whose partials are
// needed (rows for dX1, columns for dX2, both for a symmetric dX1) and ntiles
// the tiles of one chain's walk (`vjp_scratch_elems` in ops/gram.py).
extern "C" int gram_vjp_f32(const float* X1, const float* X2, const float* p, const float* G,
                            float* dp, float* dX1, float* dX2, float* scratch, int n1, int n2,
                            int d, int family, int sym, int need_dp, int need_dx1, int need_dx2,
                            int chains, long long sx1, long long sx2, long long sp, int grid,
                            void* stream) {
  return vjp_any<float>(X1, X2, p, G, dp, dX1, dX2, scratch, n1, n2, d, family, sym, need_dp,
                        need_dx1, need_dx2, Batch{chains, sx1, sx2, sp}, grid,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int gram_vjp_f64(const double* X1, const double* X2, const double* p,
                            const double* G, double* dp, double* dX1, double* dX2,
                            double* scratch, int n1, int n2, int d, int family, int sym,
                            int need_dp, int need_dx1, int need_dx2, int chains, long long sx1,
                            long long sx2, long long sp, int grid, void* stream) {
  return vjp_any<double>(X1, X2, p, G, dp, dX1, dX2, scratch, n1, n2, d, family, sym, need_dp,
                         need_dx1, need_dx2, Batch{chains, sx1, sx2, sp}, grid,
                         static_cast<cudaStream_t>(stream));
}

