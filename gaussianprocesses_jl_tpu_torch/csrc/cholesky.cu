// The Cholesky study's kernels for Hopper (sm_90a), f32:
//
//   panel_kernel         L and L^-1 of one SPD B x B panel in one cooperative
//                        launch over the card. Replaces `_panel_kernel` /
//                        `chol_inv_panel` in perf/pallas_cholesky_study.py
//                        (:164-234).
//   single_launch_kernel a whole left-looking Cholesky in one launch, in place.
//                        Replaces `_single_launch_kernel` /
//                        `single_launch_cholesky` there.
//   probe_kernel         a chain of n_iter dependent scalar adds, then
//                        o = A[0:8, 0:128] + n_iter. Replaces the inner `kern`
//                        of `study_launch_overhead` there.
//
// What bounds them. The panel does 2B^3/3 flops (Cholesky B^3/3, inverse
// B^3/3): 10.7 us at B = 1024 at the 67 TFLOP/s non-tensor f32 rate. It moves
// 12B^2 bytes (A read, L and L^-1 written, once each): 3.8 us at B = 1024 at
// 3.35 TB/s, so operations bound it. Beyond both, it
// carries a chain of nt = B/64 diagonal tiles, each factored after the last,
// with two grid syncs a step. The factorization does n^3/3: 5.3 ms at
// n = 10240, with a chain of n dependent column steps. The probe is bound by
// its dependent-add latency (~4 cycles an add), not by bytes or flops.
//
// Design (simple and correct first; f32 SIMT, no wgmma, TMA or TF32):
// - Every product goes through `gemm_tile`: one block of 256 threads computes
//   a 64 x 64 output tile, 4 x 4 outputs per thread, staging 16-deep slices of
//   both operands in shared memory. Operands and results live in device
//   memory: a B = 1024 panel is 4 MB a matrix, far above a block's 227 KB of
//   shared memory (the TPU kept it in VMEM), but it stays in the 50 MB L2.
// - `chol_inv_tile` factors one 64 x 64 diagonal tile in one block, each
//   thread holding a 4 x 4 piece in registers: the serial column chain
//   (rank-1 updates), then its inverse by row elimination, with one
//   __syncthreads a column or row (the column or row is published in a
//   double-buffered line of shared memory). The chain is the panel's
//   critical path, so it is kept to 128 block barriers and 16 FMAs a thread
//   each.
// - `panel_kernel` is a right-looking tiled Cholesky over the whole card, one
//   cooperative launch, its grid the most tiles any phase has (capped by what
//   fits on the card at once). The chain is answered by look-ahead: step k's
//   phase (a) has block 0 apply step k-1's trailing update to tile (k, k)
//   alone and factor it, while the other blocks apply that update to every
//   other trailing tile, so the chain overlaps the products. Phase (b) shares
//   out the panel apply L[r, k] <- L[r, k] D_k^T (r > k) and row k of L^-1,
//   L^-1[k, j] = -D_k W[k, j] (j < k), one tile product a block. L^-1 is
//   right-looking too: W[i, j] = sum_{m=j}^{i-1} L[i, m] L^-1[m, j] gathers
//   one term a step, in phase (a) beside the trailing update, as soon as
//   column m of L and row m of L^-1 are final; it lives in L^-1's own tile.
//   (Forming W[k, j] whole in phase (b) of step k, k - j products in one
//   block, puts a chain of ~nt^2/2 tile products on the critical path: such
//   a variant took 0.98 ms at B = 1024 against 0.49 ms this way on an H100
//   80GB HBM3 at 700 W.) No serial L^-1 pass is left. Two grid syncs a
//   step, 2 nt - 1 in all; the operation bound is answered by sharing every
//   product out over the grid. No block leaves the loop early: a NaN pivot
//   spreads through the updates.
// - `chol_inv_block` is the panel algorithm for one block (micro-panels of
//   64 columns, each a correction product, `chol_inv_tile`, and the apply
//   below; then the off-diagonal tiles of L^-1). Only the single launch uses
//   it now, for its diagonal blocks.
// - The TPU's single-launch kernel relied on its grid running in order, one
//   panel per step. CUDA blocks run in no order, so the factorization is one
//   cooperative launch sized to the blocks that fit on the card at once, with
//   grid.sync() between the three phases of each panel: the correction
//   product over all blocks, the diagonal block's Cholesky and inverse in
//   block 0 (`chol_inv_block`), and the below-diagonal apply over all
//   blocks. The panel column the TPU held in VMEM is a device scratch (n, B).
// - The probe's adds are volatile inline assembly, so the compiler can fold
//   nothing and the time grows with n_iter.
//
// Every size is a multiple of 64; the wrappers in ops/cholesky_kernels.py
// check shapes, allocate every output and scratch, size the cooperative
// grids, and launch on the caller's stream.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;       // threads per block
constexpr int TS = 64;        // output tile edge and micro-panel width
constexpr int KC = 16;        // depth of a staged operand slice
constexpr int TSP = TS + 4;   // padded smem row: keeps float4 alignment

struct __align__(16) GemmSmem {
  float a[KC][TSP];  // A slice, transposed: a[k][row]
  float b[KC][TSP];  // B slice: b[k][col]
};

struct PanelSmem {
  float ld[TS][TS + 1];  // the diagonal tile's factor, for its inverse
  float dinv[TS];        // 1 / its diagonal
  float line[2][TS];     // the chain's column j, the inverse's row k, by parity
};

// One TS x TS output tile, by the whole block:
//   out[r][c] = (cin ? cin[r][c] : 0) + sign * sum_{k < K} A[r][k] * op(B)[k][c]
// with op(B)[k][c] = B[c][k] when BT (B stored N x K) and B[k][c] otherwise.
// Pointers are at the tile's first element. `out` may alias `cin` or, when the
// output is a single tile, an operand: all reads happen before the writes.
template <bool BT>
__device__ void gemm_tile(float* out, int ldo, const float* cin, int ldcin,
                          const float* A, int lda, const float* Bm, int ldb,
                          int K, float sign, GemmSmem& s) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    for (int idx = tid; idx < TS * KC; idx += NT) {
      const int r = idx / KC, k = idx % KC;
      s.a[k][r] = A[(int64_t)r * lda + k0 + k];
    }
    if (BT) {
      for (int idx = tid; idx < TS * KC; idx += NT) {
        const int c = idx / KC, k = idx % KC;
        s.b[k][c] = Bm[(int64_t)c * ldb + k0 + k];
      }
    } else {
      for (int idx = tid; idx < TS * KC; idx += NT) {
        const int k = idx / TS, c = idx % TS;
        s.b[k][c] = Bm[(int64_t)(k0 + k) * ldb + c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
      const float a[4] = {av.x, av.y, av.z, av.w};
      const float b[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx * 4 + j;
      float v = sign * acc[i][j];
      if (cin != nullptr) v += cin[(int64_t)r * ldcin + c];
      out[(int64_t)r * ldo + c] = v;
    }
  }
}

// L and L^-1 of one TS x TS diagonal tile, by one block. Each thread holds a
// 4 x 4 piece of the tile in registers, as in `gemm_tile`. The column chain:
// for each column j the threads holding it publish it in shared memory, and
// every thread scales it by rsqrt of the pivot (NaN on a non-positive one)
// and takes its rank-1 update from its own piece. The inverse, by row
// elimination from X = I: for each k the threads holding row k scale it by
// 1/L[k][k] (a reciprocal taken once keeps IEEE division's long sequence
// out of the chain) and publish it, and every thread takes L[i][k] times it
// from its rows i > k. `line` is double-buffered, so each column or row
// costs one __syncthreads, and the updates are selects, not branches. The
// factor goes to `L`, its inverse to `Li`, each with exact zeros above the
// diagonal. `src` may alias `L`; the caller syncs the block before, so that
// `src` is complete.
__device__ void chol_inv_tile(const float* src, int lds, float* L, int ldl, float* Li, int ldi,
                              PanelSmem& ps) {
  const int r0 = threadIdx.x / 16 * 4, c0 = threadIdx.x % 16 * 4;
  float a[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = src[(int64_t)(r0 + r) * lds + c0 + c];

  for (int jb = 0; jb < TS; jb += 4) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = jb + jj;
      float* col = ps.line[j & 1];
      if (c0 == jb) {
#pragma unroll
        for (int r = 0; r < 4; ++r) col[r0 + r] = a[r][jj];
      }
      __syncthreads();
      const float rs = rsqrtf(col[j]);
      float ci[4], ck[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float v = col[r0 + r] * rs;
        ci[r] = r0 + r >= j ? v : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) ck[c] = col[c0 + c] * rs;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float u = fmaf(-ci[r], ck[c], a[r][c]);
          a[r][c] = c0 + c > j ? u : (c0 + c == j ? ci[r] : a[r][c]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float v = c0 + c <= r0 + r ? a[r][c] : 0.f;
      ps.ld[r0 + r][c0 + c] = v;
      L[(int64_t)(r0 + r) * ldl + c0 + c] = v;
      if (c0 + c == r0 + r) ps.dinv[r0 + r] = 1.f / v;
    }
  __syncthreads();

  float x[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[r][c] = r0 + r == c0 + c ? 1.f : 0.f;
  for (int kb = 0; kb < TS; kb += 4) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = kb + kk;
      float* row = ps.line[k & 1];
      if (r0 == kb) {
        const float d = ps.dinv[k];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          x[kk][c] *= d;
          row[c0 + c] = x[kk][c];
        }
      }
      __syncthreads();
      float xk[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) xk[c] = row[c0 + c];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float l = ps.ld[r0 + r][k];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float u = fmaf(-l, xk[c], x[r][c]);
          x[r][c] = r0 + r > k ? u : x[r][c];
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) Li[(int64_t)(r0 + r) * ldi + c0 + c] = x[r][c];
  __syncthreads();
}

// L and L^-1 of the SPD B x B matrix A (its lower triangle is read), by one
// block. L and Li get exact zeros above the diagonal. A may not alias L or Li.
__device__ void chol_inv_block(const float* A, int lda, float* L, int ldl,
                               float* Li, int ldi, int B, GemmSmem& gs,
                               PanelSmem& ps) {
  const int tid = threadIdx.x;
  const int nt = B / TS;

  // tiles strictly above the diagonal are zero in both factors
  for (int64_t idx = tid; idx < (int64_t)B * B; idx += NT) {
    const int r = (int)(idx / B), c = (int)(idx % B);
    if (c / TS > r / TS) {
      L[(int64_t)r * ldl + c] = 0.f;
      Li[(int64_t)r * ldi + c] = 0.f;
    }
  }

  for (int kt = 0; kt < nt; ++kt) {
    const int j0 = kt * TS;
    // 1. micro-panel column, corrected by the finished columns:
    //    L[j0:, j0:j0+TS] = A[j0:, j0:j0+TS] - L[j0:, :j0] L[j0:j0+TS, :j0]^T
    for (int rt = kt; rt < nt; ++rt) {
      const int r0 = rt * TS;
      gemm_tile<true>(L + (int64_t)r0 * ldl + j0, ldl, A + (int64_t)r0 * lda + j0, lda,
                      L + (int64_t)r0 * ldl, ldl, L + (int64_t)j0 * ldl, ldl, j0, -1.f, gs);
    }
    __syncthreads();

    // 2-4. the diagonal tile's factor and inverse
    float* d = L + (int64_t)j0 * ldl + j0;
    chol_inv_tile(d, ldl, d, ldl, Li + (int64_t)j0 * ldi + j0, ldi, ps);

    // 5. rows below: L[r, j0:j0+TS] = P[r, :] X^T (in place, one tile wide)
    for (int rt = kt + 1; rt < nt; ++rt) {
      const int r0 = rt * TS;
      float* t = L + (int64_t)r0 * ldl + j0;
      gemm_tile<true>(t, ldl, nullptr, 0, t, ldl, Li + (int64_t)j0 * ldi + j0, ldi, TS, 1.f, gs);
    }
    __syncthreads();
  }

  // 6. off-diagonal tiles of L^-1, one block row after another:
  //    S = L[i, j:i] L^-1[j:i, j], then L^-1[i, j] = -D_i S (in place)
  for (int i = 1; i < nt; ++i) {
    for (int j = 0; j < i; ++j) {
      float* t = Li + (int64_t)i * TS * ldi + j * TS;
      gemm_tile<false>(t, ldi, nullptr, 0, L + (int64_t)i * TS * ldl + j * TS, ldl,
                       Li + (int64_t)j * TS * ldi + j * TS, ldi, (i - j) * TS, 1.f, gs);
      __syncthreads();
      gemm_tile<false>(t, ldi, nullptr, 0, Li + (int64_t)i * TS * ldi + i * TS, ldi,
                       t, ldi, TS, -1.f, gs);
      __syncthreads();
    }
  }
}

// The row i' of the t-th entry of a lower triangle listed row by row:
// the largest i' with i'(i'+1)/2 <= t.
__device__ int tri_row(int t) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  return i;
}

// L and L^-1 of the SPD B x B matrix A (its lower triangle is read), over the
// whole cooperative grid; see the note at the top. A is read-only and L is
// the work array; the strictly lower tiles of L^-1 hold the running sums
// W[i, j] = sum_m L[i, m] L^-1[m, j] until row i is final. Tile (i, j) of a
// matrix M is M[64i:64i+64, 64j:64j+64]. Unless `syncs` is null, block 0 adds
// the grid syncs it passed to *syncs.
__global__ void __launch_bounds__(NT)
panel_kernel(const float* A, float* L, float* Li, int B, int* syncs) {
  __shared__ GemmSmem gs;
  __shared__ PanelSmem ps;
  cg::grid_group grid = cg::this_grid();
  const int nt = B / TS;
  const int G = gridDim.x, bid = blockIdx.x;
  int n_sync = 0;
  // phase (a): blocks 1.. share out the products while block 0 takes the
  // diagonal tile; a grid of one block takes both
  const int nw = G > 1 ? G - 1 : 1, w = G > 1 ? bid - 1 : 0;
  auto tile = [B](float* M, int i, int j) { return M + ((int64_t)i * B + j) * TS; };

  for (int k = 0; k < nt; ++k) {
    // (a) tile (k, k), updated by step k-1 and factored, in block 0 ...
    if (bid == 0) {
      float* d = tile(L, k, k);
      if (k > 0) {
        const float* p = tile(L, k, k - 1);
        gemm_tile<true>(d, B, d, B, p, B, p, B, TS, -1.f, gs);
        __syncthreads();
      }
      chol_inv_tile(k == 0 ? A : d, B, d, B, tile(Li, k, k), B, ps);
    }
    if (k == 0) {
      // ... beside the set-up: A's lower tiles but (0, 0) into L, zeros
      // above the diagonal tiles of L and L^-1 and in the sums W
      for (int64_t idx = (int64_t)bid * NT + threadIdx.x; idx < (int64_t)B * B;
           idx += (int64_t)G * NT) {
        const int rt = (int)(idx / B) / TS, ct = (int)(idx % B) / TS;
        if (ct != rt) Li[idx] = 0.f;
        if (ct > rt) L[idx] = 0.f;
        else if (rt > 0) L[idx] = A[idx];
      }
    } else if (w >= 0) {
      // ... beside step k-1's updates, with column k-1 of L and row k-1 of
      // L^-1 final: the trailing tiles (i, j), k <= j <= i, but (k, k),
      //   L[i, j] -= L[i, k-1] L[j, k-1]^T,
      // then the sums W[i, j], i >= k > j, W[i, j] += L[i, k-1] L^-1[k-1, j]
      const int m = nt - k, n_trail = m * (m + 1) / 2 - 1;
      for (int t = w; t < n_trail + m * k; t += nw) {
        if (t < n_trail) {
          const int ip = tri_row(t + 1), jp = t + 1 - ip * (ip + 1) / 2;
          float* o = tile(L, k + ip, k + jp);
          gemm_tile<true>(o, B, o, B, tile(L, k + ip, k - 1), B, tile(L, k + jp, k - 1), B, TS,
                          -1.f, gs);
        } else {
          const int i = k + (t - n_trail) / k, j = (t - n_trail) % k;
          float* o = tile(Li, i, j);
          gemm_tile<false>(o, B, o, B, tile(L, i, k - 1), B, tile(Li, k - 1, j), B, TS, 1.f,
                           gs);
        }
      }
    }
    grid.sync();
    ++n_sync;

    // (b) nt - 1 tiles, one product each: row k of L^-1, L^-1[k, j] =
    // -D_k W[k, j] for j < k (W[k, j] is whole: its last term came in (a)),
    // then the panel, L[r, k] <- L[r, k] D_k^T for r > k (both in place)
    const float* D = tile(Li, k, k);
    for (int t = bid; t < nt - 1; t += G) {
      if (t < k) {
        float* o = tile(Li, k, t);
        gemm_tile<false>(o, B, nullptr, 0, D, B, o, B, TS, -1.f, gs);
      } else {
        float* o = tile(L, t + 1, k);
        gemm_tile<true>(o, B, nullptr, 0, o, B, D, B, TS, 1.f, gs);
      }
    }
    if (k + 1 < nt) {
      grid.sync();
      ++n_sync;
    }
  }
  if (syncs != nullptr && bid == 0 && threadIdx.x == 0) *syncs += n_sync;
}

// out holds a copy of K on entry and L on exit. acc (n, B) is the current
// panel column, linv (B, B) the inverse of its diagonal block.
__global__ void __launch_bounds__(NT)
single_launch_kernel(float* out, float* acc, float* linv, int n, int B) {
  __shared__ GemmSmem gs;
  __shared__ PanelSmem ps;
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int ct_n = B / TS;
  for (int c = 0; c < n; c += B) {
    const int rt_n = (n - c) / TS;
    // 1. left-looking correction over all blocks:
    //    acc[r, :] = K[r, c:c+B] - L[r, :c] L[c:c+B, :c]^T for r >= c
    for (int t = blockIdx.x; t < rt_n * ct_n; t += gridDim.x) {
      const int r0 = c + (t / ct_n) * TS, c0 = (t % ct_n) * TS;
      gemm_tile<true>(acc + (int64_t)r0 * B + c0, B, out + (int64_t)r0 * n + c + c0, n,
                      out + (int64_t)r0 * n, n, out + (int64_t)(c + c0) * n, n, c, -1.f, gs);
    }
    grid.sync();
    // 2. the diagonal block's Cholesky and inverse, in block 0
    if (blockIdx.x == 0)
      chol_inv_block(acc + (int64_t)c * B, B, out + (int64_t)c * n + c, n, linv, B, B, gs, ps);
    grid.sync();
    // 3. below-diagonal apply over all blocks, L[r, c:c+B] = acc[r, :] linv^T
    //    for r >= c + B, and zeros above the diagonal block
    for (int t = blockIdx.x; t < (rt_n - ct_n) * ct_n; t += gridDim.x) {
      const int r0 = c + B + (t / ct_n) * TS, c0 = (t % ct_n) * TS;
      gemm_tile<true>(out + (int64_t)r0 * n + c + c0, n, nullptr, 0, acc + (int64_t)r0 * B, B,
                      linv + (int64_t)c0 * B, B, B, 1.f, gs);
    }
    for (int64_t idx = (int64_t)blockIdx.x * NT + tid; idx < (int64_t)c * B;
         idx += (int64_t)gridDim.x * NT)
      out[(idx / B) * n + c + idx % B] = 0.f;
    grid.sync();
  }
}

__global__ void probe_kernel(const float* A, int lda, float* o, int n_iter) {
  float acc = 0.f;
  for (int j = 0; j < n_iter; ++j) asm volatile("add.f32 %0, %0, 0f3F800000;" : "+f"(acc));
  const int c = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 8; ++r) o[r * 128 + c] = A[(int64_t)r * lda + c] + acc;
}

// The most blocks of `kernel` that fit on the current device at once: the
// largest grid a cooperative launch of it accepts.
template <typename Kernel>
int max_coresident_blocks(Kernel kernel, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
  *blocks = per_sm * sms;
  return (int)e;
}

int launch_cooperative(const void* kernel, int grid, void** args, void* stream) {
  cudaError_t e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(NT), args, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/cholesky_kernels.py. Matrices are
// contiguous row-major f32; stream is the caller's CUDA stream. Each returns
// the launch's cudaError_t (0 on success).

// The largest cooperative grid of each kernel on the current device.
extern "C" int panel_max_blocks(int* blocks) {
  return max_coresident_blocks(panel_kernel, blocks);
}

// A (B, B) -> L, Li (B, B); B % 64 == 0; 1 <= grid <= panel_max_blocks.
// syncs: null, or one int on the device that gains the launch's grid syncs.
extern "C" int chol_inv_panel_f32(const float* A, float* L, float* Li, int B, int grid,
                                  int* syncs, void* stream) {
  void* args[] = {&A, &L, &Li, &B, &syncs};
  return launch_cooperative((const void*)panel_kernel, grid, args, stream);
}

extern "C" int single_launch_max_blocks(int* blocks) {
  return max_coresident_blocks(single_launch_kernel, blocks);
}

// out (n, n) holds K and receives L; acc (n, B) and linv (B, B) are scratch;
// n % B == 0, B % 64 == 0; grid <= single_launch_max_blocks.
extern "C" int single_launch_cholesky_f32(float* out, float* acc, float* linv, int n, int B,
                                          int grid, void* stream) {
  void* args[] = {&out, &acc, &linv, &n, &B};
  return launch_cooperative((const void*)single_launch_kernel, grid, args, stream);
}

// A (>= 8 rows, >= 128 columns, row stride lda) -> o (8, 128).
extern "C" int launch_probe_f32(const float* A, int lda, float* o, int n_iter, void* stream) {
  probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(A, lda, o, n_iter);
  return (int)cudaGetLastError();
}
