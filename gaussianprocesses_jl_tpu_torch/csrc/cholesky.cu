// The Cholesky study's kernels for Hopper (sm_90a), f32:
//
//   panel_kernel         L and L^-1 of one SPD B x B panel in one launch.
//                        Replaces `_panel_kernel` / `chol_inv_panel` in
//                        perf/pallas_cholesky_study.py.
//   single_launch_kernel a whole left-looking Cholesky in one launch, in place.
//                        Replaces `_single_launch_kernel` /
//                        `single_launch_cholesky` there.
//   probe_kernel         a chain of n_iter dependent scalar adds, then
//                        o = A[0:8, 0:128] + n_iter. Replaces the inner `kern`
//                        of `study_launch_overhead` there.
//
// What bounds them. The panel does 2B^3/3 flops (Cholesky B^3/3, inverse
// B^3/3): 10.7 us at B = 1024 at the 67 TFLOP/s non-tensor f32 rate. The
// factorization does n^3/3: 5.3 ms at n = 10240. Both also carry a chain of B
// (or n) dependent column steps that no amount of parallel hardware shortens;
// that chain is why the TPU panel lost to XLA. The probe is bound by its
// dependent-add latency (~4 cycles an add), not by bytes or flops.
//
// Design (simple and correct first; no wgmma or TMA yet):
// - Every product goes through `gemm_tile`: one block of 256 threads computes
//   a 64 x 64 output tile, 4 x 4 outputs per thread, staging 16-deep slices of
//   both operands in shared memory. Operands and results live in device
//   memory: a B = 1024 panel is 4 MB a matrix, far above a block's 227 KB of
//   shared memory (the TPU kept it in VMEM), but it stays in the 50 MB L2.
// - `chol_inv_block` is the panel algorithm for one block: micro-panels of 64
//   columns (the TPU used 128). For each, a correction product against the
//   finished columns; the 64 x 64 diagonal tile goes to shared memory for the
//   serial column chain (rank-1 updates with __syncthreads between columns)
//   and its inverse (row elimination); the rows below are multiplied by that
//   inverse. The off-diagonal tiles of L^-1 are assembled at the end as on
//   the TPU: L^-1[i,j] = -D_i (L[i, j:i] L^-1[j:i, j]). The whole panel runs
//   in one block because the column chain is a serial dependency.
// - The TPU's single-launch kernel relied on its grid running in order, one
//   panel per step. CUDA blocks run in no order, so the factorization is one
//   cooperative launch sized to the blocks that fit on the card at once, with
//   grid.sync() between the three phases of each panel: the correction
//   product over all blocks, the diagonal block's Cholesky and inverse in
//   block 0 (the same `chol_inv_block`), and the below-diagonal apply over all
//   blocks. The panel column the TPU held in VMEM is a device scratch (n, B).
// - The probe's adds are volatile inline assembly, so the compiler can fold
//   nothing and the time grows with n_iter.
//
// Every size is a multiple of 64; the wrappers in ops/cholesky_kernels.py
// check shapes, allocate every output and scratch, and launch on the caller's
// stream.

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
  float ld[TS][TS + 1];  // diagonal tile, then its Cholesky factor
  float x[TS][TS + 1];   // the factor's inverse
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

    // 2. the diagonal tile's column chain, in shared memory
    for (int idx = tid; idx < TS * TS; idx += NT)
      ps.ld[idx / TS][idx % TS] = L[(int64_t)(j0 + idx / TS) * ldl + j0 + idx % TS];
    __syncthreads();
    for (int j = 0; j < TS; ++j) {
      const float rs = rsqrtf(ps.ld[j][j]);  // NaN on a non-positive pivot
      __syncthreads();
      if (tid >= j && tid < TS) ps.ld[tid][j] *= rs;
      __syncthreads();
      for (int idx = tid; idx < TS * TS; idx += NT) {
        const int i = idx / TS, k = idx % TS;
        if (k > j && k <= i) ps.ld[i][k] -= ps.ld[i][j] * ps.ld[k][j];
      }
      __syncthreads();
    }

    // 3. its inverse by row elimination: X = I, then for each k scale row k
    //    by 1/ld[k][k] and take ld[i][k] times it from every row i > k
    for (int idx = tid; idx < TS * TS; idx += NT) {
      const int i = idx / TS, k = idx % TS;
      ps.x[i][k] = (i == k) ? 1.f : 0.f;
      if (k > i) ps.ld[i][k] = 0.f;
    }
    __syncthreads();
    for (int k = 0; k < TS; ++k) {
      if (tid < TS) ps.x[k][tid] /= ps.ld[k][k];
      __syncthreads();
      for (int idx = tid; idx < TS * TS; idx += NT) {
        const int i = idx / TS, c = idx % TS;
        if (i > k) ps.x[i][c] -= ps.ld[i][k] * ps.x[k][c];
      }
      __syncthreads();
    }

    // 4. both tiles to device memory
    for (int idx = tid; idx < TS * TS; idx += NT) {
      const int i = idx / TS, c = idx % TS;
      L[(int64_t)(j0 + i) * ldl + j0 + c] = ps.ld[i][c];
      Li[(int64_t)(j0 + i) * ldi + j0 + c] = ps.x[i][c];
    }
    __syncthreads();

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

__global__ void __launch_bounds__(NT)
panel_kernel(const float* A, float* L, float* Li, int B) {
  __shared__ GemmSmem gs;
  __shared__ PanelSmem ps;
  chol_inv_block(A, B, L, B, Li, B, B, gs, ps);
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

}  // namespace

// C interface, bound with ctypes by ops/cholesky_kernels.py. Matrices are
// contiguous row-major f32; stream is the caller's CUDA stream. Each returns
// the launch's cudaError_t (0 on success).

// A (B, B) -> L, Li (B, B); B % 64 == 0.
extern "C" int chol_inv_panel_f32(const float* A, float* L, float* Li, int B, void* stream) {
  panel_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(A, L, Li, B);
  return (int)cudaGetLastError();
}

// The most blocks of single_launch_kernel that fit on the current device at
// once: the largest grid a cooperative launch accepts.
extern "C" int single_launch_max_blocks(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, single_launch_kernel, NT, 0);
  *blocks = per_sm * sms;
  return (int)e;
}

// out (n, n) holds K and receives L; acc (n, B) and linv (B, B) are scratch;
// n % B == 0, B % 64 == 0; grid <= single_launch_max_blocks.
extern "C" int single_launch_cholesky_f32(float* out, float* acc, float* linv, int n, int B,
                                          int grid, void* stream) {
  void* args[] = {&out, &acc, &linv, &n, &B};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)single_launch_kernel, dim3(grid),
                                              dim3(NT), args, 0,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// A (>= 8 rows, >= 128 columns, row stride lda) -> o (8, 128).
extern "C" int launch_probe_f32(const float* A, int lda, float* o, int n_iter, void* stream) {
  probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(A, lda, o, n_iter);
  return (int)cudaGetLastError();
}
