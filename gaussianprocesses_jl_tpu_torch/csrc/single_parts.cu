// Measurements of the single launch's correction on the card (not a kernel
// of the package; perf/single_parts.py builds and drives it). Both run the
// correction of panel column c of an n x n matrix X,
//   acc[c:] = X[c:, c:c+B] - X[c:, :c] X[c:c+B, :c]^T,
// `iters` times in one cooperative launch:
//
//   deep_bench  as the single launch runs it: `deep_tile` products spread
//               over the grid stream-K style (`product_partials`), a grid
//               sync, the pieces summed (`product_reduce`), a grid sync.
//   gemm_bench  as the single launch ran it before: one 64 x 64 `gemm_tile`
//               of full depth c a block at a time, then a grid sync.

#include "cholesky.cu"

namespace {

__global__ void __launch_bounds__(NT, 1)
deep_bench(const float* X, float* acc, float* part, int n, int B, int c, int iters) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  DeepStage* ring = reinterpret_cast<DeepStage*>(dyn_smem);
  cg::grid_group grid = cg::this_grid();
  const int64_t cn = (int64_t)c * n;
  const Product corr{acc + (int64_t)c * B, B, X + cn + c, n, X + cn, n, X + cn, n, n - c, B, c,
                     -1.f};
  for (int it = 0; it < iters; ++it) {
    product_partials(corr, part, ring);
    grid.sync();
    product_reduce(corr, part);
    grid.sync();
  }
}

__global__ void __launch_bounds__(NT)
gemm_bench(const float* X, float* acc, int n, int B, int c, int iters) {
  __shared__ GemmSmem gs;
  cg::grid_group grid = cg::this_grid();
  const int rt_n = (n - c) / TS, ct_n = B / TS;
  for (int it = 0; it < iters; ++it) {
    for (int t = blockIdx.x; t < rt_n * ct_n; t += gridDim.x) {
      const int r0 = c + (t / ct_n) * TS, c0 = (t % ct_n) * TS;
      gemm_tile<true>(acc + (int64_t)r0 * B + c0, B, X + (int64_t)r0 * n + c + c0, n,
                      X + (int64_t)r0 * n, n, X + (int64_t)(c + c0) * n, n, c, -1.f, gs);
    }
    grid.sync();
  }
}

}  // namespace

// Each returns the launch's cudaError_t; all run on the default stream.
extern "C" int deep_bench_max_blocks(int* blocks) {
  return max_coresident_blocks(deep_bench, DEEP_SMEM, blocks);
}

extern "C" int gemm_bench_max_blocks(int* blocks) {
  return max_coresident_blocks(gemm_bench, 0, blocks);
}

// X (n, n), acc (n, B), part (2 grid, 128, 128); n % B == 0, B % 128 == 0,
// c % B == 0, c < n
extern "C" int deep_bench_run(const float* X, float* acc, float* part, int n, int B, int c,
                              int iters, int grid) {
  void* args[] = {&X, &acc, &part, &n, &B, &c, &iters};
  return launch_cooperative(deep_bench, grid, DEEP_SMEM, args, nullptr);
}

extern "C" int gemm_bench_run(const float* X, float* acc, int n, int B, int c, int iters,
                              int grid) {
  void* args[] = {&X, &acc, &n, &B, &c, &iters};
  return launch_cooperative(gemm_bench, grid, 0, args, nullptr);
}
