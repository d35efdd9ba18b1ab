// Measurements of the panel kernel's parts on the card (not a kernel of the
// package; perf/panel_parts.py builds and drives it):
//
//   tile_bench  `chol_inv_tile` on one 64 x 64 tile, `iters` times, in one
//               block: the cost of one link of the panel's chain.
//   gemm_bench  `gemm_tile` (64 x 64 x K, B transposed), `iters` times on
//               each of `grid` blocks: the tile product's rate alone and
//               with the card shared.
//   sync_bench  `iters` grid syncs of a cooperative grid.

#include "cholesky.cu"

namespace {

__global__ void __launch_bounds__(NT) tile_bench(const float* A, float* L, float* Li, int iters) {
  __shared__ PanelSmem ps;
  for (int it = 0; it < iters; ++it) chol_inv_tile(A, TS, L, TS, Li, TS, ps);
}

__global__ void __launch_bounds__(NT)
gemm_bench(const float* A, const float* Bm, float* C, int K, int iters) {
  __shared__ GemmSmem gs;
  float* c = C + (int64_t)blockIdx.x * TS * TS;
  for (int it = 0; it < iters; ++it) gemm_tile<true>(c, TS, c, TS, A, K, Bm, K, K, -1.f, gs);
}

__global__ void __launch_bounds__(NT) sync_bench(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int it = 0; it < iters; ++it) grid.sync();
}

}  // namespace

// Each returns the launch's cudaError_t; all run on the default stream.
extern "C" int tile_bench_f32(const float* A, float* L, float* Li, int iters) {
  tile_bench<<<1, NT>>>(A, L, Li, iters);
  return (int)cudaGetLastError();
}

// A (64, K), Bm (64, K), C (grid, 64, 64)
extern "C" int gemm_bench_f32(const float* A, const float* Bm, float* C, int K, int iters,
                              int grid) {
  gemm_bench<<<grid, NT>>>(A, Bm, C, K, iters);
  return (int)cudaGetLastError();
}

extern "C" int sync_bench_max_blocks(int* blocks) {
  return max_coresident_blocks(sync_bench, blocks);
}

extern "C" int sync_bench_run(int iters, int grid) {
  void* args[] = {&iters};
  return launch_cooperative((const void*)sync_bench, grid, args, nullptr);
}
