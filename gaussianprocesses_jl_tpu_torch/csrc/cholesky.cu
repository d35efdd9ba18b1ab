// The Cholesky study's kernels for Hopper (sm_90a), f32:
//
//   panel_kernel         L and L^-1 of one SPD B x B panel in one cooperative
//                        launch over the card. Replaces `_panel_kernel` /
//                        `chol_inv_panel` in perf/pallas_cholesky_study.py
//                        (:164-234).
//   single_launch_kernel a whole left-looking Cholesky in one cooperative
//                        launch over the card. Replaces
//                        `_single_launch_kernel` / `single_launch_cholesky`
//                        there (:352-459).
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
// n = 10240, with a chain of n/B diagonal blocks, each a panel's chain. The
// probe is bound by its dependent-add latency (~4 cycles an add), not by
// bytes or flops.
//
// Design (f32 on the CUDA cores: no tensor cores, no TF32, no wgmma; the
// study holds the factors to 1e-4 of f64, and TF32 products failed to factor
// GP grams at noise <= 1e-2):
// - Short products go through `gemm_tile`: one block of 256 threads computes
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
// - `chol_inv_grid` is a right-looking tiled Cholesky and inverse of one
//   B x B block over the whole cooperative grid; `panel_kernel` is it alone,
//   its grid the most tiles any phase has (capped by what fits on the card
//   at once), and the single launch runs it on each diagonal block. The
//   chain is answered by look-ahead: step k's phase (a) has block 0 apply
//   step k-1's trailing update to tile (k, k) alone and factor it, while the
//   other blocks apply that update to every other trailing tile, so the chain
//   overlaps the products. Phase (b) shares out the panel apply
//   L[r, k] <- L[r, k] D_k^T (r > k) and row k of L^-1,
//   L^-1[k, j] = -D_k W[k, j] (j < k), one tile product a block. L^-1 is
//   right-looking too: W[i, j] = sum_{m=j}^{i-1} L[i, m] L^-1[m, j] gathers
//   one term a step, in phase (a) beside the trailing update, as soon as
//   column m of L and row m of L^-1 are final; it lives in L^-1's own tile.
//   (Forming W[k, j] whole in phase (b) of step k, k - j products in one
//   block, puts a chain of ~nt^2/2 tile products on the critical path: such
//   a variant took 0.98 ms at B = 1024 against 0.49 ms this way on an H100
//   80GB HBM3 at 700 W.) Two grid syncs a step, 2 nt - 1 in all. No block
//   leaves the loop early: a NaN pivot spreads through the updates.
// - The single launch's deep products (the left-looking correction, depth
//   up to n, and the apply below the diagonal block, depth B) go through
//   `deep_tile`: a 128 x 128 output tile a block, 8 x 8 outputs a thread in
//   registers, 16-deep slices of both operands copied by `cp.async` into a
//   ring of four stages in dynamic shared memory, so the next slices' loads
//   overlap this slice's FMAs; the slices keep the operands' row-major layout
//   with rows padded to 20 floats, so the float4 reads along the depth hit no
//   bank twice. Every product is spread over the whole grid stream-K style:
//   the (tile, slice) iterations of the phase are cut into one equal range a
//   block, so every block works in every panel, however few tiles it has. A
//   block whose range covers a whole tile writes it; the pieces of a tile
//   split between blocks (at most two a block: its range's head and tail) go
//   to a scratch buffer and, after a grid sync, are added in block order:
//   no atomics, the same sums from run to run.
// - The TPU's single-launch kernel relied on its grid running in order, one
//   panel per step. CUDA blocks run in no order, so the factorization is one
//   cooperative launch sized to the blocks that fit on the card at once, with
//   grid.sync() between its phases; the panel column the TPU held in VMEM is
//   a device scratch (n, B).
// - The probe's adds are volatile inline assembly, so the compiler can fold
//   nothing and the time grows with n_iter.
//
// Every size is a multiple of 64 (the single launch's B of 128); the
// wrappers in ops/cholesky_kernels.py check shapes, allocate every output and
// scratch, size the cooperative grids, and launch on the caller's stream.

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

// The row i' of the t-th entry of a lower triangle listed row by row:
// the largest i' with i'(i'+1)/2 <= t.
__device__ int tri_row(int t) {
  int i = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  return i;
}

// grid.sync() that counts the syncs passed and, when STAMPS and `stamps` is
// not null, has block 0 write %globaltimer (ns) after each: stamps[0] at the
// start, stamps[i] after sync i, stamps[count + 1] at block 0's end.
template <bool STAMPS>
struct GridSync {
  cg::grid_group grid;
  unsigned long long* stamps;
  int count;

  __device__ void stamp(int at) {
    if (STAMPS && stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      stamps[at] = t;
    }
  }
  __device__ void operator()() {
    grid.sync();
    ++count;
    stamp(count);
  }
  // block 0 adds the syncs passed to *syncs (unless null) and stamps its end
  __device__ void finish(int* syncs) {
    stamp(count + 1);
    if (syncs != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *syncs += count;
  }
};

// L and L^-1 of the SPD B x B matrix A (its lower triangle is read), over the
// whole cooperative grid; see the note at the top. A is read-only and L is
// the work array; the strictly lower tiles of L^-1 hold the running sums
// W[i, j] = sum_m L[i, m] L^-1[m, j] until row i is final. Tile (i, j) of a
// matrix M is M[64i:64i+64, 64j:64j+64]; lda, ldl and ldi are row strides.
// L and L^-1 get exact zeros above the diagonal. 2 nt - 1 syncs, none after
// the last phase: the caller syncs before it reads L or L^-1.
template <typename Sync>
__device__ void chol_inv_grid(const float* A, int lda, float* L, int ldl, float* Li, int ldi,
                              int B, Sync& sync, GemmSmem& gs, PanelSmem& ps) {
  const int nt = B / TS;
  const int G = gridDim.x, bid = blockIdx.x;
  // phase (a): blocks 1.. share out the products while block 0 takes the
  // diagonal tile; a grid of one block takes both
  const int nw = G > 1 ? G - 1 : 1, w = G > 1 ? bid - 1 : 0;
  auto tile = [](auto* M, int ld, int i, int j) { return M + ((int64_t)i * ld + j) * TS; };

  for (int k = 0; k < nt; ++k) {
    // (a) tile (k, k), updated by step k-1 and factored, in block 0 ...
    if (bid == 0) {
      float* d = tile(L, ldl, k, k);
      if (k > 0) {
        const float* p = tile(L, ldl, k, k - 1);
        gemm_tile<true>(d, ldl, d, ldl, p, ldl, p, ldl, TS, -1.f, gs);
        __syncthreads();
      }
      chol_inv_tile(k == 0 ? A : d, k == 0 ? lda : ldl, d, ldl, tile(Li, ldi, k, k), ldi, ps);
    }
    if (k == 0) {
      // ... beside the set-up: A's lower tiles but (0, 0) into L, zeros
      // above the diagonal tiles of L and L^-1 and in the sums W
      for (int64_t idx = (int64_t)bid * NT + threadIdx.x; idx < (int64_t)B * B;
           idx += (int64_t)G * NT) {
        const int r = (int)(idx / B), c = (int)(idx % B);
        const int rt = r / TS, ct = c / TS;
        if (ct != rt) Li[(int64_t)r * ldi + c] = 0.f;
        if (ct > rt) L[(int64_t)r * ldl + c] = 0.f;
        else if (rt > 0) L[(int64_t)r * ldl + c] = A[(int64_t)r * lda + c];
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
          float* o = tile(L, ldl, k + ip, k + jp);
          gemm_tile<true>(o, ldl, o, ldl, tile(L, ldl, k + ip, k - 1), ldl,
                          tile(L, ldl, k + jp, k - 1), ldl, TS, -1.f, gs);
        } else {
          const int i = k + (t - n_trail) / k, j = (t - n_trail) % k;
          float* o = tile(Li, ldi, i, j);
          gemm_tile<false>(o, ldi, o, ldi, tile(L, ldl, i, k - 1), ldl, tile(Li, ldi, k - 1, j),
                           ldi, TS, 1.f, gs);
        }
      }
    }
    sync();

    // (b) nt - 1 tiles, one product each: row k of L^-1, L^-1[k, j] =
    // -D_k W[k, j] for j < k (W[k, j] is whole: its last term came in (a)),
    // then the panel, L[r, k] <- L[r, k] D_k^T for r > k (both in place)
    const float* D = tile(Li, ldi, k, k);
    for (int t = bid; t < nt - 1; t += G) {
      if (t < k) {
        float* o = tile(Li, ldi, k, t);
        gemm_tile<false>(o, ldi, nullptr, 0, D, ldi, o, ldi, TS, -1.f, gs);
      } else {
        float* o = tile(L, ldl, t + 1, k);
        gemm_tile<true>(o, ldl, nullptr, 0, o, ldl, D, ldi, TS, 1.f, gs);
      }
    }
    if (k + 1 < nt) sync();
  }
}

// L and L^-1 of the SPD B x B matrix A over the cooperative grid (all B x B,
// row stride B). Unless `syncs` is null, block 0 adds the grid syncs it
// passed to *syncs.
__global__ void __launch_bounds__(NT, 2)
panel_kernel(const float* A, float* L, float* Li, int B, int* syncs) {
  __shared__ GemmSmem gs;
  __shared__ PanelSmem ps;
  GridSync<false> sync{cg::this_grid(), nullptr, 0};
  chol_inv_grid(A, B, L, B, Li, B, B, sync, gs, ps);
  sync.finish(syncs);
}

// ---------------------------------------------------------------------------
// the deep tile product
// ---------------------------------------------------------------------------

constexpr int DT = 128;      // output tile edge
constexpr int DK = 16;       // depth of a staged slice
constexpr int DKP = DK + 4;  // padded slice row: 80 B, float4 reads conflict-free
constexpr int STAGES = 4;    // slices in the ring

struct __align__(16) DeepStage {
  float a[DT][DKP];  // A's rows r0.. r0+127, depths k0.. k0+15, as in memory
  float b[DT][DKP];  // B's rows (the output's columns), the same depths
};
constexpr int DEEP_SMEM = STAGES * (int)sizeof(DeepStage);  // 81,920 B
static_assert(DEEP_SMEM >= (int)(sizeof(GemmSmem) + sizeof(PanelSmem)), "shared buffer too small");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[i][j] += sum over depths k in [DK s0, DK s1) of A[ty + 16i][k] Bm[tx + 16j][k]
// (tx, ty = thread % 16, thread / 16): one DT x DT tile of A Bm^T, both
// operands DT rows with the depth contiguous. Pointers and strides keep
// every 16-byte copy aligned (multiples of 4 floats).
__device__ void deep_tile(float (&acc)[8][8], const float* A, int lda, const float* Bm, int ldb,
                          int s0, int s1, DeepStage* ring) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 4, lk = (tid % 4) * 4;  // rows lr, lr + 64; depths lk.. lk+3
  auto load = [&](int s, int st) {
    const int k = s * DK + lk;
    DeepStage& S = ring[st];
    cp_async16(&S.a[lr][lk], A + (int64_t)lr * lda + k);
    cp_async16(&S.a[lr + 64][lk], A + (int64_t)(lr + 64) * lda + k);
    cp_async16(&S.b[lr][lk], Bm + (int64_t)lr * ldb + k);
    cp_async16(&S.b[lr + 64][lk], Bm + (int64_t)(lr + 64) * ldb + k);
  };
  const int ns = s1 - s0;
#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < ns) load(s0 + p, p);
    cp_async_commit();
  }
  for (int s = 0; s < ns; ++s) {
    cp_async_wait<STAGES - 2>();  // slice s has landed ...
    __syncthreads();              // ... for every thread, and slice s-1 is spent
    const int nx = s + STAGES - 1;
    if (nx < ns) load(s0 + nx, nx % STAGES);
    cp_async_commit();
    const DeepStage& S = ring[s % STAGES];
#pragma unroll
    for (int kk = 0; kk < DK; kk += 4) {
      float4 b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(&S.b[tx + 16 * j][kk]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(&S.a[ty + 16 * i][kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next call
}

// out = cin + sign * A Bm^T over rows x cols (multiples of DT), depth K (a
// multiple of DK); cin may be null (zero). Row strides ldo, ldcin, lda, ldb.
struct Product {
  float* out;
  int ldo;
  const float* cin;
  int ldcin;
  const float* A;
  int lda;
  const float* Bm;
  int ldb;
  int rows, cols, K;
  float sign;
};

// Stream-K: the T nk (tile, slice) iterations, tile-major, cut into G
// ranges [I b / G, I (b + 1) / G). The block whose range holds iteration x:
// the largest b with I b / G <= x.
__device__ __forceinline__ int64_t sk_start(int64_t I, int b, int G) { return I * b / G; }
__device__ __forceinline__ int sk_block_of(int64_t x, int64_t I, int G) {
  return (int)(((x + 1) * G + I - 1) / I) - 1;
}

// Phase 1 of a product: each block runs its range. A tile whose iterations
// all fall in the range is written to `out`; a piece of a tile goes to the
// scratch slot 2b (the range's head) or 2b + 1 (its tail), DT x DT each.
__device__ void product_partials(const Product& p, float* part, DeepStage* ring) {
  const int ct = p.cols / DT, nk = p.K / DK;
  const int64_t I = (int64_t)(p.rows / DT) * ct * nk;
  const int G = gridDim.x, b = blockIdx.x;
  const int64_t s = sk_start(I, b, G), e = sk_start(I, b + 1, G);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int64_t it = s; it < e;) {
    const int t = (int)(it / nk);
    const int64_t t0 = (int64_t)t * nk, t_end = t0 + nk;
    const int64_t stop = e < t_end ? e : t_end;
    const int k0 = (int)(it - t0), k1 = (int)(stop - t0);
    const int r0 = (t / ct) * DT, c0 = (t % ct) * DT;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    deep_tile(acc, p.A + (int64_t)r0 * p.lda, p.lda, p.Bm + (int64_t)c0 * p.ldb, p.ldb, k0, k1,
              ring);
    if (k0 == 0 && k1 == nk) {
      float* o = p.out + (int64_t)r0 * p.ldo + c0;
      const float* ci = p.cin == nullptr ? nullptr : p.cin + (int64_t)r0 * p.ldcin + c0;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          float v = p.sign * acc[i][j];
          if (ci != nullptr) v += ci[(int64_t)r * p.ldcin + c];
          o[(int64_t)r * p.ldo + c] = v;
        }
    } else {
      float* q = part + (int64_t)(2 * b + (it == s ? 0 : 1)) * DT * DT;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) q[(ty + 16 * i) * DT + tx + 16 * j] = acc[i][j];
    }
    it = stop;
  }
}

// Phase 2, after a grid sync: every tile not written whole in phase 1 gets
// cin + sign * (its pieces summed in block order), half a tile a block at a
// time (the pieces' slots found once a half, 8 float4s a thread). At K = 0
// that is cin (or zero).
__device__ void product_reduce(const Product& p, const float* part) {
  constexpr int H = 2, HR = DT / H;    // halves of a tile, rows a half
  constexpr int Q = HR * DT / 4 / NT;  // float4s a thread a half
  const int ct = p.cols / DT, nk = p.K / DK, T = (p.rows / DT) * ct;
  const int64_t I = (int64_t)T * nk;
  const int G = gridDim.x;
  for (int u = blockIdx.x; u < T * H; u += G) {
    const int t = u / H, h = u % H;
    const int64_t t0 = (int64_t)t * nk;
    int bf = 0, bl = -1;  // the blocks whose pieces make the tile; none at K = 0
    if (nk > 0) {
      bf = sk_block_of(t0, I, G);
      bl = sk_block_of(t0 + nk - 1, I, G);
      if (bf == bl) continue;  // one block wrote the whole tile
    }
    float4 v[Q];
#pragma unroll
    for (int m = 0; m < Q; ++m) v[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    int64_t sb = bf > bl ? 0 : sk_start(I, bf, G);
    for (int b = bf; b <= bl; ++b) {
      const int64_t se = sk_start(I, b + 1, G);
      if (se > sb) {  // not an empty range
        const float* q = part + (int64_t)(2 * b + (sb >= t0 ? 0 : 1)) * DT * DT + h * HR * DT;
#pragma unroll
        for (int m = 0; m < Q; ++m) {
          const int e = threadIdx.x + m * NT;
          const float4 w = *reinterpret_cast<const float4*>(q + (e / (DT / 4)) * DT + (e % (DT / 4)) * 4);
          v[m].x += w.x;
          v[m].y += w.y;
          v[m].z += w.z;
          v[m].w += w.w;
        }
      }
      sb = se;
    }
    const int64_t row0 = (t / ct) * DT + h * HR, col0 = (t % ct) * DT;
#pragma unroll
    for (int m = 0; m < Q; ++m) {
      const int e = threadIdx.x + m * NT;
      const int64_t row = row0 + e / (DT / 4), col = col0 + (e % (DT / 4)) * 4;
      float4 o = make_float4(p.sign * v[m].x, p.sign * v[m].y, p.sign * v[m].z, p.sign * v[m].w);
      if (p.cin != nullptr) {
        const float4 ci = *reinterpret_cast<const float4*>(p.cin + row * p.ldcin + col);
        o.x += ci.x;
        o.y += ci.y;
        o.z += ci.z;
        o.w += ci.w;
      }
      *reinterpret_cast<float4*>(p.out + row * p.ldo + col) = o;
    }
  }
}

// ---------------------------------------------------------------------------
// the whole factorization in one launch
// ---------------------------------------------------------------------------

// out holds a copy of K on entry and L on exit. acc (n, B) is the current
// panel column (by absolute row), linv (B, B) the inverse of its diagonal
// block, part (2 grid, DT, DT) the products' pieces. For each panel column c:
//   1. the correction acc[c:] = out[c:, c:c+B] - out[c:, :c] out[c:c+B, :c]^T,
//      a deep product over the grid (pieces, sync, sum, sync);
//   2. the diagonal block's L into out[c:c+B, c:c+B] and its inverse into
//      linv by `chol_inv_grid` (2 nt - 1 syncs), then a sync;
//   3. the apply out[c+B:, c:c+B] = acc[c+B:] linv^T, a deep product (pieces,
//      sync, sum), beside zeros into out[:c, c:c+B]; a sync but after the
//      last panel.
// 2 nt + 4 syncs a panel (nt = B / 64), one fewer in all. Unless null,
// `syncs` gains the syncs passed and `stamps` (syncs + 2 entries) the
// block-0 time stamps of GridSync.
__global__ void __launch_bounds__(NT, 1)
single_launch_kernel(float* out, float* acc, float* linv, float* part, int n, int B, int* syncs,
                     unsigned long long* stamps) {
  // the deep products' ring and the diagonal block's buffers take turns in
  // one dynamic shared buffer: a grid sync stands between their phases
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  DeepStage* ring = reinterpret_cast<DeepStage*>(dyn_smem);
  GemmSmem& gs = *reinterpret_cast<GemmSmem*>(dyn_smem);
  PanelSmem& ps = *reinterpret_cast<PanelSmem*>(dyn_smem + sizeof(GemmSmem));
  GridSync<true> sync{cg::this_grid(), stamps, 0};
  sync.stamp(0);
  for (int c = 0; c < n; c += B) {
    const int64_t cn = (int64_t)c * n;
    const Product corr{acc + (int64_t)c * B, B, out + cn + c, n, out + cn, n, out + cn, n,
                       n - c, B, c, -1.f};
    product_partials(corr, part, ring);
    sync();
    product_reduce(corr, part);
    sync();

    chol_inv_grid(acc + (int64_t)c * B, B, out + cn + c, n, linv, B, B, sync, gs, ps);
    sync();

    const Product apply{out + cn + (int64_t)B * n + c, n, nullptr, 0, acc + (int64_t)(c + B) * B,
                        B, linv, B, n - c - B, B, B, 1.f};
    product_partials(apply, part, ring);
    sync();
    product_reduce(apply, part);
    const int b4 = B / 4;  // zeros above the diagonal block, a float4 at a time
    for (int idx = blockIdx.x * NT + threadIdx.x; idx < c * b4; idx += gridDim.x * NT)
      *reinterpret_cast<float4*>(out + (int64_t)(idx / b4) * n + c + (idx % b4) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    if (c + B < n) sync();
  }
  sync.finish(syncs);
}

__global__ void probe_kernel(const float* A, int lda, float* o, int n_iter) {
  float acc = 0.f;
  for (int j = 0; j < n_iter; ++j) asm volatile("add.f32 %0, %0, 0f3F800000;" : "+f"(acc));
  const int c = threadIdx.x;
#pragma unroll
  for (int r = 0; r < 8; ++r) o[r * 128 + c] = A[(int64_t)r * lda + c] + acc;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB it
// must ask); the occupancy query and every launch use the same byte count.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The most blocks of `kernel` (with `smem` bytes of dynamic shared memory)
// that fit on the current device at once: the largest grid a cooperative
// launch of it accepts.
template <typename Kernel>
int max_coresident_blocks(Kernel kernel, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  *blocks = per_sm * sms;
  return (int)e;
}

template <typename Kernel>
int launch_cooperative(Kernel kernel, int grid, int smem, void** args, void* stream) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(NT), args, smem,
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
  return max_coresident_blocks(panel_kernel, 0, blocks);
}

// A (B, B) -> L, Li (B, B); B % 64 == 0; 1 <= grid <= panel_max_blocks.
// syncs: null, or one int on the device that gains the launch's grid syncs.
extern "C" int chol_inv_panel_f32(const float* A, float* L, float* Li, int B, int grid,
                                  int* syncs, void* stream) {
  void* args[] = {&A, &L, &Li, &B, &syncs};
  return launch_cooperative(panel_kernel, grid, 0, args, stream);
}

extern "C" int single_launch_max_blocks(int* blocks) {
  return max_coresident_blocks(single_launch_kernel, DEEP_SMEM, blocks);
}

// out (n, n) holds K and receives L; acc (n, B), linv (B, B) and part
// (2 grid, 128, 128) are scratch; n % B == 0, B % 128 == 0;
// 1 <= grid <= single_launch_max_blocks. syncs: null, or one int on the
// device that gains the grid syncs; stamps: null, or syncs + 2 uint64 on
// the device for block 0's %globaltimer stamps.
extern "C" int single_launch_cholesky_f32(float* out, float* acc, float* linv, float* part, int n,
                                          int B, int grid, int* syncs,
                                          unsigned long long* stamps, void* stream) {
  void* args[] = {&out, &acc, &linv, &part, &n, &B, &syncs, &stamps};
  return launch_cooperative(single_launch_kernel, grid, DEEP_SMEM, args, stream);
}

// A (>= 8 rows, >= 128 columns, row stride lda) -> o (8, 128).
extern "C" int launch_probe_f32(const float* A, int lda, float* o, int n_iter, void* stream) {
  probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(A, lda, o, n_iter);
  return (int)cudaGetLastError();
}
