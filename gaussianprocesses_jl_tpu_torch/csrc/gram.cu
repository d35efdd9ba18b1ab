// Stationary gram K(X1, X2)[i, j] = profile(|x1_i - x2_j|^2) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gram_kernel` in gaussianprocesses_jl_tpu/ops/pallas_gram.py
// (launched by `_pallas_forward`). The TPU kernel ran the module's own Python
// `_r2profile` on a 256x256 tile; here there is one compiled branch per
// profile family (SE, Matern 1/2, 3/2, 5/2, RQ, Periodic), chosen by an integer
// argument. ARD kernels pre-scale their inputs by exp(-ll) before the call and
// use the iso profile at unit length scale. The hyperparameters arrive as a
// small device vector p = [lsigma, ll, extra] (extra = lalpha for RQ, lp for
// Periodic), so no host read is needed per gram.
//
// What bounds it: at d = 10 each output costs ~3d flops of distance plus one
// profile, and the n1 x n2 output is written once. Writing the output is the
// bound: n^2 * 4 bytes at 3.35 TB/s is ~11 us at n = 3000 and ~320 us at
// n = 16384 (f32); the 67 TFLOP/s non-tensor f32 rate needs ~5 us for the
// flops at n = 3000.
//
// Design (simple and correct first): a block of 32 x 8 threads computes one
// 64 x 64 output tile, 8 x 2 outputs per thread. Row tiles of X1 and X2 are
// staged in shared memory in chunks of 16 features, transposed so that a warp
// reads consecutive addresses. The squared distance is accumulated directly as
// sum_k (x1_k - x2_k)^2 in registers: unlike the expansion
// s1 + s2 - 2 x1.x2 (which the TPU kernel fed to its matrix unit) it has no
// cancellation and needs no clamp, and at d = 10 the matrix unit would not
// help a kernel that is bound by its output write. Ragged edges are masked (no
// padding of the inputs), the symmetric diagonal is pinned to exactly 0, and a
// warp writes 32 consecutive outputs of a row. wgmma, TMA and writing only
// the lower triangle are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;        // output tile rows
constexpr int TN = 64;        // output tile columns
constexpr int BX = 32;        // threads along columns
constexpr int BY = 8;         // threads along rows
constexpr int RM = TM / BY;   // rows per thread
constexpr int RN = TN / BX;   // columns per thread
constexpr int DK = 16;        // features per shared-memory chunk

enum Family { SE = 0, MAT12 = 1, MAT32 = 2, MAT52 = 3, RQ = 4, PERIODIC = 5 };

__device__ __forceinline__ float d_exp(float x) { return expf(x); }
__device__ __forceinline__ double d_exp(double x) { return exp(x); }
__device__ __forceinline__ float d_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double d_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float d_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double d_log1p(double x) { return log1p(x); }
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

// The profiles, written as ops/kernels.py writes them (and as the plain
// version `profile` in ops/gram.py does).
template <typename T, int F>
__device__ __forceinline__ T profile(T r2, const Hyper<T>& h) {
  if constexpr (F == SE) {
    return d_exp(h.two_lsig - T(0.5) * r2 * h.il2);
  } else if constexpr (F == RQ) {
    const T z = r2 * h.il2 / (T(2) * h.alpha);
    return d_exp(h.two_lsig - h.alpha * d_log1p(z));
  } else {
    const T r = r2 > T(0) ? d_sqrt(r2) : T(0);
    if constexpr (F == MAT12) {
      return d_exp(h.two_lsig - r * h.il);
    } else if constexpr (F == MAT32) {
      const T s = T(1.7320508075688772) * r * h.il;
      return h.sig2 * (T(1) + s) * d_exp(-s);
    } else if constexpr (F == MAT52) {
      const T s = T(2.23606797749979) * r * h.il;
      return h.sig2 * (T(1) + s + s * s / T(3)) * d_exp(-s);
    } else {  // PERIODIC
      const T s = d_sin(T(3.141592653589793) * r * h.iper);
      return d_exp(h.two_lsig - T(2) * s * s * h.il2);
    }
  }
}

template <typename T, int F>
__global__ void __launch_bounds__(BX * BY)
gram_kernel(const T* __restrict__ X1, const T* __restrict__ X2,
            const T* __restrict__ p, T* __restrict__ out,
            int n1, int n2, int d, int sym) {
  __shared__ T s1[DK][TM + 1];
  __shared__ T s2[DK][TN + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + tx;
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  T acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < d; k0 += DK) {
    // stage X1[row0:row0+TM, k0:k0+DK] and X2[col0:col0+TN, k0:k0+DK],
    // transposed, with zeros past the ragged edges (a zero feature adds 0)
    for (int idx = tid; idx < TM * DK; idx += BX * BY) {
      const int r = idx / DK, k = idx % DK;
      const int gr = row0 + r, gk = k0 + k;
      s1[k][r] = (gr < n1 && gk < d) ? X1[(int64_t)gr * d + gk] : T(0);
    }
    for (int idx = tid; idx < TN * DK; idx += BX * BY) {
      const int c = idx / DK, k = idx % DK;
      const int gc = col0 + c, gk = k0 + k;
      s2[k][c] = (gc < n2 && gk < d) ? X2[(int64_t)gc * d + gk] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < DK; ++k) {
      T a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = s1[k][ty + i * BY];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = s2[k][tx + j * BX];
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

  const Hyper<T> h = load_hyper(p);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gr = row0 + ty + i * BY;
    if (gr >= n1) continue;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int gc = col0 + tx + j * BX;
      if (gc >= n2) continue;
      const T r2 = (sym && gr == gc) ? T(0) : acc[i][j];
      out[(int64_t)gr * n2 + gc] = profile<T, F>(r2, h);
    }
  }
}

template <typename T>
int launch(const T* X1, const T* X2, const T* p, T* out, int n1, int n2,
           int d, int family, int sym, cudaStream_t stream) {
  const dim3 block(BX, BY);
  const dim3 grid((n2 + TN - 1) / TN, (n1 + TM - 1) / TM);
  switch (family) {
    case SE:
      gram_kernel<T, SE><<<grid, block, 0, stream>>>(X1, X2, p, out, n1, n2, d, sym);
      break;
    case MAT12:
      gram_kernel<T, MAT12><<<grid, block, 0, stream>>>(X1, X2, p, out, n1, n2, d, sym);
      break;
    case MAT32:
      gram_kernel<T, MAT32><<<grid, block, 0, stream>>>(X1, X2, p, out, n1, n2, d, sym);
      break;
    case MAT52:
      gram_kernel<T, MAT52><<<grid, block, 0, stream>>>(X1, X2, p, out, n1, n2, d, sym);
      break;
    case RQ:
      gram_kernel<T, RQ><<<grid, block, 0, stream>>>(X1, X2, p, out, n1, n2, d, sym);
      break;
    case PERIODIC:
      gram_kernel<T, PERIODIC><<<grid, block, 0, stream>>>(X1, X2, p, out, n1, n2, d, sym);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface, bound with ctypes by ops/gram.py. X1 (n1, d), X2 (n2, d) and
// out (n1, n2) are contiguous row-major; p holds 3 values; stream is the
// caller's CUDA stream. Returns the launch's cudaError_t (0 on success).
extern "C" int gram_f32(const float* X1, const float* X2, const float* p,
                        float* out, int n1, int n2, int d, int family,
                        int sym, void* stream) {
  return launch<float>(X1, X2, p, out, n1, n2, d, family, sym,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int gram_f64(const double* X1, const double* X2, const double* p,
                        double* out, int n1, int n2, int d, int family,
                        int sym, void* stream) {
  return launch<double>(X1, X2, p, out, n1, n2, d, family, sym,
                        static_cast<cudaStream_t>(stream));
}
