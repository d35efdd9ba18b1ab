// One HMC transition of block A of a GPA's split sampler, for every chain
// and all Lmax leapfrog steps, in one launch, for Hopper (sm_90a).
//
// Block A is the whitened latents v alone (the likelihood and the mean carry
// no parameters), against the chain's cached lower factor L of K + nugget I:
//
//   target(v) = sum_i log p(y_i | f_i) - (|v|^2 + n log 2 pi) / 2 + prior(b),
//   f = mu + L v,    gradient = L^T dlog p / df - v,
//
// with target -inf (and no force) where the chain's factorization failed.
// The launch runs `hmc_transition` (inference/hmc.py) on that target with
// the JAX package's semantics: the path of chain c runs steps[c] of the Lmax
// steps; a non-finite gradient gives zero force (the glide); a non-finite
// position freezes the chain and rejects it; the endpoint's true target
// decides the accept test; a NaN accept probability reads 0.
//
// What it replaces. No TPU kernel: the JAX package leaves the leapfrog's
// `lax.scan` over the vmapped autograd target to XLA. On the card the port
// replayed that transition as a CUDA graph of ~1,500 small kernels (~2.9 ms
// at C = 128, n = 200); this is one launch, and nothing goes to device
// memory between steps.
//
// What bounds it (C = 128, n = 200, f32). Reading every chain's factor once
// is 10.3 MB for the lower triangles (20.5 MB square): 3.1 (6.1) us at
// 3.35 TB/s; the two triangular products of a step are 2 n (n + 1) flops,
// 15 steps of 128 chains 0.15 GFLOP, 2.3 us at 67 TFLOP/s. Latency binds
// instead: each step is a row product, the likelihood, a block reduction and
// a column product, each waiting on the one before.
//
// Design:
// - One block a chain (a grid-stride loop over chains past the resident
//   grid; at one block an SM, 128 chains take 128 of the H100's 132 SMs).
//   256 threads; thread i owns element i of every vector, so n <= 256.
// - The chain's factor's lower triangle goes to dynamic shared memory once
//   a transition (cp.async: a thread's ~40 copies in flight at once), rows
//   at an odd stride s >= n: in the row product
//   (f_i = sum_j L_ij v_j) a warp's lanes read 32 rows at one column, in the
//   column product (L^T g)_j = sum_i L_ij g_i 32 columns of one row, both
//   free of bank conflicts. The upper triangle is neither read nor loaded.
// - The position, momentum and gradient stay in registers, the proposed
//   position and the likelihood's derivative in shared memory for the
//   products; a step's sums (log density, |v|^2) are one block reduction.
// - A chain stops at its own path length: the steps the graph masked out
//   are not computed.
// - The likelihood is a template policy (`Probit`), the elementwise log
//   density and its derivative; y is shared by every chain.
// - The mass is the identity, as split_hmc's block A has it.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr double LOG_2PI = 1.8378770664093454835606594728112;
constexpr double HALF_LOG_2PI = 0.91893853320467274178032973640562;
constexpr double SQRT_2_OVER_PI = 0.79788456080286535587989211986876;
constexpr double SQRT1_2 = 0.70710678118654752440084436210485;

__device__ __forceinline__ float erfcx_(float x) { return erfcxf(x); }
__device__ __forceinline__ double erfcx_(double x) { return erfcx(x); }
__device__ __forceinline__ float erfc_(float x) { return erfcf(x); }
__device__ __forceinline__ double erfc_(double x) { return erfc(x); }
__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }
__device__ __forceinline__ float log1p_(float x) { return log1pf(x); }
__device__ __forceinline__ double log1p_(double x) { return log1p(x); }
__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
template <typename T>
__device__ __forceinline__ bool finite_(T x) { return x - x == T(0); }
template <typename T>
__device__ __forceinline__ bool nan_(T x) { return x != x; }

// one element from device to shared memory without a register (cp.async):
// every copy a thread issues is in flight at once, until cp_async_wait
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"((int)sizeof(T)));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// log Phi(x) with torch.special.log_ndtr's branches, and phi(x) / Phi(x):
// below -1 through erfcx, sqrt(2 / pi) / erfcx(-x / sqrt 2), which keeps
// its accuracy where phi and Phi both underflow.
template <typename T>
__device__ __forceinline__ void log_ndtr_ratio(T x, T& lnd, T& ratio) {
  const T t = x * T(SQRT1_2);
  if (x < T(-1)) {
    const T e = erfcx_(-t);
    lnd = log_(e / T(2)) - t * t;
    ratio = T(SQRT_2_OVER_PI) / e;
  } else {
    lnd = log1p_(-erfc_(t) / T(2));
    ratio = exp_(T(-0.5) * x * x - T(HALF_LOG_2PI) - lnd);
  }
}

// The probit Bernoulli likelihood (`BernLik`): y log Phi(f) + (1 - y) log
// Phi(-f) and its derivative in f.
struct Probit {
  template <typename T>
  __device__ static void eval(T f, T y, T& ld, T& dld) {
    T l1, r1, l0, r0;
    log_ndtr_ratio(f, l1, r1);
    log_ndtr_ratio(-f, l0, r0);
    ld = y * l1 + (T(1) - y) * l0;
    dld = y * r1 - (T(1) - y) * r0;
  }
};

template <typename T>
struct Args {
  const T* L;                // (C, n, n) lower factors, row-major
  const unsigned char* ok;   // (C,) the factorization held
  const T* mu;               // (n,) the mean
  const T* y;                // (n,) observations
  const T* cst;              // (C,) the hyperprior at each chain's b
  const T* theta;            // (C, n) positions
  const T* tgt;              // (C,) their targets
  const T* grad;             // (C, n) their gradients
  const T* nu0;              // (C, n) momenta
  const long long* steps;    // (C,) path lengths
  const T* log_u;            // (C,) log uniforms of the accept tests
  const T* eps;              // (C,) step sizes
  int C, n, Lmax;
  T* theta_out;
  T* tgt_out;
  T* grad_out;
  T* aprob;
  unsigned char* accepted;
};

__host__ __device__ inline int row_stride(int n) { return n | 1; }

// as `smem_bytes` in ops/leapfrog.py
template <typename T>
size_t smem_bytes(int n) {
  return sizeof(T) * ((size_t)n * row_stride(n) + 2 * (size_t)n + 2 * WARPS);
}

// (a, b) <- their sums over the block, the same in every thread; red holds
// 2 WARPS values. A barrier must separate two calls on the same red.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T* red) {
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[warp] = a;
    red[WARPS + warp] = b;
  }
  __syncthreads();
  a = T(0);
  b = T(0);
  for (int w = 0; w < WARPS; ++w) {
    a += red[w];
    b += red[WARPS + w];
  }
}

template <typename T, class Lik>
__global__ void __launch_bounds__(THREADS, 1) leapfrog_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = a.n, s = row_stride(n);
  T* Ls = reinterpret_cast<T*>(smem_raw);  // the factor's lower triangle, rows at stride s
  T* thn = Ls + (size_t)n * s;             // the proposed position
  T* gl = thn + n;                         // the likelihood's derivative at f
  T* red = gl + n;                         // block reductions
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5;
  const bool own = i < n;
  const T inf = T(INFINITY);
  for (int c = blockIdx.x; c < a.C; c += gridDim.x) {
    const bool ok = a.ok[c] != 0;
    if (ok) {  // visible to the block after the first barrier below
      const T* Lc = a.L + (size_t)c * n * n;
      for (int r = warp; r < n; r += WARPS)
        for (int j = lane; j <= r; j += 32) cp_async(Ls + r * s + j, Lc + (size_t)r * n + j);
      cp_async_wait();
    }
    const size_t e = (size_t)c * n + i;
    const T eps = a.eps[c];
    const T mu = own ? a.mu[i] : T(0), y = own ? a.y[i] : T(0);
    const T th0 = own ? a.theta[e] : T(0), g0 = own ? a.grad[e] : T(0);
    const T nu0 = own ? a.nu0[e] : T(0), tgt0 = a.tgt[c];
    const long long steps = a.steps[c];
    const T cst = a.cst[c];
    T nu = nu0 + T(0.5) * eps * g0, th = th0, g = g0, t = tgt0;
    // bad = isnan(sum(theta)): a NaN, or both infinities
    const bool has_nan = __syncthreads_or(own && nan_(th0));
    const bool has_pinf = __syncthreads_or(own && th0 == inf);
    const bool has_ninf = __syncthreads_or(own && th0 == -inf);
    bool bad = has_nan || (has_pinf && has_ninf);
    for (int step = 0; step < a.Lmax && step < steps && !bad; ++step) {
      const T thn_i = th + eps * nu;
      if (own) thn[i] = thn_i;
      if (__syncthreads_or(own && !finite_(thn_i))) {
        bad = true;  // an overflowed position freezes the chain
        break;
      }
      T t_n = -inf, geff = T(0);
      if (ok) {
        T ld = T(0), dld = T(0), v2 = own ? thn_i * thn_i : T(0);
        if (own) {  // f_i = mu_i + sum_{j <= i} L_ij v_j
          const T* row = Ls + (size_t)i * s;
          T p0 = T(0), p1 = T(0), p2 = T(0), p3 = T(0);
          int j = 0;
          for (; j + 3 <= i; j += 4) {
            p0 += row[j] * thn[j];
            p1 += row[j + 1] * thn[j + 1];
            p2 += row[j + 2] * thn[j + 2];
            p3 += row[j + 3] * thn[j + 3];
          }
          for (; j <= i; ++j) p0 += row[j] * thn[j];
          Lik::eval(((p0 + p1) + (p2 + p3)) + mu, y, ld, dld);
          gl[i] = dld;
        }
        block_sum2(ld, v2, red);
        t_n = ld - T(0.5) * (v2 + T(n * LOG_2PI)) + cst;
        if (own) {  // (L^T dld)_i = sum_{r >= i} L_ri dld_r: the lanes of a warp walk one row
          const int r0 = i & ~31, r1 = min(r0 + 32, n);
          T q0 = T(0), q1 = T(0), q2 = T(0), q3 = T(0);
          for (int r = r0; r < r1; ++r)
            if (r >= i) q0 += Ls[r * s + i] * gl[r];
          int r = r1;
          for (; r + 3 < n; r += 4) {
            q0 += Ls[r * s + i] * gl[r];
            q1 += Ls[(r + 1) * s + i] * gl[r + 1];
            q2 += Ls[(r + 2) * s + i] * gl[r + 2];
            q3 += Ls[(r + 3) * s + i] * gl[r + 3];
          }
          for (; r < n; ++r) q0 += Ls[r * s + i] * gl[r];
          const T g_n = ((q0 + q1) + (q2 + q3)) - thn_i;
          geff = finite_(g_n) ? g_n : T(0);  // the glide: no force where the gradient is not finite
        }
      }
      th = thn_i;
      g = geff;
      t = t_n;
      nu = nu + eps * geff;
    }
    nu = nu - T(0.5) * eps * g;
    T kin = own ? nu * nu : T(0), kin0 = own ? nu0 * nu0 : T(0);
    __syncthreads();  // the last step's reads of red
    block_sum2(kin, kin0, red);
    const T log_alpha = t - T(0.5) * kin - tgt0 + T(0.5) * kin0;
    const bool ok_end = finite_(t) && !bad;
    T ap = ok_end ? exp_(log_alpha > T(0) ? T(0) : log_alpha) : T(0);
    if (nan_(ap)) ap = T(0);
    const bool acc = (a.log_u[c] < log_alpha) && ok_end;
    if (own) {
      a.theta_out[e] = acc ? th : th0;
      a.grad_out[e] = acc ? g : g0;
    }
    if (i == 0) {
      a.tgt_out[c] = acc ? t : tgt0;
      a.aprob[c] = ap;
      a.accepted[c] = acc ? 1 : 0;
    }
    __syncthreads();  // the next chain's factor overwrites Ls
  }
}

template <typename T, class Lik>
int launch(const Args<T>& a, cudaStream_t stream) {
  if (a.n < 1 || a.n > THREADS || a.C < 1 || a.Lmax < 0) return (int)cudaErrorInvalidValue;
  auto kernel = leapfrog_kernel<T, Lik>;
  const size_t smem = smem_bytes<T>(a.n);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = a.C < per_sm * sms ? a.C : per_sm * sms;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int leapfrog_probit(const T* L, const unsigned char* ok, const T* mu, const T* y, const T* cst,
                    const T* theta, const T* tgt, const T* grad, const T* nu0,
                    const long long* steps, const T* log_u, const T* eps, int C, int n,
                    int Lmax, T* theta_out, T* tgt_out, T* grad_out, T* aprob,
                    unsigned char* accepted, void* stream) {
  const Args<T> a{L, ok, mu, y, cst, theta, tgt, grad, nu0, steps, log_u, eps,
                  C, n, Lmax, theta_out, tgt_out, grad_out, aprob, accepted};
  return launch<T, Probit>(a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// One transition of block A of every chain (probit likelihood, identity
// mass). Every operand is contiguous. Returns the launch's cudaError_t.
extern "C" int leapfrog_probit_f32(const float* L, const unsigned char* ok, const float* mu,
                                   const float* y, const float* cst, const float* theta,
                                   const float* tgt, const float* grad, const float* nu0,
                                   const long long* steps, const float* log_u, const float* eps,
                                   int C, int n, int Lmax, float* theta_out, float* tgt_out,
                                   float* grad_out, float* aprob, unsigned char* accepted,
                                   void* stream) {
  return leapfrog_probit<float>(L, ok, mu, y, cst, theta, tgt, grad, nu0, steps, log_u, eps, C,
                                n, Lmax, theta_out, tgt_out, grad_out, aprob, accepted, stream);
}

extern "C" int leapfrog_probit_f64(const double* L, const unsigned char* ok, const double* mu,
                                   const double* y, const double* cst, const double* theta,
                                   const double* tgt, const double* grad, const double* nu0,
                                   const long long* steps, const double* log_u,
                                   const double* eps, int C, int n, int Lmax, double* theta_out,
                                   double* tgt_out, double* grad_out, double* aprob,
                                   unsigned char* accepted, void* stream) {
  return leapfrog_probit<double>(L, ok, mu, y, cst, theta, tgt, grad, nu0, steps, log_u, eps, C,
                                 n, Lmax, theta_out, tgt_out, grad_out, aprob, accepted, stream);
}
