// K16 burgers1d_newton: backward-Euler steps of the periodic 1D viscous
// Burgers equation  u_t + u u_x = nu u_xx, each solved by Newton's method
// with a dense LU solve per iteration, one lane per block, J lanes of L
// chained steps per launch:
//   out[j, k] = [g[j, k] +] Phi_{dt[k, j]}(out[j, k-1]),  out[j, -1] = seed[j].
// Phi(u0) is the Newton limit of
//   g(u) = (u - u0) + dt (u (D1 u) - nu (D2 u)),
//   J(u) = I + dt (diag(D1 u) + u D1 - nu D2),  u <- u - J(u)^-1 g(u),
// from u = u0, while max|g(u)| >= tol and fewer than maxiter iterations
// (a NaN in g stops the lane: the max keeps NaN, and NaN >= tol is false,
// as jnp.linalg.norm(g, inf) >= tol).  D1, D2 are the periodic central
// first and second differences (c1 = 1/(2 dx), c2 = 1/dx^2, d2 = -2/dx^2);
// g is formed from the stencils, J assembled from u in shared memory.  The
// iterations of every lane and step go to iters[k, j].
//
// Replaces: pymgrit_tpu/models/burgers.py Burgers1D.step (a vmap-ed
// lax.while_loop whose body assembles the dense Jacobian and calls
// jnp.linalg.solve, LAPACK's LU with partial pivoting).
//
// Bound: FP64 operations of the LU, 2/3 n^3 per Newton iteration (1.4 MFLOP
// at n = 128) against 2 n values read and written per step; the
// elimination's n dependent stages each end in a barrier.  Design: the
// whole Newton loop of a step stays in the block, so the per-lane stop test
// needs no host read and a chain of steps is one launch.  J lives in shared
// memory with an odd leading dimension (n + 1: a column walk hits distinct
// banks), 132 KB at n = 128 in f64; the right-hand side is eliminated with
// the matrix (no L is kept), the pivot is LAPACK's (the first entry of
// largest magnitude, found by warp 0), the multipliers are scaled by the
// pivot's reciprocal as dgetf2 does, and the back substitution walks the
// columns.  The wrapper raises for a side whose J does not fit.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T>
struct Smem {
  T* A;      // n x (n + 1), row-major
  T* u;      // current iterate
  T* u0;     // the step's start
  T* r;      // residual, then the Newton update
  T* l;      // multipliers of one elimination stage
  T* red;    // kWarps partial maxima
  int* piv;  // the pivot row of the current stage
};

template <typename T>
__device__ __forceinline__ T sfmin();
template <>
__device__ __forceinline__ double sfmin<double>() { return DBL_MIN; }
template <>
__device__ __forceinline__ float sfmin<float>() { return FLT_MIN; }

// r = g(u) and the block's max |g| (NaN if any entry is NaN).
template <typename T>
__device__ T residual(const Smem<T>& s, int n, T dt, T nu, T c1, T c2, T d2) {
  T m = T(0);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int im = i == 0 ? n - 1 : i - 1;
    const int ip = i == n - 1 ? 0 : i + 1;
    const T ui = s.u[i];
    const T d1u = c1 * s.u[ip] - c1 * s.u[im];
    const T d2u = (c2 * s.u[im] + d2 * ui) + c2 * s.u[ip];
    const T gi = (ui - s.u0[i]) + dt * (ui * d1u - nu * d2u);
    s.r[i] = gi;
    m = nan_max(m, fabs(gi));
  }
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) s.red[threadIdx.x >> 5] = m;
  __syncthreads();
  T total = s.red[0];
  for (int w = 1; w < kWarps; ++w) total = nan_max(total, s.red[w]);
  __syncthreads();
  return total;
}

// A = J(u) = I + dt (diag(D1 u) + u D1 - nu D2), as the sum the JAX package
// forms entry by entry (zeros off the three periodic diagonals).
template <typename T>
__device__ void assemble(const Smem<T>& s, int n, T dt, T nu, T c1, T c2, T d2) {
  const int ld = n + 1;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    const int im = i == 0 ? n - 1 : i - 1;
    const int ip = i == n - 1 ? 0 : i + 1;
    T v;
    if (j == i) {
      const T d1u = c1 * s.u[ip] - c1 * s.u[im];
      v = T(1) + dt * (d1u - nu * d2);
    } else if (j == ip) {
      v = dt * (s.u[i] * c1 - nu * c2);
    } else if (j == im) {
      v = dt * (s.u[i] * -c1 - nu * c2);
    } else {
      v = T(0);
    }
    s.A[i * ld + j] = v;
  }
}

// Solve A x = r in place (x in r) by LU with partial pivoting.
template <typename T>
__device__ void lu_solve(const Smem<T>& s, int n) {
  const int ld = n + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < n; ++k) {
    if (warp == 0) {
      // LAPACK's idamax: the first row of largest |A[i, k]|, i >= k
      T best = T(-1);
      int bi = k;
      for (int i = k + lane; i < n; i += 32) {
        const T a = fabs(s.A[i * ld + k]);
        if (a > best) {
          best = a;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) {
          best = ob;
          bi = oi;
        }
      }
      if (lane == 0) *s.piv = bi;
    }
    __syncthreads();
    const int p = *s.piv;
    if (p != k) {
      for (int j = k + threadIdx.x; j < n; j += kThreads) {
        const T t = s.A[k * ld + j];
        s.A[k * ld + j] = s.A[p * ld + j];
        s.A[p * ld + j] = t;
      }
      if (threadIdx.x == 0) {
        const T t = s.r[k];
        s.r[k] = s.r[p];
        s.r[p] = t;
      }
      __syncthreads();
    }
    const T pivot = s.A[k * ld + k];
    const bool recip = fabs(pivot) >= sfmin<T>();
    const T rp = T(1) / pivot;
    for (int i = k + 1 + threadIdx.x; i < n; i += kThreads) {
      const T a = s.A[i * ld + k];
      s.l[i] = recip ? a * rp : a / pivot;
    }
    __syncthreads();
    const T rk = s.r[k];
    for (int i = k + 1 + warp; i < n; i += kWarps) {
      const T li = s.l[i];
      for (int j = k + 1 + lane; j < n; j += 32) s.A[i * ld + j] -= li * s.A[k * ld + j];
      if (lane == 0) s.r[i] -= li * rk;
    }
    __syncthreads();
  }
  // back substitution, column by column
  for (int k = n - 1; k >= 0; --k) {
    const T xk = s.r[k] / s.A[k * ld + k];
    __syncthreads();
    for (int i = threadIdx.x; i < k; i += kThreads) s.r[i] -= xk * s.A[i * ld + k];
    if (threadIdx.x == 0) s.r[k] = xk;
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    burgers1d_newton_kernel(const T* __restrict__ seed, int64_t s_sj, const T* __restrict__ dt,
                            T* __restrict__ out, int64_t o_sj, int64_t o_sk,
                            const T* __restrict__ g, int64_t g_sj, int64_t g_sk,
                            int* __restrict__ iters, T nu, T c1, T c2, T d2, T tol, int maxiter,
                            int64_t J, int64_t L, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> s;
  s.A = reinterpret_cast<T*>(smem_raw);
  s.u = s.A + n * (n + 1);
  s.u0 = s.u + n;
  s.r = s.u0 + n;
  s.l = s.r + n;
  s.red = s.l + n;
  s.piv = reinterpret_cast<int*>(s.red + kWarps);
  const int64_t j = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += kThreads) s.u[i] = seed[j * s_sj + i];
  __syncthreads();
  for (int64_t k = 0; k < L; ++k) {
    const T h = dt[k * J + j];
    for (int i = threadIdx.x; i < n; i += kThreads) s.u0[i] = s.u[i];
    __syncthreads();
    int it = 0;
    T gmax = residual(s, n, h, nu, c1, c2, d2);
    while (gmax >= tol && it < maxiter) {
      assemble(s, n, h, nu, c1, c2, d2);
      __syncthreads();
      lu_solve(s, n);
      for (int i = threadIdx.x; i < n; i += kThreads) s.u[i] = s.u[i] - s.r[i];
      __syncthreads();
      ++it;
      gmax = residual(s, n, h, nu, c1, c2, d2);
    }
    if (iters != nullptr && threadIdx.x == 0) iters[k * J + j] = it;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      T v = s.u[i];
      if (g != nullptr) v = g[j * g_sj + k * g_sk + i] + v;
      s.u[i] = v;
      out[j * o_sj + k * o_sk + i] = v;
    }
    __syncthreads();
  }
}

template <typename T>
size_t smem_bytes(int64_t n) {
  return sizeof(T) * (size_t)(n * (n + 1) + 4 * n + kWarps) + sizeof(int);
}

template <typename T>
int launch(const T* seed, int64_t s_sj, const T* dt, T* out, int64_t o_sj, int64_t o_sk,
           const T* g, int64_t g_sj, int64_t g_sk, int* iters, double nu, double c1, double c2,
           double d2, double tol, int64_t maxiter, int64_t J, int64_t L, int64_t n,
           void* stream) {
  if (J == 0 || L == 0) return 0;
  if (J < 0 || J > 0x7fffffff || L < 0 || n < 3 || maxiter < 0 || maxiter > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T>(n);
  cudaError_t e = cudaFuncSetAttribute(burgers1d_newton_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  burgers1d_newton_kernel<T><<<(unsigned)J, kThreads, smem, (cudaStream_t)stream>>>(
      seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, (T)nu, (T)c1, (T)c2, (T)d2, (T)tol,
      (int)maxiter, J, L, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_burgers1d_newton_f64(const double* seed, int64_t s_sj, const double* dt, double* out,
                            int64_t o_sj, int64_t o_sk, const double* g, int64_t g_sj,
                            int64_t g_sk, int* iters, double nu, double c1, double c2, double d2,
                            double tol, int64_t maxiter, int64_t J, int64_t L, int64_t n,
                            void* stream) {
  return launch<double>(seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, nu, c1, c2, d2,
                        tol, maxiter, J, L, n, stream);
}

int pm_burgers1d_newton_f32(const float* seed, int64_t s_sj, const float* dt, float* out,
                            int64_t o_sj, int64_t o_sk, const float* g, int64_t g_sj,
                            int64_t g_sk, int* iters, double nu, double c1, double c2, double d2,
                            double tol, int64_t maxiter, int64_t J, int64_t L, int64_t n,
                            void* stream) {
  return launch<float>(seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, iters, nu, c1, c2, d2, tol,
                       maxiter, J, L, n, stream);
}

}  // extern "C"
