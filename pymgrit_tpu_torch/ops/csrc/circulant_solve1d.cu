// K17 circulant_solve1d: backward-Euler steps of periodic first-order
// upwind advection, one lane per block, J lanes of L chained steps per
// launch:
//   out[j, k] = [g[j, k] +] Phi(out[j, k-1]),  out[j, -1] = seed[j],
// where Phi(b) solves  (1 + c) u_i - c u_{i-1} = b_i  (indices mod n) with
// c = dt[k, j] * fac (fac = speed / dx).  The matrix is circulant, so its
// inverse is the circular convolution  u_i = sum_m w_m b_{i-m}  with the
// closed-form first column
//   w_m = r^m / ((1 + c)(1 - r^n)),              r = c / (1 + c),  |r| <= 1,
//   w_m = q^(n-1-m) / (c (q^n - 1)),             q = (1 + c) / c,  |r| > 1,
// the second the first multiplied through by q^n (no power overflows: the
// base is at most 1 in magnitude either way).  It is finite wherever the
// Fourier route is (where no 1 + c (1 - e^(-2 pi i k/n)) vanishes).
//
// Replaces: pymgrit_tpu/models/advection_1d.py Advection1D.step (FFT,
// elementwise division by 1 + c (1 - e^(-2 pi i k/n)), inverse FFT, real
// part).
//
// Bound: at n = 128 the n^2 products per lane and step (33 kFLOP) against
// 2 n values read and written; both are small, so a launch is latency.
// Design: the lane's state and the column w live in shared memory; w is n
// calls of pow (one rounding each, no chained powers), each thread forms
// its outputs' sums over w in a fixed order, and a chain of steps stays in
// the block, so a whole F-relaxation sweep is one launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    circulant_solve1d_kernel(const T* __restrict__ seed, int64_t s_sj, const T* __restrict__ dt,
                             T* __restrict__ out, int64_t o_sj, int64_t o_sk,
                             const T* __restrict__ g, int64_t g_sj, int64_t g_sk, T fac,
                             int64_t J, int64_t L, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* b = reinterpret_cast<T*>(smem_raw);
  T* w = b + n;
  const int64_t j = blockIdx.x;
  for (int i = threadIdx.x; i < n; i += kThreads) b[i] = seed[j * s_sj + i];
  for (int64_t k = 0; k < L; ++k) {
    const T c = dt[k * J + j] * fac;
    const T c1 = T(1) + c;
    if (fabs(c) <= fabs(c1)) {
      const T r = c / c1;
      const T den = c1 * (T(1) - pow(r, T(n)));
      for (int m = threadIdx.x; m < n; m += kThreads) w[m] = pow(r, T(m)) / den;
    } else {
      const T q = c1 / c;
      const T den = c * (pow(q, T(n)) - T(1));
      for (int m = threadIdx.x; m < n; m += kThreads) w[m] = pow(q, T(n - 1 - m)) / den;
    }
    __syncthreads();
    T u[(1024 + kThreads - 1) / kThreads];
    int cnt = 0;
    for (int i = threadIdx.x; i < n; i += kThreads, ++cnt) {
      T acc = T(0);
      for (int m = 0; m <= i; ++m) acc += w[m] * b[i - m];
      for (int m = i + 1; m < n; ++m) acc += w[m] * b[i - m + n];
      u[cnt] = acc;
    }
    __syncthreads();
    cnt = 0;
    for (int i = threadIdx.x; i < n; i += kThreads, ++cnt) {
      T v = u[cnt];
      if (g != nullptr) v = g[j * g_sj + k * g_sk + i] + v;
      b[i] = v;
      out[j * o_sj + k * o_sk + i] = v;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* seed, int64_t s_sj, const T* dt, T* out, int64_t o_sj, int64_t o_sk,
           const T* g, int64_t g_sj, int64_t g_sk, double fac, int64_t J, int64_t L, int64_t n,
           void* stream) {
  if (J == 0 || L == 0) return 0;
  if (J < 0 || J > 0x7fffffff || L < 0 || n < 1 || n > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(T) * (size_t)n;
  circulant_solve1d_kernel<T><<<(unsigned)J, kThreads, smem, (cudaStream_t)stream>>>(
      seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, (T)fac, J, L, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_circulant_solve1d_f64(const double* seed, int64_t s_sj, const double* dt, double* out,
                             int64_t o_sj, int64_t o_sk, const double* g, int64_t g_sj,
                             int64_t g_sk, double fac, int64_t J, int64_t L, int64_t n,
                             void* stream) {
  return launch<double>(seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, fac, J, L, n, stream);
}

int pm_circulant_solve1d_f32(const float* seed, int64_t s_sj, const float* dt, float* out,
                             int64_t o_sj, int64_t o_sk, const float* g, int64_t g_sj,
                             int64_t g_sk, double fac, int64_t J, int64_t L, int64_t n,
                             void* stream) {
  return launch<float>(seed, s_sj, dt, out, o_sj, o_sk, g, g_sj, g_sk, fac, J, L, n, stream);
}

}  // extern "C"
