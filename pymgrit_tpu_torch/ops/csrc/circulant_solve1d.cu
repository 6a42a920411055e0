// K17 circulant_solve1d: backward-Euler steps of periodic first-order
// upwind advection, one lane per block, J lanes of L chained steps per
// launch:
//   out[j, k] = [g[j, k] +] Phi(out[j, k-1]),  out[j, -1] = seed[j],
// where Phi(b) solves the cyclic bidiagonal system
//   (1 + c) u_i - c u_{i-1} = b_i   (indices mod n)
// with c = dt[k, j] * fac (fac = speed / dx).
//
// Replaces: pymgrit_tpu/models/advection_1d.py Advection1D.step (FFT,
// elementwise division by 1 + c (1 - e^(-2 pi i k/n)), inverse FFT, real
// part).
//
// The solve is the O(n) recurrence with its closed-form cyclic closure.
// With r = c / (1 + c), |r| <= 1:  u_i = b_i / (1 + c) + r u_{i-1}, run
// forward from the closure
//   u_{n-1} = sum_m r^m b_{n-1-m} / ((1 + c)(1 - r^n)).
// With |r| > 1 (c < -1/2) the mirrored form keeps every power at most 1 in
// magnitude: q = (1 + c) / c,  u_{i-1} = q u_i - b_i / c, run backward from
//   u_{n-1} = sum_m q^m b_m / (c (q^n - 1)).
// Each recurrence damps an error by |r| or |q| <= 1 a step.  The closure is
// finite wherever the Fourier route is (where no 1 + c (1 - e^(-2 pi i k/n))
// vanishes); c = -1/2 with even n is singular for both.
//
// Bound: bytes (about 6 n operations a step against 2 n values read and
// written).  Design: the block forms the closure's sum (one pow and one
// product an entry, a fixed-order reduction); then the recurrence runs as a
// chunked scan: each thread solves its chunk of the n - 1 remaining points
// from a zero start, its first thread chains the chunks' end values into
// each chunk's incoming value (v_end + base^len * carry, a multiply-add a
// chunk), and each thread adds base^(m+1) * carry to its chunk.  b is read
// from the previous row (the seed, or the output row of the previous step)
// and u [+ g] written straight into the output row, so the state never
// needs shared memory and any n runs; a chain of steps stays in the block,
// so a whole F-relaxation sweep is one launch.

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
  __shared__ T part[kThreads];     // the closure's partial sums
  __shared__ T vend[kThreads];     // each chunk's last value from a zero start
  __shared__ T power[kThreads];    // base^(chunk length)
  __shared__ T carry[kThreads];    // the value entering each chunk
  const int64_t j = blockIdx.x;
  const int tid = threadIdx.x;
  // this thread's chunk [m0, m1) of the n - 1 steps of the recurrence
  const int len = (n - 1 + kThreads - 1) / kThreads;
  const int m0 = tid * len < n - 1 ? tid * len : n - 1;
  const int m1 = m0 + len < n - 1 ? m0 + len : n - 1;
  for (int64_t k = 0; k < L; ++k) {
    const T* b = k == 0 ? seed + j * s_sj : out + j * o_sj + (k - 1) * o_sk;
    T* u = out + j * o_sj + k * o_sk;
    const T* gk = g != nullptr ? g + j * g_sj + k * g_sk : nullptr;
    const T c = dt[k * J + j] * fac;
    const T c1 = T(1) + c;
    const bool forward = fabs(c) <= fabs(c1);
    const T base = forward ? c / c1 : c1 / c;
    T acc = T(0);
    for (int m = tid; m < n; m += kThreads) {
      acc += pow(base, T(m)) * (forward ? b[n - 1 - m] : b[m]);
    }
    part[tid] = acc;
    // step m: forward u[m] = b[m] / c1 + base u[m-1]; mirrored
    // u[n-2-m] = base u[n-1-m] - b[n-1-m] / c; here from a zero start
    T v = T(0);
    for (int m = m0; m < m1; ++m) {
      v = forward ? b[m] / c1 + base * v : base * v - b[n - 1 - m] / c;
      u[forward ? m : n - 2 - m] = v;
    }
    vend[tid] = v;
    power[tid] = pow(base, T(m1 - m0));
    __syncthreads();
    if (tid == 0) {
      T s = part[0];
      for (int t = 1; t < kThreads; ++t) s += part[t];
      // u[n-1], the value entering the first step
      const T last = forward ? s / (c1 * (T(1) - pow(base, T(n))))
                             : s / (c * (pow(base, T(n)) - T(1)));
      T cy = last;
      for (int t = 0; t < kThreads; ++t) {
        carry[t] = cy;
        cy = vend[t] + power[t] * cy;
      }
      u[n - 1] = gk != nullptr ? gk[n - 1] + last : last;
    }
    __syncthreads();
    const T cy = carry[tid];
    for (int m = m0; m < m1; ++m) {
      const int i = forward ? m : n - 2 - m;
      const T x = u[i] + pow(base, T(m - m0 + 1)) * cy;
      u[i] = gk != nullptr ? gk[i] + x : x;
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const T* seed, int64_t s_sj, const T* dt, T* out, int64_t o_sj, int64_t o_sk,
           const T* g, int64_t g_sj, int64_t g_sk, double fac, int64_t J, int64_t L, int64_t n,
           void* stream) {
  if (J == 0 || L == 0) return 0;
  if (J < 0 || J > 0x7fffffff || L < 0 || n < 1 || n > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  circulant_solve1d_kernel<T><<<(unsigned)J, kThreads, 0, (cudaStream_t)stream>>>(
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
