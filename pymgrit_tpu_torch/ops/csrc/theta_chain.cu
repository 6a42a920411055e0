// K2 theta_chain: J independent chains of L spectral theta-method steps,
//   x <- [g_k +] (x*(1 - th'*dt*Lam) + (th+th')*dt*lift + dt*rhs_k) / (1 + th*dt*Lam)
// with th' = 0 for backward Euler (theta == 1) and th' = theta otherwise;
// rhs_k = rhs(t_k+1) for BE and theta*rhs(t_k+1) + (1-theta)*rhs(t_k) else.
// Every step's x is written to out[j, k].
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D._step_spectral as the
// solver batches it: pymgrit_tpu/core/solver.py _f_relax_uniform for lvl > 0
// (lax.scan of m-1 steps plus g), the one-step Phi of _c_relax_uniform and
// _fas_residual (L = 1), and the sequential coarsest _forward_solve (J = 1).
//
// Bound: bytes.  Each step reads one g row and writes one out row per chain
// (8 + 8 bytes per coefficient in float64) against ~10 flops.  Design: one
// thread per (chain j, coefficient n) carries x in a register across all L
// steps, so the recurrence never round-trips through memory; Lam and lift
// are loaded once per thread.  Neighbouring threads own neighbouring n, so
// every load and store is coalesced.  Rows are addressed by element strides
// (chain stride, step stride), so g and out are strided views of the level
// tubes and a time-independent rhs is one row with strides 0.  The
// expression order follows _step_spectral; nvcc's default FMA contraction
// makes results agree with the plain version to rounding, not bitwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void theta_chain_kernel(const T* __restrict__ x0, int64_t x_sj,
                                   T* __restrict__ out, int64_t out_sj,
                                   int64_t out_sk, const T* __restrict__ g,
                                   int64_t g_sj, int64_t g_sk,
                                   const T* __restrict__ dt,
                                   const T* __restrict__ lam,
                                   const T* __restrict__ lift,
                                   const T* __restrict__ rhs1,
                                   const T* __restrict__ rhs0, int64_t r_sk,
                                   int64_t r_sj, T theta, int be, int64_t J,
                                   int64_t L, int64_t N) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const T lm = lam[n];
  const T lf = lift[n];
  for (int64_t j = blockIdx.y; j < J; j += gridDim.y) {
    T x = x0[j * x_sj + n];
    for (int64_t k = 0; k < L; ++k) {
      const T d = dt[k * J + j];
      const T shift = d * theta;
      const int64_t ri = k * r_sk + j * r_sj + n;
      T b;
      if (be) {
        b = x + d * rhs1[ri] + shift * lf;
      } else {
        b = (x - shift * (x * lm)) + (shift * (T)2.0) * lf +
            d * (theta * rhs1[ri] + ((T)1.0 - theta) * rhs0[ri]);
      }
      x = b / ((T)1.0 + shift * lm);
      if (g != nullptr) x = g[j * g_sj + k * g_sk + n] + x;
      out[j * out_sj + k * out_sk + n] = x;
    }
  }
}

template <typename T>
int launch(const T* x0, int64_t x_sj, T* out, int64_t out_sj, int64_t out_sk,
           const T* g, int64_t g_sj, int64_t g_sk, const T* dt, const T* lam,
           const T* lift, const T* rhs1, const T* rhs0, int64_t r_sk,
           int64_t r_sj, double theta, int64_t J, int64_t L, int64_t N,
           void* stream) {
  if (J == 0 || L == 0 || N == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((N + threads - 1) / threads),
            (unsigned)(J < 65535 ? J : 65535));
  theta_chain_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      x0, x_sj, out, out_sj, out_sk, g, g_sj, g_sk, dt, lam, lift, rhs1, rhs0,
      r_sk, r_sj, (T)theta, theta == 1.0 ? 1 : 0, J, L, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_theta_chain_f64(const double* x0, int64_t x_sj, double* out,
                       int64_t out_sj, int64_t out_sk, const double* g,
                       int64_t g_sj, int64_t g_sk, const double* dt,
                       const double* lam, const double* lift,
                       const double* rhs1, const double* rhs0, int64_t r_sk,
                       int64_t r_sj, double theta, int64_t J, int64_t L,
                       int64_t N, void* stream) {
  return launch<double>(x0, x_sj, out, out_sj, out_sk, g, g_sj, g_sk, dt, lam,
                        lift, rhs1, rhs0, r_sk, r_sj, theta, J, L, N, stream);
}

int pm_theta_chain_f32(const float* x0, int64_t x_sj, float* out,
                       int64_t out_sj, int64_t out_sk, const float* g,
                       int64_t g_sj, int64_t g_sk, const float* dt,
                       const float* lam, const float* lift, const float* rhs1,
                       const float* rhs0, int64_t r_sk, int64_t r_sj,
                       double theta, int64_t J, int64_t L, int64_t N,
                       void* stream) {
  return launch<float>(x0, x_sj, out, out_sj, out_sk, g, g_sj, g_sk, dt, lam,
                       lift, rhs1, rhs0, r_sk, r_sj, theta, J, L, N, stream);
}

}  // extern "C"
