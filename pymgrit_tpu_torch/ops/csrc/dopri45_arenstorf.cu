// K12 dopri45_arenstorf: adaptive Dormand-Prince 5(4) integration of the
// Arenstorf orbit (restricted three-body problem, 4 state values), one
// thread per lane, J lanes of L chained steps per launch:
//   out[j, k] = [g[j, k] +] integrate(out[j, k-1], tp[k, j] -> tc[k, j])
// with out[j, -1] = seed[j].  Every step restarts scipy's RK45 controller
// (Hairer's initial step; safety 0.9, factor clamp [0.2, 10], error
// exponent -1/5, after a rejection the next growth is capped at 1;
// max_steps counts attempts) and writes its attempt count.
//
// Replaces: pymgrit_tpu/ops/runge_kutta.py dopri45_integrate with
// pymgrit_tpu/models/arenstorf_orbit.py ArenstorfOrbit._f, which the JAX
// package runs as a vmap-ed lax.while_loop over lanes (a step of the slowest
// lane for every lane, masked).
//
// Bound: latency of the dependent chain of stages (7 right-hand sides of
// ~40 FP64 operations per attempt, tens of attempts per step); memory
// traffic is one state in and out per step.  Design: the whole loop runs in
// registers (4 values, 7 stages), a lane leaves as soon as it is done, and
// the chain of steps stays in the thread, so one launch covers an
// F-relaxation sweep or the whole coarsest forward solve.  Lanes of a warp
// diverge where their attempt counts differ.
//
// Exactness: the time arithmetic (t + h, t1 - t, the comparison t < t1) is
// written with explicit round-to-nearest adds, so nvcc cannot contract it
// into an FMA and the accept/step decisions follow the plain version's; the
// stage arithmetic may contract.  min/max propagate NaN as jnp.minimum and
// jnp.maximum do.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}

template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

template <typename T>
struct Arenstorf {
  T a, b;
  __device__ __forceinline__ void operator()(const T (&y)[4], T (&f)[4]) const {
    const T p = y[0] + a;
    const T q = y[0] - b;
    const T y1s = y[1] * y[1];
    const T d1 = pow(p * p + y1s, T(1.5));
    const T d2 = pow(q * q + y1s, T(1.5));
    f[0] = y[2];
    f[1] = y[3];
    f[2] = y[0] + 2 * y[3] - b * p / d1 - a * q / d2;
    f[3] = y[1] - 2 * y[2] - b * y[1] / d1 - a * y[1] / d2;
  }
};

template <typename T>
__device__ __forceinline__ T rms4(const T (&x)[4]) {
  return sqrt((x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3]) / T(4));
}

// Dormand-Prince 5(4) tableau (scipy's RK45)
__constant__ double kA[6][5] = {
    {0, 0, 0, 0, 0},
    {1.0 / 5, 0, 0, 0, 0},
    {3.0 / 40, 9.0 / 40, 0, 0, 0},
    {44.0 / 45, -56.0 / 15, 32.0 / 9, 0, 0},
    {19372.0 / 6561, -25360.0 / 2187, 64448.0 / 6561, -212.0 / 729, 0},
    {9017.0 / 3168, -355.0 / 33, 46732.0 / 5247, 49.0 / 176, -5103.0 / 18656}};
__constant__ double kB[6] = {35.0 / 384, 0, 500.0 / 1113, 125.0 / 192, -2187.0 / 6784,
                             11.0 / 84};
__constant__ double kE[7] = {71.0 / 57600,  0,           -71.0 / 16695, 71.0 / 1920,
                             -17253.0 / 339200, 22.0 / 525, -1.0 / 40};

// Integrate y from t0 to t1 in place; returns the attempt count.
template <typename T>
__device__ int integrate(const Arenstorf<T>& f, T (&y)[4], T t0, T t1, T rtol, T atol,
                         int max_steps) {
  T fy[4], k[7][4], scale[4], tmp[4], ynew[4];
  f(y, fy);
  // Hairer's initial step
  for (int c = 0; c < 4; ++c) scale[c] = atol + fabs(y[c]) * rtol;
  for (int c = 0; c < 4; ++c) tmp[c] = y[c] / scale[c];
  const T d0 = rms4(tmp);
  for (int c = 0; c < 4; ++c) tmp[c] = fy[c] / scale[c];
  const T d1 = rms4(tmp);
  const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6) : T(0.01) * d0 / d1;
  for (int c = 0; c < 4; ++c) ynew[c] = y[c] + h0 * fy[c];
  f(ynew, k[0]);
  for (int c = 0; c < 4; ++c) tmp[c] = (k[0][c] - fy[c]) / scale[c];
  const T d2 = rms4(tmp) / h0;
  const T h1 = (d1 <= T(1e-15) && d2 <= T(1e-15)) ? nan_max(T(1e-6), h0 * T(1e-3))
                                                  : pow(T(0.01) / nan_max(d1, d2), T(0.2));
  T h_abs = nan_min(nan_min(T(100) * h0, h1), sub_rn(t1, t0));

  T t = t0;
  bool rejected = false;
  int n = 0;
  while (t < t1 && n < max_steps) {
    const T h = nan_min(h_abs, sub_rn(t1, t));
    for (int c = 0; c < 4; ++c) k[0][c] = fy[c];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
      for (int c = 0; c < 4; ++c) {
        T dy = T(0);
#pragma unroll
        for (int j = 0; j < i; ++j) dy = dy + T(kA[i][j]) * k[j][c];
        tmp[c] = y[c] + h * dy;
      }
      f(tmp, k[i]);
    }
    for (int c = 0; c < 4; ++c) {
      T dy = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) dy = dy + T(kB[j]) * k[j][c];
      ynew[c] = y[c] + h * dy;
    }
    f(ynew, k[6]);
    for (int c = 0; c < 4; ++c) {
      T e = T(0);
#pragma unroll
      for (int j = 0; j < 7; ++j) e = e + T(kE[j]) * k[j][c];
      const T sc = atol + nan_max(fabs(y[c]), fabs(ynew[c])) * rtol;
      tmp[c] = (e * h) / sc;
    }
    const T err = rms4(tmp);
    const bool accept = err < T(1);
    const T grow = T(0.9) * pow(err, T(-0.2));
    T factor;
    if (accept) {
      factor = err == T(0) ? T(10) : nan_min(T(10), grow);
      if (rejected) factor = nan_min(T(1), factor);
      t = add_rn(t, h);
      for (int c = 0; c < 4; ++c) {
        y[c] = ynew[c];
        fy[c] = k[6][c];
      }
    } else {
      factor = nan_max(T(0.2), grow);
    }
    h_abs = h_abs * factor;
    rejected = !accept;
    ++n;
  }
  return n;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dopri45_arenstorf_kernel(const T* __restrict__ seed, int64_t s_sj,
                             const T* __restrict__ tp, const T* __restrict__ tc,
                             T* __restrict__ out, int64_t o_sj, int64_t o_sk,
                             const T* __restrict__ g, int64_t g_sj, int64_t g_sk,
                             int* __restrict__ attempts, T rtol, T atol, T a, int max_steps,
                             int64_t J, int64_t L) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= J) return;
  const Arenstorf<T> f{a, T(1) - a};
  T y[4];
  for (int c = 0; c < 4; ++c) y[c] = seed[j * s_sj + c];
  for (int64_t k = 0; k < L; ++k) {
    const int n = integrate(f, y, tp[k * J + j], tc[k * J + j], rtol, atol, max_steps);
    if (attempts != nullptr) attempts[k * J + j] = n;
    if (g != nullptr) {
      for (int c = 0; c < 4; ++c) y[c] = g[j * g_sj + k * g_sk + c] + y[c];
    }
    for (int c = 0; c < 4; ++c) out[j * o_sj + k * o_sk + c] = y[c];
  }
}

template <typename T>
int launch(const T* seed, int64_t s_sj, const T* tp, const T* tc, T* out, int64_t o_sj,
           int64_t o_sk, const T* g, int64_t g_sj, int64_t g_sk, int* attempts, double rtol,
           double atol, double a, int64_t max_steps, int64_t J, int64_t L, void* stream) {
  if (J == 0 || L == 0) return 0;
  if (J < 0 || L < 0 || max_steps < 0 || max_steps > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t blocks = (J + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dopri45_arenstorf_kernel<T><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      seed, s_sj, tp, tc, out, o_sj, o_sk, g, g_sj, g_sk, attempts, (T)rtol, (T)atol, (T)a,
      (int)max_steps, J, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_dopri45_arenstorf_f64(const double* seed, int64_t s_sj, const double* tp,
                             const double* tc, double* out, int64_t o_sj, int64_t o_sk,
                             const double* g, int64_t g_sj, int64_t g_sk, int* attempts,
                             double rtol, double atol, double a, int64_t max_steps, int64_t J,
                             int64_t L, void* stream) {
  return launch<double>(seed, s_sj, tp, tc, out, o_sj, o_sk, g, g_sj, g_sk, attempts, rtol,
                        atol, a, max_steps, J, L, stream);
}

int pm_dopri45_arenstorf_f32(const float* seed, int64_t s_sj, const float* tp,
                             const float* tc, float* out, int64_t o_sj, int64_t o_sk,
                             const float* g, int64_t g_sj, int64_t g_sk, int* attempts,
                             double rtol, double atol, double a, int64_t max_steps, int64_t J,
                             int64_t L, void* stream) {
  return launch<float>(seed, s_sj, tp, tc, out, o_sj, o_sk, g, g_sj, g_sk, attempts, rtol,
                       atol, a, max_steps, J, L, stream);
}

}  // extern "C"
