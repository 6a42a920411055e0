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
// Bound: latency.  An attempt is a chain of 7 right-hand sides (6 new),
// each waiting on the stages before it, then the error norm and the next
// step size; memory traffic is one state in and out per step.  A warp runs
// as many attempts as its slowest lane.  The first version spent most of an
// attempt in CUDA's general pow: two pow(s, 1.5) a right-hand side and
// pow(err, -0.2), each a long library routine with special-case branches.
// Design (ops/runge_kutta.py ``dopri45_arenstorf_pack``):
// * the whole loop runs in registers (4 values, 7 stages), a lane leaves as
//   soon as it is done, and the chain of steps stays in the thread, so one
//   launch covers an F-relaxation sweep or the whole coarsest forward
//   solve; one warp a block, so J = 250 lanes run on 8 SMs;
// * the tableau is compile-time (immediates; its zero entries drop out);
// * a right-hand side forms y1^2 once, its two distances on independent
//   chains, each s^1.5 as s * sqrt(s) (a correctly rounded root and one
//   multiply, within an ulp or two of pow: the attempt counts stay the
//   plain version's and the values within the kernel tolerance, checked by
//   chip_smoke.py on every case and in the [ode] solve); its four
//   divisions stay divisions, as the JAX package divides;
// * the step-size factor keeps pow(err, -0.2), once an attempt.
// What is left on the chain: each division and root is CUDA's routine, a
// convergence region with a slow-path call, so the four divisions of a
// right-hand side run one after another (two reciprocals in their place,
// which the JAX package does not take, ran about a quarter faster).
//
// Exactness: the time arithmetic (t + h, t1 - t, the comparison t < t1) is
// written with explicit round-to-nearest adds, so nvcc cannot contract it
// into an FMA and the accept/step decisions follow the plain version's; the
// stage arithmetic may contract.  min/max propagate NaN as jnp.minimum and
// jnp.maximum do.  Launched by one ctypes call: a packed int64 argument
// array (rtol, atol and a as the bits of doubles).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // threads a block: one warp

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

// s^1.5
template <typename T>
__device__ __forceinline__ T pow15(T s) {
  return s * sqrt(s);
}

template <typename T>
struct Params {
  const T* seed;                 // (J, 4), lane stride s_sj
  const T *tp, *tc;              // (L, J) contiguous step times
  T* out;                        // out[j, k] at j * o_sj + k * o_sk
  const T* g;                    // null: no g; g[j, k] at j * g_sj + k * g_sk
  int* attempts;                 // null: none; (L, J) contiguous
  int64_t s_sj, o_sj, o_sk, g_sj, g_sk, J, L;
  int max_steps;
  T rtol, atol, a, b;            // b = 1 - a
};

// the Arenstorf right-hand side at y (expression order of
// ArenstorfOrbit._f)
template <typename T>
__device__ __forceinline__ void rhs(const Params<T>& p, const T (&y)[4], T (&f)[4]) {
  const T pa = y[0] + p.a;
  const T qb = y[0] - p.b;
  const T y1s = y[1] * y[1];
  const T d1 = pow15(pa * pa + y1s);
  const T d2 = pow15(qb * qb + y1s);
  f[0] = y[2];
  f[1] = y[3];
  f[2] = y[0] + 2 * y[3] - p.b * pa / d1 - p.a * qb / d2;
  f[3] = y[1] - 2 * y[2] - p.b * y[1] / d1 - p.a * y[1] / d2;
}

template <typename T>
__device__ __forceinline__ T rms4(const T (&x)[4]) {
  return sqrt((x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3]) / T(4));
}

// Dormand-Prince 5(4) tableau (scipy's RK45), as functions of their
// indices: once the loops over them are unrolled every entry is a
// compile-time constant, and the zero entries drop out
__host__ __device__ constexpr double tab_a(int i, int j) {
  return i == 1 ? 1.0 / 5
       : i == 2 ? (j == 0 ? 3.0 / 40 : 9.0 / 40)
       : i == 3 ? (j == 0 ? 44.0 / 45 : j == 1 ? -56.0 / 15 : 32.0 / 9)
       : i == 4 ? (j == 0 ? 19372.0 / 6561 : j == 1 ? -25360.0 / 2187
                   : j == 2 ? 64448.0 / 6561 : -212.0 / 729)
                : (j == 0 ? 9017.0 / 3168 : j == 1 ? -355.0 / 33 : j == 2 ? 46732.0 / 5247
                   : j == 3 ? 49.0 / 176 : -5103.0 / 18656);
}
__host__ __device__ constexpr double tab_b(int j) {
  return j == 0 ? 35.0 / 384 : j == 1 ? 0.0 : j == 2 ? 500.0 / 1113 : j == 3 ? 125.0 / 192
       : j == 4 ? -2187.0 / 6784 : 11.0 / 84;
}
// the error weights b5 - b4, with the FSAL stage k7
__host__ __device__ constexpr double tab_e(int j) {
  return j == 0 ? 71.0 / 57600 : j == 1 ? 0.0 : j == 2 ? -71.0 / 16695 : j == 3 ? 71.0 / 1920
       : j == 4 ? -17253.0 / 339200 : j == 5 ? 22.0 / 525 : -1.0 / 40;
}

// Integrate y from t0 to t1 in place; returns the attempt count.  Inlined:
// a call would pass y through the stack, and every access of the chain's
// state would wait on local memory.
template <typename T>
__device__ __forceinline__ int integrate(const Params<T>& p, T (&y)[4], T t0, T t1) {
  const T rtol = p.rtol, atol = p.atol;
  T fy[4], k[7][4], scale[4], tmp[4], ynew[4];
  rhs(p, y, fy);
  // Hairer's initial step
#pragma unroll
  for (int c = 0; c < 4; ++c) scale[c] = atol + fabs(y[c]) * rtol;
#pragma unroll
  for (int c = 0; c < 4; ++c) tmp[c] = y[c] / scale[c];
  const T d0 = rms4(tmp);
#pragma unroll
  for (int c = 0; c < 4; ++c) tmp[c] = fy[c] / scale[c];
  const T d1 = rms4(tmp);
  const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6) : T(0.01) * d0 / d1;
#pragma unroll
  for (int c = 0; c < 4; ++c) ynew[c] = y[c] + h0 * fy[c];
  rhs(p, ynew, k[0]);
#pragma unroll
  for (int c = 0; c < 4; ++c) tmp[c] = (k[0][c] - fy[c]) / scale[c];
  const T d2 = rms4(tmp) / h0;
  const T h1 = (d1 <= T(1e-15) && d2 <= T(1e-15)) ? nan_max(T(1e-6), h0 * T(1e-3))
                                                  : pow(T(0.01) / nan_max(d1, d2), T(0.2));
  T h_abs = nan_min(nan_min(T(100) * h0, h1), sub_rn(t1, t0));

  T t = t0;
  bool rejected = false;
  int n = 0;
  while (t < t1 && n < p.max_steps) {
    const T h = nan_min(h_abs, sub_rn(t1, t));
#pragma unroll
    for (int c = 0; c < 4; ++c) k[0][c] = fy[c];
#pragma unroll
    for (int i = 1; i < 6; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        T dy = T(0);
#pragma unroll
        for (int j = 0; j < i; ++j) dy = dy + T(tab_a(i, j)) * k[j][c];
        tmp[c] = y[c] + h * dy;
      }
      rhs(p, tmp, k[i]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      T dy = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (tab_b(j) != 0) dy = dy + T(tab_b(j)) * k[j][c];
      }
      ynew[c] = y[c] + h * dy;
    }
    rhs(p, ynew, k[6]);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      T e = T(0);
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        if (tab_e(j) != 0) e = e + T(tab_e(j)) * k[j][c];
      }
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
#pragma unroll
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
__global__ void __launch_bounds__(kThreads) dopri45_arenstorf_kernel(const Params<T> p) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= p.J) return;
  T y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) y[c] = p.seed[j * p.s_sj + c];
  for (int64_t k = 0; k < p.L; ++k) {
    const int n = integrate(p, y, p.tp[k * p.J + j], p.tc[k * p.J + j]);
    if (p.attempts != nullptr) p.attempts[k * p.J + j] = n;
    if (p.g != nullptr) {
#pragma unroll
      for (int c = 0; c < 4; ++c) y[c] = p.g[j * p.g_sj + k * p.g_sk + c] + y[c];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) p.out[j * p.o_sj + k * p.o_sk + c] = y[c];
  }
}

// args (int64): CUDA device; seed, tp, tc, out, g (0: none), attempts (0:
// none); seed's lane stride, out's lane and step strides, g's lane and step
// strides; J, L, max_steps; the bits of rtol, atol, a as doubles
// (ops/runge_kutta.py::dopri45_arenstorf_pack)
template <typename T>
int launch(const int64_t* a, void* stream) {
  Params<T> p{};
  p.seed = reinterpret_cast<const T*>(a[1]);
  p.tp = reinterpret_cast<const T*>(a[2]);
  p.tc = reinterpret_cast<const T*>(a[3]);
  p.out = reinterpret_cast<T*>(a[4]);
  p.g = reinterpret_cast<const T*>(a[5]);
  p.attempts = reinterpret_cast<int*>(a[6]);
  p.s_sj = a[7];
  p.o_sj = a[8];
  p.o_sk = a[9];
  p.g_sj = a[10];
  p.g_sk = a[11];
  p.J = a[12];
  p.L = a[13];
  const int64_t max_steps = a[14];
  double c[3];
  std::memcpy(c, a + 15, sizeof(c));
  p.rtol = (T)c[0];
  p.atol = (T)c[1];
  p.a = (T)c[2];
  p.b = (T)(1.0 - c[2]);
  if (p.J == 0 || p.L == 0) return 0;
  const int64_t grid = (p.J + kThreads - 1) / kThreads;
  if (p.J < 0 || p.L < 0 || max_steps < 0 || max_steps > 0x7fffffff || grid > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  p.max_steps = (int)max_steps;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  dopri45_arenstorf_kernel<T><<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_dopri45_arenstorf_f64(const int64_t* args, void* stream) {
  return launch<double>(args, stream);
}

int pm_dopri45_arenstorf_f32(const int64_t* args, void* stream) {
  return launch<float>(args, stream);
}

}  // extern "C"
