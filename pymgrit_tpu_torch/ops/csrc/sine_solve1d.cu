// K20 sine_solve1d: the physical-basis Heat1D backward-Euler step, the BDF2
// step of the pair-state heat model, and the 1D sine transform of B rows of
// n interior values,
//
//   BE:         y_b = ((x_b + dt_b r_b) S / (1 + dt_b lam)) S
//   BDF2:       y_b = (((r_b - c2_b x_b) + c1_b x2_b) S / (lam + coeff_b)) S
//   transform:  y_b = x_b S
//
// with the symmetric orthonormal sine basis S (so x S == S x).
//
// Replaces: pymgrit_tpu/models/heat_1d.py Heat1D.step_batched (physical
// branch: `b @ S`, the diagonal scale, `xh @ S`) and Heat1D.relax_interval
// (physical branch: the two einsums around the closed-form tables, which
// run through K1 between two transforms); pymgrit_tpu/models/heat_1d_2pts.py
// Heat1DBDF1.step (two BE solves, solve_shifted_1d) and Heat1DBDF2.step (two
// Helmholtz solves, solve_helmholtz_1d, after the three-term right-hand
// side `rhs - coeffm2 * first + coeffm1 * second`).
//
// Design: each product is the row product Y = X S of a (B x n) batch with
// the (n x n) table.  A block owns a 32 x 32 tile of Y (32 rows, 32
// columns); it walks the inner index in k-tiles of 32, staging the X and S
// tiles through shared memory (odd leading dimension: conflict-free
// columns), and a thread accumulates four outputs of one column in
// registers, summing the inner index in ascending order.  A solve's first
// product forms its right-hand side while it stages X (x + dt r, or BDF2's
// (r - c2 x) + c1 x2 with per-lane c2, c1; the row of r may be shared by
// every row: stride 0), and divides by 1 + dt lam (or lam + coeff) in its
// epilogue into a contiguous workspace; the second product writes the
// output, so a solve may write over its inputs.  The staged sums and the
// divisors are formed with explicitly rounded operations, as the plain
// version forms them (no FMA contraction).  No shared-memory limit depends
// on n or B.  Output rows are addressed as b = hi * D + lo with a stride for
// hi and one for lo, which covers a (B, n) view and the (interval, row)
// layouts of relax_interval.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                    // output tile side, k-tile depth
constexpr int kRowsPer = 4;                  // outputs a thread owns (one column)
constexpr int kThreads = kTile * kTile / kRowsPer;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    row_product(const T* __restrict__ x, int64_t sx, const T* __restrict__ x2, int64_t sx2,
                const T* __restrict__ r, int64_t sr, const T* __restrict__ dt,
                const T* __restrict__ c2, const T* __restrict__ c1, const T* __restrict__ S,
                const T* __restrict__ lam, const T* __restrict__ coeff, int64_t B, int n,
                T* __restrict__ y, int64_t D, int64_t s_hi, int64_t s_lo) {
  __shared__ T Xs[kTile][kTile + 1];
  __shared__ T Ss[kTile][kTile + 1];
  const int64_t row0 = (int64_t)blockIdx.x * kTile;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  constexpr int kStep = kTile / kRowsPer;    // thread rows
  const int j = blockIdx.y * kTile + tx;
  T acc[kRowsPer];
#pragma unroll
  for (int q = 0; q < kRowsPer; ++q) acc[q] = T(0);
  for (int l0 = 0; l0 < n; l0 += kTile) {
    for (int q = ty; q < kTile; q += kStep) {
      const int64_t b = row0 + q;
      const int l = l0 + tx;
      T v = T(0);
      if (b < B && l < n) {
        v = x[b * sx + l];
        if (c2 != nullptr)
          v = add_rn(sub_rn(r[b * sr + l], mul_rn(c2[b], v)), mul_rn(c1[b], x2[b * sx2 + l]));
        else if (r != nullptr)
          v = add_rn(v, mul_rn(dt[b], r[b * sr + l]));
      }
      Xs[q][tx] = v;
      Ss[q][tx] = (l0 + q < n && j < n) ? S[(int64_t)(l0 + q) * n + j] : T(0);
    }
    __syncthreads();
    const int lmax = n - l0 < kTile ? n - l0 : kTile;
    for (int l = 0; l < lmax; ++l) {
      const T sv = Ss[l][tx];
#pragma unroll
      for (int q = 0; q < kRowsPer; ++q) acc[q] += Xs[ty + q * kStep][l] * sv;
    }
    __syncthreads();
  }
  if (j >= n) return;
#pragma unroll
  for (int q = 0; q < kRowsPer; ++q) {
    const int64_t b = row0 + ty + q * kStep;
    if (b >= B) continue;
    T v = acc[q];
    if (coeff != nullptr)
      v = v / add_rn(lam[j], coeff[b]);
    else if (lam != nullptr)
      v = v / add_rn(T(1), mul_rn(dt[b], lam[j]));
    const int64_t hi = b / D;
    y[hi * s_hi + (b - hi * D) * s_lo + j] = v;
  }
}

template <typename T>
int launch(const T* x, int64_t sx, const T* x2, int64_t sx2, const T* r, int64_t sr,
           const T* dt, const T* c2, const T* c1, const T* S, const T* lam, const T* coeff,
           T* work, T* y, int64_t D, int64_t s_hi, int64_t s_lo, int64_t B, int64_t n,
           void* stream) {
  if (B == 0 || n == 0) return 0;
  const int64_t row_tiles = (B + kTile - 1) / kTile;
  const int64_t col_tiles = (n + kTile - 1) / kTile;
  if (row_tiles > 0x7fffffff || col_tiles > 65535 || n > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lam != nullptr) {
    // work = (the right-hand side) S / (the divisor), then y = work S
    row_product<T><<<grid, kThreads, 0, s>>>(x, sx, x2, sx2, r, sr, dt, c2, c1, S, lam, coeff,
                                             B, (int)n, work, 1, n, 0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    row_product<T><<<grid, kThreads, 0, s>>>(work, n, nullptr, 0, nullptr, 0, nullptr, nullptr,
                                             nullptr, S, nullptr, nullptr, B, (int)n, y, D,
                                             s_hi, s_lo);
  } else {
    row_product<T><<<grid, kThreads, 0, s>>>(x, sx, nullptr, 0, nullptr, 0, nullptr, nullptr,
                                             nullptr, S, nullptr, nullptr, B, (int)n, y, D,
                                             s_hi, s_lo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_sine_solve1d_f64(const double* x, int64_t sx, const double* x2, int64_t sx2,
                        const double* r, int64_t sr, const double* dt, const double* c2, const double* c1,
                        const double* S, const double* lam, const double* coeff, double* work, double* y,
                        int64_t D, int64_t s_hi, int64_t s_lo, int64_t B, int64_t n,
                        void* stream) {
  return launch<double>(x, sx, x2, sx2, r, sr, dt, c2, c1, S, lam, coeff, work, y, D, s_hi, s_lo,
                     B, n, stream);
}

int pm_sine_solve1d_f32(const float* x, int64_t sx, const float* x2, int64_t sx2,
                        const float* r, int64_t sr, const float* dt, const float* c2, const float* c1,
                        const float* S, const float* lam, const float* coeff, float* work, float* y,
                        int64_t D, int64_t s_hi, int64_t s_lo, int64_t B, int64_t n,
                        void* stream) {
  return launch<float>(x, sx, x2, sx2, r, sr, dt, c2, c1, S, lam, coeff, work, y, D, s_hi, s_lo,
                     B, n, stream);
}

}  // extern "C"
