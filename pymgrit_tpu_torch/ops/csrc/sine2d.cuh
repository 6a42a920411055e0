// Shared core of K5 sine_solve2d and K6 sine_affine2d: two-sided products
// Sx * X * Sy of one (r x c) interior state (r, c <= 128; wider states
// take the tiled path of tiled2d.cuh) with the symmetric orthogonal sine
// bases Sx (r x r) and Sy (c x c), one thread block per state.
//
// Layout.  The state lives in shared memory with an odd leading dimension
// (kLd = 129), so a store down a column hits 32 distinct banks.  A thread
// owns one column q = tid % 128 and the 32 rows p = g + 4k of its row group
// g = tid / 128; it accumulates M[p, :] . S[:, q] in 32 registers, reading
// M[p, l] as a warp-wide broadcast from shared memory and S[l, q] as a
// coalesced load (S is read by every block and stays in L1/L2).  Both
// factors are applied as right products: X Sy is stored transposed, and
// (X Sy)^T Sx = (Sx X Sy)^T because Sx is symmetric; storing that
// transposed again gives Sx X Sy.  So every product is the same loop, and
// no second state-sized buffer is needed: one f64 state is 129 KB of the
// 227 KB a block may use, and the partial products live in registers.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sine2d {

constexpr int kThreads = 512;
constexpr int kCols = 128;                  // column lanes
constexpr int kGroups = kThreads / kCols;   // row groups
constexpr int kMaxN = 128;                  // largest side of the interior
constexpr int kRows = kMaxN / kGroups;      // rows one thread owns
constexpr int kLd = kMaxN + 1;              // odd: conflict-free columns

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * kMaxN * kLd;
}

// acc[k] = sum_l M[p_k, l] * S[l, q] with M in shared memory (n columns
// used) and S an (n x n) row-major matrix in global memory.  Rows p_k past
// the matrix read finite leftovers (the tile is cleared when a block
// starts) into accumulators that are never stored.
template <typename T>
__device__ __forceinline__ void right_mul(const T* M, int n, const T* __restrict__ S,
                                          T (&acc)[kRows]) {
  const int q = threadIdx.x % kCols;
  const T* row = M + (threadIdx.x / kCols) * kLd;
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = T(0);
  if (q >= n) return;
  for (int l = 0; l < n; ++l) {
    const T s = __ldg(S + l * n + q);
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] += row[k * kGroups * kLd + l] * s;
  }
}

// acc holds element (p_k, q) of an (rows x cols) result; write it to
// M[q, p_k], i.e. store the transpose.
template <typename T>
__device__ __forceinline__ void store_transposed(T* M, int rows, int cols,
                                                 const T (&acc)[kRows]) {
  const int q = threadIdx.x % kCols;
  const int g = threadIdx.x / kCols;
  if (q >= cols) return;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int p = g + kGroups * k;
    if (p < rows) M[q * kLd + p] = acc[k];
  }
}

// On entry M holds X (r x c); on exit M holds Sx X Sy (r x c), divided
// elementwise by (1 + shift * lam) when lam (r x c, row-major) is given.
template <typename T>
__device__ void sandwich(T* M, int r, int c, const T* __restrict__ Sx,
                         const T* __restrict__ Sy, const T* __restrict__ lam, T shift) {
  T acc[kRows];
  right_mul(M, c, Sy, acc);           // X Sy                      (r x c)
  __syncthreads();
  store_transposed(M, r, c, acc);     // M = (X Sy)^T              (c x r)
  __syncthreads();
  right_mul(M, r, Sx, acc);           // (X Sy)^T Sx = (Sx X Sy)^T (c x r)
  if (lam != nullptr) {
    // acc[k] is element (x = q, y = p_k) of Sx X Sy
    const int q = threadIdx.x % kCols;
    const int g = threadIdx.x / kCols;
    if (q < r) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int p = g + kGroups * k;
        if (p < c) acc[k] = acc[k] / (T(1) + shift * lam[q * c + p]);
      }
    }
  }
  __syncthreads();
  store_transposed(M, c, r, acc);     // M = Sx X Sy               (r x c)
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void clear_tile(T* M) {
  for (int i = threadIdx.x; i < kMaxN * kLd; i += kThreads) M[i] = T(0);
}

// M[i, j] = src[i * row_stride + j] for the (r x c) state at src.
template <typename T>
__device__ __forceinline__ void load_tile(T* M, const T* __restrict__ src,
                                          int64_t row_stride, int r, int c) {
  for (int idx = threadIdx.x; idx < r * c; idx += kThreads) {
    const int i = idx / c;
    const int j = idx - i * c;
    M[i * kLd + j] = src[i * row_stride + j];
  }
}

// Write the (r x c) tile M to out (row stride os).  With ring != nullptr
// the output is the full (r+2 x c+2) state: the tile is its interior and
// the boundary ring is copied from ring (an (r+2 x c+2) row-major field).
// With g != nullptr (row stride gs, the output's shape) out = g + value.
template <typename T>
__device__ __forceinline__ void store_state(const T* M, int r, int c, T* __restrict__ out,
                                            int64_t os, const T* __restrict__ ring,
                                            const T* __restrict__ g, int64_t gs) {
  const int P = ring != nullptr ? r + 2 : r;
  const int Q = ring != nullptr ? c + 2 : c;
  const int off = ring != nullptr ? 1 : 0;
  for (int idx = threadIdx.x; idx < P * Q; idx += kThreads) {
    const int i = idx / Q;
    const int j = idx - i * Q;
    const int ii = i - off;
    const int jj = j - off;
    T v = (ii >= 0 && ii < r && jj >= 0 && jj < c) ? M[ii * kLd + jj] : ring[idx];
    if (g != nullptr) v = g[i * gs + j] + v;
    out[i * os + j] = v;
  }
}

// Opt the kernel in to more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace sine2d
