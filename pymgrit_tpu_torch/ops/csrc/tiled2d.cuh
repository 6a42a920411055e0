// Shared tiled path of K5 sine_solve2d, K6 sine_affine2d and K10
// periodic_solve2d for states whose side exceeds the one-tile core of
// sine2d.cuh (128): the two-sided products S1 X S2 go through device
// memory, one product per launch over a chunk of states.
//
// tiled_product computes C_b = A_b B_b for every state b of a chunk, where
// each operand is a state (batch stride > 0) or a table shared by all
// states (batch stride 0).  A block owns a 32 x 32 tile of C_b; it walks
// the inner dimension in k-tiles of 32, staging the A and B tiles through
// shared memory (odd leading dimension: conflict-free columns), and a
// thread accumulates four outputs of one column in registers, summing the
// inner index in ascending order as the one-tile core does.  The epilogue
// writes C_b to a workspace, to a workspace divided by (1 + sh_b lam) (the
// solve's diagonal), or into the output state (interior offset 1 with a
// ring, plus g).  finish_ring writes the output's Dirichlet ring (plus g).
// States are addressed by a flat index b = hi * D + lo with a stride for hi
// and one for lo, which covers (state), (interval, table row) and (lane,
// species) layouts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tiled2d {

constexpr int kTile = 32;                     // output tile side, k-tile depth
constexpr int kRowsPer = 4;                   // outputs a thread owns (one column)
constexpr int kThreads = kTile * kTile / kRowsPer;

enum Store { kToWork = 0, kToWorkDiv = 1, kToOut = 2 };

template <typename T>
struct Operand {
  const T* p;     // state 0 of the chunk (or the table)
  int64_t sb;     // batch stride (0: one table for every state)
  int64_t ld;     // row stride
};

template <typename T>
struct Epilogue {
  int mode;
  T* work;                    // kToWork, kToWorkDiv: contiguous (M x N) states
  const T* lam;               // kToWorkDiv: (M x N) row-major
  const T* shift;             // kToWorkDiv: sh = shift[hi] (or shift0) [* coef[lo]]
  T shift0;
  const T* coef;
  T* out;                     // kToOut: out[hi, lo] interior at (off, off)
  int64_t o_hi, o_lo, o_row;
  const T* g;                 // kToOut: optional, the output's layout
  int64_t g_hi, g_lo, g_row;
  int off;
  int64_t D;                  // b = hi * D + lo
  int64_t b0;                 // flat index of the chunk's first state
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    tiled_product(Operand<T> A, Operand<T> B, int M, int N, int K, int tiles_n, Epilogue<T> ep) {
  __shared__ T As[kTile][kTile + 1];
  __shared__ T Bs[kTile][kTile + 1];
  const int64_t b = blockIdx.x;
  const int ti = blockIdx.y / tiles_n;
  const int tj = blockIdx.y - ti * tiles_n;
  const int tx = threadIdx.x % kTile;
  const int ty = threadIdx.x / kTile;
  constexpr int kStep = kTile / kRowsPer;     // thread rows
  const T* a = A.p + b * A.sb;
  const T* bm = B.p + b * B.sb;
  T acc[kRowsPer];
#pragma unroll
  for (int q = 0; q < kRowsPer; ++q) acc[q] = T(0);
  const int j = tj * kTile + tx;
  for (int l0 = 0; l0 < K; l0 += kTile) {
    for (int q = ty; q < kTile; q += kStep) {
      const int i = ti * kTile + q;
      As[q][tx] = (i < M && l0 + tx < K) ? a[i * A.ld + l0 + tx] : T(0);
      Bs[q][tx] = (l0 + q < K && j < N) ? bm[(l0 + q) * B.ld + j] : T(0);
    }
    __syncthreads();
    const int lmax = K - l0 < kTile ? K - l0 : kTile;
    for (int l = 0; l < lmax; ++l) {
      const T bv = Bs[l][tx];
#pragma unroll
      for (int q = 0; q < kRowsPer; ++q) acc[q] += As[ty + q * kStep][l] * bv;
    }
    __syncthreads();
  }
  if (j >= N) return;
  const int64_t bg = ep.b0 + b;
  const int64_t hi = bg / ep.D;
  const int64_t lo = bg - hi * ep.D;
#pragma unroll
  for (int q = 0; q < kRowsPer; ++q) {
    const int i = ti * kTile + ty + q * kStep;
    if (i >= M) continue;
    T v = acc[q];
    if (ep.mode == kToOut) {
      const int64_t at = (int64_t)(i + ep.off) * ep.o_row + (j + ep.off);
      if (ep.g != nullptr) {
        v = ep.g[hi * ep.g_hi + lo * ep.g_lo + (int64_t)(i + ep.off) * ep.g_row + (j + ep.off)] + v;
      }
      ep.out[hi * ep.o_hi + lo * ep.o_lo + at] = v;
    } else {
      if (ep.mode == kToWorkDiv) {
        T sh = ep.shift != nullptr ? ep.shift[hi] : ep.shift0;
        if (ep.coef != nullptr) sh = sh * ep.coef[lo];
        v = v / (T(1) + sh * ep.lam[i * N + j]);
      }
      ep.work[b * (int64_t)M * N + (int64_t)i * N + j] = v;
    }
  }
}

// C_b = A_b B_b (M x K times K x N) for the nb states of a chunk.
template <typename T>
cudaError_t product(Operand<T> A, Operand<T> B, int M, int N, int K, int64_t nb,
                    const Epilogue<T>& ep, cudaStream_t stream) {
  const int tiles_n = (N + kTile - 1) / kTile;
  const int tiles = ((M + kTile - 1) / kTile) * tiles_n;
  if (tiles > 65535 || nb > 0x7fffffff) return cudaErrorInvalidValue;
  tiled_product<T><<<dim3((unsigned)nb, (unsigned)tiles), kThreads, 0, stream>>>(A, B, M, N, K,
                                                                              tiles_n, ep);
  return cudaGetLastError();
}

// The Dirichlet ring of each output state (P x Q, the ring template's
// entries, plus g), for the nb states of a chunk.
template <typename T>
__global__ void finish_ring(const T* __restrict__ ring, int P, int Q, Epilogue<T> ep) {
  const int64_t bg = ep.b0 + blockIdx.x;
  const int64_t hi = bg / ep.D;
  const int64_t lo = bg - hi * ep.D;
  const int edge = 2 * Q + 2 * (P - 2);
  for (int e = threadIdx.x; e < edge; e += blockDim.x) {
    int i, j;
    if (e < Q) {
      i = 0;
      j = e;
    } else if (e < 2 * Q) {
      i = P - 1;
      j = e - Q;
    } else {
      i = 1 + (e - 2 * Q) / 2;
      j = ((e - 2 * Q) % 2) * (Q - 1);
    }
    T v = ring[i * Q + j];
    if (ep.g != nullptr) v = ep.g[hi * ep.g_hi + lo * ep.g_lo + (int64_t)i * ep.g_row + j] + v;
    ep.out[hi * ep.o_hi + lo * ep.o_lo + (int64_t)i * ep.o_row + j] = v;
  }
}

template <typename T>
cudaError_t ring(const T* ring_field, int P, int Q, int64_t nb, const Epilogue<T>& ep,
                 cudaStream_t stream) {
  finish_ring<T><<<(unsigned)nb, 256, 0, stream>>>(ring_field, P, Q, ep);
  return cudaGetLastError();
}

// Y_b = S1 X_b S2, then (solve) Y_b <- S1 ((Y_b) / (1 + sh_b lam)) S2, for
// the nb states of a chunk: X_b is read from x (any strides), Y_b written
// by the epilogue `last` (its mode kToOut); w0, w1 are (nb x r x c)
// workspaces (w0 may hold X_b itself).  S1 is (r x r), S2 (c x c).
template <typename T>
cudaError_t sandwich(Operand<T> x, int r, int c, const T* S1, const T* S2, T* w0, T* w1,
                     int64_t nb, const Epilogue<T>& div, Epilogue<T> last, bool solve,
                     cudaStream_t stream) {
  const int64_t rc = (int64_t)r * c;
  Epilogue<T> to_w1{};
  to_w1.mode = kToWork;
  to_w1.work = w1;
  to_w1.D = 1;
  cudaError_t e = product<T>(x, {S2, 0, c}, r, c, c, nb, to_w1, stream);      // X S2
  if (e != cudaSuccess) return e;
  if (solve) {
    Epilogue<T> d = div;
    d.mode = kToWorkDiv;
    d.work = w0;
    e = product<T>({S1, 0, r}, {w1, rc, c}, r, c, r, nb, d, stream);           // S1 X S2 / ..
    if (e != cudaSuccess) return e;
    e = product<T>({w0, rc, c}, {S2, 0, c}, r, c, c, nb, to_w1, stream);       // .. S2
    if (e != cudaSuccess) return e;
  }
  last.mode = kToOut;
  return product<T>({S1, 0, r}, {w1, rc, c}, r, c, r, nb, last, stream);      // S1 ..
}

}  // namespace tiled2d
