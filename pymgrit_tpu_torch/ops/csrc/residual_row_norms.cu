// K3 residual_row_norms: the 2-norm of the difference of two row views,
//
//   out[i] = sqrt(sum_j (s[i, j] - u[i, j])^2)      for every row i < R,
//
// the per-C-point residual norm of the convergence check, or in the
// squares mode the sum without its root:
//
//   out[i] = sum_j (s[i, j] - u[i, j])^2,
//
// each space shard's part of a C-point's norm when the state is split over
// a 'space' mesh axis (the sharded executor adds the parts over the space
// group and takes the root of the sum; the JAX package's GSPMD reduces the
// norm's sum over the sharded axis the same way,
// pymgrit_tpu/parallel/shard_solver.py _conv_body :1135-1195).
//
// Replaces: pymgrit_tpu/core/solver.py _point_residual_norms (:1056-1076)
// with its default state_norm (the 2-norm, vector.batched_norm), which the
// JAX package vmaps over the C-points of level 0 and XLA fuses into one
// reduction.  The solver calls it with tube row views (any row stride;
// rows of odd N alternate in 16-byte alignment) and, in double-double
// precision, with float32 rows against a zero row expanded to stride 0.
//
// Bound: bytes.  The call reads both rows once and writes one value a row:
// at the main path's 512 C-rows of 127^2 float64, 132 MB, 0.0394 ms at
// 3.35 TB/s.  What held the Triton version back (on an H100, 0.127 ms
// against torch.linalg.vector_norm's 0.103) was its launcher's host time
// and one program of 4 warps a row.  Design:
// * one ctypes call of pm_residual_row_norms_*: a packed int64 argument
//   array the wrapper caches with its checks (ops/row_norms.py), and the
//   three pointers;
// * one block of 256 threads a row, four blocks an SM (64 registers a
//   thread), so that 528 rows are in flight in one wave on 132 SMs;
// * each thread keeps kUnroll 16-byte loads of each operand in flight.
//   s's row is read in 16-byte vectors from its first 16-byte-aligned
//   element on (the elements before it, and the tail, by single threads);
//   u's row in vectors at the same elements where they are 16-byte aligned
//   too, else element by element (the main path's s = a[1:], u = b[:J] of
//   odd N disagree on every row);
// * a fixed summation order, no atomics: kUnroll partials a thread summed
//   pairwise, a warp-shuffle butterfly (lane l adds lane l ^ k's value, the
//   same sum on both lanes), then the warps' sums in warp order; so a call
//   repeats bit for bit.  The order differs from PyTorch's sum, so the
//   kernel agrees with the plain version to rounding.
// * NaN and Inf propagate as in the plain version (no rescaling: a row
//   whose squares overflow gives Inf, as sum(square(.)) does).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one block a row
constexpr int kMinBlocks = 4;  // blocks an SM holds
constexpr int kUnroll = 4;     // 16-byte loads in flight a thread and operand
constexpr int kWarps = kThreads / 32;

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};

// element e of a vector (e is a constant after unrolling: no local memory)
__device__ __forceinline__ double& lane(double2& v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ float& lane(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double root(double x) { return sqrt(x); }
__device__ __forceinline__ float root(float x) { return sqrtf(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    residual_row_norms_kernel(const T* __restrict__ s, const T* __restrict__ u,
                              T* __restrict__ out, int64_t ss, int64_t su, int64_t N,
                              bool squares) {
  using VT = typename Vec16<T>::type;
  constexpr int V = Vec16<T>::n;
  const int64_t row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* sr = s + row * ss;
  const T* ur = u + row * su;
  int64_t head = (int64_t)(((16 - (reinterpret_cast<uintptr_t>(sr) & 15)) & 15) / sizeof(T));
  head = head < N ? head : N;
  const int64_t nv = (N - head) / V;
  const bool uvec = (reinterpret_cast<uintptr_t>(ur + head) & 15) == 0;
  const VT* sv = reinterpret_cast<const VT*>(sr + head);
  const VT* uv = reinterpret_cast<const VT*>(ur + head);
  const T* us = ur + head;

  T acc[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) acc[k] = T(0);
  for (int64_t v0 = tid; v0 < nv; v0 += (int64_t)kUnroll * kThreads) {
    VT a[kUnroll], b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int64_t vi = v0 + (int64_t)k * kThreads;
      if (vi < nv) {
        a[k] = __ldg(sv + vi);
        if (uvec) {
          b[k] = __ldg(uv + vi);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) lane(b[k], e) = __ldg(us + vi * V + e);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (v0 + (int64_t)k * kThreads < nv) {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const T d = lane(a[k], e) - lane(b[k], e);
          acc[k] = fma_(d, d, acc[k]);
        }
      }
    }
  }
  // the peeled head (threads 0 .. head - 1) and the tail (threads 32 ..)
  const int64_t tail = N - head - nv * V;
  int64_t e = -1;
  if (tid < head) e = tid;
  if (tid >= 32 && tid - 32 < tail) e = head + nv * V + (tid - 32);
  if (e >= 0) {
    const T d = __ldg(sr + e) - __ldg(ur + e);
    acc[0] = fma_(d, d, acc[0]);
  }

  T p = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
  for (int k = 16; k >= 1; k >>= 1) p += __shfl_xor_sync(0xffffffffu, p, k);
  __shared__ T part[kWarps];
  if ((tid & 31) == 0) part[tid >> 5] = p;
  __syncthreads();
  if (tid == 0) {
    T t = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += part[w];
    out[row] = squares ? t : root(t);
  }
}

// args (int64): CUDA device, R, N, s's and u's row strides (elements)
// (ops/row_norms.py::pack); squares: leave the root out
template <typename T>
int launch(const int64_t* a, const void* s, const void* u, void* out, void* stream,
           bool squares) {
  const int64_t R = a[1], N = a[2];
  if (R == 0) return 0;
  if (R < 0 || R > 0x7fffffff || N < 0) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  residual_row_norms_kernel<T><<<(unsigned)R, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(s), static_cast<const T*>(u), static_cast<T*>(out), a[3], a[4], N, squares);
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_residual_row_norms_f64(const int64_t* args, const void* s, const void* u, void* out,
                              void* stream) {
  return launch<double>(args, s, u, out, stream, false);
}

int pm_residual_row_norms_f32(const int64_t* args, const void* s, const void* u, void* out,
                              void* stream) {
  return launch<float>(args, s, u, out, stream, false);
}

int pm_residual_row_norms_squares_f64(const int64_t* args, const void* s, const void* u,
                                      void* out, void* stream) {
  return launch<double>(args, s, u, out, stream, true);
}

int pm_residual_row_norms_squares_f32(const int64_t* args, const void* s, const void* u,
                                      void* out, void* stream) {
  return launch<float>(args, s, u, out, stream, true);
}

}  // extern "C"
