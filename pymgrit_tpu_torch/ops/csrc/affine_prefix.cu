// K8 affine_prefix: every state of the elementwise affine recurrence
//   out[k, j] = A[k, j] * out[k-1, j] + (b[k, j] [+ g[k, j]]),  k = 0..n-1,
// with out[-1, j] = x0[j].
//
// Replaces: pymgrit_tpu/ops/prefix.py affine_prefix_states (an
// associative scan over composed affine maps), which the coarsest level of
// pymgrit_tpu/core/solver.py Mgrit._forward_solve runs with
// coarsest_prefix=True instead of the sequential time march.
//
// Bound: bytes at the TOMS width (n = 2048 rows of N = 16129 columns: the g
// rows are 264 MB in float64, read twice, and the out rows are written
// once); latency at the Dahlquist shape (n = 65536 rows of one column, where
// the chain itself is the work).  Design: a chunked three-pass scan.  The
// rows split into chunks of T (T ~ sqrt(n), chosen by the wrapper).
//   1. One thread per (chunk, column) composes its chunk's map
//      (prod A, c) in registers and stores it.
//   2. One thread per column scans the chunk maps from x0 and leaves each
//      chunk's carry-in in place of its c.
//   3. One thread per (chunk, column) replays its T steps from the carry-in
//      and writes its rows.
// The sequential depth is 2T + n/T steps instead of n.  Threads are
// numbered column-fastest, so neighbouring threads read neighbouring
// columns (TOMS) or neighbouring chunks (one column).  Every operand row is
// addressed by its own element stride; A and b may have stride 0 (one row
// broadcast over all steps), g may be null.  The association order differs
// from the sequential recurrence and from JAX's associative scan, so the
// results agree with both to rounding, not bitwise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ T offset(const T* b, int64_t b_s, const T* g,
                                    int64_t g_s, int64_t r, int64_t j) {
  const T c = b[r * b_s + j];
  return g != nullptr ? c + g[r * g_s + j] : c;
}

template <typename T>
__global__ void chunk_maps(const T* __restrict__ A, int64_t a_s,
                           const T* __restrict__ b, int64_t b_s,
                           const T* __restrict__ g, int64_t g_s, int64_t n,
                           int64_t N, int64_t chunk, int64_t nchunks,
                           T* __restrict__ P, T* __restrict__ C) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nchunks * N) return;
  const int64_t q = tid / N, j = tid - q * N;
  const int64_t r1 = (q + 1) * chunk < n ? (q + 1) * chunk : n;
  T p = (T)1.0, c = (T)0.0;
  for (int64_t r = q * chunk; r < r1; ++r) {
    const T a = A[r * a_s + j];
    p = a * p;
    c = a * c + offset(b, b_s, g, g_s, r, j);
  }
  P[tid] = p;
  C[tid] = c;
}

template <typename T>
__global__ void chunk_carries(const T* __restrict__ x0, const T* __restrict__ P,
                              T* __restrict__ C, int64_t N, int64_t nchunks) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= N) return;
  T x = x0[j];
  for (int64_t q = 0; q < nchunks; ++q) {
    const T p = P[q * N + j], c = C[q * N + j];
    C[q * N + j] = x;
    x = p * x + c;
  }
}

template <typename T>
__global__ void chunk_replay(const T* __restrict__ A, int64_t a_s,
                             const T* __restrict__ b, int64_t b_s,
                             const T* __restrict__ g, int64_t g_s,
                             const T* __restrict__ C, T* __restrict__ out,
                             int64_t o_s, int64_t n, int64_t N, int64_t chunk,
                             int64_t nchunks) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nchunks * N) return;
  const int64_t q = tid / N, j = tid - q * N;
  const int64_t r1 = (q + 1) * chunk < n ? (q + 1) * chunk : n;
  T x = C[tid];
  for (int64_t r = q * chunk; r < r1; ++r) {
    x = A[r * a_s + j] * x + offset(b, b_s, g, g_s, r, j);
    out[r * o_s + j] = x;
  }
}

template <typename T>
int launch(const T* A, int64_t a_s, const T* b, int64_t b_s, const T* g,
           int64_t g_s, const T* x0, T* out, int64_t o_s, T* P, T* C,
           int64_t n, int64_t N, int64_t chunk, void* stream) {
  if (n == 0 || N == 0) return 0;
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const int64_t nchunks = (n + chunk - 1) / chunk;
  const int threads = 256;
  const unsigned blocks = (unsigned)((nchunks * N + threads - 1) / threads);
  const unsigned col_blocks = (unsigned)((N + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  chunk_maps<T><<<blocks, threads, 0, s>>>(A, a_s, b, b_s, g, g_s, n, N, chunk,
                                           nchunks, P, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_carries<T><<<col_blocks, threads, 0, s>>>(x0, P, C, N, nchunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  chunk_replay<T><<<blocks, threads, 0, s>>>(A, a_s, b, b_s, g, g_s, C, out,
                                             o_s, n, N, chunk, nchunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_affine_prefix_f64(const double* A, int64_t a_s, const double* b,
                         int64_t b_s, const double* g, int64_t g_s,
                         const double* x0, double* out, int64_t o_s, double* P,
                         double* C, int64_t n, int64_t N, int64_t chunk,
                         void* stream) {
  return launch<double>(A, a_s, b, b_s, g, g_s, x0, out, o_s, P, C, n, N,
                        chunk, stream);
}

int pm_affine_prefix_f32(const float* A, int64_t a_s, const float* b,
                         int64_t b_s, const float* g, int64_t g_s,
                         const float* x0, float* out, int64_t o_s, float* P,
                         float* C, int64_t n, int64_t N, int64_t chunk,
                         void* stream) {
  return launch<float>(A, a_s, b, b_s, g, g_s, x0, out, o_s, P, C, n, N, chunk,
                       stream);
}

}  // extern "C"
