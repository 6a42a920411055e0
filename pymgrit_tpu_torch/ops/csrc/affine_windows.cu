// K9 affine_windows: the truncated coarsest-level solves of AT-MGRIT for an
// elementwise affine step.  For every lane p = 0..nt-1 and column j:
//   x = u[ws(p), j],  ws(p) = max(0, p - k + 1);
//   for i = ws(p)+1 .. p:  x = g[i-1, j] + (A[i-1, j] * x + b[i-1, j]);
//   out[p, j] = x.
// Row i-1 of A, b and g is the step from point i-1 to point i (the
// coarse tube's g rows 1..nt-1).  Lane 0 takes no step and is copied.
//
// Replaces: pymgrit_tpu/core/at_mgrit.py AtMgrit._forward_solve, a vmap
// over all coarsest points of a masked lax.scan of k-1 steps.
//
// Bound: L2 traffic.  Each lane reads up to k-1 rows of g (and of A and b,
// which at the TOMS width are single rows broadcast with stride 0), and
// neighbouring lanes share all but one of those rows: at nt = 2049,
// N = 16129, k = 64 the threads read 16.6 GB of g through L2 out of a
// 264 MB array.  Design: one thread per (lane, column), numbered
// column-fastest (neighbouring threads read neighbouring columns, or
// neighbouring lanes when N = 1), the window state in a register, every
// operand through L2.  No lane writes a row another lane reads, because out
// must not alias u.  Sharing a window's g rows through shared memory is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void affine_windows_kernel(const T* __restrict__ u, int64_t u_s,
                                      const T* __restrict__ A, int64_t a_s,
                                      const T* __restrict__ b, int64_t b_s,
                                      const T* __restrict__ g, int64_t g_s,
                                      T* __restrict__ out, int64_t o_s,
                                      int64_t nt, int64_t N, int64_t k) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= nt * N) return;
  const int64_t p = tid / N, j = tid - p * N;
  const int64_t ws = p - k + 1 > 0 ? p - k + 1 : 0;
  T x = u[ws * u_s + j];
  for (int64_t r = ws; r < p; ++r) {
    x = g[r * g_s + j] + (A[r * a_s + j] * x + b[r * b_s + j]);
  }
  out[p * o_s + j] = x;
}

template <typename T>
int launch(const T* u, int64_t u_s, const T* A, int64_t a_s, const T* b,
           int64_t b_s, const T* g, int64_t g_s, T* out, int64_t o_s,
           int64_t nt, int64_t N, int64_t k, void* stream) {
  if (nt == 0 || N == 0) return 0;
  if (k < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((nt * N + threads - 1) / threads);
  affine_windows_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      u, u_s, A, a_s, b, b_s, g, g_s, out, o_s, nt, N, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_affine_windows_f64(const double* u, int64_t u_s, const double* A,
                          int64_t a_s, const double* b, int64_t b_s,
                          const double* g, int64_t g_s, double* out,
                          int64_t o_s, int64_t nt, int64_t N, int64_t k,
                          void* stream) {
  return launch<double>(u, u_s, A, a_s, b, b_s, g, g_s, out, o_s, nt, N, k,
                        stream);
}

int pm_affine_windows_f32(const float* u, int64_t u_s, const float* A,
                          int64_t a_s, const float* b, int64_t b_s,
                          const float* g, int64_t g_s, float* out, int64_t o_s,
                          int64_t nt, int64_t N, int64_t k, void* stream) {
  return launch<float>(u, u_s, A, a_s, b, b_s, g, g_s, out, o_s, nt, N, k,
                       stream);
}

}  // extern "C"
