// K10 periodic_solve2d: the batched diagonal solve of the periodic heat
// operator, one (n x n) state per block,
//   x = (I - s_b L)^-1 b = H ((H b H) / (1 + s_b Lam)) H
// with L the periodic 5-point Laplacian, H the normalised Hartley matrix
// H[j, k] = (cos + sin)(2 pi j k / n) / sqrt(n) (real, symmetric,
// orthogonal; it diagonalises L because L's eigenvalues are even in k) and
// Lam = -(lam_k + lam_l) >= 0 the negated eigenvalue sums.  Optional
// prologue (nu > 0): b is the state u and the block first forms the IMEX
// right-hand side  u + s_b ((u / eps^2) (1 - u^nu)),  so one IMEX step of the
// Allen-Cahn equation is one launch.  Optional epilogue: out = g + x (the
// coarse-level F-relaxation's  x <- g + Phi(x)).
//
// Replaces: pymgrit_tpu/models/allen_cahn.py AllenCahn._fft_solve (the
// complex dense-DFT products  real(F^-1 (F b F^T / (1 - s Lam)) F^-T)) and
// the IMEX branch of AllenCahn.step; it is also the preconditioner of the
// Newton-CG solves of IMPL and CN (ops/cg.py).
//
// Bound: FP64 operations.  A solve is four (n x n) products per state (n =
// 128: 16.8 MFLOP against 2 x 128 KB read and written).  Design: the shared
// core of K5 (sine2d.cuh): the state in shared memory, the partial products
// in registers, the basis read through L1/L2, the product loops the block's
// own (no library GEMM).  The real Hartley route needs no complex
// arithmetic and no second buffer.  n <= 128 (the tile); the wrapper raises
// above.  A radix-2 FFT in shared memory would do O(n^2 log n) work instead
// of O(n^3); it is left for a later change.

#include "sine2d.cuh"

namespace {

using namespace sine2d;

template <typename T>
__device__ __forceinline__ T ipow(T x, int nu) {
  T p = x;
  for (int k = 1; k < nu; ++k) p = p * x;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    periodic_solve2d_kernel(const T* __restrict__ b, int64_t b_sb, int64_t b_sr,
                            T* __restrict__ out, int64_t o_sb, int64_t o_sr,
                            const T* __restrict__ H, const T* __restrict__ lam,
                            const T* __restrict__ shift, int nu, T inv_eps2,
                            const T* __restrict__ g, int64_t g_sb, int64_t g_sr, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int64_t s = blockIdx.x;
  const T sh = shift[s];
  clear_tile(M);
  __syncthreads();
  const T* src = b + s * b_sb;
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    T v = src[i * b_sr + j];
    if (nu > 0) v = v + sh * ((inv_eps2 * v) * (T(1) - ipow(v, nu)));
    M[i * kLd + j] = v;
  }
  __syncthreads();
  sandwich(M, n, n, H, H, lam, sh);
  sandwich(M, n, n, H, H, static_cast<const T*>(nullptr), T(0));
  store_state(M, n, n, out + s * o_sb, o_sr, static_cast<const T*>(nullptr),
              g != nullptr ? g + s * g_sb : nullptr, g_sr);
}

template <typename T>
int launch(const T* b, int64_t b_sb, int64_t b_sr, T* out, int64_t o_sb, int64_t o_sr,
           const T* H, const T* lam, const T* shift, int64_t nu, double inv_eps2, const T* g,
           int64_t g_sb, int64_t g_sr, int64_t B, int64_t n, void* stream) {
  if (B == 0) return 0;
  if (n < 1 || n > kMaxN || B > 0x7fffffff || nu < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T>();
  cudaError_t e = allow_smem(periodic_solve2d_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  periodic_solve2d_kernel<T><<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
      b, b_sb, b_sr, out, o_sb, o_sr, H, lam, shift, (int)nu, (T)inv_eps2, g, g_sb, g_sr,
      (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_periodic_solve2d_f64(const double* b, int64_t b_sb, int64_t b_sr, double* out,
                            int64_t o_sb, int64_t o_sr, const double* H, const double* lam,
                            const double* shift, int64_t nu, double inv_eps2, const double* g,
                            int64_t g_sb, int64_t g_sr, int64_t B, int64_t n, void* stream) {
  return launch<double>(b, b_sb, b_sr, out, o_sb, o_sr, H, lam, shift, nu, inv_eps2, g, g_sb,
                        g_sr, B, n, stream);
}

int pm_periodic_solve2d_f32(const float* b, int64_t b_sb, int64_t b_sr, float* out,
                            int64_t o_sb, int64_t o_sr, const float* H, const float* lam,
                            const float* shift, int64_t nu, double inv_eps2, const float* g,
                            int64_t g_sb, int64_t g_sr, int64_t B, int64_t n, void* stream) {
  return launch<float>(b, b_sb, b_sr, out, o_sb, o_sr, H, lam, shift, nu, inv_eps2, g, g_sb,
                       g_sr, B, n, stream);
}

}  // extern "C"
