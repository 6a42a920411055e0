// K10 periodic_solve2d: the batched diagonal solve of the periodic heat
// operator, one (n x n) state of one species of one lane per block,
//   x = (I - s_bc L)^-1 b = H ((H b H) / (1 + s_bc Lam)) H,  s_bc = dt_b coef_c
// with L the periodic 5-point Laplacian, H the normalised Hartley matrix
// H[j, k] = (cos + sin)(2 pi j k / n) / sqrt(n) (real, symmetric,
// orthogonal; it diagonalises L because L's eigenvalues are even in k) and
// Lam = -(lam_k + lam_l) >= 0 the negated eigenvalue sums.  A lane holds S
// species (strides b_sb, b_ss, b_sr: a chain's slice out[:, k] of a
// (J, L, S, n, n) tube is no (J S, n, n) batch of one stride), each with its
// own coefficient (Gray-Scott (du, dv), Burgers (nu, nu), Allen-Cahn one
// species with 1).  Optional prologue: b is the state and the block first
// forms the IMEX right-hand side, so one IMEX step is one launch: Allen-Cahn
//   u + dt ((u / eps^2) (1 - u^nu)),
// or Gray-Scott, where the block of species c reads both species at each
// point:  u + dt (-u v^2 + a (1 - u))  (c = 0),  v + dt (u v^2 - b v)  (c = 1).
// Optional epilogue: out = g + x (the coarse-level F-relaxation's
// x <- g + Phi(x)).
//
// Replaces: pymgrit_tpu/models/allen_cahn.py AllenCahn._fft_solve (the
// complex dense-DFT products  real(F^-1 (F b F^T / (1 - s Lam)) F^-T)) and
// the IMEX branch of AllenCahn.step; gray_scott_2d.py
// GrayScott2D._fft_solve_diffusion and its IMEX step; burgers.py
// Burgers2D._fft_visc_solve.  It is also the preconditioner of the
// Newton-Krylov solves of Allen-Cahn (CG), Gray-Scott IMPL and Burgers 2D
// (BiCGStab) (ops/cg.py).
//
// Bound: FP64 operations.  A solve is four (n x n) products per state (n =
// 128: 16.8 MFLOP against 2 x 128 KB read and written).  Design: the shared
// core of K5 (sine2d.cuh): the state in shared memory, the partial products
// in registers, the basis read through L1/L2, the product loops the block's
// own (no library GEMM); the species of a lane are separate blocks.  The
// real Hartley route needs no complex arithmetic and no second buffer.
// n <= 128 (the tile); the wrapper raises above.  A radix-2 FFT in shared
// memory would do O(n^2 log n) work instead of O(n^3); it is left for a
// later change.

#include "sine2d.cuh"

namespace {

using namespace sine2d;

constexpr int kAllenCahn = 1;   // prologue modes (0: none)
constexpr int kGrayScott = 2;

template <typename T>
__device__ __forceinline__ T ipow(T x, int nu) {
  T p = x;
  for (int k = 1; k < nu; ++k) p = p * x;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    periodic_solve2d_kernel(const T* __restrict__ b, int64_t b_sb, int64_t b_ss, int64_t b_sr,
                            T* __restrict__ out, int64_t o_sb, int64_t o_ss, int64_t o_sr,
                            const T* __restrict__ H, const T* __restrict__ lam,
                            const T* __restrict__ shift, const T* __restrict__ coef, int S,
                            int mode, int nu, T p0, T p1, const T* __restrict__ g, int64_t g_sb,
                            int64_t g_ss, int64_t g_sr, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int64_t lane = blockIdx.x / S;
  const int sp = blockIdx.x - (int)(lane * S);
  const T dt = shift[lane];
  const T sh = coef != nullptr ? dt * coef[sp] : dt;
  clear_tile(M);
  __syncthreads();
  const T* src = b + lane * b_sb + sp * b_ss;
  const T* su = b + lane * b_sb;           // Gray-Scott: species 0 (u) ...
  const T* sv = su + b_ss;                 // ... and 1 (v) of the lane
  for (int idx = threadIdx.x; idx < n * n; idx += kThreads) {
    const int i = idx / n;
    const int j = idx - i * n;
    T v;
    if (mode == kGrayScott) {
      const T uu = su[i * b_sr + j];
      const T vv = sv[i * b_sr + j];
      const T uv2 = uu * (vv * vv);
      v = sp == 0 ? uu + dt * (-uv2 + p0 * (T(1) - uu)) : vv + dt * (uv2 - p1 * vv);
    } else {
      v = src[i * b_sr + j];
      if (mode == kAllenCahn) v = v + dt * ((p0 * v) * (T(1) - ipow(v, nu)));
    }
    M[i * kLd + j] = v;
  }
  __syncthreads();
  sandwich(M, n, n, H, H, lam, sh);
  sandwich(M, n, n, H, H, static_cast<const T*>(nullptr), T(0));
  store_state(M, n, n, out + lane * o_sb + sp * o_ss, o_sr, static_cast<const T*>(nullptr),
              g != nullptr ? g + lane * g_sb + sp * g_ss : nullptr, g_sr);
}

template <typename T>
int launch(const T* b, int64_t b_sb, int64_t b_ss, int64_t b_sr, T* out, int64_t o_sb,
           int64_t o_ss, int64_t o_sr, const T* H, const T* lam, const T* shift, const T* coef,
           int64_t S, int64_t mode, int64_t nu, double p0, double p1, const T* g, int64_t g_sb,
           int64_t g_ss, int64_t g_sr, int64_t B, int64_t n, void* stream) {
  if (B == 0) return 0;
  if (n < 1 || n > kMaxN || S < 1 || B * S > 0x7fffffff || nu < 0 || mode < 0 ||
      mode > kGrayScott || (mode == kGrayScott && S != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T>();
  cudaError_t e = allow_smem(periodic_solve2d_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  periodic_solve2d_kernel<T><<<(unsigned)(B * S), kThreads, smem, (cudaStream_t)stream>>>(
      b, b_sb, b_ss, b_sr, out, o_sb, o_ss, o_sr, H, lam, shift, coef, (int)S, (int)mode,
      (int)nu, (T)p0, (T)p1, g, g_sb, g_ss, g_sr, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_periodic_solve2d_f64(const double* b, int64_t b_sb, int64_t b_ss, int64_t b_sr,
                            double* out, int64_t o_sb, int64_t o_ss, int64_t o_sr,
                            const double* H, const double* lam, const double* shift,
                            const double* coef, int64_t S, int64_t mode, int64_t nu, double p0,
                            double p1, const double* g, int64_t g_sb, int64_t g_ss, int64_t g_sr,
                            int64_t B, int64_t n, void* stream) {
  return launch<double>(b, b_sb, b_ss, b_sr, out, o_sb, o_ss, o_sr, H, lam, shift, coef, S, mode,
                        nu, p0, p1, g, g_sb, g_ss, g_sr, B, n, stream);
}

int pm_periodic_solve2d_f32(const float* b, int64_t b_sb, int64_t b_ss, int64_t b_sr,
                            float* out, int64_t o_sb, int64_t o_ss, int64_t o_sr, const float* H,
                            const float* lam, const float* shift, const float* coef, int64_t S,
                            int64_t mode, int64_t nu, double p0, double p1, const float* g,
                            int64_t g_sb, int64_t g_ss, int64_t g_sr, int64_t B, int64_t n,
                            void* stream) {
  return launch<float>(b, b_sb, b_ss, b_sr, out, o_sb, o_ss, o_sr, H, lam, shift, coef, S, mode,
                       nu, p0, p1, g, g_sb, g_ss, g_sr, B, n, stream);
}

}  // extern "C"
