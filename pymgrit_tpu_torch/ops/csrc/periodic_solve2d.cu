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
// Sides above 128 (the one-tile core's limit) take the tiled path of
// tiled2d.cuh: the right-hand side and the four products through a device
// workspace, a chunk of states at a time.  A radix-2 FFT in shared memory
// would do O(n^2 log n) work instead of O(n^3); it is left for a later
// change.

#include "sine2d.cuh"
#include "tiled2d.cuh"

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

// Tiled path: the right-hand side of flat state b0 + blockIdx.x (lane,
// species) into the workspace, as the kernel above forms it.
template <typename T>
__global__ void rhs_tile(const T* __restrict__ b, int64_t b_sb, int64_t b_ss, int64_t b_sr,
                         const T* __restrict__ shift, int S, int mode, int nu, T p0, T p1,
                         T* __restrict__ w, int64_t b0, int n) {
  const int64_t bg = b0 + blockIdx.x;
  const int64_t lane = bg / S;
  const int sp = (int)(bg - lane * S);
  const T dt = shift[lane];
  const T* src = b + lane * b_sb + sp * b_ss;
  const T* su = b + lane * b_sb;
  const T* sv = su + b_ss;
  T* dst = w + (int64_t)blockIdx.x * n * n;
  for (int idx = threadIdx.x; idx < n * n; idx += blockDim.x) {
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
    dst[idx] = v;
  }
}

template <typename T>
int launch_tiled(const T* b, int64_t b_sb, int64_t b_ss, int64_t b_sr, T* out, int64_t o_sb,
                 int64_t o_ss, int64_t o_sr, const T* H, const T* lam, const T* shift,
                 const T* coef, int64_t S, int mode, int nu, T p0, T p1, const T* g, int64_t g_sb,
                 int64_t g_ss, int64_t g_sr, T* ws, int64_t chunk, int64_t B, int n,
                 cudaStream_t st) {
  if (ws == nullptr || chunk < 1) return (int)cudaErrorInvalidValue;
  const int64_t nn = (int64_t)n * n;
  const int64_t total = B * S;
  for (int64_t b0 = 0; b0 < total; b0 += chunk) {
    const int64_t nb = total - b0 < chunk ? total - b0 : chunk;
    rhs_tile<T><<<(unsigned)nb, 256, 0, st>>>(b, b_sb, b_ss, b_sr, shift, (int)S, mode, nu, p0, p1,
                                               ws, b0, n);
    cudaError_t e = cudaGetLastError();
    tiled2d::Epilogue<T> div{};
    div.lam = lam;
    div.shift = shift;
    div.coef = coef;
    div.D = S;
    div.b0 = b0;
    tiled2d::Epilogue<T> last{};
    last.out = out;
    last.o_hi = o_sb;
    last.o_lo = o_ss;
    last.o_row = o_sr;
    last.g = g;
    last.g_hi = g_sb;
    last.g_lo = g_ss;
    last.g_row = g_sr;
    last.D = S;
    last.b0 = b0;
    if (e == cudaSuccess) {
      e = tiled2d::sandwich<T>({ws, nn, n}, n, n, H, H, ws, ws + chunk * nn, nb, div, last, true,
                               st);
    }
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch(const T* b, int64_t b_sb, int64_t b_ss, int64_t b_sr, T* out, int64_t o_sb,
           int64_t o_ss, int64_t o_sr, const T* H, const T* lam, const T* shift, const T* coef,
           int64_t S, int64_t mode, int64_t nu, double p0, double p1, const T* g, int64_t g_sb,
           int64_t g_ss, int64_t g_sr, T* ws, int64_t chunk, int64_t B, int64_t n,
           void* stream) {
  if (B == 0) return 0;
  if (n < 1 || n > 46340 || S < 1 || B * S > 0x7fffffff || nu < 0 || mode < 0 ||
      mode > kGrayScott || (mode == kGrayScott && S != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n > kMaxN) {
    return launch_tiled<T>(b, b_sb, b_ss, b_sr, out, o_sb, o_ss, o_sr, H, lam, shift, coef, S,
                           (int)mode, (int)nu, (T)p0, (T)p1, g, g_sb, g_ss, g_sr, ws, chunk, B,
                           (int)n, (cudaStream_t)stream);
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
                            double* ws, int64_t chunk, int64_t B, int64_t n, void* stream) {
  return launch<double>(b, b_sb, b_ss, b_sr, out, o_sb, o_ss, o_sr, H, lam, shift, coef, S, mode,
                        nu, p0, p1, g, g_sb, g_ss, g_sr, ws, chunk, B, n, stream);
}

int pm_periodic_solve2d_f32(const float* b, int64_t b_sb, int64_t b_ss, int64_t b_sr,
                            float* out, int64_t o_sb, int64_t o_ss, int64_t o_sr, const float* H,
                            const float* lam, const float* shift, const float* coef, int64_t S,
                            int64_t mode, int64_t nu, double p0, double p1, const float* g,
                            int64_t g_sb, int64_t g_ss, int64_t g_sr, float* ws, int64_t chunk,
                            int64_t B, int64_t n, void* stream) {
  return launch<float>(b, b_sb, b_ss, b_sr, out, o_sb, o_ss, o_sr, H, lam, shift, coef, S, mode,
                       nu, p0, p1, g, g_sb, g_ss, g_sr, ws, chunk, B, n, stream);
}

}  // extern "C"
