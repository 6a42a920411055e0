// K10 periodic_solve2d: the batched diagonal solve of the periodic heat
// operator on B lanes of S species of (n x n) states,
//   x = (I - s_bc L)^-1 r = H ((H r H) / (1 + s_bc Lam)) H,  s_bc = dt_b coef_c
// with L the periodic 5-point Laplacian, H the normalised Hartley matrix
// H[j, k] = (cos + sin)(2 pi j k / n) / sqrt(n) (real, symmetric,
// orthogonal; it diagonalises L because L's eigenvalues are even in k) and
// Lam = -(lam_k + lam_l) >= 0 the negated eigenvalue sums.  A lane's
// species are addressed by (lane, species, row) strides (a chain's slice
// out[:, k] of a (J, L, S, n, n) tube is no (J S, n, n) batch of one
// stride), each with its own coefficient (Gray-Scott (du, dv), Burgers
// (nu, nu), Allen-Cahn one species with 1).  r is b, or the IMEX
// right-hand side formed from the state b as it is loaded, so one IMEX step
// is one call: Allen-Cahn (mode 1)
//   u + dt ((u / eps^2) (1 - u^nu)),
// or Gray-Scott (mode 2), where the state of species c reads both species
// of its lane at each point:
//   u + dt (-u v^2 + a (1 - u))  (c = 0),  v + dt (u v^2 - b v)  (c = 1).
// Optional epilogue: out = g + x (the coarse-level F-relaxation's
// x <- g + Phi(x)).
//
// Replaces: pymgrit_tpu/models/allen_cahn.py AllenCahn._fft_solve and the
// IMEX branch of AllenCahn.step (:82-88, 124-139); gray_scott_2d.py
// GrayScott2D._fft_solve_diffusion and its IMEX step (:83-114); burgers.py
// Burgers2D._fft_visc_solve (:117).  It is also the preconditioner of the
// Newton-Krylov solves of Allen-Cahn (CG), Gray-Scott IMPL and Burgers 2D
// (BiCGStab) (ops/cg.py).
//
// Bound: FP64 operations on the tensor cores (67 TFLOP/s).  A solve is four
// (n x n) products a state, 8 n^3 operations (16.8 MFLOP at n = 128)
// against 2 x 128 KB read and written: the Allen-Cahn IMEX step of 512
// states takes 0.13 ms, its bytes 0.04 ms.  Design:
// * float64, sides <= 128: K5's DMMA core (sine2d_dmma.cuh one_tile: the
//   states in shared memory from load to store, the four products on the
//   FP64 tensor cores, mma m16n8k4, the basis H streamed through a cp.async
//   ring, 1-8 states a block) with PeriodicIO below as its load, shift and
//   store policies: without a prologue the states come in by cp.async
//   ahead of the basis; the Allen-Cahn and Gray-Scott prologues form the
//   right-hand side in the tiles from plain loads, a batch of loads in
//   flight, after the basis's first slabs (K6's recipe); the divide's
//   shift is shift[lane] coef[species]; the store writes at the (lane,
//   species) address with g.  A block's states may be of different lanes
//   and species (n = 17: tiles of 32, eight states a block).
// * float64, wider states: the right-hand side (and a table of each
//   state's shift) into a workspace by a pass of its own (periodic_rhs),
//   then four launches of K5's band kernel (16 warps a 64 x 256 block of
//   one state's product, DMMA), the divide after the second through the
//   table (so the band kernel needs no species), g with the last, whose
//   store splits the flat state index into (lane, species).  The band
//   route would also split a state over blocks below the one-tile side,
//   which the Newton-Krylov preconditioner's small batches (B S = 8-16
//   states of 128^2: one block a state leaves most SMs idle) might want;
//   timed on an H100 at B S = 1-64 against one block a state, it lost at
//   every batch (0.091 against 0.073 ms device at B S = 8: five launches
//   and the workspace's round trips against one block's four products).
//   There is no crossover below, so the launcher takes it past 128 only.
// * float32: the FFMA cores of sine2d.cuh (sides <= 128) and tiled2d.cuh
//   (wider), as K5 and K6: the tensor cores have no full-float32 product,
//   and TF32 is not used.
// b, out and g are strided views of the level tubes, so no copy precedes
// or follows the kernel.  The products are the kernels' own: no library
// GEMM is called.  The products sum in DMMA's k4 groups, so K10 agrees
// with its plain version (four cuBLAS GEMMs) to rounding, not bitwise; a
// NaN anywhere in a state's input gives NaN in that state's output.
//
// Launch: one ctypes call with a packed int64 argument array that the
// wrapper caches with its checks (ops/periodic.py periodic_pack), the two
// prologue scalars by value, and the stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "sine2d.cuh"
#include "sine2d_dmma.cuh"
#include "tiled2d.cuh"

namespace {

constexpr int kAllenCahn = 1;   // prologue modes (0: none)
constexpr int kGrayScott = 2;

// The call's operands, as the packed argument array gives them.  States
// are numbered z = lane S + species; B counts them (lanes times S).  It is
// also the float64 one-tile kernel's parameter (the fields one_tile reads:
// B, Sx = Sy = H, r = c = n, cx = cy, lam).
template <typename T>
struct Call {
  const T *b, *Sx, *Sy, *lam, *shift, *coef, *g;
  T *out, *ws;
  int64_t b_sl, b_ss, b_sr, o_sl, o_ss, o_sr, g_sl, g_ss, g_sr;
  int64_t lanes, B, chunk;
  int S, mode, nu;
  int r, c, cx, cy;
  double p0, p1;              // Allen-Cahn: 1 / eps^2; Gray-Scott: a, b
};

template <typename T>
__device__ __forceinline__ T ipow(T x, int nu) {
  T p = x;
  for (int k = 1; k < nu; ++k) p = p * x;
  return p;
}

// The right-hand side of one point of species sp (the plain version's
// operations, each rounded once, in its order): Allen-Cahn from the state
// v, Gray-Scott from the lane's pair (v, w).
__device__ __forceinline__ double rhs_ac(double v, double dt, double p0, int nu) {
  double p = v;
  for (int k = 1; k < nu; ++k) p = __dmul_rn(p, v);
  return __dadd_rn(v, __dmul_rn(dt, __dmul_rn(__dmul_rn(p0, v), __dsub_rn(1.0, p))));
}

__device__ __forceinline__ double rhs_gs(double u, double v, int sp, double dt, double a,
                                         double b) {
  const double uv2 = __dmul_rn(u, __dmul_rn(v, v));
  if (sp == 0)
    return __dadd_rn(u, __dmul_rn(dt, __dadd_rn(-uv2, __dmul_rn(a, __dsub_rn(1.0, u)))));
  return __dadd_rn(v, __dmul_rn(dt, __dsub_rn(uv2, __dmul_rn(b, v))));
}

// ---------------------------------------------------------------------------
// float64, sides <= 128: sine2d_dmma.cuh's one-tile kernel
// ---------------------------------------------------------------------------

// K10's policies for sine2d_dmma::one_tile: a solve whose states are
// (lane, species) views; ASYNC (no prologue): the states by cp.async,
// else the IMEX right-hand side formed from plain loads.
template <bool ASYNC>
struct PeriodicIO {
  using Params = Call<double>;
  static constexpr bool kSolve = true, kAsyncLoad = ASYNC;

  // shift[lane] coef[species] (plain: dt * coef)
  static __device__ __forceinline__ double shift(const Params& p, int64_t z) {
    if (z >= p.B) return 0.0;
    const int64_t lane = z / p.S;
    const double dt = p.shift[lane];
    return p.coef != nullptr ? __dmul_rn(dt, p.coef[z - lane * p.S]) : dt;
  }

  template <int T>
  static __device__ __forceinline__ void load(const Params& p, double* tiles, int64_t z0) {
    using C = sine2d_dmma::Cfg<T>;
    constexpr int LD = C::LD, PER = T * T / C::kThreads;
    static_assert(PER * C::kThreads == T * T, "a tile's elements split evenly over the threads");
#pragma unroll 1
    for (int st = 0; st < C::SPB; ++st) {
      const int64_t z = z0 + st;
      const bool live = z < p.B;
      const int64_t lane = live ? z / p.S : 0;
      const int sp = (int)(z - lane * p.S);
      double* tile = tiles + st * T * LD;
      if constexpr (ASYNC) {
        const double* src = p.b + lane * p.b_sl + sp * p.b_ss;
#pragma unroll 4
        for (int k = 0; k < PER; ++k) {
          const int i = k * C::kThreads + threadIdx.x;
          const int row = i / T, col = i % T;
          const bool ok = live && row < p.r && col < p.c;
          pm_tile::cp_async(tile + row * LD + col, ok ? src + row * p.b_sr + col : p.b, 8,
                            ok ? 8 : 0);
        }
      } else if (!live) {
        for (int i = threadIdx.x; i < T * T; i += C::kThreads) tile[(i / T) * LD + i % T] = 0.0;
      } else if (p.mode == kGrayScott) {
        form<T, true>(p, tile, p.b + lane * p.b_sl, sp, p.shift[lane]);
      } else {
        form<T, false>(p, tile, p.b + lane * p.b_sl + sp * p.b_ss, sp, p.shift[lane]);
      }
    }
  }

  // One state's right-hand side tile, zeros outside n x n.  A thread takes
  // the tile's elements kThreads apart, U at a time: it loads every operand
  // of the U elements first (at an index clamped to 0 outside the state),
  // so that U (Gray-Scott: 2 U) loads are in flight, then forms and stores
  // them (K6's AffineIO::form).  src: the state (Gray-Scott: the lane's
  // species 0, species 1 at src + b_ss).
  template <int T, bool GS>
  static __device__ __forceinline__ void form(const Params& p, double* tile, const double* src,
                                              int sp, double dt) {
    using C = sine2d_dmma::Cfg<T>;
    constexpr int LD = C::LD, PER = T * T / C::kThreads;
    constexpr int U = PER < 8 ? PER : 8;
    static_assert(PER % U == 0, "the batches split a thread's elements evenly");
    const int n = p.r;
#pragma unroll 1
    for (int k0 = 0; k0 < PER; k0 += U) {
      int64_t idx[U];
      int at[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = (k0 + u) * C::kThreads + threadIdx.x;
        const int row = i / T, col = i % T;
        ok[u] = row < n && col < n;
        idx[u] = ok[u] ? row * p.b_sr + col : 0;
        at[u] = row * LD + col;
      }
      double x[U], y[GS ? U : 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[u] = __ldg(src + idx[u]);
        if constexpr (GS) y[u] = __ldg(src + p.b_ss + idx[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        double v;
        if constexpr (GS)
          v = rhs_gs(x[u], y[u], sp, dt, p.p0, p.p1);
        else
          v = rhs_ac(x[u], dt, p.p0, p.nu);
        tile[at[u]] = ok[u] ? v : 0.0;
      }
    }
  }

  // the states' results into out at (lane, species), plus g: a warp a row,
  // a lane a column
  template <int T>
  static __device__ __forceinline__ void store(const Params& p, const double* tiles, int64_t z0,
                                               int warp, int lane_id) {
    using C = sine2d_dmma::Cfg<T>;
    constexpr int LD = C::LD;
    for (int s = 0; s < C::SPB; ++s) {
      const int64_t zs = z0 + s;
      if (zs >= p.B) break;
      const int64_t ln = zs / p.S;
      const int64_t sp = zs - ln * p.S;
      const double* tile = tiles + s * T * LD;
      double* o = p.out + ln * p.o_sl + sp * p.o_ss;
      const double* gs = p.g != nullptr ? p.g + ln * p.g_sl + sp * p.g_ss : nullptr;
      for (int row = warp; row < p.r; row += C::kWarps) {
        for (int col = lane_id; col < p.c; col += 32) {
          double v = tile[row * LD + col];
          if (gs != nullptr) v = gs[row * p.g_sr + col] + v;
          o[row * p.o_sr + col] = v;
        }
      }
    }
  }
};

template <int T, bool ASYNC>
__global__ void __launch_bounds__(sine2d_dmma::Cfg<T>::kThreads, sine2d_dmma::Cfg<T>::kMinBlocks)
    periodic_solve2d_dmma_kernel(const Call<double> p) {
  sine2d_dmma::one_tile<T, PeriodicIO<ASYNC>>(p);
}

template <bool ASYNC>
cudaError_t tile_route(const Call<double>& p, cudaStream_t st) {
  using sine2d_dmma::run;
  using IO = PeriodicIO<ASYNC>;   // (each kernel its own shared-memory opt-in)
  if (p.r <= 16) return run<16, Call<double>, IO>(periodic_solve2d_dmma_kernel<16, ASYNC>, p, st);
  if (p.r <= 32) return run<32, Call<double>, IO>(periodic_solve2d_dmma_kernel<32, ASYNC>, p, st);
  if (p.r <= 64) return run<64, Call<double>, IO>(periodic_solve2d_dmma_kernel<64, ASYNC>, p, st);
  return run<128, Call<double>, IO>(periodic_solve2d_dmma_kernel<128, ASYNC>, p, st);
}

// ---------------------------------------------------------------------------
// float64 through the workspace: the right-hand side pass, then the band
// products
// ---------------------------------------------------------------------------

constexpr int kRhsRows = 32;    // rows a block of the right-hand side pass

// The right-hand side of state b0 + blockIdx.x (prologue MODE) into w +
// blockIdx.x n ld (rows at ld), kRhsRows rows a block (blockIdx.y); the
// blocks of row band 0 write the state's shift into tab[blockIdx.x].  A warp
// a row, a lane a column.
template <int MODE>
__global__ void __launch_bounds__(256) periodic_rhs(const Call<double> p, double* __restrict__ w,
                                                    double* __restrict__ tab, int64_t b0,
                                                    int64_t ld) {
  const int64_t z = b0 + blockIdx.x;
  const int64_t lane = z / p.S;
  const int sp = (int)(z - lane * p.S);
  const double dt = p.shift[lane];
  if (blockIdx.y == 0 && threadIdx.x == 0)
    tab[blockIdx.x] = p.coef != nullptr ? __dmul_rn(dt, p.coef[sp]) : dt;
  const double* __restrict__ src = p.b + lane * p.b_sl + (MODE == kGrayScott ? 0 : sp * p.b_ss);
  double* __restrict__ dst = w + (int64_t)blockIdx.x * p.r * ld;
  const int n = p.r;
  const int warp = threadIdx.x / 32, col0 = threadIdx.x % 32;
  const int i0 = blockIdx.y * kRhsRows, i1 = i0 + kRhsRows < n ? i0 + kRhsRows : n;
  for (int i = i0 + warp; i < i1; i += 8) {
    for (int q = col0; q < n; q += 32) {
      const double x = src[i * p.b_sr + q];
      double v = x;
      if constexpr (MODE == kGrayScott)
        v = rhs_gs(x, src[p.b_ss + i * p.b_sr + q], sp, dt, p.p0, p.p1);
      else if constexpr (MODE == kAllenCahn)
        v = rhs_ac(x, dt, p.p0, p.nu);
      dst[i * ld + q] = v;
    }
  }
}

// per chunk of nb states, with W0 and W1 (nb x n x ld) the workspace's
// buffers, h the basis (or its copy with rows of even length ld) and tab
// the chunk's shifts:
//   W0 = r (periodic_rhs),  W1 = (W0 H)^T,  W0 = ((W1 H)^T) / (1 + tab Lam),
//   W1 = (W0 H)^T,  out = [g +] (W1 H)^T = H W0 H  (split (lane, species))
cudaError_t band_route(const Call<double>& a, cudaStream_t st) {
  if (a.ws == nullptr || a.chunk < 1) return cudaErrorInvalidValue;
  const int64_t n = a.r, ld = n + (n & 1), nn = n * ld;
  double* hc = a.ws;                          // (n x ld)
  double* w1 = hc + nn;                       // chunk x (n x ld)
  double* w0 = w1 + a.chunk * nn;             // chunk x (n x ld)
  double* tab = w0 + a.chunk * nn;            // chunk
  // 16-byte copies of the basis's rows: H itself where its rows allow
  const double* h = a.Sx;
  if (ld != n || reinterpret_cast<uintptr_t>(a.Sx) % 16 != 0) {
    const cudaError_t e = cudaMemcpy2DAsync(hc, ld * sizeof(double), a.Sx, n * sizeof(double),
                                            n * sizeof(double), n, cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return e;
    h = hc;
  }
  // a right product of the chunk's states (rows at ld) by the basis
  auto right = [&](const double* A, double* dst) {
    sine2d_dmma::BandArgs p{};
    p.a = A;
    p.a_sb = nn;
    p.a_sr = ld;
    p.R = (int)n;
    p.K = (int)n;
    p.ca = 2;
    p.s = h;
    p.s_ld = ld;
    p.N = (int)n;
    p.cs = 2;
    p.dst = dst;
    p.d_sb = nn;
    p.d_sr = ld;
    return p;
  };
  for (int64_t b0 = 0; b0 < a.B; b0 += a.chunk) {
    const int64_t nb = a.B - b0 < a.chunk ? a.B - b0 : a.chunk;
    const dim3 grid((unsigned)nb, (unsigned)((n + kRhsRows - 1) / kRhsRows));
    if (a.mode == kGrayScott)
      periodic_rhs<kGrayScott><<<grid, 256, 0, st>>>(a, w0, tab, b0, ld);
    else if (a.mode == kAllenCahn)
      periodic_rhs<kAllenCahn><<<grid, 256, 0, st>>>(a, w0, tab, b0, ld);
    else
      periodic_rhs<0><<<grid, 256, 0, st>>>(a, w0, tab, b0, ld);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    sine2d_dmma::BandArgs p2 = right(w1, w0);
    p2.lam = a.lam;
    p2.lam_ld = n;
    p2.shift = tab;
    sine2d_dmma::BandArgs p4 = right(w1, a.out);
    p4.b0 = b0;
    p4.D = a.S;
    p4.d_hi = a.o_sl;
    p4.d_lo = a.o_ss;
    p4.d_sr = a.o_sr;
    if (a.g != nullptr) {
      p4.g = a.g;
      p4.g_hi = a.g_sl;
      p4.g_lo = a.g_ss;
      p4.g_sr = a.g_sr;
    }
    e = sine2d_dmma::band(right(w0, w1), nb, st);
    if (e == cudaSuccess) e = sine2d_dmma::band(p2, nb, st);
    if (e == cudaSuccess) e = sine2d_dmma::band(right(w0, w1), nb, st);
    if (e == cudaSuccess) e = sine2d_dmma::band<true>(p4, nb, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t dmma(Call<double>& a, cudaStream_t st) {
  if (a.r > 128) return band_route(a, st);
  // 16-byte copies of the basis's rows where its side is even and its
  // pointer 16-byte aligned
  a.cx = a.cy = a.r % 2 == 0 && reinterpret_cast<uintptr_t>(a.Sx) % 16 == 0 ? 2 : 1;
  return a.mode == 0 ? tile_route<true>(a, st) : tile_route<false>(a, st);
}

// ---------------------------------------------------------------------------
// float32: the FFMA cores
// ---------------------------------------------------------------------------

using namespace sine2d;

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

cudaError_t ffma(const Call<float>& a, cudaStream_t st) {
  using T = float;
  const int n = a.r;
  if (n > kMaxN) {
    // tiled2d.cuh's four products through the workspace's two buffers of a
    // chunk of states, the right-hand side first
    if (a.ws == nullptr || a.chunk < 1) return cudaErrorInvalidValue;
    const int64_t nn = (int64_t)n * n;
    for (int64_t b0 = 0; b0 < a.B; b0 += a.chunk) {
      const int64_t nb = a.B - b0 < a.chunk ? a.B - b0 : a.chunk;
      rhs_tile<T><<<(unsigned)nb, 256, 0, st>>>(a.b, a.b_sl, a.b_ss, a.b_sr, a.shift, a.S, a.mode,
                                                 a.nu, (T)a.p0, (T)a.p1, a.ws, b0, n);
      cudaError_t e = cudaGetLastError();
      tiled2d::Epilogue<T> div{};
      div.lam = a.lam;
      div.shift = a.shift;
      div.coef = a.coef;
      div.D = a.S;
      div.b0 = b0;
      tiled2d::Epilogue<T> last{};
      last.out = a.out;
      last.o_hi = a.o_sl;
      last.o_lo = a.o_ss;
      last.o_row = a.o_sr;
      last.g = a.g;
      last.g_hi = a.g_sl;
      last.g_lo = a.g_ss;
      last.g_row = a.g_sr;
      last.D = a.S;
      last.b0 = b0;
      if (e == cudaSuccess) {
        e = tiled2d::sandwich<T>({a.ws, nn, n}, n, n, a.Sx, a.Sx, a.ws, a.ws + a.chunk * nn, nb,
                                 div, last, true, st);
      }
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
  // the 129 KB tile: opt in once a device
  static bool given[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t smem = smem_bytes<T>();
  if (dev >= 32 || !given[dev]) {
    e = allow_smem(periodic_solve2d_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    if (dev < 32) given[dev] = true;
  }
  periodic_solve2d_kernel<T><<<(unsigned)a.B, kThreads, smem, st>>>(
      a.b, a.b_sl, a.b_ss, a.b_sr, a.out, a.o_sl, a.o_ss, a.o_sr, a.Sx, a.lam, a.shift, a.coef,
      a.S, a.mode, a.nu, (T)a.p0, (T)a.p1, a.g, a.g_sl, a.g_ss, a.g_sr, n);
  return cudaGetLastError();
}

// args (int64): CUDA device, then the pointers b, out, H, lam, shift, coef,
// g (0: none), workspace (0: none), b's, out's and g's lane, species and
// row strides, the lanes, S, n, the prologue mode (0 none, 1 Allen-Cahn, 2
// Gray-Scott), nu, the workspace's chunk of states (0 up to a side of 128)
// (ops/periodic.py::periodic_pack)
template <typename T>
int launch(const int64_t* g, double p0, double p1, void* stream) {
  Call<T> a{};
  a.b = reinterpret_cast<const T*>(g[1]);
  a.out = reinterpret_cast<T*>(g[2]);
  a.Sx = a.Sy = reinterpret_cast<const T*>(g[3]);
  a.lam = reinterpret_cast<const T*>(g[4]);
  a.shift = reinterpret_cast<const T*>(g[5]);
  a.coef = reinterpret_cast<const T*>(g[6]);
  a.g = reinterpret_cast<const T*>(g[7]);
  a.ws = reinterpret_cast<T*>(g[8]);
  a.b_sl = g[9];
  a.b_ss = g[10];
  a.b_sr = g[11];
  a.o_sl = g[12];
  a.o_ss = g[13];
  a.o_sr = g[14];
  a.g_sl = g[15];
  a.g_ss = g[16];
  a.g_sr = g[17];
  a.lanes = g[18];
  const int64_t S = g[19], n = g[20], mode = g[21], nu = g[22];
  a.chunk = g[23];
  a.p0 = p0;
  a.p1 = p1;
  if (a.lanes == 0) return 0;
  if (n < 1 || n > 46340 || S < 1 || a.lanes > 0x7fffffff / S || nu < 0 || nu > 64 ||
      mode < 0 || mode > kGrayScott || (mode == kGrayScott && S != 2))
    return (int)cudaErrorInvalidValue;
  a.S = (int)S;
  a.B = a.lanes * S;
  a.r = a.c = (int)n;
  a.mode = (int)mode;
  a.nu = (int)nu;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)g[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (sizeof(T) == 8)
    e = dmma(a, st);
  else
    e = ffma(a, st);
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_periodic_solve2d_f64(const int64_t* args, double p0, double p1, void* stream) {
  return launch<double>(args, p0, p1, stream);
}

int pm_periodic_solve2d_f32(const int64_t* args, double p0, double p1, void* stream) {
  return launch<float>(args, p0, p1, stream);
}

}  // extern "C"
