// K6 sine_affine2d: the physical-basis closed-form interval relaxation of
// J intervals, table rows r0 .. r0 + R - 1,
//   y[j, rr] = Sx (xhat_j * A[r0+rr] + G[r0+rr] [+ (dhat_j * dscale) * A[r0+rr-1]]) Sy
// with A[-1] = 1, written with its Dirichlet ring; the states of row 0 also
// copy seed j into seed_out when it is given (the C-row of the tube).
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.relax_interval, physical
// branch (:543-612: the back transform of A^k xhat + G_k, the `back` /
// `back_im` expressions, CN's ring correction delta * A^(k-1), the ring
// `.at[].set` chain and the chunked concat), and the physical side of
// pymgrit_tpu/core/solver.py Mgrit._cnd_materialize_expr.
//
// Bound: FP64 operations on the tensor cores (67 TFLOP/s).  Each output
// state is two (n x n) products, 4 n^3 operations (8.2 MFLOP at n = 127);
// the materialization of the TOMS tube is 512 x 31 of them (1.95 ms) and
// writes 2.18 GB (0.65 ms at 3.35 TB/s).  Design:
// * float64, sides <= 128: the one-tile DMMA kernel of K5
//   (sine2d_dmma.cuh one_tile) in its transform mode, with AffineIO below
//   as its load and store policies: the block forms its coefficient tile
//   in shared memory straight from xhat, the table rows and the
//   correction (plain loads in batches, every load of a batch issued
//   before any is used, after the basis's first slabs are in flight), so
//   no (rows, J, n, n) workspace is written; its store addresses the
//   output by interval, row and state-row strides (row-major,
//   interval-major and in-tube layouts with one kernel), writes the ring,
//   and copies the seeds from the blocks of row 0.  States are numbered
//   z = j R + rr, so a block of 2-8 states (sides <= 64) and neighbouring
//   blocks share interval j: xhat_j is read once from device memory, and
//   the A and G rows stay in the 50 MB L2.
// * float64, wider states (toms257: n = 255): K5's band kernel (16 warps a
//   64 x 256 block of a product, DMMA) in transform mode, a chunk of states
//   at a time: affine_tile writes the coefficient tiles into the workspace
//   (rows of even length, so the band copies move 16 bytes), one band
//   product by Sy, then one by Sx whose store splits the flat state index
//   into (j, rr) and writes the ring.
// * float32: the FFMA cores of sine2d.cuh (sides <= 128) and tiled2d.cuh
//   (wider), as K5's float32 path: the tensor cores have no full-float32
//   product, and TF32 is not used.
//
// Launch: one ctypes call with a packed int64 argument array that the
// wrapper caches with its checks (ops/heat_kernels.py::affine_pack) and
// fills with the call's pointers, and the stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "sine2d.cuh"
#include "sine2d_dmma.cuh"
#include "tiled2d.cuh"

namespace {

// The call's operands, as the packed argument array gives them: state
// (j, rr) of J x R (B = J R states) at out + j o_sj + rr o_sr, its rows at
// o_row; xhat's and dhat's rows j at j x_sj, j d_sj; table rows r0 .. r0 +
// R - 1 of A and G; seed_out[j] = seed[j] from the states of row 0.  cx,
// cy: the elements a cp.async copies of Sx's, Sy's rows (1 or 2; float64
// sides <= 128).  It is also the float64 one-tile kernel's parameter.
template <typename T>
struct Call {
  const T *xhat, *A, *G, *Sx, *Sy, *ring, *dhat, *dscale, *seed;
  T *out, *seed_out, *ws;
  int64_t x_sj, d_sj, o_sj, o_sr, o_row, s_sj, s_row, so_sj, so_row, r0, R, J, r, c, chunk, B;
  int cx, cy;
};

// ---------------------------------------------------------------------------
// float32, sides <= 128: one output state a block on the FFMA core
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(sine2d::kThreads, 1)
    sine_affine2d_kernel(const T* __restrict__ xhat, int64_t x_sj,
                         const T* __restrict__ A, const T* __restrict__ G, int64_t r0,
                         int64_t R, const T* __restrict__ dhat, int64_t d_sj,
                         const T* __restrict__ dscale, T* __restrict__ out, int64_t o_sj,
                         int64_t o_sr, int64_t o_row, const T* __restrict__ seed,
                         int64_t s_sj, int64_t s_row, T* __restrict__ seed_out,
                         int64_t so_sj, int64_t so_row, const T* __restrict__ Sx,
                         const T* __restrict__ Sy, const T* __restrict__ ring, int r,
                         int c) {
  using namespace sine2d;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int64_t j = blockIdx.x / R;
  const int64_t rr = blockIdx.x - j * R;
  const int64_t ra = r0 + rr;
  const int64_t N = (int64_t)r * c;
  const T* xh = xhat + j * x_sj;
  const T* a = A + ra * N;
  const T* gg = G + ra * N;
  const T* am1 = ra > 0 ? A + (ra - 1) * N : nullptr;
  const T* dh = dhat != nullptr ? dhat + j * d_sj : nullptr;
  clear_tile(M);
  __syncthreads();
  for (int idx = threadIdx.x; idx < r * c; idx += kThreads) {
    T v = xh[idx] * a[idx] + gg[idx];
    if (dh != nullptr) v = v + (dh[idx] * dscale[idx]) * (am1 != nullptr ? am1[idx] : T(1));
    const int i = idx / c;
    M[i * kLd + (idx - i * c)] = v;
  }
  __syncthreads();
  sandwich(M, r, c, Sx, Sy, static_cast<const T*>(nullptr), T(0));
  store_state(M, r, c, out + j * o_sj + rr * o_sr, o_row, ring, static_cast<const T*>(nullptr),
              0);
  if (seed_out != nullptr && rr == 0) {
    const int P = ring != nullptr ? r + 2 : r;
    const int Q = ring != nullptr ? c + 2 : c;
    for (int idx = threadIdx.x; idx < P * Q; idx += kThreads) {
      const int i = idx / Q;
      const int jj = idx - i * Q;
      seed_out[j * so_sj + i * so_row + jj] = seed[j * s_sj + i * s_row + jj];
    }
  }
}

// ---------------------------------------------------------------------------
// sides > 128: the coefficient tiles through the workspace
// ---------------------------------------------------------------------------

// The coefficient tile of flat state b0 + blockIdx.x (interval j, table row
// rr) into w + blockIdx.x * r * ld, its rows at ld, kTileRows rows a block
// (blockIdx.y); the blocks of row 0 copy seed j into seed_out.  A warp a
// row, a lane a column.  (One block a whole state, 128 blocks of 8 warps
// at toms257's C-step, left the card's memory half idle: on an H100 the
// C-step took 0.48 ms against two band products' 0.31.)
constexpr int kTileRows = 32;

template <typename T>
__global__ void __launch_bounds__(256) affine_tile(const Call<T> a, T* __restrict__ w,
                                                   int64_t b0, int64_t ld) {
  const int r = (int)a.r, c = (int)a.c;
  const int64_t bg = b0 + blockIdx.x;
  const int64_t j = bg / a.R;
  const int64_t rr = bg - j * a.R;
  const int64_t ra = a.r0 + rr;
  const int64_t N = (int64_t)r * c;
  const T* __restrict__ xh = a.xhat + j * a.x_sj;
  const T* __restrict__ am = a.A + ra * N;
  const T* __restrict__ gg = a.G + ra * N;
  const T* __restrict__ am1 = ra > 0 ? a.A + (ra - 1) * N : nullptr;
  const T* __restrict__ dh = a.dhat != nullptr ? a.dhat + j * a.d_sj : nullptr;
  const T* __restrict__ ds = a.dscale;
  T* __restrict__ ws = w + (int64_t)blockIdx.x * r * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.y * kTileRows, i1 = i0 + kTileRows < r ? i0 + kTileRows : r;
  for (int i = i0 + warp; i < i1; i += 8) {
#pragma unroll 4
    for (int q = lane; q < c; q += 32) {
      const int64_t idx = (int64_t)i * c + q;
      T v = xh[idx] * am[idx] + gg[idx];
      if (dh != nullptr) v = v + (dh[idx] * ds[idx]) * (am1 != nullptr ? am1[idx] : T(1));
      ws[i * ld + q] = v;
    }
  }
  if (a.seed_out != nullptr && rr == 0 && blockIdx.y == 0) {
    const int P = a.ring != nullptr ? r + 2 : r;
    const int Q = a.ring != nullptr ? c + 2 : c;
    for (int i = warp; i < P; i += 8)
      for (int q = lane; q < Q; q += 32)
        a.seed_out[j * a.so_sj + i * a.so_row + q] = a.seed[j * a.s_sj + i * a.s_row + q];
  }
}

template <typename T>
cudaError_t coefficients(const Call<T>& a, T* w, int64_t b0, int64_t nb, int64_t ld,
                         cudaStream_t st) {
  const dim3 grid((unsigned)nb, (unsigned)((a.r + kTileRows - 1) / kTileRows));
  affine_tile<T><<<grid, 256, 0, st>>>(a, w, b0, ld);
  return cudaGetLastError();
}

// float32 past 128: tiled2d.cuh's two products through the workspace's two
// buffers of a chunk of (r x c) states, the ring after them.
cudaError_t ffma_tiled(const Call<float>& a, cudaStream_t st) {
  using T = float;
  if (a.ws == nullptr || a.chunk < 1) return cudaErrorInvalidValue;
  const int64_t rc = a.r * a.c;
  const int64_t total = a.B;
  for (int64_t b0 = 0; b0 < total; b0 += a.chunk) {
    const int64_t nb = total - b0 < a.chunk ? total - b0 : a.chunk;
    cudaError_t e = coefficients<T>(a, a.ws, b0, nb, a.c, st);
    tiled2d::Epilogue<T> last{};
    last.out = a.out;
    last.o_hi = a.o_sj;
    last.o_lo = a.o_sr;
    last.o_row = a.o_row;
    last.off = a.ring != nullptr ? 1 : 0;
    last.D = a.R;
    last.b0 = b0;
    if (e == cudaSuccess) {
      e = tiled2d::sandwich<T>({a.ws, rc, a.c}, (int)a.r, (int)a.c, a.Sx, a.Sy, a.ws,
                               a.ws + a.chunk * rc, nb, tiled2d::Epilogue<T>{}, last, false, st);
    }
    if (e == cudaSuccess && a.ring != nullptr) {
      e = tiled2d::ring<T>(a.ring, (int)a.r + 2, (int)a.c + 2, nb, last, st);
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

cudaError_t ffma(const Call<float>& a, cudaStream_t st) {
  if (a.r > sine2d::kMaxN || a.c > sine2d::kMaxN) return ffma_tiled(a, st);
  // the 129 KB tile: opt in once a device
  static bool given[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t smem = sine2d::smem_bytes<float>();
  if (dev >= 32 || !given[dev]) {
    e = sine2d::allow_smem(sine_affine2d_kernel<float>, smem);
    if (e != cudaSuccess) return e;
    if (dev < 32) given[dev] = true;
  }
  sine_affine2d_kernel<float><<<(unsigned)(a.J * a.R), sine2d::kThreads, smem, st>>>(
      a.xhat, a.x_sj, a.A, a.G, a.r0, a.R, a.dhat, a.d_sj, a.dscale, a.out, a.o_sj, a.o_sr,
      a.o_row, a.seed, a.s_sj, a.s_row, a.seed_out, a.so_sj, a.so_row, a.Sx, a.Sy, a.ring,
      (int)a.r, (int)a.c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float64 on the FP64 tensor cores
// ---------------------------------------------------------------------------

// K6's policies for sine2d_dmma::one_tile: the transform, the coefficient
// tile formed in place, the (interval, row) store with the ring and seeds.
struct AffineIO {
  using Params = Call<double>;
  static constexpr bool kSolve = false, kAsyncLoad = false;

  // state z = j R + rr of the block: tile = xhat_j A[ra] + G[ra]
  // (+ (dhat_j dscale) A[ra - 1], A[-1] = 1) inside r x c, zeros outside
  template <int T>
  static __device__ __forceinline__ void load(const Params& p, double* tiles, int64_t z0) {
    using C = sine2d_dmma::Cfg<T>;
    constexpr int LD = C::LD;
#pragma unroll 1
    for (int st = 0; st < C::SPB; ++st) {
      const int64_t z = z0 + st;
      double* tile = tiles + st * T * LD;
      if (z >= p.B) {
        for (int i = threadIdx.x; i < T * T; i += C::kThreads) tile[(i / T) * LD + i % T] = 0.0;
        continue;
      }
      const int64_t j = z / p.R;
      const int64_t ra = p.r0 + (z - j * p.R);
      const int64_t N = p.r * p.c;
      const double* xh = p.xhat + j * p.x_sj;
      const double* a = p.A + ra * N;
      const double* g = p.G + ra * N;
      if (p.dhat == nullptr) {
        form<T, false>(p, tile, xh, a, g, nullptr, nullptr);
      } else {
        form<T, true>(p, tile, xh, a, g, p.dhat + j * p.d_sj, ra > 0 ? p.A + (ra - 1) * N : nullptr);
      }
    }
  }

  // One state's coefficient tile.  A thread takes the tile's elements
  // kThreads apart (a constant: the tile's index is shifts and masks, the
  // tables' one multiply-add), U at a time: it loads every operand of the
  // U elements first, at an index clamped to 0 outside r x c, so that no
  // branch separates the loads and 3 U (BE) or 6 U (CN) of them are in
  // flight, then combines and stores them.  U = 8; 4 for CN below T = 128,
  // where 8 spilled at the 128 registers two blocks an SM allow.  (Tried on
  // an H100, C-step of 512 states, device ms: an element-by-element loop,
  // its loads under a branch, left the prologue 0.05 (BE) and 0.11 (CN)
  // over the transform's 0.17, latency-bound at a third of the SM's share
  // of L2 bandwidth; batches of 8 / 4 took BE to 0.19 and CN to 0.24, 16 /
  // 8 CN to 0.23, 4 / 2 no better than 8 / 4; starting each block at
  // another element, an unroll of 4-16 of the old loop, and prefetching
  // the next wave's xhat and dhat rows into L2 each moved it by 4 % or
  // less.)
  template <int T, bool CN>
  static __device__ __forceinline__ void form(const Params& p, double* tile, const double* xh,
                                              const double* a, const double* g,
                                              const double* dh, const double* am1) {
    using C = sine2d_dmma::Cfg<T>;
    constexpr int LD = C::LD, PER = T * T / C::kThreads;
    constexpr int UU = CN && T < 128 ? 4 : 8;
    constexpr int U = PER < UU ? PER : UU;
    static_assert(PER * C::kThreads == T * T && PER % U == 0,
                  "a tile's elements split evenly over the threads and the batches");
    const int r = (int)p.r, c = (int)p.c;
    const double* m1 = am1 != nullptr ? am1 : a;   // A[-1] = 1: loads a row, uses 1
    const bool first = am1 == nullptr;
#pragma unroll 1
    for (int k0 = 0; k0 < PER; k0 += U) {
      int idx[U], at[U];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = (k0 + u) * C::kThreads + threadIdx.x;
        const int row = i / T, col = i % T;
        ok[u] = row < r && col < c;
        idx[u] = ok[u] ? row * c + col : 0;
        at[u] = row * LD + col;
      }
      double x[U], av[U], gv[U], dv[CN ? U : 1], sv[CN ? U : 1], mv[CN ? U : 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        x[u] = __ldg(xh + idx[u]);
        av[u] = __ldg(a + idx[u]);
        gv[u] = __ldg(g + idx[u]);
        if constexpr (CN) {
          dv[u] = __ldg(dh + idx[u]);
          sv[u] = __ldg(p.dscale + idx[u]);
          mv[u] = __ldg(m1 + idx[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        double v = x[u] * av[u] + gv[u];
        if constexpr (CN) v = v + (dv[u] * sv[u]) * (first ? 1.0 : mv[u]);
        tile[at[u]] = ok[u] ? v : 0.0;
      }
    }
  }

  // the states' results into out at (j, rr) with the ring, then seed j
  // into seed_out from the state of row 0: a warp a row, a lane a column
  template <int T>
  static __device__ __forceinline__ void store(const Params& p, const double* tiles, int64_t z0,
                                               int warp, int lane) {
    using C = sine2d_dmma::Cfg<T>;
    constexpr int LD = C::LD;
    const int r = (int)p.r, c = (int)p.c;
    const bool has_ring = p.ring != nullptr;
    const int P = has_ring ? r + 2 : r;
    const int Q = has_ring ? c + 2 : c;
    const int off = has_ring ? 1 : 0;
    for (int s = 0; s < C::SPB; ++s) {
      const int64_t zs = z0 + s;
      if (zs >= p.B) break;
      const int64_t j = zs / p.R;
      const int64_t rr = zs - j * p.R;
      const double* tile = tiles + s * T * LD;
      double* o = p.out + j * p.o_sj + rr * p.o_sr;
      for (int row = warp; row < P; row += C::kWarps) {
        const int ii = row - off;
        const bool inner_row = ii >= 0 && ii < r;
        for (int col = lane; col < Q; col += 32) {
          const int jj = col - off;
          o[row * p.o_row + col] =
              inner_row && jj >= 0 && jj < c ? tile[ii * LD + jj] : p.ring[row * Q + col];
        }
      }
      if (p.seed_out != nullptr && rr == 0) {
        const double* sd = p.seed + j * p.s_sj;
        double* so = p.seed_out + j * p.so_sj;
        for (int row = warp; row < P; row += C::kWarps)
          for (int col = lane; col < Q; col += 32) so[row * p.so_row + col] = sd[row * p.s_row + col];
      }
    }
  }
};

template <int T>
__global__ void __launch_bounds__(sine2d_dmma::Cfg<T>::kThreads, sine2d_dmma::Cfg<T>::kMinBlocks)
    sine_affine2d_dmma_kernel(const Call<double> p) {
  sine2d_dmma::one_tile<T, AffineIO>(p);
}

// float64 past the one-tile side, per chunk of nb states, with W0 (nb x r x
// ldc) and W1 (nb x c x ldr) the workspace's buffers and sx, sy its copies
// of the bases (even rows, as K5's band_dmma lays them out):
//   W0 = the coefficient tiles (affine_tile),  W1 = (W0 Sy)^T,
//   out[j, rr] = (W1 Sx)^T = Sx W0 Sy with the ring (the split store).
cudaError_t band_dmma(const Call<double>& a, cudaStream_t st) {
  if (a.ws == nullptr || a.chunk < 1) return cudaErrorInvalidValue;
  const int64_t r = a.r, c = a.c, ldr = r + (r & 1), ldc = c + (c & 1);
  double* sx = a.ws;                          // (r x ldr)
  double* sy = sx + r * ldr;                  // (c x ldc)
  double* w1 = sy + c * ldc;                  // chunk x (c x ldr)
  double* w0 = w1 + a.chunk * c * ldr;        // chunk x (r x ldc)
  cudaError_t e = cudaMemcpy2DAsync(sx, ldr * sizeof(double), a.Sx, r * sizeof(double),
                                    r * sizeof(double), r, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess)
    e = cudaMemcpy2DAsync(sy, ldc * sizeof(double), a.Sy, c * sizeof(double),
                          c * sizeof(double), c, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  const int64_t total = a.B;
  for (int64_t b0 = 0; b0 < total; b0 += a.chunk) {
    const int64_t nb = total - b0 < a.chunk ? total - b0 : a.chunk;
    e = coefficients<double>(a, w0, b0, nb, ldc, st);
    if (e != cudaSuccess) return e;
    sine2d_dmma::BandArgs p1{};
    p1.a = w0;
    p1.a_sb = r * ldc;
    p1.a_sr = ldc;
    p1.R = (int)r;
    p1.K = (int)c;
    p1.ca = 2;
    p1.s = sy;
    p1.s_ld = ldc;
    p1.N = (int)c;
    p1.cs = 2;
    p1.dst = w1;
    p1.d_sb = c * ldr;
    p1.d_sr = ldr;
    sine2d_dmma::BandArgs p2{};
    p2.a = w1;
    p2.a_sb = c * ldr;
    p2.a_sr = ldr;
    p2.R = (int)c;
    p2.K = (int)r;
    p2.ca = 2;
    p2.s = sx;
    p2.s_ld = ldr;
    p2.N = (int)r;
    p2.cs = 2;
    p2.dst = a.out + (a.ring != nullptr ? a.o_row + 1 : 0);
    p2.d_sr = a.o_row;
    p2.b0 = b0;
    p2.D = a.R;
    p2.d_hi = a.o_sj;
    p2.d_lo = a.o_sr;
    p2.ring = a.ring;
    e = sine2d_dmma::band(p1, nb, st);
    if (e == cudaSuccess) e = sine2d_dmma::band<true>(p2, nb, st);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// float64: the DMMA one-tile kernel (sides <= 128), else the band products
cudaError_t dmma(const Call<double>& a, cudaStream_t st) {
  if (a.r > 128 || a.c > 128) return band_dmma(a, st);
  Call<double> p = a;
  // 16-byte copies of a basis's rows where its side is even and its
  // pointer 16-byte aligned
  p.cx = a.r % 2 == 0 && reinterpret_cast<uintptr_t>(a.Sx) % 16 == 0 ? 2 : 1;
  p.cy = a.c % 2 == 0 && reinterpret_cast<uintptr_t>(a.Sy) % 16 == 0 ? 2 : 1;
  const int64_t n = a.r > a.c ? a.r : a.c;
  using sine2d_dmma::run;
  if (n <= 16) return run<16>(sine_affine2d_dmma_kernel<16>, p, st);
  if (n <= 32) return run<32>(sine_affine2d_dmma_kernel<32>, p, st);
  if (n <= 64) return run<64>(sine_affine2d_dmma_kernel<64>, p, st);
  return run<128>(sine_affine2d_dmma_kernel<128>, p, st);
}

// args (int64): CUDA device, then the pointers xhat, A, G, out, Sx, Sy,
// ring, dhat, dscale, seed, seed_out, workspace (0: none), then xhat's and
// dhat's interval strides, out's interval, row and state-row strides,
// seed's and seed_out's interval and state-row strides, r0, R, J, r, c, the
// workspace's chunk of states (ops/heat_kernels.py::affine_pack)
template <typename T>
int launch(const int64_t* g, void* stream) {
  Call<T> a{};
  a.xhat = reinterpret_cast<const T*>(g[1]);
  a.A = reinterpret_cast<const T*>(g[2]);
  a.G = reinterpret_cast<const T*>(g[3]);
  a.out = reinterpret_cast<T*>(g[4]);
  a.Sx = reinterpret_cast<const T*>(g[5]);
  a.Sy = reinterpret_cast<const T*>(g[6]);
  a.ring = reinterpret_cast<const T*>(g[7]);
  a.dhat = reinterpret_cast<const T*>(g[8]);
  a.dscale = reinterpret_cast<const T*>(g[9]);
  a.seed = reinterpret_cast<const T*>(g[10]);
  a.seed_out = reinterpret_cast<T*>(g[11]);
  a.ws = reinterpret_cast<T*>(g[12]);
  a.x_sj = g[13];
  a.d_sj = g[14];
  a.o_sj = g[15];
  a.o_sr = g[16];
  a.o_row = g[17];
  a.s_sj = g[18];
  a.s_row = g[19];
  a.so_sj = g[20];
  a.so_row = g[21];
  a.r0 = g[22];
  a.R = g[23];
  a.J = g[24];
  a.r = g[25];
  a.c = g[26];
  a.chunk = g[27];
  a.B = a.J * a.R;
  if (a.J == 0 || a.R == 0) return 0;
  if (a.r < 1 || a.c < 1 || a.r > 0x7fffffff / a.c || a.J * a.R > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
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

int pm_sine_affine2d_f64(const int64_t* args, void* stream) { return launch<double>(args, stream); }

int pm_sine_affine2d_f32(const int64_t* args, void* stream) { return launch<float>(args, stream); }

}  // extern "C"
