// The float64 one-tile core of K5 sine_solve2d on Hopper's FP64 tensor
// cores: the two-sided products Sx X Sy of (r x c) interior states with
// r, c <= 128, each state held in shared memory by one block from its load
// to its store (float32 keeps the FFMA core of sine2d.cuh: the tensor
// cores have no full-float32 product, and TF32 is not used).
//
// Layout.  A state lives in a T x T tile of shared memory, T the side
// rounded up to 16, 32, 64 or 128, with leading dimension T + 4 (as
// dmma_tile.cuh pads: a warp's fragment reads hit distinct banks); it is
// copied in by cp.async with zeros outside r x c.  Every product is a right
// product M S of the tile M by a symmetric basis S, as in sine2d.cuh: X Sy
// is stored transposed into the same tile, and (X Sy)^T Sx = (Sx X Sy)^T,
// stored transposed again, is Sx X Sy; so one tile a state suffices, and
// the accumulators of a product stay in registers until every warp has
// read the tile.  The divide by 1 + shift_b Lam is applied to the
// accumulators of the second product, before its store; the ring and g go
// in with the final store.
//
// Products.  Each warp owns a WT x WT block of one state's product (32 x 32,
// or the whole state below 32) as m16n8 fragments of
// mma.sync.aligned.m16n8k4.row.col.f64:
// the A fragments are read from the state's tile, the B fragments from the
// basis, which every block shares (L2-resident): it streams through a ring
// of kStages slots of kBK rows, filled by cp.async (16-byte copies where
// the basis's rows allow, else 8), the copies of slab i + kStages - 1 in
// flight while the warps multiply slab i; the ring runs on from one
// product into the next.  Rows and columns of a basis past its side are
// zero-filled, so the zeros around a state stay zeros (for finite data).
//
// Small sides.  A block holds SPB states: one at T = 128 (16 warps), two at
// 64 (8 warps, two blocks an SM), eight at 32 and at 16 (8 warps, one
// warp a state), so that the 63^2, 31^2 and 15^2 interiors of the spatial
// and ragged hierarchies keep every warp busy and share one ring of the
// basis.
//
// Instructions.  What bounds the kernel is not the tensor cores (on an
// H100, with the DMMA replaced by an FMA it kept most of its time), so
// every copy and store indexes with constant powers of two: a runtime
// division a copy was a large share of what remained.
//
// Sides past 128 (band_product below) stream the state too: one product a
// launch, through device memory.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "dmma_tile.cuh"

namespace sine2d_dmma {

constexpr int kBK = 16;       // basis rows a ring slot holds
constexpr int kStages = 3;    // ring slots

// per tile side T: a warp's square block (WT), states a block (SPB),
// blocks an SM by registers.  (Tried on an H100 at phase 3's shapes: 8
// warps of 64 x 32 at T = 128, one or four states a block at T = 64, two
// or four at T = 32, two or four k4 steps unrolled, slabs of 32 basis rows
// in two ring slots, and loading the states slab by slab with the first
// product's ring were each as fast or slower; the last three spilled at
// 128 registers.)
template <int T>
struct Cfg {
  static constexpr int WT = T < 32 ? T : 32;
  static constexpr int TPS = (T / WT) * (T / WT);       // warp blocks a state
  static constexpr int SPB = T == 128 ? 1 : T == 64 ? 2 : 8;
  static constexpr int kWarps = SPB * TPS;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMinBlocks = T == 128 ? 1 : T == 16 ? 4 : 2;
  static constexpr int LD = T + 4;
  static constexpr int KT = T / kBK;                    // ring slabs a product
  static constexpr size_t smem_bytes() {
    return sizeof(double) * (size_t)(SPB * T + kStages * kBK) * LD;
  }
};

struct Params {
  const double* b;            // B states (batch stride b_sb, row stride b_sr)
  double* out;                // (r x c), or (r+2 x c+2) with the ring
  const double* Sx;           // (r x r)
  const double* Sy;           // (c x c)
  const double* lam;          // (r x c) or null: the transform
  const double* shift;        // (B,) or null: shift0
  const double* ring;         // (r+2 x c+2) or null
  const double* g;            // out's shape, or null
  int64_t b_sb, b_sr, o_sb, o_sr, g_sb, g_sr;
  int64_t B;
  double shift0;
  int r, c;
  int cx, cy;                 // elements a cp.async copies of Sx's, Sy's rows (1 or 2)
};

// copy slab kt of basis S (n x n) into a ring slot (kBK x T, leading dim
// LD), CHUNK elements a cp.async: every index a constant power of two, so
// that a copy costs a few integer instructions
template <int T, int CHUNK>
__device__ __forceinline__ void copy_slab(double* slot, const double* __restrict__ S, int n,
                                          int kt) {
  using C = Cfg<T>;
  constexpr int PER_ROW = T / CHUNK, TOTAL = kBK * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < TOTAL; i0 += C::kThreads) {
    const int i = i0 + threadIdx.x;
    if (TOTAL % C::kThreads == 0 || i < TOTAL) {
      const int row = i / PER_ROW;
      const int col = (i % PER_ROW) * CHUNK;
      const int k = kt * kBK + row;
      const bool ok = k < n && col < n;
      pm_tile::cp_async(slot + row * C::LD + col, ok ? S + (int64_t)k * n + col : S, 8 * CHUNK,
                        ok ? 8 * CHUNK : 0);
    }
  }
}

template <int T>
__global__ void __launch_bounds__(Cfg<T>::kThreads, Cfg<T>::kMinBlocks)
    sine_solve2d_dmma_kernel(const Params p) {
  using C = Cfg<T>;
  constexpr int LD = C::LD, WT = C::WT, FM = WT / 16, FN = WT / 8, KT = C::KT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* tiles = reinterpret_cast<double*>(smem_raw);  // SPB x T x LD
  double* ring = tiles + C::SPB * T * LD;               // kStages x kBK x LD
  const int nprod = p.lam != nullptr ? 4 : 2;
  const int items = nprod * KT;
  const int64_t z0 = (int64_t)blockIdx.x * C::SPB;

  // the states (zeros outside r x c, and for states past B), then the
  // first slabs of the basis: products alternate Sy (even) and Sx (odd)
  for (int i = threadIdx.x; i < C::SPB * T * T; i += C::kThreads) {
    const int st = i / (T * T);
    const int rem = i - st * T * T;
    const int row = rem / T, col = rem % T;
    const int64_t z = z0 + st;
    const bool ok = z < p.B && row < p.r && col < p.c;
    pm_tile::cp_async(tiles + (st * T + row) * LD + col,
                      ok ? p.b + z * p.b_sb + row * p.b_sr + col : p.b, 8, ok ? 8 : 0);
  }
  auto load = [&](int q) {
    const int prod = q / KT;
    double* slot = ring + (q % kStages) * kBK * LD;
    const double* S = prod & 1 ? p.Sx : p.Sy;
    const int n = prod & 1 ? p.r : p.c;
    if ((prod & 1 ? p.cx : p.cy) == 2)
      copy_slab<T, 2>(slot, S, n, q - prod * KT);
    else
      copy_slab<T, 1>(slot, S, n, q - prod * KT);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) load(s);
    pm_tile::cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int st = warp / C::TPS;
  const int wb = warp - st * C::TPS;
  const int m0 = (wb / (T / WT)) * WT, n0 = (wb % (T / WT)) * WT;
  double* M = tiles + st * T * LD;
  const int64_t z = z0 + st;
  const double sh = p.shift != nullptr && z < p.B ? p.shift[z] : p.shift0;

  double acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.0;

  for (int q = 0; q < items; ++q) {
    pm_tile::cp_async_wait<kStages - 2>();   // this thread's copies of slab q have landed
    __syncthreads();                         // everyone's, and slab q - 1's slot is free
    if (q + kStages - 1 < items) load(q + kStages - 1);
    pm_tile::cp_async_commit();
    const double* slab = ring + (q % kStages) * kBK * LD;
    const int kt = q % KT;
    // one k4 step at a time: the accumulators leave no registers for more
    // fragments in flight
#pragma unroll 1
    for (int ks = 0; ks < kBK; ks += 4) {
      const int k = kt * kBK + ks + t;
      double a[FM][2], bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        a[i][0] = M[(m0 + 16 * i + g) * LD + k];
        a[i][1] = M[(m0 + 16 * i + 8 + g) * LD + k];
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) bf[j] = slab[(ks + t) * LD + n0 + 8 * j + g];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) pm_tile::dmma(acc[i][j], a[i][0], a[i][1], bf[j]);
    }
    if (kt == KT - 1) {
      // a product is done: once every warp has read the tile, store the
      // product transposed into it (after the second product of a solve,
      // divided by 1 + shift Lam: element (m, n) of (Sx X Sy)^T is (n, m)
      // of Sx X Sy), and start the next from zero
      __syncthreads();
      const bool divide = p.lam != nullptr && q / KT == 1;
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int m = m0 + 16 * i + 8 * (h >> 1) + g;
            const int n = n0 + 8 * j + 2 * t + (h & 1);
            double v = acc[i][j][h];
            if (divide && m < p.c && n < p.r)
              v = v / __dadd_rn(1.0, __dmul_rn(sh, p.lam[n * p.c + m]));
            M[n * LD + m] = v;
            acc[i][j][h] = 0.0;
          }
    }
  }
  pm_tile::cp_async_wait<0>();
  __syncthreads();

  // the states' (r x c) results into out, with the ring and g: a warp a
  // row, a lane a column (coalesced, no division)
  const bool has_ring = p.ring != nullptr;
  const int P = has_ring ? p.r + 2 : p.r;
  const int Q = has_ring ? p.c + 2 : p.c;
  const int off = has_ring ? 1 : 0;
  for (int s = 0; s < C::SPB; ++s) {
    const int64_t zs = z0 + s;
    if (zs >= p.B) break;
    const double* tile = tiles + s * T * LD;
    double* o = p.out + zs * p.o_sb;
    const double* gs = p.g != nullptr ? p.g + zs * p.g_sb : nullptr;
    for (int row = warp; row < P; row += C::kWarps) {
      const int ii = row - off;
      const bool inner_row = ii >= 0 && ii < p.r;
      for (int col = lane; col < Q; col += 32) {
        const int jj = col - off;
        double v = inner_row && jj >= 0 && jj < p.c ? tile[ii * LD + jj] : p.ring[row * Q + col];
        if (gs != nullptr) v = gs[row * p.g_sr + col] + v;
        o[row * p.o_sr + col] = v;
      }
    }
  }
}

// Launch the one-tile kernel of side T for every state (r, c <= T).
template <int T>
cudaError_t run(const Params& p, cudaStream_t stream) {
  using C = Cfg<T>;
  auto kernel = sine_solve2d_dmma_kernel<T>;
  // opt in to the ring and tiles' shared memory once a device
  static bool given[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !given[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::smem_bytes());
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    if (dev < 32) given[dev] = true;
  }
  const int64_t blocks = (p.B + C::SPB - 1) / C::SPB;
  kernel<<<(unsigned)blocks, C::kThreads, C::smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}

// The side's tile: 16, 32, 64 or 128 (r, c <= 128).
inline cudaError_t solve(const Params& p, cudaStream_t stream) {
  const int n = p.r > p.c ? p.r : p.c;
  if (n <= 16) return run<16>(p, stream);
  if (n <= 32) return run<32>(p, stream);
  if (n <= 64) return run<64>(p, stream);
  return run<128>(p, stream);
}

// ---------------------------------------------------------------------------
// States past the one-tile side: one product a launch, through device memory.
//
// band_product computes, for every state z of a chunk, the right product
// A_z S of an (R x K) state A_z (rows at any stride) by a basis S (K x N,
// rows at s_ld) and writes it transposed, dst_z[n][m] = (A_z S)[m][n]
// (divided by 1 + shift_z Lam[n][m] after the second product of a solve;
// plus g at the same place after the last), so that four launches chain as
// the one-tile kernel's four products do.  A block of 16 warps owns a
// 64 x 256 block of one state's product (a warp 32 x 32, the one-tile
// kernel's fragments) and walks K in slabs of kBK through a ring of
// kBandStages slots holding a slab of A (64 x kBK) and one of S (kBK x 256):
// at a 255^2 state that is 1.25 copies a thread a slab against 32 DMMA a
// warp.  Copies are 16 bytes where the rows allow (the wrapper's workspace
// and basis copies have even rows), with zeros past R, K and N.

constexpr int kBandRows = 64, kBandCols = 256, kBandStages = 4, kBandThreads = 512;
constexpr int kBandLDA = kBK + 4, kBandLDS = kBandCols + 4;
constexpr int kBandSlot = kBandRows * kBandLDA + kBK * kBandLDS;   // doubles a ring slot

struct BandArgs {
  const double* a;            // state 0 of the chunk: A_z[m][k] = a[z a_sb + m a_sr + k]
  int64_t a_sb, a_sr;
  const double* s;            // S[k][n] = s[k s_ld + n]
  int64_t s_ld;
  double* dst;                // dst[z d_sb + n d_sr + m]
  int64_t d_sb, d_sr;
  const double* g;            // plus g[z g_sb + n g_sr + m], or null
  int64_t g_sb, g_sr;
  const double* lam;          // divide by 1 + sh lam[n lam_ld + m], or null
  int64_t lam_ld;
  const double* shift;        // sh = shift[z], or shift0
  double shift0;
  int R, K, N;
  int ca, cs;                 // elements a copy of A's and of S's rows (1 or 2)
};

template <int CHUNK>
__device__ __forceinline__ void band_copy_a(double* sa, const BandArgs& p, const double* A,
                                            int m0, int k0) {
  constexpr int PER_ROW = kBK / CHUNK, TOTAL = kBandRows * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < TOTAL; i0 += kBandThreads) {
    const int i = i0 + threadIdx.x;
    const int row = i / PER_ROW, col = (i % PER_ROW) * CHUNK;
    const int m = m0 + row, k = k0 + col;
    const int v = m < p.R && k < p.K ? (p.K - k < CHUNK ? p.K - k : CHUNK) : 0;
    pm_tile::cp_async(sa + row * kBandLDA + col, v ? A + (int64_t)m * p.a_sr + k : p.a,
                      8 * CHUNK, 8 * v);
  }
}

template <int CHUNK>
__device__ __forceinline__ void band_copy_s(double* ss, const BandArgs& p, int n0, int k0) {
  constexpr int PER_ROW = kBandCols / CHUNK, TOTAL = kBK * PER_ROW;
#pragma unroll
  for (int i0 = 0; i0 < TOTAL; i0 += kBandThreads) {
    const int i = i0 + threadIdx.x;
    const int row = i / PER_ROW, col = (i % PER_ROW) * CHUNK;
    const int k = k0 + row, n = n0 + col;
    const int v = k < p.K && n < p.N ? (p.N - n < CHUNK ? p.N - n : CHUNK) : 0;
    pm_tile::cp_async(ss + row * kBandLDS + col, v ? p.s + (int64_t)k * p.s_ld + n : p.s,
                      8 * CHUNK, 8 * v);
  }
}

__global__ void __launch_bounds__(kBandThreads, 1) band_product(const BandArgs p) {
  constexpr int FM = 2, FN = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const int64_t z = blockIdx.y;
  const int m0 = blockIdx.x * kBandRows, n0 = blockIdx.z * kBandCols;
  const double* A = p.a + z * p.a_sb;
  const int KT = (p.K + kBK - 1) / kBK;
  auto load = [&](int kt) {
    double* sa = smem + (kt % kBandStages) * kBandSlot;
    if (p.ca == 2)
      band_copy_a<2>(sa, p, A, m0, kt * kBK);
    else
      band_copy_a<1>(sa, p, A, m0, kt * kBK);
    if (p.cs == 2)
      band_copy_s<2>(sa + kBandRows * kBandLDA, p, n0, kt * kBK);
    else
      band_copy_s<1>(sa + kBandRows * kBandLDA, p, n0, kt * kBK);
  };
#pragma unroll
  for (int s = 0; s < kBandStages - 1; ++s) {
    if (s < KT) load(s);
    pm_tile::cp_async_commit();
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / (kBandCols / 32)) * 32, wn = (warp % (kBandCols / 32)) * 32;
  double acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[i][j][h] = 0.0;
  for (int kt = 0; kt < KT; ++kt) {
    pm_tile::cp_async_wait<kBandStages - 2>();
    __syncthreads();
    if (kt + kBandStages - 1 < KT) load(kt + kBandStages - 1);
    pm_tile::cp_async_commit();
    const double* sa = smem + (kt % kBandStages) * kBandSlot;
    const double* ss = sa + kBandRows * kBandLDA;
#pragma unroll 1
    for (int ks = 0; ks < kBK; ks += 4) {
      double a[FM][2], bf[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        a[i][0] = sa[(wm + 16 * i + g) * kBandLDA + ks + t];
        a[i][1] = sa[(wm + 16 * i + 8 + g) * kBandLDA + ks + t];
      }
#pragma unroll
      for (int j = 0; j < FN; ++j) bf[j] = ss[(ks + t) * kBandLDS + wn + 8 * j + g];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) pm_tile::dmma(acc[i][j], a[i][0], a[i][1], bf[j]);
    }
  }
  pm_tile::cp_async_wait<0>();
  const double sh = p.shift != nullptr ? p.shift[z] : p.shift0;
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int m = m0 + wm + 16 * i + 8 * (h >> 1) + g;
        const int n = n0 + wn + 8 * j + 2 * t + (h & 1);
        if (m >= p.R || n >= p.N) continue;
        double v = acc[i][j][h];
        if (p.lam != nullptr) v = v / __dadd_rn(1.0, __dmul_rn(sh, p.lam[n * p.lam_ld + m]));
        if (p.g != nullptr) v = p.g[z * p.g_sb + n * p.g_sr + m] + v;
        p.dst[z * p.d_sb + n * p.d_sr + m] = v;
      }
}

// One band product over nb states.
inline cudaError_t band(const BandArgs& p, int64_t nb, cudaStream_t stream) {
  constexpr size_t smem = sizeof(double) * kBandStages * kBandSlot;
  static bool given[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || !given[dev]) {
    err = cudaFuncSetAttribute(band_product, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(band_product, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 100);
    if (err != cudaSuccess) return err;
    if (dev < 32) given[dev] = true;
  }
  const dim3 grid((unsigned)((p.R + kBandRows - 1) / kBandRows), (unsigned)nb,
                  (unsigned)((p.N + kBandCols - 1) / kBandCols));
  band_product<<<grid, kBandThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace sine2d_dmma
