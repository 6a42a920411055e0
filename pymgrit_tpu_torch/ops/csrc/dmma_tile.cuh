// The FP64 product tile shared by K20 sine_solve1d, K22 eig_step and K26
// dd_matmul:
//
//   C[z][m][n] = sum_k A[z][m][k] B[z][n][k]          (B given as B^T, N x K)
//
// over strided operands, on Hopper's FP64 tensor cores
// (mma.sync.aligned.m16n8k4.row.col.f64, which reaches the FP64 tensor-core
// peak where m8n8k4 reaches half of it: product_sweep.py times both),
// or on the CUDA cores' FFMA for the float32 instantiations of K20 and K22
// (never TF32).
//
// Design (the host picks every parameter; ops/product_tile.py::product_plan):
// - A block of 128 threads (4 warps) owns a BM x BN output tile and walks its
//   slice of the inner index in k-tiles of BK through a ring of STAGES slots
//   in dynamic shared memory, filled by cp.async (16-byte cp.async.cg where
//   every row of the operand is 16-byte aligned, 8- or 4-byte cp.async.ca
//   otherwise) with commit_group / wait_group: the copies of k-tile
//   i + STAGES - 1 are in flight while the warps multiply k-tile i, one
//   __syncthreads a k-tile.
// - Two regimes, one kernel: 64 x 8 ("skinny": few lanes, the product
//   streams its table once and is bound by its bytes; the host puts the
//   long axis on M, so zero lanes are neither staged nor multiplied beyond
//   the 8-wide fragment) and 64 x 64 ("wide"; K20's with k-tiles of 32,
//   compiled for two blocks an SM).
// - Split-K: blockIdx.y picks a slice of `kps` k-tiles.  With more than one
//   slice every block writes its float64 (K22 float32: float32) partial tile
//   into a workspace, and reduce_slices sums the slices in order 0 .. S - 1
//   (no atomics: a call repeats bit for bit) and applies the epilogue; with
//   one slice the product kernel applies it.
// - A batch (K26) longer than one wave of blocks is walked: blockIdx.z takes
//   entries z, z + gridDim.z, ... and the ring runs on from one entry into
//   the next.  A DD output tile goes out through shared memory, hi then lo,
//   so that consecutive threads store consecutive elements of a row (stored
//   from the fragments, every warp instruction would half-fill 8 sectors).
// - Operands: a value (float64 or float32) or a double-double pair (hi, lo
//   float32, staged side by side through the same ring); each operand is
//   addressed by element strides (batch, row, inner index; 0 broadcasts)
//   and stages along its unit-stride axis: K-major smem [mn][k] when the
//   inner index is contiguous, MN-major [k][mn] when the rows are, element
//   by element otherwise.  A DD value is formed as the exact
//   __dadd_rn((double)hi, (double)lo) when a fragment is read from shared
//   memory.  Rows, columns and inner indices past the edge are zero-filled
//   by the copy (src-size < cp-size) and never written.
// - Shared-memory rows are padded (K-major: BK + 4; MN-major: extent + 4
//   doubles, or + 8 floats where the extent is a multiple of 16) so that a
//   warp's fragment reads hit distinct banks.
// - K20's lanes (the LANES template argument, kPlain for K22 and K26): the
//   B operand is B lane rows.  On the skinny tile K20's right-hand side is
//   formed as it is staged (kBe: x + dt r; kBdf2: (r - c2 x) + c1 x2,
//   per-lane dt, c2, c1): each component rides the ring in its own tile of
//   the slot, every component with the same copy width, so that a thread
//   copies the same elements of each; once its own copies of a k-tile have
//   landed, the thread forms those elements in the x tile, rounding each
//   operation once in the plain version's order, before the k-tile's
//   barrier (on the wide tile K20's launcher forms it in a first pass).
//   K20's epilogue (finish_lanes, LaneOut): the tile through shared memory,
//   a warp a lane; lane b = hi D + lo stored at hi s_hi + lo sc
//   (relax_interval's (interval, row) layouts); the divisor 1 + dt lam
//   (BE) or lam + shift (BDF2); a split's partials [slice][lane][row],
//   summed by reduce_lanes.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>


namespace pm_tile {

constexpr int kThreads = 128;


struct Operand {
  const void* p0;         // values, or DD hi
  const void* p1;         // DD lo (null otherwise)
  int64_t sb, smn, sk;    // element strides: batch, row (the M or N axis), inner index
  int64_t extent;         // rows (M or N)
  int chunk;              // elements one cp.async copies along the unit-stride axis
};

struct Epilogue {
  void* c0;               // output values, or DD hi
  void* c1;               // DD lo
  int64_t sb, sr, sc;     // output element strides of the kernel's (batch, row, column)
  const void* dt;         // the scale 1 / (1 + dt lam) (K20's BE, K22), or null
  const void* lam;
  int64_t dt_r, dt_c, lam_r, lam_c;   // dt[r dt_r + c dt_c], lam[r lam_r + c lam_c]
  // K20 (LaneOut): the scale 1 / (lam + shift) (BDF2); column (lane) c =
  // hi D + lo goes to hi s_hi + lo sc; dt and shift by lane, lam by row
  const void* shift;
  int64_t D, s_hi;
};

// K20's right-hand side, formed from B's components as they are staged
enum Lanes : int {
  kPlain = 0,             // K22, K26: B as it is, the plain store
  kRows = 1,              // K20: B as it is, the (hi, lo) store
  kBe = 2,                // K20: x + dt r
  kBdf2 = 3,              // K20: (r - c2 x) + c1 x2
};

struct Args {
  Operand a, b;           // A (M x K) and B^T (N x K); with LANES >= kBe, B's x
  Operand r, x2;          // K20: B's other components (r; x2 with kBdf2)
  const void* cf0;        // K20: per-lane dt (kBe) or c2 (kBdf2), indexed by B's row
  const void* cf1;        // K20: per-lane c1 (kBdf2)
  int64_t batch, M, N, K;
  int64_t kps;            // k-tiles a slice
  int splits;
  void* ws;               // splits x batch x M x N partials (splits > 1)
  Epilogue epi;
  // K20's small solve (one k-tile, one M tile, no split): the block divides
  // its tile by epi's divisor into shared memory and multiplies it by the
  // same S tile again, storing through epi2 (fused_product below)
  bool fused;
  Epilogue epi2;
};

// components of B staged in a slot
__host__ __device__ constexpr int lane_comps(int lanes) {
  return lanes == kBdf2 ? 3 : lanes == kBe ? 2 : 1;
}

struct Plan {
  int bm, bn, bk, stages, splits;
  int64_t kps;
  int zblocks;            // blocks walking the batch (gridDim.z)
};

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

// ---------------------------------------------------------------------------
// shared-memory layout (the host computes the same sizes)

__host__ __device__ constexpr bool kmajor(int64_t smn, int64_t sk) { return sk == 1 || smn != 1; }

template <typename E>
__host__ __device__ constexpr int ld_mn(int extent) {
  return sizeof(E) == 8 ? extent + 4 : (extent % 16 == 0 ? extent + 8 : extent);
}

// elements of one component of one operand's tile in one slot
template <typename E, int BK>
__host__ __device__ constexpr int tile_elems(int extent, bool km) {
  return km ? extent * (BK + 4) : BK * ld_mn<E>(extent);
}

// ---------------------------------------------------------------------------
// cp.async

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b for one m16n8k4 f64 fragment: a0 = A[g][t], a1 = A[g + 8][t],
// b = B[t][g] (= B^T[g][t]), d = C[g][2t], C[g][2t + 1], C[g + 8][2t],
// C[g + 8][2t + 1], with g = lane / 4, t = lane % 4
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// The copies one thread makes of one operand's tile, set up once a block:
// the tile is OUTER x INNER elements (K-major: rows x BK, MN-major: BK x
// rows), copied in chunks of o.chunk elements along INNER, thread tid
// taking chunk tid % per of lines tid / per, tid / per + 128 / per, ...
// (per = INNER / chunk, a power of two dividing 128), so that a k-tile
// costs each copy two additions and a compare.  The operand's own fields
// stay in kernel-parameter space; only what differs by thread is held here.
template <typename E, bool kPair, int EXT, int BK>
struct Stager {
  const E* g;             // the thread's first source at z = 0, k = 0 (DD: hi)
  int64_t gstep;          // source elements between its copies
  int64_t first;          // K-major: its first row; MN-major: its first k within a tile
  int so, n, inner, fixed;  // smem offset, copies a tile, inner offset; MN-major: valid elements
  int step;               // lines between its copies

  __device__ __forceinline__ static bool km(const Operand& o) { return kmajor(o.smn, o.sk); }
  __device__ __forceinline__ static int ld(bool k) { return k ? BK + 4 : ld_mn<E>(EXT); }
  __host__ __device__ static constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

  // (every count here is a power of two: shifts, not divisions)
  __device__ __forceinline__ void init(const Operand& o, int64_t mn0) {
    const bool k = km(o);
    const int lc = __ffs(o.chunk) - 1;                   // chunk = 2^lc
    const int lp = (k ? ilog2(BK) : ilog2(EXT)) - lc;    // per = (k ? BK : EXT) / chunk = 2^lp
    step = kThreads >> lp;
    const int outer0 = threadIdx.x >> lp, outer_len = k ? EXT : BK;
    inner = (threadIdx.x & ((1 << lp) - 1)) << lc;
    n = outer0 < outer_len ? (outer_len - outer0 + step - 1) >> (ilog2(kThreads) - lp) : 0;
    so = outer0 * ld(k) + inner;
    int64_t off;
    if (k) {
      first = mn0 + outer0;
      off = first * o.smn + inner * o.sk;
      gstep = step * o.smn;
      fixed = 0;
    } else {
      first = outer0;
      off = (mn0 + inner) * o.smn + outer0 * o.sk;
      gstep = step * o.sk;
      const int64_t left = o.extent - (mn0 + inner);
      fixed = left <= 0 ? 0 : (left < o.chunk ? (int)left : o.chunk);
    }
    g = static_cast<const E*>(o.p0) + off;
  }

  // copy inner indices k0 .. k0 + BK - 1 (< kend) of batch entry z into a slot
  __device__ __forceinline__ void copy(const Operand& o, int64_t z, E* s0, E* s1, int64_t k0,
                                       int64_t kend) const {
    const bool k = km(o);
    const int cw = o.chunk, bytes = cw * (int)sizeof(E);
    const int sstep = step * ld(k);
    const E* z0 = static_cast<const E*>(o.p0) + z * o.sb;     // aligned: zero-filled copies
    const int64_t dlo = kPair ? static_cast<const E*>(o.p1) - static_cast<const E*>(o.p0) : 0;
    int64_t off = z * o.sb + k0 * o.sk;
    int64_t line = k ? first : k0 + first;
    int kv = fixed;
    if (k) {
      const int64_t left = kend - (k0 + inner);
      kv = left <= 0 ? 0 : (left < cw ? (int)left : cw);
    }
    for (int i = 0; i < n; ++i, line += step, off += gstep) {
      const int v = (k ? line < o.extent : line < kend) ? kv : 0;
      const E* src = v ? g + off : z0;
      cp_async(s0 + so + i * sstep, src, bytes, v * (int)sizeof(E));
      if (kPair) cp_async(s1 + so + i * sstep, src + dlo, bytes, v * (int)sizeof(E));
    }
  }

  // K20: form the right-hand side in the x tile s from the thread's own
  // copies of k-tile k0 (K-major lanes: the copies of every component sit
  // at the same offsets, tile tb elements apart), with the lanes'
  // coefficients cf (cf[0][row], cf[1][row]: rows of this block's tile)
  template <int LANES>
  __device__ __forceinline__ void form(const Operand& o, E* s, int tb, int64_t k0, int64_t kend,
                                       E (*cf)[EXT], int64_t mn0) const {
    const int cw = o.chunk, sstep = step * (BK + 4);
    const int64_t left = kend - (k0 + inner);
    const int kv = left <= 0 ? 0 : (left < cw ? (int)left : cw);
    int64_t line = first;
    for (int i = 0; i < n; ++i, line += step) {
      if (line >= o.extent) break;
      const int row = (int)(line - mn0);
      E* x = s + so + i * sstep;
      for (int e = 0; e < kv; ++e) {
        if constexpr (LANES == kBe)
          x[e] = add_rn(x[e], mul_rn(cf[0][row], x[tb + e]));
        else
          x[e] = add_rn(sub_rn(x[tb + e], mul_rn(cf[0][row], x[e])),
                        mul_rn(cf[1][row], x[2 * tb + e]));
      }
    }
  }
};

template <typename E, bool kPair>
__device__ __forceinline__ auto value(const E* s0, const E* s1, int off) {
  if constexpr (kPair)
    return __dadd_rn((double)s0[off], (double)s1[off]);
  else
    return s0[off];
}

template <typename Acc, bool kPairOut>
__device__ __forceinline__ void emit(const Epilogue& e, int64_t z, int64_t r, int64_t c, Acc v) {
  const int64_t o = z * e.sb + r * e.sr + c * e.sc;
  if constexpr (kPairOut) {
    // the DD split of the float64 sum: hi = fl32(v), lo = fl32(v - hi)
    const float hi = __double2float_rn(v);
    static_cast<float*>(e.c0)[o] = hi;
    static_cast<float*>(e.c1)[o] = __double2float_rn(__dsub_rn(v, (double)hi));
  } else {
    if (e.dt != nullptr) {
      const Acc* dt = static_cast<const Acc*>(e.dt);
      const Acc* lam = static_cast<const Acc*>(e.lam);
      v = v / add_rn(Acc(1), mul_rn(dt[r * e.dt_r + c * e.dt_c], lam[r * e.lam_r + c * e.lam_c]));
    }
    static_cast<Acc*>(e.c0)[o] = v;
  }
}

// K20's epilogue (one batch entry): the accumulator tile goes out through
// shared memory (st, the ring's memory, free after the k-loop), a warp a
// lane with its rows (S's row index, the output rows' unit stride) over the
// warp's threads, so that the stores run as one short loop and not as
// copies of emit unrolled for every fragment (those made a one-block
// product several times slower); a split's partials go out alike,
// [slice][lane][row] (reduce_lanes sums them).
// K20: lane b's divisor terms (rows from m0 on): of(r, v) = v / (1 + dt_b
// lam_r), v / (lam_r + shift_b) or v, each operation rounded once as the
// plain version rounds it.
template <typename Acc>
struct Divisor {
  const Acc* lam;
  const Acc *dt, *shift;
  Acc db;
  __device__ __forceinline__ Divisor(const Epilogue& e, int64_t b, int64_t m0) {
    lam = e.lam != nullptr ? static_cast<const Acc*>(e.lam) + m0 : nullptr;
    dt = static_cast<const Acc*>(e.dt);
    shift = static_cast<const Acc*>(e.shift);
    db = dt != nullptr ? dt[b] : shift != nullptr ? shift[b] : Acc(0);
  }
  __device__ __forceinline__ Acc of(int64_t r, Acc v) const {
    if (dt != nullptr) return v / add_rn(Acc(1), mul_rn(db, lam[r]));
    if (shift != nullptr) return v / add_rn(lam[r], db);
    return v;
  }
};

// K20: lane b's output row (entries from row m0 on): put(r, v) stores v
// divided as Divisor says.
template <typename Acc>
struct LaneOut {
  Acc* out;
  int64_t sr;
  Divisor<Acc> div;
  __device__ __forceinline__ LaneOut(const Epilogue& e, int64_t b, int64_t m0) : div(e, b, m0) {
    const int64_t hi = e.D == 1 ? b : (int64_t)((uint64_t)b / (uint64_t)e.D);
    out = static_cast<Acc*>(e.c0) + hi * e.s_hi + (b - hi * e.D) * e.sc + m0 * e.sr;
    sr = e.sr;
  }
  __device__ __forceinline__ void put(int64_t r, Acc v) const { out[r * sr] = div.of(r, v); }
};

template <typename Acc, int BM, int BN, int FM, int FN>
__device__ __forceinline__ void finish_lanes(const Args& p, const Epilogue& epi,
                                             const Acc (&acc)[FM][FN][4], Acc* st, int64_t m0,
                                             int64_t n0, int wm, int wn, int g, int t) {
  constexpr int LD = BM + 1;                  // st[c * LD + r]: column c (lane), row r
  // what the stores read, in registers: a store through the output pointer
  // cannot then make the compiler read them again from the parameters
  const Epilogue e = epi;
  const int64_t M = p.M, N = p.N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = (int)(M - m0 < BM ? M - m0 : BM), cols = (int)(N - n0 < BN ? N - n0 : BN);
  __syncthreads();                            // every warp is done with the ring
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int h = 0; h < 4; ++h)
        st[(wn + 8 * j + 2 * t + (h & 1)) * LD + wm + 16 * i + 8 * (h >> 1) + g] = acc[i][j][h];
  __syncthreads();
  // a warp a lane (column), its rows over the warp's threads
  if (p.splits > 1) {
    Acc* ws = static_cast<Acc*>(p.ws) + blockIdx.y * M * N;    // [slice][lane][row]
    for (int c = warp; c < cols; c += kThreads / 32)
      for (int r = lane; r < rows; r += 32) ws[(n0 + c) * M + m0 + r] = st[c * LD + r];
    return;
  }
  for (int c = warp; c < cols; c += kThreads / 32) {
    const LaneOut<Acc> o(e, n0 + c, m0);
    for (int r = lane; r < rows; r += 32) o.put(r, st[c * LD + r]);
  }
}

// K20's split products: the slices' partials ([slice][lane][row]) summed
// in order 0 .. S - 1 (reduce_slices' order and rounding), then the
// epilogue; a block takes 256 rows of gridDim.y-strided lanes.
template <typename Acc>
__global__ void __launch_bounds__(256)
    reduce_lanes(const Acc* __restrict__ ws, int splits, int64_t M, int64_t N, const Epilogue e) {
  const int64_t r = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (r >= M) return;
  const int64_t plane = M * N;
  for (int64_t b = blockIdx.y; b < N; b += gridDim.y) {
    const Acc* w = ws + b * M + r;
    Acc v = w[0];
    int s = 1;
    for (; s + 4 <= splits; s += 4) {       // four loads in flight, summed in order
      const Acc a0 = w[s * plane], a1 = w[(s + 1) * plane], a2 = w[(s + 2) * plane],
                a3 = w[(s + 3) * plane];
      v = add_rn(add_rn(add_rn(add_rn(v, a0), a1), a2), a3);
    }
    for (; s < splits; ++s) v = add_rn(v, w[s * plane]);
    LaneOut<Acc>(e, b, 0).put(r, v);
  }
}

// ---------------------------------------------------------------------------
// the product kernel

template <typename E, bool kPair, int BM, int BN, int BK, int STAGES, int MINB, int LANES>
__global__ void __launch_bounds__(kThreads, MINB) tile_product(const Args p) {
  using Acc = typename std::conditional<sizeof(E) == 8 || kPair, double, float>::type;
  constexpr bool kDmma = sizeof(Acc) == 8;
  constexpr int NB = lane_comps(LANES);                  // B's components a slot
  static_assert(LANES == kPlain || !kPair, "K20's lanes are values");
  constexpr int WN = BN >= 32 ? 2 : 1, WM = 4 / WN;      // warps along N and M
  constexpr int TM = BM / WM, TN = BN / WN;              // a warp's tile
  constexpr int FM = TM / 16, FN = TN / 8;               // m16n8 fragments a warp
  static_assert(FM >= 1 && FN >= 1 && BK % 8 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* smem = reinterpret_cast<E*>(smem_raw);
  const bool a_km = kmajor(p.a.smn, p.a.sk), b_km = kmajor(p.b.smn, p.b.sk);
  // one component's tile (ta, tb); slot layout: A (hi), [A lo], B (hi), [B lo]
  // (K20: A, B's x, [r], [x2])
  const int ta = tile_elems<E, BK>(BM, a_km), tb = tile_elems<E, BK>(BN, b_km);
  const int boff = (kPair ? 2 : 1) * ta, slot = boff + (kPair ? 2 : NB) * tb;

  const unsigned tiles_n = (unsigned)((p.N + BN - 1) / BN);    // run() checks tiles < 2^31
  const int64_t m0 = (int64_t)(blockIdx.x / tiles_n) * BM;
  const int64_t n0 = (int64_t)(blockIdx.x % tiles_n) * BN;
  const int64_t KT = (p.K + BK - 1) / BK;
  const int64_t kt0 = (int64_t)blockIdx.y * p.kps;
  const int64_t kt1 = kt0 + p.kps < KT ? kt0 + p.kps : KT;
  const int ktn = kt1 > kt0 ? (int)(kt1 - kt0) : 0;
  const int64_t kend = kt1 * BK < p.K ? kt1 * BK : p.K;
  // a DD product's block walks batch entries blockIdx.z, + gridDim.z, ...:
  // the ring runs on from one entry's last k-tile into the next entry's
  // first, so an entry's epilogue overlaps the next one's copies (K22's
  // products have one entry: its epilogue, with the scale's division, stays
  // out of the k-loop)
  const int64_t nz = kPair ? ((int64_t)p.batch - blockIdx.z + gridDim.z - 1) / gridDim.z : 1;
  const int64_t items = nz * ktn;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / WN) * TM, wn = (warp % WN) * TN;
  // smem element (mn, k) of a tile sits at mn * r + k * kk
  const int ar = a_km ? BK + 4 : 1, ak = a_km ? 1 : ld_mn<E>(BM);
  const int br = b_km ? BK + 4 : 1, bk = b_km ? 1 : ld_mn<E>(BN);

  Stager<E, kPair, BM, BK> sta;
  Stager<E, kPair, BN, BK> stb, stb1, stb2;
  sta.init(p.a, m0);
  stb.init(p.b, n0);
  // K20: B's other components and this tile's lane coefficients
  __shared__ E cf[LANES >= kBe ? 2 : 1][LANES >= kBe ? BN : 1];
  if constexpr (LANES >= kBe) {
    stb1.init(p.r, n0);
    if constexpr (LANES == kBdf2) stb2.init(p.x2, n0);
    for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
      const int64_t lane = n0 + i % BN;
      const E* c = static_cast<const E*>(i < BN ? p.cf0 : p.cf1);
      cf[i / BN][i % BN] = lane < p.N && (i < BN || LANES == kBdf2) ? c[lane] : E(0);
    }
    __syncthreads();
  }
  int64_t lz = blockIdx.z;   // the next copy's batch entry and k-tile
  int lkt = 0;
  auto load = [&](int s) {
    E* base = smem + s * slot;
    const int64_t k0 = (kt0 + lkt) * BK;
    sta.copy(p.a, lz, base, base + ta, k0, kend);
    stb.copy(p.b, lz, base + boff, base + boff + tb, k0, kend);
    if constexpr (LANES >= kBe) stb1.copy(p.r, lz, base + boff + tb, nullptr, k0, kend);
    if constexpr (LANES == kBdf2) stb2.copy(p.x2, lz, base + boff + 2 * tb, nullptr, k0, kend);
    if (++lkt == ktn) {
      lkt = 0;
      lz += gridDim.z;
    }
  };

  Acc acc[FM][FN][4];
  auto clear = [&]() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[i][j][h] = Acc(0);
  };
  Acc* ws = static_cast<Acc*>(p.ws);
  const int64_t plane = p.batch * p.M * p.N;
  // a DD product with no split writes its output tile through shared memory
  // (after the ring, BM x (BN + 1) floats), hi and then lo, so that
  // consecutive threads store consecutive elements of a row
  float* const stage = reinterpret_cast<float*>(smem + STAGES * slot);
  auto staged = [&](int64_t z) {
    const auto& e = p.epi;
    const bool by_row = e.sc != 1 && e.sr == 1;     // the output's contiguous axis
    for (int part = 0; part < 2; ++part) {
      __syncthreads();                             // the previous readers are done
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const double v = acc[i][j][h];
            const float hi = __double2float_rn(v);
            stage[(wm + 16 * i + 8 * (h >> 1) + g) * (BN + 1) + wn + 8 * j + 2 * t + (h & 1)] =
                part == 0 ? hi : __double2float_rn(__dsub_rn(v, (double)hi));
          }
      __syncthreads();
      float* out = static_cast<float*>(part == 0 ? e.c0 : e.c1) + z * e.sb;
      for (int q = threadIdx.x; q < BM * BN; q += kThreads) {
        const int r = by_row ? q % BM : q / BN, c = by_row ? q / BM : q % BN;
        const int64_t m = m0 + r, n = n0 + c;
        if (m < p.M && n < p.N) out[m * e.sr + n * e.sc] = stage[r * (BN + 1) + c];
      }
    }
  };
  auto finish = [&](int64_t z) {
    if constexpr (kPair) {
      if (p.splits == 1) {
        staged(z);
        return;
      }
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int64_t m = m0 + wm + 16 * i + 8 * (h >> 1) + g;
          const int64_t n = n0 + wn + 8 * j + 2 * t + (h & 1);
          if (m >= p.M || n >= p.N) continue;
          if (p.splits > 1)
            ws[blockIdx.y * plane + (z * p.M + m) * p.N + n] = acc[i][j][h];
          else
            emit<Acc, kPair>(p.epi, z, m, n, acc[i][j][h]);
        }
  };

  // the products of one k-tile in a slot of the ring into acc
  auto multiply = [&](const E* base) {
    const E *sa0 = base, *sa1 = base + ta, *sb0 = base + boff, *sb1 = base + boff + tb;
    if constexpr (kDmma) {
#pragma unroll 2
      for (int ks = 0; ks < BK; ks += 4) {
        double a[FM][2], b[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            a[i][h] = value<E, kPair>(sa0, sa1, (wm + 16 * i + 8 * h + g) * ar + (ks + t) * ak);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          b[j] = value<E, kPair>(sb0, sb1, (wn + 8 * j + g) * br + (ks + t) * bk);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j) dmma(acc[i][j], a[i][0], a[i][1], b[j]);
      }
    } else {
      // FFMA on the CUDA cores, the DMMA fragment's outputs: rows g, g + 8,
      // columns 2t, 2t + 1 of each m16n8 block, in k order
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        Acc a[FM][2], b[FN][2];
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) a[i][h] = sa0[(wm + 16 * i + 8 * h + g) * ar + k * ak];
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) b[j][v] = sb0[(wn + 8 * j + 2 * t + v) * br + k * bk];
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int v = 0; v < 2; ++v)
                acc[i][j][2 * h + v] = fmaf(a[i][h], b[j][v], acc[i][j][2 * h + v]);
      }
    }
  };

  clear();
  if constexpr (LANES == kPlain) {
    if (ktn == 0) {          // an empty inner index: zeros (K20 falls through to its store)
      for (int64_t z = blockIdx.z; z < p.batch; z += gridDim.z) finish(z);
      return;
    }
  }
  // (a loop, not unrolled: each copy of load() is a few hundred instructions
  // that a block runs once)
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < items) load(s);
    cp_async_commit();
  }
  int64_t cz = blockIdx.z;   // the batch entry being multiplied
  int ckt = 0;
  for (int64_t q = 0; q < items; ++q) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of item q have landed
    if constexpr (LANES >= kBe)    // K20 (one entry): form its rhs from them
      stb.template form<LANES>(p.b, smem + (int)(q % STAGES) * slot + boff, tb,
                               (kt0 + q) * BK, kend, cf, n0);
    __syncthreads();               // everyone's have, and item q - 1's slot is free
    if (q + STAGES - 1 < items) load((int)((q + STAGES - 1) % STAGES));
    cp_async_commit();
    multiply(smem + (int)(q % STAGES) * slot);
    if constexpr (kPair) {       // only the DD products walk a batch
      if (++ckt == ktn) {
        ckt = 0;
        if (q + 1 < items) {
          finish(cz);
          clear();
          cz += gridDim.z;
        }
      }
    }
  }
  cp_async_wait<0>();
  if constexpr (LANES != kPlain) {
    if (p.fused) {
      // K20's small solve: slot 0 holds S's whole tile (n <= BK, n <= BM) and
      // this block's lanes; their product, divided, becomes the B tile
      // (K-major, lane c's entry k at c (BK + 4) + k; zero past n and N),
      // multiplied by the same S tile: the work rows never leave the block
      const Epilogue e = p.epi;
      E* bt = smem + boff;
      __syncthreads();                        // every warp's products of the slot are done
      for (int c = threadIdx.x / 32; c < BN; c += kThreads / 32) {
        if (n0 + c >= p.N) {
          for (int k = threadIdx.x % 32; k < BK; k += 32) bt[c * (BK + 4) + k] = E(0);
        }
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int r = wm + 16 * i + 8 * (h >> 1) + g, c = wn + 8 * j + 2 * t + (h & 1);
            if (r < BK && n0 + c < p.N)
              bt[c * (BK + 4) + r] = r < p.M ? (E)Divisor<Acc>(e, n0 + c, 0).of(r, acc[i][j][h])
                                             : E(0);
          }
      __syncthreads();
      clear();
      multiply(smem);
      finish_lanes<Acc, BM, BN, FM, FN>(p, p.epi2, acc, reinterpret_cast<Acc*>(smem_raw), m0,
                                        n0, wm, wn, g, t);
    } else {
      finish_lanes<Acc, BM, BN, FM, FN>(p, p.epi, acc, reinterpret_cast<Acc*>(smem_raw), m0,
                                        n0, wm, wn, g, t);
    }
  } else {
    finish(cz);
  }
}

// The slices' partials summed in order 0 .. S - 1, then the epilogue.
template <typename Acc, bool kPairOut>
__global__ void __launch_bounds__(256)
    reduce_slices(const Acc* __restrict__ ws, int splits, int64_t batch, int64_t M, int64_t N,
                  const Epilogue e) {
  const int64_t plane = batch * M * N;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane;
       i += (int64_t)gridDim.x * blockDim.x) {
    Acc v = ws[i];
    for (int s = 1; s < splits; ++s) v = add_rn(v, ws[s * plane + i]);
    const int64_t n = i % N, m = (i / N) % M, z = i / (M * N);
    emit<Acc, kPairOut>(e, z, m, n, v);
  }
}

// ---------------------------------------------------------------------------
// host side

template <typename E, bool kPair, int BM, int BN, int BK, int STAGES, int MINB, int LANES>
cudaError_t run(const Args& p, int zblocks, cudaStream_t s) {
  using Acc = typename std::conditional<sizeof(E) == 8 || kPair, double, float>::type;
  const bool a_km = kmajor(p.a.smn, p.a.sk), b_km = kmajor(p.b.smn, p.b.sk);
  if (sizeof(Acc) == 4 && !(a_km && b_km && p.a.sk == 1 && p.b.sk == 1))
    return cudaErrorInvalidValue;      // the FFMA path reads K-major tiles only
  const size_t smem = sizeof(E) * STAGES *
                          ((kPair ? 2 : 1) * tile_elems<E, BK>(BM, a_km) +
                           (kPair ? 2 : lane_comps(LANES)) * tile_elems<E, BK>(BN, b_km)) +
                      (kPair && p.splits == 1 ? sizeof(float) * BM * (BN + 1) : 0);
  const int64_t tiles = ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
  auto kernel = tile_product<E, kPair, BM, BN, BK, STAGES, MINB, LANES>;
  // the largest ring this instantiation has been given, per device; shared
  // memory before L1, so that MINB rings fit on an SM
  static size_t given[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32 || smem > given[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err != cudaSuccess) return err;
    if (dev < 32) given[dev] = smem;
  }
  const dim3 grid((unsigned)tiles, (unsigned)p.splits, (unsigned)zblocks);
  kernel<<<grid, kThreads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  if constexpr (LANES != kPlain) {
    const dim3 grid((unsigned)((p.M + 255) / 256), (unsigned)(p.N < 65535 ? p.N : 65535));
    reduce_lanes<Acc><<<grid, 256, 0, s>>>(static_cast<const Acc*>(p.ws), p.splits, p.M, p.N,
                                           p.epi);
    return cudaGetLastError();
  }
  const int64_t plane = p.batch * p.M * p.N;
  const int64_t blocks = (plane + 255) / 256 < 132 * 16 ? (plane + 255) / 256 : 132 * 16;
  reduce_slices<Acc, kPair><<<(unsigned)blocks, 256, 0, s>>>(static_cast<const Acc*>(p.ws),
                                                            p.splits, p.batch, p.M, p.N, p.epi);
  return cudaGetLastError();
}

// Whether an operand's copies of o.chunk elements are legal: a power of two
// of at most 16 bytes, along a unit-stride axis, with every pointer and every
// other stride (of an axis longer than 1) a multiple of the width (the rule
// of ops/product_tile.py::copy_bytes).  A wider copy would fault on a
// misaligned address, which ends the CUDA context.
template <typename E>
bool copies_fit(const Operand& o, int64_t batch, int64_t K) {
  const int64_t w = (int64_t)o.chunk * (int64_t)sizeof(E);
  if (o.chunk < 1 || w > 16 || (w & (w - 1)) != 0) return false;
  if (o.chunk == 1) return true;
  const bool k = kmajor(o.smn, o.sk);
  if ((k ? o.sk : o.smn) != 1) return false;
  const int64_t other = k ? o.smn : o.sk, other_len = k ? o.extent : K;
  return reinterpret_cast<uintptr_t>(o.p0) % w == 0 &&
         (o.p1 == nullptr || reinterpret_cast<uintptr_t>(o.p1) % w == 0) &&
         (batch <= 1 || o.sb * (int64_t)sizeof(E) % w == 0) &&
         (other_len <= 1 || other * (int64_t)sizeof(E) % w == 0);
}

// One product on the plan's tile (the TILES of ops/product_tile.py).
template <typename E, bool kPair, int LANES = kPlain>
cudaError_t product(const Args& p, const Plan& plan, cudaStream_t s) {
  if (p.batch == 0 || p.M == 0 || p.N == 0) return cudaSuccess;
  if (!copies_fit<E>(p.a, p.batch, p.K) || !copies_fit<E>(p.b, p.batch, p.K))
    return cudaErrorMisalignedAddress;
  // K20: every component of B K-major with B's copy width, and B's extent
  if (LANES >= kBe && !(kmajor(p.b.smn, p.b.sk) && p.b.sk == 1 && p.r.sk == 1 &&
                        p.r.chunk == p.b.chunk && p.r.extent == p.b.extent &&
                        copies_fit<E>(p.r, p.batch, p.K) &&
                        (LANES != kBdf2 || (p.x2.sk == 1 && p.x2.chunk == p.b.chunk &&
                                            p.x2.extent == p.b.extent &&
                                            copies_fit<E>(p.x2, p.batch, p.K)))))
    return cudaErrorMisalignedAddress;
  const int64_t KT = (p.K + plan.bk - 1) / plan.bk;
  // the slices must cover [0, K) with none empty; the batch walkers, 1 .. batch
  if (plan.splits < 1 || plan.splits > 65535 || plan.kps < (KT > 0 ? 1 : 0) ||
      (int64_t)plan.splits * plan.kps < KT ||
      (int64_t)(plan.splits - 1) * plan.kps >= (KT > 0 ? KT : 1) ||
      (plan.splits > 1 && p.ws == nullptr) || plan.zblocks < 1 || plan.zblocks > 65535 ||
      plan.zblocks > p.batch || (!kPair && p.batch != 1))
    return cudaErrorInvalidValue;
  // K20's small solve: one k-tile and one M tile hold S, no split
  if (p.fused && !(LANES != kPlain && plan.splits == 1 && p.K <= plan.bk && p.M <= plan.bk &&
                   p.M <= plan.bm))
    return cudaErrorInvalidValue;
  Args q = p;
  q.kps = plan.kps;
  q.splits = plan.splits;
#define PM_TILE(BM_, BN_, BK_, ST_, MINB_)                                          \
  if (plan.bm == BM_ && plan.bn == BN_ && plan.bk == BK_ && plan.stages == ST_) \
    return run<E, kPair, BM_, BN_, BK_, ST_, MINB_, LANES>(q, plan.zblocks, s);
  PM_TILE(64, 8, 32, 3, 3)
  if constexpr (LANES == kPlain) {
    PM_TILE(64, 64, 16, 3, 3)
  } else if constexpr (LANES == kRows) {
    // K20's wide tile (ops/product_tile.py K20_WIDE), which stages plain
    // lanes only: there a first pass forms the rhs (heat_kernels.k20_prepass)
    PM_TILE(64, 64, 32, 3, 2)
  }
#undef PM_TILE
  return cudaErrorInvalidValue;
}

}  // namespace pm_tile
