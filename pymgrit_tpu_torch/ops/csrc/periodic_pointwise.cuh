// What the periodic stencil kernels K11 allen_cahn_pointwise, K14
// gray_scott_pointwise and K15 burgers2d_pointwise share: operations
// rounded once, 16-byte row loads and stores, a thread's V consecutive
// points of a row with their four neighbours, the walk over a block's
// units of TY rows, and the residual's exact per-lane max.
//
// * add/sub/mul/dvd are __dadd_rn ... __ddiv_rn and their float32 forms:
//   nvcc contracts none of them into an FMA, and dvd is a true division,
//   so a kernel that writes its plain version's expressions with them, in
//   their order, equals the plain version bit for bit.
// * A block of TX x TY = kThreads threads covers TY rows of one lane at a
//   time (a unit), a thread V consecutive columns of its row.  The grid
//   is sized to the card: a block walks per consecutive units
//   (ops/pointwise.py plan: one where the lanes' units do not fill the
//   grid, more past it), so a lane of few units is one block's, folding
//   its residual max once.
// * A Cross holds a thread's V points of one plane and their neighbours:
//   north and south are the same columns of rows i - 1 and i + 1, west
//   and east one scalar each beyond the vector; the periodic wraps are a
//   compare each, never a division.  A call covers B lanes of R rows of n
//   columns: whole states (R = n, wrapped in both axes) or, in a halo
//   mode, a space shard's slab of R rows of each state (wrapped in y
//   only), whose first row's north and last row's south neighbours are
//   the halo rows the call takes as operands (the neighbouring shards'
//   edge rows: parallel/comm.py row_halo), one (B, [2,] n) contiguous
//   tensor each (Nbr).
// * lane_max folds a thread's max |g| of its units into its lane's max:
//   NaN-propagating within the block (a NaN anywhere gives NaN, as
//   jnp.max), then an atomic max on the bit pattern into the lane's slot
//   of a device workspace (for non-negative values, and a NaN with its
//   sign cleared, the bit patterns order as the values do), and a count
//   of the lane's units folded, added after a __threadfence; the fold that
//   completes the lane takes the slot (resetting it and the counter to 0
//   for the next launch) and writes gmax[b].  The workspace holds two 64-bit words a
//   lane (B slots, then B counters), one for each device and stream
//   (ops/pointwise.py _workspace).

#pragma once

#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

namespace pm_pointwise {

constexpr int kThreads = 256;

__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double dvd(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ unsigned long long bits(double v) {
  return (unsigned long long)__double_as_longlong(v);
}
__device__ __forceinline__ unsigned long long bits(float v) { return __float_as_uint(v); }
__device__ __forceinline__ void from_bits(double* p, unsigned long long b) {
  *p = __longlong_as_double((long long)b);
}
__device__ __forceinline__ void from_bits(float* p, unsigned long long b) {
  *p = __uint_as_float((unsigned)b);
}

// the larger of a and b; NaN if either is
template <typename T>
__device__ __forceinline__ T nanmax(T a, T b) {
  return (b > a || b != b) ? b : a;
}

// V consecutive values of a row, as one 16-byte vector where V > 1
template <typename T, int V>
__device__ __forceinline__ void load(T (&v)[V], const T* p) {
  if constexpr (V == 1) {
    v[0] = *p;
  } else if constexpr (sizeof(T) == 8) {
    const double2 w = *reinterpret_cast<const double2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    const float4 w = *reinterpret_cast<const float4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const T (&v)[V]) {
  if constexpr (V == 1) {
    *p = v[0];
  } else if constexpr (sizeof(T) == 8) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// The rows a thread's row i reads: its own (c), north (i - 1) and south
// (i + 1).  Within a state or slab of R rows at row stride rs; past its
// edge the halo row (above, below) where the call gives one, else the
// state's other edge (the periodic wrap)
template <typename T>
struct Nbr {
  const T *c, *n, *s;
};

template <typename T>
__device__ __forceinline__ Nbr<T> nbr(const T* plane, int64_t rs, int i, int R, const T* above,
                                      const T* below) {
  const T* c = plane + i * rs;
  return {c, i > 0 ? c - rs : above != nullptr ? above : plane + (int64_t)(R - 1) * rs,
          i + 1 < R ? c + rs : below != nullptr ? below : plane};
}

// V points of one plane's row (n columns, wrapped) and their four neighbours
template <typename T, int V>
struct Cross {
  T c[V], n[V], s[V], w0, e0;

  __device__ __forceinline__ void load_at(const Nbr<T>& r, int ncols, int j) {
    load<T, V>(c, r.c + j);
    load<T, V>(n, r.n + j);
    load<T, V>(s, r.s + j);
    w0 = r.c[j == 0 ? ncols - 1 : j - 1];
    e0 = r.c[j + V == ncols ? 0 : j + V];
  }
  __device__ __forceinline__ T west(int k) const { return k == 0 ? w0 : c[k - 1]; }
  __device__ __forceinline__ T east(int k) const { return k == V - 1 ? e0 : c[k + 1]; }
};

// the periodic 5-point Laplacian at point k,
// ((((x_i-1,j + x_i+1,j) + x_i,j-1) + x_i,j+1) - 4 x_ij) / dx^2
template <typename T, int V>
__device__ __forceinline__ T lap(const Cross<T, V>& x, int k, T dx2) {
  return dvd(sub(add(add(add(x.n[k], x.s[k]), x.west(k)), x.east(k)), mul(T(4), x.c[k])), dx2);
}

// The units of a call: B lanes of n rows (a state's side, or a slab's R),
// each cut into blocks of TY rows (unit q: lane q / blocks, its rows
// (q % blocks) TY + y); CUDA block k walks the per consecutive units from
// k per on
struct Walk {
  int64_t total;              // B blocks
  int B, n, blocks, per;
};

// Walks the block's units: row(b, i) where this thread's row i of the unit
// is < n, then end(b, k) after the block's last unit of lane b (k: its
// units of lane b), which every thread of the block reaches (lane_max
// needs them all).  The lane and unit advance by a carry: one division a
// block, none a unit.
template <typename Row, typename End>
__device__ __forceinline__ void walk_units(const Walk& w, Row&& row, End&& end) {
  int64_t q = (int64_t)blockIdx.x * w.per;
  if (q >= w.total) return;
  const int64_t q1 = q + w.per < w.total ? q + w.per : w.total;
  int64_t b = q / w.blocks;
  int u = (int)(q - b * w.blocks), k = 0;
  for (; q < q1; ++q) {
    const int i = u * (int)blockDim.y + (int)threadIdx.y;
    if (i < w.n) row(b, i);
    ++k;
    const bool last = ++u == w.blocks;
    if (last || q + 1 == q1) {
      end(b, k);
      k = 0;
    }
    if (last) {
      u = 0;
      ++b;
    }
  }
}

// Folds this thread's max m of |g| over its points of lane b's last k units
// into gmax[b] (see the head of this file); every thread of the block
// calls it
template <typename T>
__device__ __forceinline__ void lane_max(T m, int64_t b, int k, const Walk& w,
                                         unsigned long long* ws, T* gmax) {
  __shared__ T warp_max[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1) m = nanmax(m, __shfl_xor_sync(0xffffffffu, m, off));
  const int t = (int)(threadIdx.y * blockDim.x + threadIdx.x);
  const int nwarps = (int)(blockDim.x * blockDim.y) / 32;
  if (t % 32 == 0) warp_max[t / 32] = m;
  __syncthreads();
  if (t == 0) {
    for (int j = 1; j < nwarps; ++j) m = nanmax(m, warp_max[j]);
    unsigned long long* slot = ws + b;
    unsigned long long* count = ws + w.B + b;   // the lane's units folded so far
    // |g| >= 0 (or NaN with its sign bit clear): its bits order as it does
    atomicMax(slot, bits(m));
    __threadfence();
    if (atomicAdd(count, (unsigned long long)k) + k == (unsigned long long)w.blocks) {
      from_bits(gmax + b, atomicExch(slot, 0ull));
      atomicExch(count, 0ull);
    }
  }
  __syncthreads();   // warp_max is reused by the block's next fold
}

// Checks a launch's shape (the plan's TX, TY, units a block and grid for
// B lanes of n rows) and fills the walk; false if the kernel cannot take it
inline bool walk_of(Walk& w, int64_t B, int64_t n, int64_t tx, int64_t ty, int64_t per,
                    int64_t grid) {
  if (n < 1 || n > 0x3fffffff || B < 1 || B > 0x7fffffff || tx < 1 || ty < 1 ||
      tx * ty != kThreads || per < 1 || grid < 1 || grid > 0x7fffffff)
    return false;
  w.blocks = (int)((n + ty - 1) / ty);
  w.total = B * w.blocks;
  if (grid * per < w.total) return false;
  w.B = (int)B;
  w.n = (int)n;
  w.per = (int)(per < w.total ? per : w.total);
  return true;
}

// true where every pointer given starts on 16 bytes
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t any = 0;
  for (const void* p : ptrs) any |= reinterpret_cast<uintptr_t>(p);
  return any % 16 == 0;
}

// Makes CUDA device d current for a launch and restores the caller's after
struct OnDevice {
  int prev = 0, dev;
  explicit OnDevice(int d) : dev(d) {
    cudaGetDevice(&prev);
    if (dev != prev) cudaSetDevice(dev);
  }
  ~OnDevice() {
    if (dev != prev) cudaSetDevice(prev);
  }
};

}  // namespace pm_pointwise
