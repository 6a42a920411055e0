// K21 indexed_combine: the row gathers, drop-scatters and weighted sums of
// non-uniform coarsening,
//
//   out[io[r]] = sum_k c_k * x_k[i_k[r]]       for every row r < R,
//
// with 1-3 terms summed left to right, every row index optional (row r
// itself), and io[r] == T (out's row count) dropping the row (the padding
// of the ragged chains).  A term may be out itself, read at the row it
// writes (the weighted C-update).
//
// Replaces: the index-based phases of pymgrit_tpu/core/solver.py on a level
// whose C-points are not evenly strided: Mgrit._f_relax's g gather and
// drop-scatter (vector.take / vector.set_at(mode='drop')), _c_relax's
// weighted update and scatter, the FAS right-hand side at gathered C-rows
// (_fas_residual) and the indexed correction (_error_correction,
// vector.add_at), which XLA fuses into gathers and scatters.
//
// Bound: bytes.  A call reads each of its terms' rows and writes the out
// rows once (ragged65: 515 rows of 4225 float64, 34.8 MB, 0.0104 ms at
// 3.35 TB/s); no arithmetic to speak of.  What held the Triton version back
// was host time (≈ 0.1 ms a call against ≈ 0.02 ms on the device) and lanes:
// one program a (row, 1024 columns), so a 4225-point row took five programs,
// the last with 129 lanes busy.  Design:
// * one ctypes call of pm_indexed_combine_*: one packed int64 argument
//   array, the coefficients as doubles; they reach the kernel by value, in
//   the parameter (constant) bank, so no device tensor holds them;
// * the work is one range of warp items, (row, segment of 32 x kUnroll
//   vectors; kUnroll 4 with one term, else 2), and a grid sized to the
//   card (SM count x kMinBlocks blocks, ops/indexed.py::plan) strides
//   through it; a warp reads the item's row indices once (one broadcast
//   load each);
// * each lane keeps kUnroll independent 16-byte loads in flight a term
//   where the row's pointers allow it: a row is vectorized when every
//   operand's row pointer sits at the same offset from 16-byte alignment
//   (rows of 4225 float64 step by 33800 bytes, 8 mod 16, so every other row
//   of a tube is off by 8 bytes): the first elements up to alignment are
//   peeled, then 16-byte vectors, then a scalar tail.  Rows whose operands
//   disagree take 8-byte (4-byte) loads, kUnroll in flight per chunk;
// * products and sums are __dmul_rn / __dadd_rn (__fmul_rn / __fadd_rn), so
//   nvcc cannot contract them into FMAs: the kernel equals the plain version
//   (ops/indexed.py::indexed_combine_plain) bit for bit, NaN included.
// No pointer is __restrict__: out may be a term.  Each element of out is
// read (as a term) and written by the same lane, reads first.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block
constexpr int kMinBlocks = 4;  // blocks an SM holds (ops/indexed.py BLOCKS_PER_SM)

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};

// element e of a vector (e is a constant after unrolling: no local memory)
__device__ __forceinline__ double& lane(double2& v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ float& lane(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

struct Params {
  void* out;
  const void* x[3];
  const int64_t* io;      // null: rows in order
  const int64_t* idx[3];  // null: rows in order
  int64_t so, sx[3];      // row strides (elements)
  int64_t T, R, N;        // out's rows, rows combined, row length
  int64_t segs;           // segments a row (32 * kUnroll * V elements each)
  double c[3];
};

template <typename T, int NT>
__device__ __forceinline__ T combine(const T (&c)[NT], const T (&v)[NT]) {
  T acc = mul_rn(c[0], v[0]);
#pragma unroll
  for (int k = 1; k < NT; ++k) acc = add_rn(acc, mul_rn(c[k], v[k]));
  return acc;
}

// one element e of the row: the scalar path
template <typename T, int NT>
__device__ __forceinline__ void element(T* o, const T* const (&x)[NT], const T (&c)[NT],
                                        int64_t e) {
  T v[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) v[k] = x[k][e];
  o[e] = combine<T, NT>(c, v);
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) indexed_combine_kernel(const Params p) {
  constexpr int V = Vec16<T>::n;  // elements a 16-byte vector
  // independent loads in flight a lane and term (ops/indexed.py UNROLL): 4
  // vectors (64 bytes) with one term, 2 with two or three, so that 64
  // registers hold them without spilling
  constexpr int kUnroll = NT == 1 ? 4 : 2;
  constexpr int kSeg = 32 * kUnroll * V;  // elements a segment
  const int ln = threadIdx.x & 31;
  T c[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) c[k] = (T)p.c[k];
  const int64_t items = p.R * p.segs;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t it = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); it < items;
       it += warps) {
    const int64_t r = it / p.segs;
    const int64_t s = it - r * p.segs;
    const int64_t dst = p.io != nullptr ? p.io[r] : r;
    if (dst >= p.T) continue;  // a dropped row (uniform across the warp)
    T* o = static_cast<T*>(p.out) + dst * p.so;
    const T* x[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const int64_t src = p.idx[k] != nullptr ? p.idx[k][r] : r;
      x[k] = static_cast<const T*>(p.x[k]) + src * p.sx[k];
    }
    const int64_t N = p.N;
    const uintptr_t mo = reinterpret_cast<uintptr_t>(o) & 15;
    bool vec = true;
#pragma unroll
    for (int k = 0; k < NT; ++k) vec &= (reinterpret_cast<uintptr_t>(x[k]) & 15) == mo;
    if (vec) {
      using VT = typename Vec16<T>::type;
      int64_t head = (int64_t)(((16 - mo) & 15) / sizeof(T));
      head = head < N ? head : N;
      const int64_t nv = (N - head) / V;
      const int64_t v0 = s * (32 * kUnroll) + ln;
      VT* ov = reinterpret_cast<VT*>(o + head);
      VT a[kUnroll][NT];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t vi = v0 + u * 32;
        if (vi < nv) {
#pragma unroll
          for (int k = 0; k < NT; ++k) a[u][k] = reinterpret_cast<const VT*>(x[k] + head)[vi];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t vi = v0 + u * 32;
        if (vi < nv) {
          VT res;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            T v[NT];
#pragma unroll
            for (int k = 0; k < NT; ++k) v[k] = lane(a[u][k], e);
            lane(res, e) = combine<T, NT>(c, v);
          }
          ov[vi] = res;
        }
      }
      if (s == 0) {  // the peeled head and the scalar tail
        const int64_t tail = N - head - nv * V;
        if (ln < head) element<T, NT>(o, x, c, ln);
        if (ln >= 16 && ln - 16 < tail) element<T, NT>(o, x, c, head + nv * V + (ln - 16));
      }
    } else {
      // kUnroll scalar loads in flight a term, V chunks a segment
      const int64_t e0 = s * kSeg + ln;
#pragma unroll
      for (int h = 0; h < V; ++h) {
        T a[kUnroll][NT];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t e = e0 + (h * kUnroll + u) * 32;
          if (e < N) {
#pragma unroll
            for (int k = 0; k < NT; ++k) a[u][k] = x[k][e];
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int64_t e = e0 + (h * kUnroll + u) * 32;
          if (e < N) o[e] = combine<T, NT>(c, a[u]);
        }
      }
    }
  }
}

// args (int64): CUDA device, out, io, x0, x1, x2, i0, i1, i2 (0: none),
// out's row stride, x0-x2's row strides, T, R, N, segments a row, terms,
// vector width (16 bytes: the launcher refuses another), grid
// (ops/indexed.py::pack)
template <typename T>
int launch(const int64_t* a, double c0, double c1, double c2, void* stream) {
  Params p{};
  p.out = reinterpret_cast<void*>(a[1]);
  p.io = reinterpret_cast<const int64_t*>(a[2]);
  for (int k = 0; k < 3; ++k) {
    p.x[k] = reinterpret_cast<const void*>(a[3 + k]);
    p.idx[k] = reinterpret_cast<const int64_t*>(a[6 + k]);
    p.sx[k] = a[10 + k];
  }
  p.so = a[9];
  p.T = a[13];
  p.R = a[14];
  p.N = a[15];
  p.segs = a[16];
  const int nt = (int)a[17], vec = (int)a[18];
  const unsigned grid = (unsigned)a[19];
  p.c[0] = c0;
  p.c[1] = c1;
  p.c[2] = c2;
  if (p.R == 0 || p.N == 0) return 0;
  if (nt < 1 || nt > 3 || vec != Vec16<T>::n || grid == 0) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nt == 1) indexed_combine_kernel<T, 1><<<grid, kThreads, 0, s>>>(p);
  if (nt == 2) indexed_combine_kernel<T, 2><<<grid, kThreads, 0, s>>>(p);
  if (nt == 3) indexed_combine_kernel<T, 3><<<grid, kThreads, 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_indexed_combine_f64(const int64_t* args, double c0, double c1, double c2, void* stream) {
  return launch<double>(args, c0, c1, c2, stream);
}

int pm_indexed_combine_f32(const int64_t* args, double c0, double c1, double c2, void* stream) {
  return launch<float>(args, c0, c1, c2, stream);
}

}  // extern "C"
