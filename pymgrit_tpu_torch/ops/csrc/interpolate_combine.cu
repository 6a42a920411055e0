// K19 interpolate_combine: the heat grid interpolation fused with the
// coarse-grid correction around it, over the rows of a tube,
//
//   dst_r += P(a_r - b_r)      or, without b,      dst_r = P(a_r)
//
// for every row r < R.  P is 1D linear interpolation with zero Dirichlet
// ends (coarse n -> fine 2n + 1: an odd fine point copies coarse (p-1)/2,
// an even one 2i is d[i-1]/2 + d[i]/2, a missing end 0) or 2D bilinear
// interpolation between vertex grids (coarse (P, Q) -> fine (2P-1, 2Q-1)),
// along axis 0 and then axis 1 as the JAX version does: coincident points
// copy, edge points take two-point means, a cell centre the mean of the
// two axis-0 means.
//
// Replaces: pymgrit_tpu/models/grid_transfer_heat.py
// GridTransferHeat.interpolation (:40-54) and GridTransferHeat2D.interpolation
// (:98) via _interp_1d_vertex (:57-66), vmapped by the JAX solver over a
// tube's rows, fused with Mgrit._error_correction's u += P(u_c - v_c)
// (pymgrit_tpu/core/solver.py) and, without b, nested iteration's and the
// batched interpolation alone.
//
// Bound: bytes.  spatial65's correction reads two coarse terms (1024 rows
// of 33^2 float64) and reads and writes the fine rows (65^2): 87 MB, 0.026
// ms at 3.35 TB/s.  What held the Triton version back was host time (a
// wrapper that re-ran every check, and Triton's Python launcher: 0.05 ms of
// a 0.002 ms 1D call) and lanes (one program a (row, 1024 fine points)).
// Design, as K18's (csrc/restrict_combine.cu):
// * one ctypes call of pm_interpolate_combine_*: a packed int64 argument
//   array cached by the wrapper with its checks, and the three pointers;
// * the fine points of all rows are one flat range e = (r Pf + p) Qf + q,
//   so many small rows share a block and neighbouring threads store
//   neighbouring fine points of a row (coalesced); a grid sized to the
//   card (ops/transfer.py::interpolate_plan) strides through it, each step
//   of the grid's stride three additions with carries, no division;
// * a thread handles U = 4 points a pass, all their loads (the coarse
//   points through the read-only path, __ldg, where a fine row's
//   neighbours find them again in L1; dst's old values) issued before any
//   arithmetic or store; every fine point loads the same (clamped) coarse
//   neighbours and selects, so odd and even points do not diverge;
// * rows are strided views (the condensed tube's C-rows tube[m::m]): every
//   operand has its own row stride; each state is contiguous;
// * every operation is __dsub_rn / __dadd_rn / __dmul_rn (float32:
//   __fsub_rn, __fadd_rn, __fmul_rn) in the plain version's order
//   (ops/transfer.py::interpolate_combine_plain: a - b, then P, then
//   dst + P), so it equals the plain version bit for bit.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block (ops/transfer.py INTERP_THREADS)
constexpr int kMinBlocks = 4;  // blocks an SM holds (ops/transfer.py INTERP_BLOCKS_PER_SM)
constexpr int U = 4;           // fine points a thread handles a pass

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }

struct Params {
  void* dst;
  const void* a;
  const void* b;
  int64_t sd, sa, sb;  // row strides (elements)
  int64_t R;           // rows
  int64_t dr;          // the grid's stride in (rows, fine rows, points)
  int dp, dq;
  int Pc, Qc;          // coarse rows (1 in 1D) and a coarse row's length
  int Pf, Qf;          // fine rows (1 in 1D) and a fine row's length
};

// the next point e + S = e + (dr Pf + dp) Qf + dq: q, then p, then r, each
// with its carry
__device__ __forceinline__ void advance(int64_t& r, int& p, int& q, const Params& s) {
  q += s.dq;
  if (q >= s.Qf) {
    q -= s.Qf;
    ++p;
  }
  p += s.dp;
  if (p >= s.Pf) {
    p -= s.Pf;
    ++r;
  }
  r += s.dr;
}

// the coarse difference d = a - b (or a) at offset o of a row
template <typename T, bool HAS_B>
__device__ __forceinline__ T coarse(const T* a, const T* b, int o) {
  const T x = __ldg(a + o);
  return HAS_B ? sub_rn(x, __ldg(b + o)) : x;
}

// P(d) at fine point (p, q) of one row: a (row of a) and b (row of b).
// Every point loads the same coarse points, at offsets clamped into the
// row, and selects what it needs: no branch, so the lanes of a warp (odd
// and even q alternate) load together.
template <typename T, int DIM, bool HAS_B>
__device__ __forceinline__ T interp(const T* a, const T* b, int p, int q, int Pc, int Qc) {
  const T half = T(0.5);
  const int j = q >> 1;
  const bool qo = q & 1;
  if (DIM == 1) {
    const T lo = coarse<T, HAS_B>(a, b, j >= 1 ? j - 1 : 0);
    const T hi = coarse<T, HAS_B>(a, b, j < Qc ? j : Qc - 1);
    const T even = add_rn(mul_rn(half, j >= 1 ? lo : T(0)), mul_rn(half, j < Qc ? hi : T(0)));
    return qo ? hi : even;
  }
  const int i = p >> 1;
  const bool po = p & 1;
  const int o = i * Qc + j;
  const int di = i + 1 < Pc ? Qc : 0, dj = j + 1 < Qc ? 1 : 0;
  const T d00 = coarse<T, HAS_B>(a, b, o), d10 = coarse<T, HAS_B>(a, b, o + di);
  const T d01 = coarse<T, HAS_B>(a, b, o + dj), d11 = coarse<T, HAS_B>(a, b, o + di + dj);
  const T e0 = po ? mul_rn(half, add_rn(d00, d10)) : d00;
  const T e1 = po ? mul_rn(half, add_rn(d01, d11)) : d01;
  return qo ? mul_rn(half, add_rn(e0, e1)) : e0;
}

template <typename T, int DIM, bool HAS_B>
__global__ void __launch_bounds__(kThreads, kMinBlocks) interpolate_combine_kernel(const Params s) {
  T* dst = static_cast<T*>(s.dst);
  const T* a = static_cast<const T*>(s.a);
  const T* b = static_cast<const T*>(s.b);
  // a state's offsets fit in 32 bits (the wrapper and the launcher check it)
  const int64_t nf = (int64_t)s.Pf * s.Qf;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t r = e / nf;
  const int rem = (int)(e - r * nf);
  int p = rem / s.Qf;
  int q = rem - p * s.Qf;
  const int R = (int)s.R;
  while (r < R) {
    int rr[U], pp[U], qq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rr[u] = (int)r;
      pp[u] = p;
      qq[u] = q;
      advance(r, p, q, s);
    }
    T v[U], old[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (rr[u] < R) {
        const int64_t ro = rr[u];
        v[u] = interp<T, DIM, HAS_B>(a + ro * s.sa, b + ro * s.sb, pp[u], qq[u], s.Pc, s.Qc);
        if (HAS_B) old[u] = dst[ro * s.sd + pp[u] * s.Qf + qq[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (rr[u] < R) {
        dst[(int64_t)rr[u] * s.sd + pp[u] * s.Qf + qq[u]] = HAS_B ? add_rn(old[u], v[u]) : v[u];
      }
    }
  }
}

template <typename T, int DIM>
void dispatch(bool has_b, unsigned grid, cudaStream_t st, const Params& s) {
  if (has_b) {
    interpolate_combine_kernel<T, DIM, true><<<grid, kThreads, 0, st>>>(s);
  } else {
    interpolate_combine_kernel<T, DIM, false><<<grid, kThreads, 0, st>>>(s);
  }
}

// args (int64): CUDA device, dst's, a's and b's row strides, R, Pc, Qc,
// Pf, Qf, dim, has b, grid, dr, dp, dq (ops/transfer.py::interpolate_pack)
template <typename T>
int launch(const int64_t* g, void* dst, const void* a, const void* b, void* stream) {
  Params s{};
  s.dst = dst;
  s.a = a;
  s.b = b;
  s.sd = g[1];
  s.sa = g[2];
  s.sb = g[3];
  s.R = g[4];
  s.Pc = (int)g[5];
  s.Qc = (int)g[6];
  s.Pf = (int)g[7];
  s.Qf = (int)g[8];
  const int dim = (int)g[9];
  const bool has_b = g[10] != 0;
  const unsigned grid = (unsigned)g[11];
  s.dr = g[12];
  s.dp = (int)g[13];
  s.dq = (int)g[14];
  if (s.R == 0) return 0;
  if ((dim != 1 && dim != 2) || grid == 0 || s.Pf < 1 || s.Qf < 1 || s.dp < 0 ||
      s.dp >= s.Pf || s.dq < 0 || s.dq >= s.Qf || (has_b && b == nullptr) ||
      s.R > INT32_MAX - (int64_t)U * grid * kThreads || (int64_t)s.Pf * s.Qf > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)g[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dim == 1) {
    dispatch<T, 1>(has_b, grid, st, s);
  } else {
    dispatch<T, 2>(has_b, grid, st, s);
  }
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_interpolate_combine_f64(const int64_t* args, void* dst, const void* a, const void* b,
                               void* stream) {
  return launch<double>(args, dst, a, b, stream);
}

int pm_interpolate_combine_f32(const int64_t* args, void* dst, const void* a, const void* b,
                               void* stream) {
  return launch<float>(args, dst, a, b, stream);
}

}  // extern "C"
