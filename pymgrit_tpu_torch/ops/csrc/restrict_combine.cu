// K18 restrict_combine: the heat grid restriction fused with the FAS
// right-hand side around it, over the rows of a tube,
//
//   out_r = R(sum_k c_k x_k,r) + sum_j d_j y_j,r      for every row r < R,
//
// with 1-3 fine terms x and 0-2 coarse adds y, each sum left to right.  R
// is 1D full weighting (coarse i = fine 2i * 1/4 + 2i+1 * 1/2 + 2i+2 * 1/4,
// interior-point Dirichlet grids n -> (n - 1) / 2) or 2D injection (coarse
// (i, j) = fine (2i, 2j), vertex grids with their ring, 2P-1 -> P).
//
// Replaces: pymgrit_tpu/models/grid_transfer_heat.py
// GridTransferHeat.restriction (:31-37) and GridTransferHeat2D.restriction
// (:94), vmapped by the JAX solver over a tube's rows, fused with
// Mgrit._fas_residual's combination (pymgrit_tpu/core/solver.py) and, with
// one term and no add, the batched restriction alone.
//
// Bound: bytes.  spatial65's FAS call reads two fine terms and two coarse
// adds and writes the coarse rows: 1024 rows of 33^2 float64, counted as
// 5 x 1089 values a row (44.6 MB, 0.0133 ms at 3.35 TB/s).  Injection
// reads every other element of every other fine row: a 32-byte sector holds
// four float64 of which two are needed, and the odd fine rows are never
// touched, so a fine term costs 2 x 33 x 65 / 1089 ≈ 1.97 coarse values of
// sectors instead of 1, and the FAS call moves about 7 / 5 = 1.4x the
// bound's bytes.  Full weighting reads every fine point, as the bound
// counts.  What held the Triton version back was host time (≈ 0.1 ms a
// call) and lanes: one program a (row, 1024 coarse points), so a 33^2
// state took two programs (65 of the second's 1024 lanes busy) and the 1D
// example's 7-point rows kept 7 of 1024.  Design:
// * one ctypes call of pm_restrict_combine_*: one packed int64 argument
//   array, the coefficients as doubles, which reach the kernel by value in
//   the parameter (constant) bank;
// * the coarse points of all rows are one flat range e = (r Pc + i) Qc + j,
//   so many small rows share a block; a grid sized to the card (SM count x
//   kMinBlocks blocks, ops/transfer.py::restrict_plan) strides through it.
//   A thread divides its first e once; each later step of the grid's stride
//   S = (dr, di, dj) (computed by the plan) is three additions with
//   carries, no division;
// * a thread handles U points a pass, all their loads issued before
//   any arithmetic (4 points in 2D; 2 in 1D, which loads three fine points
//   a term), so 32-64 bytes a term are in flight a thread;
// * rows are strided views (the condensed tube's C-rows tube[m::m]): every
//   operand has its own row stride; each state is contiguous;
// * products and sums are __dmul_rn / __dadd_rn (__fmul_rn / __fadd_rn), in
//   the plain version's order (ops/transfer.py::restrict_combine_plain:
//   combine, restrict, then add the sum of the adds), so it equals the plain
//   version bit for bit; injection multiplies by nothing.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kMinBlocks = 4;  // blocks an SM holds (ops/transfer.py BLOCKS_PER_SM)


__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

struct Params {
  void* out;
  const void* x[3];
  const void* y[2];
  int64_t so, sx[3], sy[2];  // row strides (elements)
  int64_t R;                 // rows
  int64_t dr;                // the grid's stride in (rows, coarse rows, points)
  int di, dj;
  int Qf;                    // a fine row's length (2D) or the fine n (1D)
  int Pc, Qc;                // coarse rows (1 in 1D) and a coarse row's length
  double c[3], d[2];
};

// the next point e + S = e + (dr Pc + di) Qc + dj: j, then i, then r, each
// with its carry
__device__ __forceinline__ void advance(int64_t& r, int& i, int& j, int64_t dr, int di, int dj,
                                        int Pc, int Qc) {
  j += dj;
  if (j >= Qc) {
    j -= Qc;
    ++i;
  }
  i += di;
  if (i >= Pc) {
    i -= Pc;
    ++r;
  }
  r += dr;
}

template <typename T, int DIM, int NT, int NA>
__global__ void __launch_bounds__(kThreads, kMinBlocks) restrict_combine_kernel(const Params p) {
  constexpr int U = DIM == 1 ? 2 : 4;  // points a pass (ops/transfer.py UNROLL)
  constexpr int KP = DIM == 1 ? 3 : 1;  // fine points a coarse point reads
  T c[NT], d[NA > 0 ? NA : 1];
#pragma unroll
  for (int k = 0; k < NT; ++k) c[k] = (T)p.c[k];
#pragma unroll
  for (int k = 0; k < NA; ++k) d[k] = (T)p.d[k];
  const T* x[NT];
  const T* y[NA > 0 ? NA : 1];
#pragma unroll
  for (int k = 0; k < NT; ++k) x[k] = static_cast<const T*>(p.x[k]);
#pragma unroll
  for (int k = 0; k < NA; ++k) y[k] = static_cast<const T*>(p.y[k]);
  T* out = static_cast<T*>(p.out);

  // a state's offsets fit in 32 bits (the launcher and the wrapper check it)
  const int64_t nc = (int64_t)p.Pc * p.Qc;
  const int64_t e = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int64_t r = e / nc;
  const int rem = (int)(e - r * nc);
  int i = rem / p.Qc;
  int j = rem - i * p.Qc;
  const int R = (int)p.R;
  while (r < R) {
    int rr[U], fo[U], co[U];  // rows fit in 32 bits (the launcher checks R)
#pragma unroll
    for (int u = 0; u < U; ++u) {
      rr[u] = (int)r;
      fo[u] = DIM == 1 ? 2 * j : 2 * i * p.Qf + 2 * j;
      co[u] = i * p.Qc + j;
      advance(r, i, j, p.dr, p.di, p.dj, p.Pc, p.Qc);
    }
    T v[U][KP][NT], w[U][NA > 0 ? NA : 1];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (rr[u] < R) {
#pragma unroll
        for (int k = 0; k < NT; ++k) {
          const T* row = x[k] + (int64_t)rr[u] * p.sx[k] + fo[u];
#pragma unroll
          for (int q = 0; q < KP; ++q) v[u][q][k] = row[q];
        }
#pragma unroll
        for (int k = 0; k < NA; ++k) w[u][k] = y[k][(int64_t)rr[u] * p.sy[k] + co[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (rr[u] < R) {
        T res;
#pragma unroll
        for (int q = 0; q < KP; ++q) {
          T s = mul_rn(c[0], v[u][q][0]);
#pragma unroll
          for (int k = 1; k < NT; ++k) s = add_rn(s, mul_rn(c[k], v[u][q][k]));
          if (DIM == 1) {
            const T wq = q == 1 ? T(0.5) : T(0.25);
            res = q == 0 ? mul_rn(s, wq) : add_rn(res, mul_rn(s, wq));
          } else {
            res = s;
          }
        }
        if (NA > 0) {
          T a = mul_rn(d[0], w[u][0]);
#pragma unroll
          for (int k = 1; k < NA; ++k) a = add_rn(a, mul_rn(d[k], w[u][k]));
          res = add_rn(res, a);
        }
        out[(int64_t)rr[u] * p.so + co[u]] = res;
      }
    }
  }
}

template <typename T, int DIM, int NT>
void dispatch_adds(int na, unsigned grid, cudaStream_t s, const Params& p) {
  if (na == 0) restrict_combine_kernel<T, DIM, NT, 0><<<grid, kThreads, 0, s>>>(p);
  if (na == 1) restrict_combine_kernel<T, DIM, NT, 1><<<grid, kThreads, 0, s>>>(p);
  if (na == 2) restrict_combine_kernel<T, DIM, NT, 2><<<grid, kThreads, 0, s>>>(p);
}

template <typename T, int DIM>
void dispatch_terms(int nt, int na, unsigned grid, cudaStream_t s, const Params& p) {
  if (nt == 1) dispatch_adds<T, DIM, 1>(na, grid, s, p);
  if (nt == 2) dispatch_adds<T, DIM, 2>(na, grid, s, p);
  if (nt == 3) dispatch_adds<T, DIM, 3>(na, grid, s, p);
}

// args (int64): CUDA device, out, x0, x1, x2, y0, y1 (0: none), out's row
// stride, x0-x2's and y0-y1's row strides, R, Qf, Pc, Qc, dim, terms,
// adds, grid, dr, di, dj (ops/transfer.py::restrict_pack)
template <typename T>
int launch(const int64_t* a, double c0, double c1, double c2, double d0, double d1,
           void* stream) {
  Params p{};
  p.out = reinterpret_cast<void*>(a[1]);
  for (int k = 0; k < 3; ++k) {
    p.x[k] = reinterpret_cast<const void*>(a[2 + k]);
    p.sx[k] = a[8 + k];
  }
  for (int k = 0; k < 2; ++k) {
    p.y[k] = reinterpret_cast<const void*>(a[5 + k]);
    p.sy[k] = a[11 + k];
  }
  p.so = a[7];
  p.R = a[13];
  p.Qf = (int)a[14];
  p.Pc = (int)a[15];
  p.Qc = (int)a[16];
  const int dim = (int)a[17], nt = (int)a[18], na = (int)a[19];
  const unsigned grid = (unsigned)a[20];
  p.dr = a[21];
  p.di = (int)a[22];
  p.dj = (int)a[23];
  p.c[0] = c0;
  p.c[1] = c1;
  p.c[2] = c2;
  p.d[0] = d0;
  p.d[1] = d1;
  if (p.R == 0 || p.Pc == 0 || p.Qc == 0) return 0;
  if ((dim != 1 && dim != 2) || nt < 1 || nt > 3 || na < 0 || na > 2 || grid == 0 ||
      p.di < 0 || p.di >= p.Pc || p.dj < 0 || p.dj >= p.Qc ||
      p.R > INT32_MAX - (int64_t)grid * kThreads ||
      (dim == 2 ? (2 * a[15] - 1) * a[14] : a[14]) > INT32_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dim == 1) {
    dispatch_terms<T, 1>(nt, na, grid, s, p);
  } else {
    dispatch_terms<T, 2>(nt, na, grid, s, p);
  }
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_restrict_combine_f64(const int64_t* args, double c0, double c1, double c2, double d0,
                            double d1, void* stream) {
  return launch<double>(args, c0, c1, c2, d0, d1, stream);
}

int pm_restrict_combine_f32(const int64_t* args, double c0, double c1, double c2, double d0,
                            double d1, void* stream) {
  return launch<float>(args, c0, c1, c2, d0, d1, stream);
}

}  // extern "C"
