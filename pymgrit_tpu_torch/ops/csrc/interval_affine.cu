// K1 interval_affine: closed-form interval relaxation of the spectral heat
// step, out[j, r, n] = A[r0 + r, n] * x[j, n] + G[r0 + r, n].
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.relax_interval (spectral
// branch, `seed * A_t + G_t`) and pymgrit_tpu/core/solver.py
// Mgrit._cnd_materialize_expr (condensed C-rows -> full level-0 tube).
//
// Bound: bytes written.  At the main path's materialization it writes the
// whole 16385 x 16129 float64 tube (2.1 GB) and reads the 512 seeds and two
// (31, 16129) tables (8 MB).  The first design ran one thread per (interval,
// coefficient) over the rows, so the 512 intervals read the tables 512
// times (4.1 GB of loads, from the L2 at best) beside 2.1 GB of stores whose
// lines, allocated in the L2, pushed the tables out; it ran at 1.7x the
// bound.  This design:
// * interval blocking: a block owns C = 256 coefficients (512 in float32)
//   for a group of JB intervals; it loads the group's seeds into shared
//   memory once and each table row once for all of them (double-buffered:
//   row r + 1 loads into registers while row r is written, then goes to
//   shared memory), so table loads fall JB-fold
//   (the grid's y walks the groups; JB = 16, or 4 or 1 where J, N and the
//   SM count would leave the card short of blocks, as in the R = 1
//   condensed C-step);
// * streaming stores (__stcs, evict first), so that the output does not
//   push the tables out of the L2;
// * 16-byte stores, in whole 32-byte sectors: an output row starts at any
//   8-byte offset from a sector (N = 127^2 is odd and 8 N is 8 modulo 32,
//   so the tube's rows step through all four), so each row is written from
//   its first sector-aligned element e on, thread t taking elements
//   VW t + e .. VW t + e + VW - 1 of the block's range (VW = 2, or 4 in
//   float32), which the shared buffers hold for every e; the elements that
//   fall off a row's head or tail are stored alone.  A block works on one
//   row at a time, so the choice never diverges;
// * exact rounding: the product and the sum are __dmul_rn and __dadd_rn
//   (__fmul_rn, __fadd_rn), the plain version's two roundings
//   (ops/heat_kernels.py::interval_affine_plain), so the kernel equals it
//   bit for bit where nvcc would otherwise contract them into an FMA.
// The output layout is given by two element strides (out_sj between
// intervals, out_sr between rows), which covers the row-major (R, J, N) and
// interval-major (J, R, N) layouts and the tube itself (out_sj = m*N,
// out_sr = N).  When seed_out is not null the kernel also copies each seed
// into that row (the C-point row j*m of the tube), so materialization needs
// no other pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads a block

// a 16-byte vector of T (VW elements) and the elements a 32-byte sector
// holds (SA); a block covers C = VW kThreads coefficients
template <typename T> struct Vec;
template <> struct Vec<double> {
  using type = double2;
  static constexpr int VW = 2, SA = 4;
};
template <> struct Vec<float> {
  using type = float4;
  static constexpr int VW = 4, SA = 8;
};

__device__ __forceinline__ double fma_free(double a, double s, double g) {
  return __dadd_rn(__dmul_rn(a, s), g);
}
__device__ __forceinline__ float fma_free(float a, float s, float g) {
  return __fadd_rn(__fmul_rn(a, s), g);
}

// Block x covers the coefficients cb - SA .. cb + C - 1 (cb = C blockIdx.x:
// its C and the SA before them) in shared memory: the seeds of its JB
// intervals, once, and each table row, double-buffered.  In an output row
// whose first sector-aligned element is e (0 <= e < SA, from the row's
// address), thread t writes elements cb - SA + VW t + e .. + VW - 1: one
// 16-byte store, so a warp's 32 stores cover whole 32-byte sectors that no
// other warp touches.
template <typename T, int JB>
__global__ void __launch_bounds__(kThreads) interval_affine_kernel(
    const T* __restrict__ x, int64_t x_sj, const T* __restrict__ A, const T* __restrict__ G,
    int64_t r0, int64_t R, int64_t J, int64_t N, T* __restrict__ out, int64_t out_sj,
    int64_t out_sr, T* __restrict__ seed_out, int64_t seed_sj) {
  using V = typename Vec<T>::type;
  constexpr int VW = Vec<T>::VW, SA = Vec<T>::SA, C = VW * kThreads, S = C + SA;
  __shared__ T seeds[JB][S];
  __shared__ T tab[2][2][S];  // [buffer][A, G][coefficient]
  const int t = threadIdx.x;
  const int64_t lo = (int64_t)blockIdx.x * C - SA;  // the coefficient of shared index 0

  // the grid's y walks the groups of JB intervals
  for (int64_t j0 = (int64_t)blockIdx.y * JB; j0 < J; j0 += (int64_t)gridDim.y * JB) {
    const int jn = J - j0 < JB ? (int)(J - j0) : JB;
    // the seeds, eight loads in flight a thread
    for (int i0 = t; i0 < JB * S; i0 += 8 * kThreads) {
      T v[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kThreads, b = i / S, c = i - b * S;
        const int64_t n = lo + c;
        v[q] = i < JB * S && b < jn && n >= 0 && n < N ? __ldg(x + (j0 + b) * x_sj + n) : T(0);
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int i = i0 + q * kThreads;
        if (i < JB * S) seeds[i / S][i % S] = v[q];
      }
    }
    // a table row's share of this thread: loaded into registers at the
    // start of a row's stores and written to shared memory after them, so
    // the loads' latency hides behind the stores
    constexpr int P = (S + kThreads - 1) / kThreads;
    T ra[P], rg[P];
    auto load_row = [&](int64_t r) {
      const T* a = A + (r0 + r) * N;
      const T* g = G + (r0 + r) * N;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int c = t + q * kThreads;
        const int64_t n = lo + c;
        const bool in = c < S && n >= 0 && n < N;
        ra[q] = in ? __ldg(a + n) : T(0);
        rg[q] = in ? __ldg(g + n) : T(0);
      }
    };
    auto store_row = [&](int buf) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int c = t + q * kThreads;
        if (c < S) {
          tab[buf][0][c] = ra[q];
          tab[buf][1][c] = rg[q];
        }
      }
    };
    if (R > 0) {
      load_row(0);
      store_row(0);
    }
    __syncthreads();
    if (seed_out != nullptr) {  // the block's own C coefficients, not the SA before them
      for (int i = t; i < jn * C; i += kThreads) {
        const int b = i / C, c = SA + i - b * C;
        const int64_t n = lo + c;
        if (n < N) seed_out[(j0 + b) * seed_sj + n] = seeds[b][c];
      }
    }
    for (int64_t r = 0; r < R; ++r) {
      const int cur = (int)(r & 1);
      const bool next = r + 1 < R;
      if (next) load_row(r + 1);
      for (int b = 0; b < jn; ++b) {
        T* o = out + (j0 + b) * out_sj + r * out_sr;
        // the row's first sector-aligned element; the block shares the row
        const int e = (SA - (int)((reinterpret_cast<uintptr_t>(o) / sizeof(T)) % SA)) % SA;
        const int c = VW * t + e;  // shared index of the thread's first element
        const int64_t n = lo + c;
        V v;
        T* lanes = reinterpret_cast<T*>(&v);
#pragma unroll
        for (int u = 0; u < VW; ++u) {
          lanes[u] = fma_free(tab[cur][0][c + u], seeds[b][c + u], tab[cur][1][c + u]);
        }
        if (n >= 0 && n + VW <= N) {
          __stcs(reinterpret_cast<V*>(o + n), v);
        } else {
#pragma unroll
          for (int u = 0; u < VW; ++u) {
            if (n + u >= 0 && n + u < N) __stcs(o + n + u, lanes[u]);
          }
        }
      }
      if (next) store_row(cur ^ 1);
      __syncthreads();
    }
    __syncthreads();  // the seed copies read seeds[] before the next group writes it
  }
}

// JB from the shape: 16 intervals a block where that leaves at least two
// blocks an SM, else 4, else 1
template <typename T>
int launch(const T* x, int64_t x_sj, const T* A, const T* G, int64_t r0, int64_t R, int64_t J,
           int64_t N, T* out, int64_t out_sj, int64_t out_sr, T* seed_out, int64_t seed_sj,
           void* stream) {
  if (J == 0 || N == 0) return 0;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  constexpr int C = Vec<T>::VW * kThreads, SA = Vec<T>::SA;
  const int64_t bx = (N + SA + C - 1) / C;
  const int jb = bx * ((J + 15) / 16) >= 2 * sms ? 16 : bx * ((J + 3) / 4) >= 2 * sms ? 4 : 1;
  const int64_t groups = (J + jb - 1) / jb;
  const int64_t by = groups < 65535 ? groups : 65535;
  if (bx > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (jb == 16) {
    interval_affine_kernel<T, 16><<<grid, kThreads, 0, s>>>(x, x_sj, A, G, r0, R, J, N, out,
                                                            out_sj, out_sr, seed_out, seed_sj);
  } else if (jb == 4) {
    interval_affine_kernel<T, 4><<<grid, kThreads, 0, s>>>(x, x_sj, A, G, r0, R, J, N, out,
                                                           out_sj, out_sr, seed_out, seed_sj);
  } else {
    interval_affine_kernel<T, 1><<<grid, kThreads, 0, s>>>(x, x_sj, A, G, r0, R, J, N, out,
                                                           out_sj, out_sr, seed_out, seed_sj);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_interval_affine_f64(const double* x, int64_t x_sj, const double* A,
                           const double* G, int64_t r0, int64_t R, int64_t J,
                           int64_t N, double* out, int64_t out_sj,
                           int64_t out_sr, double* seed_out, int64_t seed_sj,
                           void* stream) {
  return launch<double>(x, x_sj, A, G, r0, R, J, N, out, out_sj, out_sr,
                        seed_out, seed_sj, stream);
}

int pm_interval_affine_f32(const float* x, int64_t x_sj, const float* A,
                           const float* G, int64_t r0, int64_t R, int64_t J,
                           int64_t N, float* out, int64_t out_sj,
                           int64_t out_sr, float* seed_out, int64_t seed_sj,
                           void* stream) {
  return launch<float>(x, x_sj, A, G, r0, R, J, N, out, out_sj, out_sr,
                       seed_out, seed_sj, stream);
}

}  // extern "C"
