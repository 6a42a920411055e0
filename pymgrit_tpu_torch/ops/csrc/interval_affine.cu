// K1 interval_affine: closed-form interval relaxation of the spectral heat
// step, out[j, r, n] = A[r0 + r, n] * x[j, n] + G[r0 + r, n].
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.relax_interval (spectral
// branch, `seed * A_t + G_t`) and pymgrit_tpu/core/solver.py
// Mgrit._cnd_materialize_expr (condensed C-rows -> full level-0 tube).
//
// Bound: bytes written.  At the main path's materialization it writes the
// whole 16385 x 16129 float64 tube (2.1 GB) and reads only the 512 seeds and
// two (31, 16129) tables, which stay in the 50 MB L2.  Design: one thread
// per (interval j, coefficient n); it loads its seed once into a register and
// loops over the table rows, so each output element is written exactly once
// by a coalesced store (neighbouring threads own neighbouring n).  The output
// layout is given by two element strides (out_sj between intervals, out_sr
// between rows), which covers the row-major (R, J, N) and interval-major
// (J, R, N) layouts and the tube itself (out_sj = m*N, out_sr = N).  When
// seed_out is not null the thread also copies its seed into that row (the
// C-point row j*m of the tube), so materialization needs no other pass.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void interval_affine_kernel(const T* __restrict__ x, int64_t x_sj,
                                       const T* __restrict__ A,
                                       const T* __restrict__ G, int64_t r0,
                                       int64_t R, int64_t J, int64_t N,
                                       T* __restrict__ out, int64_t out_sj,
                                       int64_t out_sr, T* __restrict__ seed_out,
                                       int64_t seed_sj) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  for (int64_t j = blockIdx.y; j < J; j += gridDim.y) {
    const T s = x[j * x_sj + n];
    if (seed_out != nullptr) seed_out[j * seed_sj + n] = s;
    T* o = out + j * out_sj + n;
    const T* a = A + r0 * N + n;
    const T* g = G + r0 * N + n;
    for (int64_t r = 0; r < R; ++r) {
      o[r * out_sr] = a[r * N] * s + g[r * N];
    }
  }
}

template <typename T>
int launch(const T* x, int64_t x_sj, const T* A, const T* G, int64_t r0,
           int64_t R, int64_t J, int64_t N, T* out, int64_t out_sj,
           int64_t out_sr, T* seed_out, int64_t seed_sj, void* stream) {
  if (J == 0 || N == 0) return 0;
  const int threads = 256;
  dim3 grid((unsigned)((N + threads - 1) / threads),
            (unsigned)(J < 65535 ? J : 65535));
  interval_affine_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      x, x_sj, A, G, r0, R, J, N, out, out_sj, out_sr, seed_out, seed_sj);
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
