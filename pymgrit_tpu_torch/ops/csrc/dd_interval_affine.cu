// K23 dd_interval_affine: K1's closed-form interval relaxation in
// double-double, out[j, r, n] = A[r0 + r, n] (x) x[j, n] (+) G[r0 + r, n]
// with DD mul (x) and add (+) (dd.cuh), every value a float32 pair.
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.relax_interval, spectral
// DD branch (`A_k[:, None] * seed[None] + G_k[:, None]`, :528-537), the
// same in pymgrit_tpu/models/heat_1d.py (:191-200), and through it the
// condensed C-step and the materialization of the level-0 tube
// (pymgrit_tpu/core/solver.py _cnd_c_step, _cnd_materialize_expr).
//
// Bound: bytes written.  The materialization writes the whole 16385 x 16129
// DD tube (8 bytes a value, 2.1 GB) and reads the 512 seeds and two
// (31, 16129) DD tables, which stay in the 50 MB L2; one DD mul and add are
// ~40 float32 operations a value, far under the FP32 rate.  Design: K1's,
// one thread per (interval j, coefficient n) holding its seed in two
// registers across the table rows, coalesced stores; hi and lo of x, out
// and seed_out are addressed by separate pointers with shared element
// strides, so the solver's packed (rows, 2, N) tubes (lo = hi + N) and DD
// pairs of separate tensors both work.  seed_out, when not null, receives a
// copy of the seed (the tube's C-point row).

#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

__global__ void dd_interval_affine_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
                                          int64_t x_sj, const float* __restrict__ Ah,
                                          const float* __restrict__ Al, const float* __restrict__ Gh,
                                          const float* __restrict__ Gl, int64_t r0, int64_t R,
                                          int64_t J, int64_t N, float* __restrict__ oh,
                                          float* __restrict__ ol, int64_t out_sj, int64_t out_sr,
                                          float* __restrict__ sh, float* __restrict__ sl,
                                          int64_t seed_sj) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  for (int64_t j = blockIdx.y; j < J; j += gridDim.y) {
    const dd::F2 s{xh[j * x_sj + n], xl[j * x_sj + n]};
    if (sh != nullptr) {
      sh[j * seed_sj + n] = s.hi;
      sl[j * seed_sj + n] = s.lo;
    }
    const int64_t o = j * out_sj + n;
    for (int64_t r = 0; r < R; ++r) {
      const int64_t t = (r0 + r) * N + n;
      const dd::F2 y = dd::add(dd::mul(dd::F2{Ah[t], Al[t]}, s), dd::F2{Gh[t], Gl[t]});
      oh[o + r * out_sr] = y.hi;
      ol[o + r * out_sr] = y.lo;
    }
  }
}

}  // namespace

extern "C" {

int pm_dd_interval_affine(const float* xh, const float* xl, int64_t x_sj, const float* Ah,
                          const float* Al, const float* Gh, const float* Gl, int64_t r0,
                          int64_t R, int64_t J, int64_t N, float* oh, float* ol, int64_t out_sj,
                          int64_t out_sr, float* sh, float* sl, int64_t seed_sj, void* stream) {
  if (J == 0 || N == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((N + threads - 1) / threads), (unsigned)(J < 65535 ? J : 65535));
  dd_interval_affine_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      xh, xl, x_sj, Ah, Al, Gh, Gl, r0, R, J, N, oh, ol, out_sj, out_sr, sh, sl, seed_sj);
  return (int)cudaGetLastError();
}

}  // extern "C"
