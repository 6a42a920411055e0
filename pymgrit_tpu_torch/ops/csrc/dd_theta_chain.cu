// K24 dd_theta_chain: K2's J independent chains of L spectral theta-steps
// in double-double, every value a float32 pair and every operation a DD
// operation of dd.cuh, in the expression order of the JAX package:
//
//   shift = dt (x) theta
//   BE:  b = (x (+) dt (x) r1) (+) shift (x) lift
//   CN:  b = ((x (-) shift (x) (x (x) lam)) (+) (shift (x) 2) (x) lift)
//            (+) dt (x) fl32(fl32(theta r1) + fl32((1 - theta) r0))
//   x <- [g (+)] b (/) (shift (x) lam (+) 1)
//
// with the rhs rows r1 = rhs(t_k+1), r0 = rhs(t_k) float32 (the JAX
// package's DD rhs table is float32, and CN mixes it in float32 before the
// DD product).  Every step's x is written to out[j, k].
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D._step_spectral in DD
// (:419-437) as the JAX solver batches it (lax.scan of m-1 steps plus g in
// _f_relax_uniform, the one-step Phi of _c_relax_uniform and _fas_residual,
// the sequential coarsest _forward_solve), and Heat1D's spectral DD step
// (pymgrit_tpu/models/heat_1d.py:228-231: BE with a zero lift).
//
// Bound: bytes.  Each step reads one g row and writes one out row a chain,
// 8 + 8 bytes a coefficient, against ~150 float32 operations (one DD div,
// four DD muls, three DD adds).  Design: K2's, one thread per (chain j,
// coefficient n) carrying x in two registers across all L steps; lam and
// lift loaded once a thread; hi and lo by separate pointers with shared
// strides (the solver's packed tubes, or separate tensors).

#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

struct Chain {
  const float *xh, *xl;
  int64_t x_sj;
  float *oh, *ol;
  int64_t out_sj, out_sk;
  const float *gh, *gl;
  int64_t g_sj, g_sk;
  const float *dth, *dtl;                 // (L, J) step sizes
  const float *lamh, *laml, *lifth, *liftl;
  const float *rhs1, *rhs0;               // float32 rows, strides r_sk, r_sj
  int64_t r_sk, r_sj;
  float th_hi, th_lo;                     // theta split
  float th32, oth32;                      // float32 theta and 1 - theta
  int be;
  int64_t J, L, N;
};

__global__ void dd_theta_chain_kernel(const Chain c) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= c.N) return;
  const dd::F2 lm{c.lamh[n], c.laml[n]};
  const dd::F2 lf{c.lifth[n], c.liftl[n]};
  const dd::F2 theta{c.th_hi, c.th_lo};
  for (int64_t j = blockIdx.y; j < c.J; j += gridDim.y) {
    dd::F2 x{c.xh[j * c.x_sj + n], c.xl[j * c.x_sj + n]};
    for (int64_t k = 0; k < c.L; ++k) {
      const dd::F2 d{c.dth[k * c.J + j], c.dtl[k * c.J + j]};
      const dd::F2 shift = dd::mul(d, theta);
      const int64_t ri = k * c.r_sk + j * c.r_sj + n;
      dd::F2 b;
      if (c.be) {
        b = dd::add(dd::add(x, dd::mul(d, dd::F2{c.rhs1[ri], 0.0f})), dd::mul(shift, lf));
      } else {
        const float r = __fadd_rn(__fmul_rn(c.th32, c.rhs1[ri]), __fmul_rn(c.oth32, c.rhs0[ri]));
        b = dd::sub(x, dd::mul(shift, dd::mul(x, lm)));
        b = dd::add(b, dd::mul(dd::mul(shift, dd::F2{2.0f, 0.0f}), lf));
        b = dd::add(b, dd::mul(d, dd::F2{r, 0.0f}));
      }
      x = dd::div(b, dd::add(dd::mul(shift, lm), dd::F2{1.0f, 0.0f}));
      if (c.gh != nullptr) {
        const int64_t gi = j * c.g_sj + k * c.g_sk + n;
        x = dd::add(dd::F2{c.gh[gi], c.gl[gi]}, x);
      }
      const int64_t oi = j * c.out_sj + k * c.out_sk + n;
      c.oh[oi] = x.hi;
      c.ol[oi] = x.lo;
    }
  }
}

}  // namespace

extern "C" {

// ptrs: x0 hi, lo; out hi, lo; g hi, lo (null without g); dt hi, lo; lam
// hi, lo; lift hi, lo; rhs1; rhs0 (14).  strides: x_sj, out_sj, out_sk,
// g_sj, g_sk, r_sk, r_sj (7).  dims: J, L, N.
int pm_dd_theta_chain(void* const* ptrs, const int64_t* strides, double theta,
                      const int64_t* dims, void* stream) {
  Chain c;
  c.xh = static_cast<const float*>(ptrs[0]);
  c.xl = static_cast<const float*>(ptrs[1]);
  c.oh = static_cast<float*>(ptrs[2]);
  c.ol = static_cast<float*>(ptrs[3]);
  c.gh = static_cast<const float*>(ptrs[4]);
  c.gl = static_cast<const float*>(ptrs[5]);
  c.dth = static_cast<const float*>(ptrs[6]);
  c.dtl = static_cast<const float*>(ptrs[7]);
  c.lamh = static_cast<const float*>(ptrs[8]);
  c.laml = static_cast<const float*>(ptrs[9]);
  c.lifth = static_cast<const float*>(ptrs[10]);
  c.liftl = static_cast<const float*>(ptrs[11]);
  c.rhs1 = static_cast<const float*>(ptrs[12]);
  c.rhs0 = static_cast<const float*>(ptrs[13]);
  c.x_sj = strides[0];
  c.out_sj = strides[1];
  c.out_sk = strides[2];
  c.g_sj = strides[3];
  c.g_sk = strides[4];
  c.r_sk = strides[5];
  c.r_sj = strides[6];
  c.th_hi = (float)theta;
  c.th_lo = (float)(theta - (double)c.th_hi);
  c.th32 = (float)theta;
  c.oth32 = (float)(1.0 - theta);
  c.be = theta == 1.0 ? 1 : 0;
  c.J = dims[0];
  c.L = dims[1];
  c.N = dims[2];
  if (c.J == 0 || c.L == 0 || c.N == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((c.N + threads - 1) / threads), (unsigned)(c.J < 65535 ? c.J : 65535));
  dd_theta_chain_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(c);
  return (int)cudaGetLastError();
}

}  // extern "C"
