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
// Bound: bytes on paper, the float32 issue in fact.  Each step reads one g
// row and writes one out row a chain, 8 + 8 bytes a coefficient (the
// dd_toms129 level-1 F-relaxation, J = 32, L = 15, N = 16129, moves 128 MB:
// 0.0383 ms at 3.35 TB/s), against ~290 float32 operations a coefficient
// and step (one DD div with three true divisions, four DD muls, four DD
// adds), ~180 where the step's invariants are formed once: the level-1
// call's 2.2 G operations take ~0.067 ms at one a lane a clock on the
// card's 16,896 FP32 lanes.  What held the first version back: every step re-formed its
// invariants, loaded its g row after its arithmetic, and branched on BE/CN
// and g at run time.  Design (ops/heat_kernels.py ``dd_theta_chain_plan``,
// ``dd_theta_chain_pack``):
// * one thread a coefficient of a chain, coalesced on any row.  K2's
//   design, a thread owning 16 bytes (4 coefficients) with the rows through
//   a cp.async ring, ran slower at every dd_toms129 shape (level-1 BE
//   0.0960 ms of device time, chip_smoke.py phase 3 on an NVIDIA H100 80GB
//   HBM3): 3 of 4 rows of the packed (J, L, 2, N) tube start off 16-byte
//   alignment, where element copies and shuffled whole-sector stores cost
//   more issue than the vectors saved, and 4 chains a thread left fewer
//   threads to hide the DD operations' latency;
// * each warp checks once whether the chain's step sizes are all equal (hi
//   and lo, bit for bit; no block barrier); if so, the step's shift, the DD
//   denominator shift (x) lam (+) 1, the lift term and, with a
//   time-independent rhs, the rhs term dt (x) r (CN: its float32 mix
//   first) are formed once: the same operations on the same operands as
//   every step forms them, so the same bits;
// * step k + 1's rows (g, a tabulated rhs) are loaded during step k, step
//   0's with the seeds, so that no step waits on its rows;
// * a one-step call (C-relaxation, the FAS residual) takes a leaner
//   variant: no check, no invariants, no loop, every operand loaded up
//   front, in 32-40 registers (through the chain code, in 40-48, these
//   latency-bound calls held fewer threads and ran behind the first
//   version);
// * compile-time variants for BE / CN, with or without g, a
//   time-independent (strides 0) or tabulated rhs, one step or more;
// * every float32 operation is an intrinsic that rounds once (dd.cuh), in
//   dd_theta_chain_plain's order: the kernel equals the plain version bit
//   for bit;
// * the work is a range of items (chain, segment of a block's threads),
//   one block an item, so the coarse-level calls (J = 1-8, L = 1-3) launch
//   no idle blocks; the block has 256, 128 or 64 threads, the largest that
//   still gives 4 items an SM.
// Launched by one ctypes call: a packed int64 argument array and theta as
// a double.

#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int kThreads = 256;   // the largest block (8 warps)

struct Params {
  const float *xh, *xl;            // seeds (J rows, stride x_sj)
  float *oh, *ol;                  // out rows at j * out_sj + k * out_sk
  const float *gh, *gl;            // null: no g
  const float *dth, *dtl;          // (L, J) contiguous step sizes
  const float *lamh, *laml, *lifth, *liftl;
  const float *rhs1, *rhs0;        // float32 rows at k * r_sk + j * r_sj
  int64_t x_sj, out_sj, out_sk, g_sj, g_sk, r_sk, r_sj;  // strides (elements)
  int64_t J, L, N;
  int64_t segs;                    // segments a chain (a block's threads each)
  float th_hi, th_lo;              // theta split into a float32 pair
  float th32, oth32;               // float32 theta and 1 - theta
};

__device__ __forceinline__ dd::F2 f2(float hi) { return dd::F2{hi, 0.0f}; }

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}

// the float32 rhs term of a step: r1 (BE) or theta r1 + (1 - theta) r0 (CN)
template <bool CN>
__device__ __forceinline__ float rhs_mix(const Params& p, float r1, float r0) {
  return CN ? __fadd_rn(__fmul_rn(p.th32, r1), __fmul_rn(p.oth32, r0)) : r1;
}

// the lift term of a step: shift (x) lift (BE) or (shift (x) 2) (x) lift (CN)
template <bool CN>
__device__ __forceinline__ dd::F2 lift_term(dd::F2 shift, dd::F2 lf) {
  return dd::mul(CN ? dd::mul(shift, f2(2.0f)) : shift, lf);
}

// the step's DD denominator shift (x) lam (+) 1
__device__ __forceinline__ dd::F2 denom(dd::F2 shift, dd::F2 lm) {
  return dd::add(dd::mul(shift, lm), f2(1.0f));
}

// one theta-step of x from its terms (shift, the lift term sl, the rhs term
// dr = dt (x) mix, the denominator den), g (hi, lo) added after it with G
template <bool CN, bool G>
__device__ __forceinline__ dd::F2 theta_step(dd::F2 x, dd::F2 shift, dd::F2 lm, dd::F2 sl,
                                             dd::F2 dr, dd::F2 den, float gh, float gl) {
  dd::F2 b;
  if (CN) {
    b = dd::sub(x, dd::mul(shift, dd::mul(x, lm)));
    b = dd::add(b, sl);
    b = dd::add(b, dr);
  } else {
    b = dd::add(dd::add(x, dr), sl);
  }
  x = dd::div(b, den);
  return G ? dd::add(dd::F2{gh, gl}, x) : x;
}

// chain j's L steps of coefficient n; UNI: the chain's step sizes are all
// equal, and the step's invariants are formed once.  Step k + 1's rows (g,
// a tabulated rhs) are loaded during step k, step 0's with the seeds.  CN:
// theta != 1; G: g added after each step; TAB: the rhs rows change with
// (k, j).
template <bool UNI, bool CN, bool G, bool TAB>
__device__ __forceinline__ void walk(const Params& p, int64_t j, int64_t n) {
  const float* dth = p.dth + j;
  const float* dtl = p.dtl + j;
  const float* r1 = p.rhs1 + j * p.r_sj + n;
  const float* r0 = p.rhs0 + j * p.r_sj + n;
  const float* gh = G ? p.gh + j * p.g_sj + n : nullptr;
  const float* gl = G ? p.gl + j * p.g_sj + n : nullptr;
  float* oh = p.oh + j * p.out_sj + n;
  float* ol = p.ol + j * p.out_sj + n;
  const dd::F2 theta{p.th_hi, p.th_lo};
  dd::F2 x{__ldg(p.xh + j * p.x_sj + n), __ldg(p.xl + j * p.x_sj + n)};
  const dd::F2 lm{__ldg(p.lamh + n), __ldg(p.laml + n)};
  const dd::F2 lf{__ldg(p.lifth + n), __ldg(p.liftl + n)};
  // a time-independent rhs: r1 (BE) or the float32 mix theta r1 + (1 - theta) r0 (CN)
  float mix = 0.0f;
  if (!TAB) mix = rhs_mix<CN>(p, __ldg(r1), CN ? __ldg(r0) : 0.0f);
  // step k's rows: g hi, lo, r1, r0
  const auto rows = [&](int64_t k, float (&v)[4]) {
    if (G) {
      v[0] = __ldg(gh + k * p.g_sk);
      v[1] = __ldg(gl + k * p.g_sk);
    }
    if (TAB) {
      v[2] = __ldg(r1 + k * p.r_sk);
      if (CN) v[3] = __ldg(r0 + k * p.r_sk);
    }
  };
  float next[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  rows(0, next);
  dd::F2 d{__ldg(dth), __ldg(dtl)}, shift{0.0f, 0.0f}, den{0.0f, 0.0f}, sl{0.0f, 0.0f},
      dr{0.0f, 0.0f};
  if (UNI) {
    shift = dd::mul(d, theta);
    den = denom(shift, lm);
    sl = lift_term<CN>(shift, lf);
    if (!TAB) dr = dd::mul(d, f2(mix));
  }
#pragma unroll 1
  for (int64_t k = 0; k < p.L; ++k) {
    const float v[4] = {next[0], next[1], next[2], next[3]};
    if (k + 1 < p.L) rows(k + 1, next);
    const float m = !TAB ? mix : rhs_mix<CN>(p, v[2], v[3]);
    const dd::F2 dk = d;
    if (!UNI && k + 1 < p.L) d = dd::F2{__ldg(dth + (k + 1) * p.J), __ldg(dtl + (k + 1) * p.J)};
    const dd::F2 sk = UNI ? shift : dd::mul(dk, theta);
    const dd::F2 drk = UNI && !TAB ? dr : dd::mul(dk, f2(m));
    const dd::F2 slk = UNI ? sl : lift_term<CN>(sk, lf);
    const dd::F2 dn = UNI ? den : denom(sk, lm);
    x = theta_step<CN, G>(x, sk, lm, slk, drk, dn, v[0], v[1]);
    oh[k * p.out_sk] = x.hi;
    ol[k * p.out_sk] = x.lo;
  }
}

// one step of chain j's coefficient n (L = 1: C-relaxation, the FAS
// residual): every operand loaded up front, no loop (fewer registers: more
// threads in flight for these latency-bound calls)
template <bool CN, bool G, bool TAB>
__device__ __forceinline__ void step1(const Params& p, int64_t j, int64_t n) {
  const dd::F2 theta{p.th_hi, p.th_lo};
  const int64_t xi = j * p.x_sj + n, ri = j * p.r_sj + n;
  const dd::F2 x{__ldg(p.xh + xi), __ldg(p.xl + xi)};
  const dd::F2 lm{__ldg(p.lamh + n), __ldg(p.laml + n)};
  const dd::F2 lf{__ldg(p.lifth + n), __ldg(p.liftl + n)};
  const dd::F2 d{__ldg(p.dth + j), __ldg(p.dtl + j)};
  const float r1 = __ldg(p.rhs1 + ri), r0 = CN ? __ldg(p.rhs0 + ri) : 0.0f;
  float gh = 0.0f, gl = 0.0f;
  if (G) {
    gh = __ldg(p.gh + j * p.g_sj + n);
    gl = __ldg(p.gl + j * p.g_sj + n);
  }
  const dd::F2 sk = dd::mul(d, theta);
  const dd::F2 y = theta_step<CN, G>(x, sk, lm, lift_term<CN>(sk, lf),
                                     dd::mul(d, f2(rhs_mix<CN>(p, r1, r0))), denom(sk, lm), gh, gl);
  const int64_t oi = j * p.out_sj + n;
  p.oh[oi] = y.hi;
  p.ol[oi] = y.lo;
}

// LONG: more than one step (the uniform check, the invariants, the rows a
// step ahead); else the one-step calls (C-relaxation, the FAS residual)
template <bool LONG, bool CN, bool G, bool TAB>
__global__ void __launch_bounds__(kThreads) dd_theta_chain_kernel(const Params p) {
  const int64_t items = p.J * p.segs;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t j = (unsigned)it / (unsigned)p.segs;   // items < 2^31 (the launcher)
    const int64_t n = (it - j * p.segs) * blockDim.x + threadIdx.x;
    if (!LONG) {
      if (n < p.N) step1<CN, G, TAB>(p, j, n);
      continue;
    }
    // are chain j's step sizes all equal (hi and lo, bit for bit)?  Each
    // warp's lanes split the column (a warp's answer: no block barrier)
    const float h0 = p.dth[j], l0 = p.dtl[j];
    int uniform = 1;
    for (int64_t k = 1 + (threadIdx.x & 31); k < p.L; k += 32) {
      uniform &= same_bits(p.dth[k * p.J + j], h0) && same_bits(p.dtl[k * p.J + j], l0);
    }
    uniform = __all_sync(0xffffffffu, uniform);
    if (n >= p.N) continue;
    if (uniform) {
      walk<true, CN, G, TAB>(p, j, n);
    } else {
      walk<false, CN, G, TAB>(p, j, n);
    }
  }
}

// a one-step call reads its rhs row at k = 0 whatever its strides: one
// variant serves a time-independent and a tabulated rhs
template <bool CN, bool G>
void dispatch_rhs(bool tab, unsigned grid, unsigned block, cudaStream_t s, const Params& p) {
  if (p.L == 1) {
    dd_theta_chain_kernel<false, CN, G, false><<<grid, block, 0, s>>>(p);
  } else if (tab) {
    dd_theta_chain_kernel<true, CN, G, true><<<grid, block, 0, s>>>(p);
  } else {
    dd_theta_chain_kernel<true, CN, G, false><<<grid, block, 0, s>>>(p);
  }
}

}  // namespace

extern "C" {

// args (int64): CUDA device; x0 hi, lo; out hi, lo; g hi, lo (0: none); dt
// hi, lo; lam hi, lo; lift hi, lo; rhs1; rhs0; x0's chain stride, out's
// chain and step strides, g's chain and step strides, the rhs rows' step
// and chain strides; J, L, N, segments a chain, grid, CN (0: BE), g
// present, rhs tabulated, threads a block (a multiple of 32, at most
// kThreads); fewer than 2^31 items (ops/heat_kernels.py::dd_theta_chain_pack)
int pm_dd_theta_chain(const int64_t* a, double theta, void* stream) {
  Params p{};
  const auto in = [a](int i) { return reinterpret_cast<const float*>(a[i]); };
  p.xh = in(1);
  p.xl = in(2);
  p.oh = reinterpret_cast<float*>(a[3]);
  p.ol = reinterpret_cast<float*>(a[4]);
  p.gh = in(5);
  p.gl = in(6);
  p.dth = in(7);
  p.dtl = in(8);
  p.lamh = in(9);
  p.laml = in(10);
  p.lifth = in(11);
  p.liftl = in(12);
  p.rhs1 = in(13);
  p.rhs0 = in(14);
  p.x_sj = a[15];
  p.out_sj = a[16];
  p.out_sk = a[17];
  p.g_sj = a[18];
  p.g_sk = a[19];
  p.r_sk = a[20];
  p.r_sj = a[21];
  p.J = a[22];
  p.L = a[23];
  p.N = a[24];
  p.segs = a[25];
  const unsigned grid = (unsigned)a[26];
  const bool cn = a[27] != 0, g = a[28] != 0, tab = a[29] != 0;
  const unsigned block = (unsigned)a[30];
  p.th_hi = (float)theta;
  p.th_lo = (float)(theta - (double)p.th_hi);
  p.th32 = (float)theta;
  p.oth32 = (float)(1.0 - theta);
  if (p.J == 0 || p.L == 0 || p.N == 0) return 0;
  if (grid == 0 || block == 0 || block > kThreads || block % 32 != 0
      || p.J * p.segs >= (int64_t{1} << 31) || g != (p.gh != nullptr && p.gl != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cn && g) dispatch_rhs<true, true>(tab, grid, block, s, p);
  if (cn && !g) dispatch_rhs<true, false>(tab, grid, block, s, p);
  if (!cn && g) dispatch_rhs<false, true>(tab, grid, block, s, p);
  if (!cn && !g) dispatch_rhs<false, false>(tab, grid, block, s, p);
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // extern "C"
