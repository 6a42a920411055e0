// Double-double ("DD") arithmetic on float32 pairs hi + lo, the device
// counterpart of pymgrit_tpu/ops/dd.py (error-free transforms of Knuth and
// Dekker, the QD library's accurate add/mul/div/sqrt) and of the plain
// versions in pymgrit_tpu_torch/ops/dd.py, operation for operation.
//
// Every operation is an intrinsic that rounds once (__fadd_rn, __fsub_rn,
// __fmul_rn, __fdiv_rn, __fsqrt_rn).  nvcc never contracts these into FMAs
// and never reassociates them, which the transforms need: under the default
// --fmad=true a plain `c - (c - a)` (Dekker's split) or `e + (a*b + c*d)`
// (DD mul) would be contracted and the error terms lost.  Dekker's two_prod
// is kept (rather than __fmaf_rn(a, b, -p), which gives the same exact error
// term) so that the kernels and the plain versions execute the same
// operations.  With -ftz=false (nvcc's default) subnormals are kept, as
// PyTorch keeps them.

#pragma once

#include <cuda_runtime.h>

namespace dd {

struct F2 {
  float hi, lo;
};

__device__ __forceinline__ F2 two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

__device__ __forceinline__ F2 quick_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

__device__ __forceinline__ F2 split(float a) {
  const float c = __fmul_rn(4097.0f, a);
  const float h = __fsub_rn(c, __fsub_rn(c, a));
  return {h, __fsub_rn(a, h)};
}

__device__ __forceinline__ F2 two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  const F2 as = split(a), bs = split(b);
  float e = __fsub_rn(__fmul_rn(as.hi, bs.hi), p);
  e = __fadd_rn(e, __fmul_rn(as.hi, bs.lo));
  e = __fadd_rn(e, __fmul_rn(as.lo, bs.hi));
  e = __fadd_rn(e, __fmul_rn(as.lo, bs.lo));
  return {p, e};
}

__device__ __forceinline__ F2 add(F2 x, F2 y) {
  F2 s = two_sum(x.hi, y.hi);
  const F2 t = two_sum(x.lo, y.lo);
  s = quick_two_sum(s.hi, __fadd_rn(s.lo, t.hi));
  return quick_two_sum(s.hi, __fadd_rn(s.lo, t.lo));
}

__device__ __forceinline__ F2 neg(F2 x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ F2 sub(F2 x, F2 y) { return add(x, neg(y)); }

__device__ __forceinline__ F2 mul(F2 x, F2 y) {
  const F2 p = two_prod(x.hi, y.hi);
  const float e = __fadd_rn(p.lo, __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi)));
  return quick_two_sum(p.hi, e);
}

__device__ __forceinline__ F2 div(F2 x, F2 y) {
  const float q1 = __fdiv_rn(x.hi, y.hi);
  F2 r = sub(x, mul(y, F2{q1, 0.0f}));
  const float q2 = __fdiv_rn(r.hi, y.hi);
  r = sub(r, mul(y, F2{q2, 0.0f}));
  const float q3 = __fdiv_rn(r.hi, y.hi);
  return add(quick_two_sum(q1, q2), F2{q3, 0.0f});
}

// One Karp/Markstein refinement of the float32 root; sqrt(x) = 0 where
// x.hi <= 0 (and, as in the JAX package, 0.5 where x.hi is NaN)
__device__ __forceinline__ F2 sqrt(F2 x) {
  const bool pos = x.hi > 0.0f;
  const float y = __fsqrt_rn(pos ? x.hi : 1.0f);
  const F2 e = sub(F2{pos ? x.hi : 0.0f, pos ? x.lo : 0.0f}, mul(F2{y, 0.0f}, F2{y, 0.0f}));
  const float corr = __fmul_rn(e.hi, __fdiv_rn(0.5f, y));
  const F2 out = add(F2{y, 0.0f}, F2{corr, 0.0f});
  return x.hi <= 0.0f ? F2{0.0f, 0.0f} : out;
}

// The float32 value hi + lo (what the JAX package's norms read)
__device__ __forceinline__ float to_float(F2 x) { return __fadd_rn(x.hi, x.lo); }

}  // namespace dd
