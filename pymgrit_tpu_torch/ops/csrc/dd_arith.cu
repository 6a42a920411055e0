// K25 dd_arith: elementwise double-double arithmetic over strided operands
// of up to four dimensions,
//
//   add, sub, mul, div    out = a op b
//   sqrt, neg             out = op a
//   combine               out = t_0 (+) t_1 (+) ... (+) t_{n-1}, t_k = c_k (x) x_k
//   resid                 out = float32 value of a (-) b          (float32 out)
//
// where (+) and (x) are DD add and mul (dd.cuh) and each combine coefficient
// c_k is +1 (x_k itself), -1 (its negation) or an exactly split DD constant.
//
// Replaces: pymgrit_tpu/ops/dd.py add/sub/mul/div/sqrt (:270-315) behind
// the DD operators (:152-183), and the DD branches of pymgrit_tpu/core/
// vector.py add/sub/scale/axpy (:51-72) and add_at (:134-146) through which
// the JAX solver forms the FAS residual, the correction, the weighted
// C-update and the residual (pymgrit_tpu/core/solver.py:899-989,
// 1056-1076); the JAX package leaves them to XLA's elementwise fusion.
//
// Bound: bytes.  Each element reads 8 bytes an operand and writes 8 (4 for
// resid) against 20-60 float32 operations a DD op, far under the FP32 rate.
// Design: the wrapper broadcasts every operand to the output's shape and
// hands element strides (0 where broadcast; hi and lo strided alike or not,
// so an operand may be a DD pair of separate tensors or the two halves of a
// packed tube row); one thread per element of the innermost axis, the outer
// three axes over blockIdx.y, so neighbouring threads touch neighbouring
// addresses.  An operand with a null hi pointer is an immediate scalar
// passed by value; a null lo pointer reads lo = 0 (a float32 tensor taken
// at face value).  The arguments travel by value in one struct.

#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int kMaxTerms = 8;

enum Op { kAdd = 0, kSub, kMul, kDiv, kSqrt, kNeg, kCombine, kResid };

struct Operand {
  const float* hi;
  const float* lo;
  int64_t shi[4];
  int64_t slo[4];
  float ihi, ilo;
};

struct Args {
  int op, n;
  int64_t size[4];
  float* ohi;
  float* olo;
  int64_t sohi[4];
  int64_t solo[4];
  Operand in[kMaxTerms];
  float chi[kMaxTerms], clo[kMaxTerms];
  int kind[kMaxTerms];  // +1, -1, or 0 (multiply by chi + clo)
};

__device__ __forceinline__ dd::F2 load(const Operand& o, int64_t i0, int64_t i1, int64_t i2,
                                       int64_t i3) {
  if (o.hi == nullptr) return {o.ihi, o.ilo};
  const float h = o.hi[i0 * o.shi[0] + i1 * o.shi[1] + i2 * o.shi[2] + i3 * o.shi[3]];
  const float l = o.lo == nullptr ? 0.0f
                                  : o.lo[i0 * o.slo[0] + i1 * o.slo[1] + i2 * o.slo[2] + i3 * o.slo[3]];
  return {h, l};
}

__global__ void dd_arith_kernel(const Args a) {
  const int64_t i3 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i3 >= a.size[3]) return;
  const int64_t outer = a.size[0] * a.size[1] * a.size[2];
  for (int64_t o = blockIdx.y; o < outer; o += gridDim.y) {
    const int64_t i2 = o % a.size[2];
    const int64_t i1 = (o / a.size[2]) % a.size[1];
    const int64_t i0 = o / (a.size[2] * a.size[1]);
    dd::F2 r;
    switch (a.op) {
      case kAdd: r = dd::add(load(a.in[0], i0, i1, i2, i3), load(a.in[1], i0, i1, i2, i3)); break;
      case kSub:
      case kResid: r = dd::sub(load(a.in[0], i0, i1, i2, i3), load(a.in[1], i0, i1, i2, i3)); break;
      case kMul: r = dd::mul(load(a.in[0], i0, i1, i2, i3), load(a.in[1], i0, i1, i2, i3)); break;
      case kDiv: r = dd::div(load(a.in[0], i0, i1, i2, i3), load(a.in[1], i0, i1, i2, i3)); break;
      case kSqrt: r = dd::sqrt(load(a.in[0], i0, i1, i2, i3)); break;
      case kNeg: r = dd::neg(load(a.in[0], i0, i1, i2, i3)); break;
      default: {  // kCombine
        for (int k = 0; k < a.n; ++k) {
          dd::F2 t = load(a.in[k], i0, i1, i2, i3);
          if (a.kind[k] < 0) t = dd::neg(t);
          else if (a.kind[k] == 0) t = dd::mul(t, dd::F2{a.chi[k], a.clo[k]});
          r = k == 0 ? t : dd::add(r, t);
        }
      }
    }
    const int64_t oh = i0 * a.sohi[0] + i1 * a.sohi[1] + i2 * a.sohi[2] + i3 * a.sohi[3];
    if (a.op == kResid) {
      a.ohi[oh] = dd::to_float(r);
    } else {
      a.ohi[oh] = r.hi;
      a.olo[i0 * a.solo[0] + i1 * a.solo[1] + i2 * a.solo[2] + i3 * a.solo[3]] = r.lo;
    }
  }
}

}  // namespace

extern "C" {

// ptrs: out hi, out lo, then hi and lo of each of the n operands (2 + 2 n);
// strides: out hi, out lo, then hi and lo of each operand, four each
// (8 + 8 n); imm: hi and lo of each operand (used where its hi is null);
// coef: hi and lo of each combine coefficient; kind: one per operand;
// size: the four extents.
int pm_dd_arith(int op, int n, void* const* ptrs, const int64_t* strides, const float* imm,
                const float* coef, const int* kind, const int64_t* size, void* stream) {
  if (n < 1 || n > kMaxTerms) return (int)cudaErrorInvalidValue;
  Args a;
  a.op = op;
  a.n = n;
  for (int d = 0; d < 4; ++d) a.size[d] = size[d];
  a.ohi = static_cast<float*>(ptrs[0]);
  a.olo = static_cast<float*>(ptrs[1]);
  for (int d = 0; d < 4; ++d) {
    a.sohi[d] = strides[d];
    a.solo[d] = strides[4 + d];
  }
  for (int k = 0; k < kMaxTerms; ++k) {
    Operand& o = a.in[k];
    const bool used = k < n;
    o.hi = used ? static_cast<const float*>(ptrs[2 + 2 * k]) : nullptr;
    o.lo = used ? static_cast<const float*>(ptrs[3 + 2 * k]) : nullptr;
    for (int d = 0; d < 4; ++d) {
      o.shi[d] = used ? strides[8 + 8 * k + d] : 0;
      o.slo[d] = used ? strides[12 + 8 * k + d] : 0;
    }
    o.ihi = used ? imm[2 * k] : 0.0f;
    o.ilo = used ? imm[2 * k + 1] : 0.0f;
    a.chi[k] = used ? coef[2 * k] : 0.0f;
    a.clo[k] = used ? coef[2 * k + 1] : 0.0f;
    a.kind[k] = used ? kind[k] : 1;
  }
  const int64_t outer = size[0] * size[1] * size[2];
  if (outer == 0 || size[3] == 0) return 0;
  const int threads = 256;
  const dim3 grid((unsigned)((size[3] + threads - 1) / threads),
                  (unsigned)(outer < 65535 ? outer : 65535));
  dd_arith_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
