// K25 dd_arith: elementwise double-double arithmetic over strided operands,
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
// resid) against 2-114 float32 operations a DD op, far under the FP32 rate.
// At the DD solves' small calls (one 63 x 63 state) the bound is the
// launch, so the host side is one ctypes call (ops/dd.py).
//
// Design:
// * one kernel a (op, term count): dd_arith_kernel<OP, NT, V, I>, so no
//   element branches on the op; the arithmetic is dd.cuh's round-once
//   transforms in the plain version's order, so the kernel equals
//   ops/dd.py dd_arith_plain bit for bit;
// * the wrapper broadcasts and coalesces every operand to at most three
//   outer axes (the rows) and one inner axis of extent W, with one
//   pointer and four element strides for each component (hi or lo) of each
//   operand and of out; a component with a null pointer is an immediate
//   (a 0-d CPU scalar) passed by value;
// * an item is one segment of 4 TX elements of one row; a block of TX x TY
//   threads (TX * TY = 256) takes TY items at a time, so short rows (61-65
//   at dd65) fill the block with TY = 16 rows; the grid is sized to the
//   card (blocks an SM from the occupancy of the instantiation, times the
//   SMs) and each block walks its items; a row's outer index is split once
//   an item, in 32-bit arithmetic (I = int) where every offset of the call
//   fits, else 64-bit;
// * V = 4 when out's components take 16-byte accesses (inner stride 1,
//   outer strides and pointer on 16 bytes): a thread owns 4 consecutive
//   elements and each component whose layout allows it is read as one
//   float4 (the others with scalar loads); else V = 1: a thread owns the
//   elements tx, tx + TX, ... of the segment, every access scalar and
//   coalesced across the warp;
// * the arguments travel as a packed int64 array and a float array
//   (immediates and coefficients), decoded once into a __grid_constant__
//   struct.

#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTerms = 8;
constexpr int kComps = 2 + 2 * kMaxTerms;   // out hi, out lo, then each operand's hi and lo
constexpr int kHead = 23;                   // int64 slots before the components
constexpr int kSlots = 5;                   // int64 slots a component

enum Op { kAdd = 0, kSub, kMul, kDiv, kSqrt, kNeg, kCombine, kResid };

struct Comp {
  const float* p;   // null: the immediate imm
  int64_t s[3];     // outer strides
  int64_t si;       // inner stride
  float imm;
};

struct Args {
  Comp c[kComps];
  int64_t size[3];  // outer extents
  int64_t W, segs, items;
  unsigned vec;     // bit k: component k takes float4 accesses
  float chi[kMaxTerms], clo[kMaxTerms];
  int kind[kMaxTerms];  // +1, -1, or 0 (multiply by chi + clo)
};

template <int OP, int NT>
struct Arity {
  static constexpr int value = OP == kCombine ? NT : (OP == kSqrt || OP == kNeg) ? 1 : 2;
};

// element j (< 4) of component k for this thread: V = 4 reads 4 consecutive
// elements from e0 (one float4 where allowed), V = 1 the elements e0 + j step
template <int V, typename I>
__device__ __forceinline__ void load4(const Comp& c, bool vec, I off, I e0, I step, I W,
                                      float (&v)[4]) {
  if (c.p == nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = c.imm;
    return;
  }
  const float* b = c.p + off;
  if (V == 4 && vec && e0 + 3 < W) {
    const float4 q = *reinterpret_cast<const float4*>(b + e0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
  const I si = (I)c.si;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const I e = e0 + (I)j * step;
    v[j] = e < W ? b[e * si] : 0.0f;
  }
}

template <int V, typename I>
__device__ __forceinline__ void store4(const Comp& c, bool vec, I off, I e0, I step, I W,
                                       const float (&v)[4]) {
  float* b = const_cast<float*>(c.p) + off;
  if (V == 4 && vec && e0 + 3 < W) {
    *reinterpret_cast<float4*>(b + e0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  const I si = (I)c.si;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const I e = e0 + (I)j * step;
    if (e < W) b[e * si] = v[j];
  }
}

template <typename I>
__device__ __forceinline__ I offset(const Comp& c, I i0, I i1, I i2) {
  return (I)c.s[0] * i0 + (I)c.s[1] * i1 + (I)c.s[2] * i2;
}

template <int OP, int NT>
__device__ __forceinline__ dd::F2 apply(const Args& a, const dd::F2 (&x)[Arity<OP, NT>::value]) {
  if constexpr (OP == kAdd) {
    return dd::add(x[0], x[1]);
  } else if constexpr (OP == kSub || OP == kResid) {
    return dd::sub(x[0], x[1]);
  } else if constexpr (OP == kMul) {
    return dd::mul(x[0], x[1]);
  } else if constexpr (OP == kDiv) {
    return dd::div(x[0], x[1]);
  } else if constexpr (OP == kSqrt) {
    return dd::sqrt(x[0]);
  } else if constexpr (OP == kNeg) {
    return dd::neg(x[0]);
  } else {  // kCombine: the left-to-right DD sum of c_k x_k
    dd::F2 r = x[0];
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      dd::F2 t = x[k];
      if (a.kind[k] < 0) t = dd::neg(t);
      else if (a.kind[k] == 0) t = dd::mul(t, dd::F2{a.chi[k], a.clo[k]});
      r = k == 0 ? t : dd::add(r, t);
    }
    return r;
  }
}

template <int OP, int NT, int V, typename I>
__global__ void __launch_bounds__(kThreads) dd_arith_kernel(const __grid_constant__ Args a) {
  constexpr int NA = Arity<OP, NT>::value;
  const I W = (I)a.W, segs = (I)a.segs, items = (I)a.items;
  const I n1 = (I)a.size[1], n2 = (I)a.size[2];
  const I tx = (I)blockDim.x;
  const I step = V == 4 ? (I)1 : tx;
  const I lead = V == 4 ? (I)4 * (I)threadIdx.x : (I)threadIdx.x;
  for (I it = (I)blockIdx.x * (I)blockDim.y + (I)threadIdx.y; it < items;
       it += (I)gridDim.x * (I)blockDim.y) {
    const I row = it / segs;
    const I e0 = (it - row * segs) * 4 * tx + lead;
    const I i2 = row % n2, r1 = row / n2;
    const I i1 = r1 % n1, i0 = r1 / n1;
    float hi[NA][4], lo[NA][4];
#pragma unroll
    for (int k = 0; k < NA; ++k) {
      const Comp& ch = a.c[2 + 2 * k];
      const Comp& cl = a.c[3 + 2 * k];
      load4<V, I>(ch, (a.vec >> (2 + 2 * k)) & 1u, offset(ch, i0, i1, i2), e0, step, W, hi[k]);
      load4<V, I>(cl, (a.vec >> (3 + 2 * k)) & 1u, offset(cl, i0, i1, i2), e0, step, W, lo[k]);
    }
    float oh[4], ol[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dd::F2 x[NA];
#pragma unroll
      for (int k = 0; k < NA; ++k) x[k] = dd::F2{hi[k][j], lo[k][j]};
      const dd::F2 r = apply<OP, NT>(a, x);
      oh[j] = OP == kResid ? dd::to_float(r) : r.hi;
      ol[j] = r.lo;
    }
    store4<V, I>(a.c[0], a.vec & 1u, offset(a.c[0], i0, i1, i2), e0, step, W, oh);
    if constexpr (OP != kResid)
      store4<V, I>(a.c[1], (a.vec >> 1) & 1u, offset(a.c[1], i0, i1, i2), e0, step, W, ol);
  }
}

template <int OP, int NT, int V, typename I>
cudaError_t run_one(const Args& a, dim3 block, int64_t want, int sms, cudaStream_t st) {
  static int per_sm = 0;   // resident blocks an SM of this instantiation
  if (per_sm == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dd_arith_kernel<OP, NT, V, I>, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  const int64_t cap = (int64_t)per_sm * sms;
  const unsigned grid = (unsigned)(want < cap ? want : cap);
  dd_arith_kernel<OP, NT, V, I><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

template <int OP, int NT>
cudaError_t run(const Args& a, int V, bool i32, dim3 block, int64_t want, int sms,
                cudaStream_t st) {
  if (V == 4)
    return i32 ? run_one<OP, NT, 4, int>(a, block, want, sms, st)
               : run_one<OP, NT, 4, long long>(a, block, want, sms, st);
  return i32 ? run_one<OP, NT, 1, int>(a, block, want, sms, st)
             : run_one<OP, NT, 1, long long>(a, block, want, sms, st);
}

}  // namespace

extern "C" {

// args (int64, ops/dd.py::pack): the CUDA device, the op, the term count,
// 32-bit indexing (1) or 64-bit (0), TX, TY, the three outer extents, the
// inner extent W, segments a row, items, blocks wanted, the SMs, the
// components that may take float4 accesses (a bitmask), the eight
// coefficient kinds, then five slots a component (out hi, out lo, then hi
// and lo of each operand): its pointer (0: an immediate, or no lo for
// resid), its three outer strides and its inner stride.  vals (float):
// each component's immediate, then hi and lo of each coefficient.
int pm_dd_arith(const int64_t* g, const float* vals, void* stream) {
  Args a{};
  const int op = (int)g[1], n = (int)g[2];
  const bool i32 = g[3] != 0;
  const int64_t tx = g[4], ty = g[5];
  if (op < kAdd || op > kResid || n < 1 || n > kMaxTerms || tx < 1 || ty < 1 ||
      tx * ty != kThreads || g[10] < 1 || g[12] < 1 || g[13] < 1)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < 3; ++d) a.size[d] = g[6 + d];
  a.W = g[9];
  a.segs = g[10];
  a.items = g[11];
  if (a.items == 0) return 0;
  unsigned cap = (unsigned)g[14];
  for (int k = 0; k < kMaxTerms; ++k) {
    a.kind[k] = (int)g[15 + k];
    a.chi[k] = vals[kComps + 2 * k];
    a.clo[k] = vals[kComps + 2 * k + 1];
  }
  unsigned vec = 0;
  for (int k = 0; k < kComps; ++k) {
    const int64_t* s = g + kHead + kSlots * k;
    Comp& c = a.c[k];
    c.p = reinterpret_cast<const float*>(s[0]);
    for (int d = 0; d < 3; ++d) c.s[d] = s[1 + d];
    c.si = s[4];
    c.imm = vals[k];
    // 16-byte accesses where the plan allows them and the pointer is aligned
    if (((cap >> k) & 1u) && c.p != nullptr && reinterpret_cast<uintptr_t>(c.p) % 16 == 0)
      vec |= 1u << k;
  }
  a.vec = vec;
  const bool out_vec = (vec & 1u) && (op == kResid || (vec & 2u));
  const int V = out_vec ? 4 : 1;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)g[0];
  if (device != current) cudaSetDevice(device);
  const dim3 block((unsigned)tx, (unsigned)ty);
  const int64_t want = g[12];
  const int sms = (int)g[13];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (op) {
    case kAdd: e = run<kAdd, 2>(a, V, i32, block, want, sms, st); break;
    case kSub: e = run<kSub, 2>(a, V, i32, block, want, sms, st); break;
    case kMul: e = run<kMul, 2>(a, V, i32, block, want, sms, st); break;
    case kDiv: e = run<kDiv, 2>(a, V, i32, block, want, sms, st); break;
    case kSqrt: e = run<kSqrt, 1>(a, V, i32, block, want, sms, st); break;
    case kNeg: e = run<kNeg, 1>(a, V, i32, block, want, sms, st); break;
    case kResid: e = run<kResid, 2>(a, V, i32, block, want, sms, st); break;
    default:
      switch (n) {
        case 1: e = run<kCombine, 1>(a, V, i32, block, want, sms, st); break;
        case 2: e = run<kCombine, 2>(a, V, i32, block, want, sms, st); break;
        case 3: e = run<kCombine, 3>(a, V, i32, block, want, sms, st); break;
        case 4: e = run<kCombine, 4>(a, V, i32, block, want, sms, st); break;
        case 5: e = run<kCombine, 5>(a, V, i32, block, want, sms, st); break;
        case 6: e = run<kCombine, 6>(a, V, i32, block, want, sms, st); break;
        case 7: e = run<kCombine, 7>(a, V, i32, block, want, sms, st); break;
        default: e = run<kCombine, 8>(a, V, i32, block, want, sms, st); break;
      }
  }
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // extern "C"
