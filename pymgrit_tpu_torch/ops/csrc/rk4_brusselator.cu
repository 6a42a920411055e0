// K13 rk4_brusselator: J chains of L classic RK4 steps of the Brusselator,
//   y' = (a + x^2 y - (b+1) x, b x - x^2 y),
// one thread a lane: out[j, k] = [g[j, k] +] rk4(out[j, k-1], tp[k, j] ->
// tc[k, j]) with out[j, -1] = seed[j].
//
// Replaces: pymgrit_tpu/ops/runge_kutta.py rk4_step (:38-45) composed with
// pymgrit_tpu/models/brusselator.py Brusselator._f (:27-31), which the JAX
// solver vmaps over a level's intervals and scans over their steps (the
// F-relaxation's chains, the one-step C-relaxation, the coarsest march).
//
// Bound: latency.  A step is four stages of ~6 dependent FP64 operations
// and the combine, ~26 in a row, on two values a lane; its bytes (the step
// times, g, the state written) are a few per operation, so a chain of L
// steps takes at least 26 L dependent-issue latencies, whatever the lanes.
// The first version (Triton) loaded tp[k], tc[k] and g[:, k] right before
// each step used them, so a load latency sat on the chain every step, and
// ran Triton's launcher and the checks on every call.
// Design (ops/runge_kutta.py ``rk4_brusselator_pack``):
// * one thread a lane, one warp a block (J = 32 launches one warp, J = 512
//   sixteen, each on an SM of its own);
// * loads off the chain: each thread copies its own lane's step times and
//   g rows kCh steps at a time into shared memory by cp.async, a chunk
//   (kCh steps of the chain) ahead of the steps that use them; a thread
//   reads only what it copied, so no block barrier; the step's dt, dt/2 and
//   dt/6 depend on the times alone and issue beside the chain;
// * every operation rounds once (__dadd_rn, __dsub_rn, __dmul_rn,
//   __ddiv_rn; the float32 intrinsics in float32) in the plain version's
//   order (ops/runge_kutta.py ``rk4_step``, ``brusselator_f``): q = y0 y0,
//   k_a = (a + q y1) - (b+1) y0, k_b = b y0 - q y1, the stage states
//   y + (dt/2) k and y + dt k3, y + (dt/6) (((k1 + 2 k2) + 2 k3) + k4), then
//   g + y, so the kernel equals the plain version bit for bit (nvcc would
//   otherwise contract them into FMAs);
// * out[j, k] is one 16-byte (float64) or 8-byte (float32) store where the
//   lane's rows allow it.
// Launched by one ctypes call: a packed int64 argument array (a, b and b+1
// as the bits of doubles).

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;   // threads a block: one warp
constexpr int kCh = 16;        // steps a chunk of the shared-memory ring (4 and 8 ran slower)

__device__ __forceinline__ double add(double x, double y) { return __dadd_rn(x, y); }
__device__ __forceinline__ float add(float x, float y) { return __fadd_rn(x, y); }
__device__ __forceinline__ double sub(double x, double y) { return __dsub_rn(x, y); }
__device__ __forceinline__ float sub(float x, float y) { return __fsub_rn(x, y); }
__device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
__device__ __forceinline__ float mul(float x, float y) { return __fmul_rn(x, y); }
__device__ __forceinline__ double dvd(double x, double y) { return __ddiv_rn(x, y); }
__device__ __forceinline__ float dvd(float x, float y) { return __fdiv_rn(x, y); }

template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };

template <typename T>
struct Params {
  const T* seed;                 // (J, 2), lane stride s_sj
  const T *tp, *tc;              // (L, J) contiguous step times
  T* out;                        // out[j, k] at j * o_sj + k * o_sk
  const T* g;                    // null: no g; g[j, k] at j * g_sj + k * g_sk
  int64_t s_sj, o_sj, o_sk, g_sj, g_sk, J, L;
  T a, b, b1;                    // a, b, b + 1
};

// one value of a lane into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void copy_value(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the Brusselator's right-hand side at (x, y), in brusselator_f's order
template <typename T>
__device__ __forceinline__ void rhs(const Params<T>& p, T x, T y, T& fa, T& fb) {
  const T q = mul(x, x);
  fa = sub(add(p.a, mul(q, y)), mul(p.b1, x));
  fb = sub(mul(p.b, x), mul(q, y));
}

// G: g added after each step.  The ring holds, per chunk and step, the
// lane's tp, tc (and g's two values), [chunk][step][value][lane].
template <typename T, bool G>
__global__ void __launch_bounds__(kThreads) rk4_brusselator_kernel(const Params<T> p) {
  constexpr int V = G ? 4 : 2;
  __shared__ T ring[2][kCh][V][kThreads];
  const int t = threadIdx.x;
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + t;
  if (j >= p.J) return;
  // chunk c's copies: steps c kCh .. of this lane into ring[c & 1]
  const auto fetch = [&](int64_t c) {
    const int64_t k0 = c * kCh;
    const int n = p.L - k0 < kCh ? (int)(p.L - k0) : kCh;
    T(*dst)[V][kThreads] = ring[c & 1];
    for (int s = 0; s < n; ++s) {
      const int64_t k = k0 + s;
      copy_value(&dst[s][0][t], p.tp + k * p.J + j);
      copy_value(&dst[s][1][t], p.tc + k * p.J + j);
      if (G) {
        const T* g = p.g + j * p.g_sj + k * p.g_sk;
        copy_value(&dst[s][2][t], g);
        copy_value(&dst[s][3][t], g + 1);
      }
    }
    commit();
  };
  using P2 = typename Pair<T>::type;
  T* o = p.out + j * p.o_sj;
  const bool vec = (reinterpret_cast<uintptr_t>(o) % sizeof(P2)) == 0
                   && (p.o_sk * (int64_t)sizeof(T)) % (int64_t)sizeof(P2) == 0;
  T y0 = p.seed[j * p.s_sj], y1 = p.seed[j * p.s_sj + 1];
  const int64_t chunks = (p.L + kCh - 1) / kCh;
  fetch(0);
  for (int64_t c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      fetch(c + 1);
      wait_groups<1>();
    } else {
      wait_groups<0>();
    }
    const T(*src)[V][kThreads] = ring[c & 1];
    const int n = p.L - c * kCh < kCh ? (int)(p.L - c * kCh) : kCh;
#pragma unroll 1
    for (int s = 0; s < n; ++s) {
      const T dt = sub(src[s][1][t], src[s][0][t]);
      const T h2 = mul(dt, T(0.5));      // dt / 2, exactly
      const T h6 = dvd(dt, T(6));
      T k1a, k1b, k2a, k2b, k3a, k3b, k4a, k4b;
      rhs(p, y0, y1, k1a, k1b);
      rhs(p, add(y0, mul(h2, k1a)), add(y1, mul(h2, k1b)), k2a, k2b);
      rhs(p, add(y0, mul(h2, k2a)), add(y1, mul(h2, k2b)), k3a, k3b);
      rhs(p, add(y0, mul(dt, k3a)), add(y1, mul(dt, k3b)), k4a, k4b);
      y0 = add(y0, mul(h6, add(add(add(k1a, mul(T(2), k2a)), mul(T(2), k3a)), k4a)));
      y1 = add(y1, mul(h6, add(add(add(k1b, mul(T(2), k2b)), mul(T(2), k3b)), k4b)));
      if (G) {
        y0 = add(src[s][2][t], y0);
        y1 = add(src[s][3][t], y1);
      }
      T* dst = o + (c * kCh + s) * p.o_sk;
      if (vec) {
        P2 v;
        v.x = y0;
        v.y = y1;
        *reinterpret_cast<P2*>(dst) = v;
      } else {
        dst[0] = y0;
        dst[1] = y1;
      }
    }
  }
}

// args (int64): CUDA device; seed, tp, tc, out, g (0: none); seed's lane
// stride, out's lane and step strides, g's lane and step strides; J, L;
// the bits of a, b, b + 1 as doubles
// (ops/runge_kutta.py::rk4_brusselator_pack)
template <typename T>
int launch(const int64_t* a, void* stream) {
  Params<T> p{};
  p.seed = reinterpret_cast<const T*>(a[1]);
  p.tp = reinterpret_cast<const T*>(a[2]);
  p.tc = reinterpret_cast<const T*>(a[3]);
  p.out = reinterpret_cast<T*>(a[4]);
  p.g = reinterpret_cast<const T*>(a[5]);
  p.s_sj = a[6];
  p.o_sj = a[7];
  p.o_sk = a[8];
  p.g_sj = a[9];
  p.g_sk = a[10];
  p.J = a[11];
  p.L = a[12];
  double c[3];
  std::memcpy(c, a + 13, sizeof(c));
  p.a = (T)c[0];
  p.b = (T)c[1];
  p.b1 = (T)c[2];
  if (p.J == 0 || p.L == 0) return 0;
  const int64_t grid = (p.J + kThreads - 1) / kThreads;
  if (p.J < 0 || p.L < 0 || grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.g != nullptr) {
    rk4_brusselator_kernel<T, true><<<(unsigned)grid, kThreads, 0, s>>>(p);
  } else {
    rk4_brusselator_kernel<T, false><<<(unsigned)grid, kThreads, 0, s>>>(p);
  }
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_rk4_brusselator_f64(const int64_t* args, void* stream) {
  return launch<double>(args, stream);
}

int pm_rk4_brusselator_f32(const int64_t* args, void* stream) {
  return launch<float>(args, stream);
}

}  // extern "C"
