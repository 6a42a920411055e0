// K17 circulant_solve1d: backward-Euler steps of periodic first-order
// upwind advection, J lanes of L chained steps per launch:
//   out[j, k] = [g[j, k] +] Phi(out[j, k-1]),  out[j, -1] = seed[j],
// where Phi(b) solves the cyclic bidiagonal system
//   (1 + c) u_i - c u_{i-1} = b_i   (indices mod n)
// with c = dt[k, j] * fac (fac = speed / dx).
//
// Replaces: pymgrit_tpu/models/advection_1d.py Advection1D.step (FFT,
// elementwise division by 1 + c (1 - e^(-2 pi i k/n)), inverse FFT, real
// part).
//
// The solve is the O(n) recurrence with its closed-form cyclic closure, as
// one affine scan from a zero start.  With r = c / (1 + c), |r| <= 1, the
// recurrence (1 + c) u_i = r (1 + c) u_{i-1} + b_i runs forward: its
// zero-start values W_i = r W_{i-1} + b_i (W_{-1} = 0) give
//   u_i = (W_i + r^(i+1) u_{n-1} (1 + c)) / (1 + c),
//   u_{n-1} (1 + c) = W_{n-1} / (1 - r^n).
// With |r| > 1 (c < -1/2) the mirrored form keeps every power at most 1 in
// magnitude: q = (1 + c) / c, v_i = u_{i-1} = q u_i - b_i / c runs
// backward from the top, the same scan on the reversed sequence, scaled by
// -1/c, and its value at i is u_{i-1}.  Each recurrence damps an error by
// |r| or |q| <= 1 a step.  The closure is finite wherever the Fourier route
// is (where no 1 + c (1 - e^(-2 pi i k/n)) vanishes); c = -1/2 with even n
// is singular for both.
//
// Bound: bytes (a step reads g and writes a row; about 6 n operations a
// step).  Design: a thread runs a contiguous chunk of the sequence serially
// from a zero start, giving its chunk's affine map (r^len, W at its end);
// the chunks' maps are composed by a scan (warp shuffles; across warps
// through shared memory), which gives every chunk the zero-start value
// entering it and r to the power of its first index; with the total map's
// closure each entry then takes one multiply-add: no power is taken and no
// thread waits on a serial loop over the others.
// - Warp route (n <= 512): one warp a lane, the state in registers (CH >=
//   ceil(n / 32) values a thread) across the chain's L steps: step k's
//   right-hand side is step k - 1's output, so a launch reads the seed and
//   g once and writes each output row once, each through the warp's row in
//   shared memory so that the global accesses are coalesced (the mirrored
//   branch's shift by one index is the slot it writes).  The steps'
//   coefficients (two divisions each) are formed 32 steps at a time, one a
//   lane, and shuffled to the step that takes them.
// - Block route (any n): one block of 256 threads a lane, a chunk of
//   ceil(n / 256) values a thread read from the previous output row twice
//   (once for the chunk's map, once for its values), the warps' maps
//   composed in shared memory.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpThreads = 128;            // warp route: four lanes a block
constexpr int kBlockThreads = 256;           // block route: one lane a block

struct Params {
  const void* seed;
  int64_t s_sj;
  const void* dt;
  void* out;
  int64_t o_sj, o_sk;
  const void* g;
  int64_t g_sj, g_sk;
  double fac;
  int64_t J, L;
  int n, len;                                // len: a thread's chunk
};

// x -> a x + b; compose(e, l) applies e first, then l
template <typename T>
struct Map {
  T a, b;
};

template <typename T>
__device__ __forceinline__ Map<T> compose(Map<T> e, Map<T> l) {
  return {l.a * e.a, l.a * e.b + l.b};
}

template <typename T>
__device__ __forceinline__ Map<T> shfl(Map<T> m, int src) {
  return {__shfl_sync(kFull, m.a, src), __shfl_sync(kFull, m.b, src)};
}

// inclusive scan of the lanes' maps in sequence order: from lane 0 up
// (forward) or from lane 31 down (mirrored)
template <typename T>
__device__ __forceinline__ Map<T> warp_scan(Map<T> m, bool up, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Map<T> o{up ? __shfl_up_sync(kFull, m.a, d) : __shfl_down_sync(kFull, m.a, d),
                   up ? __shfl_up_sync(kFull, m.b, d) : __shfl_down_sync(kFull, m.b, d)};
    if (up ? lane >= d : lane + d < 32) m = compose(o, m);
  }
  return m;
}

// a step's coefficients: the branch, the base (r or q) and the scale (1 /
// (1 + c), or -1 / c).  c = dt fac is rounded in the working type, as the
// plain version forms it; the scan runs in float64 for float32 rows too
// (each output then rounds once; the float32 Fourier route divides in
// complex128 as well).
template <typename T>
struct Step {
  bool up;
  double base, scale;
  __device__ __forceinline__ Step(T dt, T fac) {
    const double c = dt * fac, c1 = 1.0 + c;
    up = fabs(c) <= fabs(c1);
    base = up ? c / c1 : c1 / c;
    scale = up ? 1.0 / c1 : -1.0 / c;
  }
};

template <typename T, int CH>
__global__ void __launch_bounds__(kWarpThreads) circulant_warp(const Params p) {
  constexpr int W = kWarpThreads / 32;
  // a lane's row in shared memory, entry i at slot i + i / len (a pad after
  // each chunk: the chunks' reads hit distinct banks), for the row's global
  // loads and stores to run coalesced (entry lane + 32 m of each) while a
  // thread computes on its contiguous chunk
  __shared__ T rows[W][32 * CH + 32];
  const int lane = threadIdx.x % 32;
  const int64_t j = (int64_t)blockIdx.x * W + threadIdx.x / 32;
  if (j >= p.J) return;                      // a whole warp: no shuffle is left waiting
  T* row = rows[threadIdx.x / 32];
  const int n = p.n, len = p.len, i0 = lane * len, c0 = lane * (len + 1);
  const int cnt = n - i0 < 0 ? 0 : (n - i0 < len ? n - i0 : len);
  const int last_slot = (n - 1) + (n - 1) / len;
  int sl[CH];                                // the slot of entry lane + 32 m (-1: past n)
#pragma unroll
  for (int m = 0; m < CH; ++m) {
    const int i = lane + 32 * m;
    sl[m] = i < n ? i + i / len : -1;
  }
  const T* seed = static_cast<const T*>(p.seed) + j * p.s_sj;
#pragma unroll
  for (int m = 0; m < CH; ++m)
    if (sl[m] >= 0) row[sl[m]] = seed[lane + 32 * m];
  __syncwarp();
  T u[CH];
#pragma unroll
  for (int k = 0; k < CH; ++k) u[k] = k < cnt ? row[c0 + k] : T(0);
  const T fac = (T)p.fac;
  const T* dt = static_cast<const T*>(p.dt);
  // the coefficients of 32 steps at a time, lane l holding step s0 + l's (off
  // the steps' dependent chain: their divisions run in parallel)
  int c_up = 1;
  double c_base = 0.0, c_scale = 0.0;
  for (int64_t step = 0; step < p.L; ++step) {
    const int src = (int)(step % 32);
    if (src == 0 && step + lane < p.L) {
      const Step<T> c(dt[(step + lane) * p.J + j], fac);
      c_up = c.up;
      c_base = c.base;
      c_scale = c.scale;
    }
    const bool up = __shfl_sync(kFull, c_up, src) != 0;
    const double base = __shfl_sync(kFull, c_base, src);
    const double scale = __shfl_sync(kFull, c_scale, src);
    const T* g = p.g != nullptr ? static_cast<const T*>(p.g) + j * p.g_sj + step * p.g_sk
                                : nullptr;
    T gv[CH];
    if (g != nullptr) {
#pragma unroll
      for (int m = 0; m < CH; ++m) gv[m] = sl[m] >= 0 ? g[lane + 32 * m] : T(0);
    }
    // the chunk from a zero start, in sequence order (mirrored: downward;
    // each loop indexes the registers by compile-time slots)
    double w[CH];
    Map<double> mp{1.0, 0.0};
    auto run = [&](int k) {
      if (k < cnt) {
        mp.b = base * mp.b + u[k];
        mp.a *= base;
        w[k] = mp.b;
      }
    };
    if (up) {
#pragma unroll
      for (int k = 0; k < CH; ++k) run(k);
    } else {
#pragma unroll
      for (int k = CH - 1; k >= 0; --k) run(k);
    }
    const Map<double> inc = warp_scan(mp, up, lane);
    const Map<double> total = shfl(inc, up ? 31 : 0);
    Map<double> in = shfl(inc, up ? (lane + 31) % 32 : (lane + 1) % 32);
    if (up ? lane == 0 : lane == 31) in = Map<double>{1.0, 0.0};
    // the closure, and what enters this chunk
    const double last = total.b / (1.0 - total.a);
    const double d = in.b + in.a * last;
    double pw = 1.0;
    auto value = [&](int k) {
      if (k < cnt) {
        pw *= base;
        w[k] = scale * (w[k] + pw * d);
      }
    };
    if (up) {
#pragma unroll
      for (int k = 0; k < CH; ++k) value(k);
    } else {
#pragma unroll
      for (int k = CH - 1; k >= 0; --k) value(k);
    }
    // w[k] is u at entry i0 + k (forward) or i0 + k - 1 (mirrored): into
    // the row at that entry, then out [+ g] coalesced, then the new chunk
    __syncwarp();                            // the last step's chunk reads are done
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (k < cnt)
        row[up ? c0 + k : (k > 0 ? c0 + k - 1 : (lane > 0 ? c0 - 2 : last_slot))] = (T)w[k];
    __syncwarp();
    T* o = static_cast<T*>(p.out) + j * p.o_sj + step * p.o_sk;
#pragma unroll
    for (int m = 0; m < CH; ++m) {
      if (sl[m] >= 0) {
        T x = row[sl[m]];
        if (g != nullptr) {
          x = gv[m] + x;
          row[sl[m]] = x;
        }
        o[lane + 32 * m] = x;
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (k < cnt) u[k] = row[c0 + k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlockThreads) circulant_block(const Params p) {
  __shared__ Map<double> part[kBlockThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  constexpr int W = kBlockThreads / 32;
  const int64_t j = blockIdx.x;
  const int n = p.n, i0 = threadIdx.x * p.len;
  const int cnt = n - i0 < 0 ? 0 : (n - i0 < p.len ? n - i0 : p.len);
  const T fac = (T)p.fac;
  for (int64_t step = 0; step < p.L; ++step) {
    const T* b = step == 0 ? static_cast<const T*>(p.seed) + j * p.s_sj
                           : static_cast<const T*>(p.out) + j * p.o_sj + (step - 1) * p.o_sk;
    T* o = static_cast<T*>(p.out) + j * p.o_sj + step * p.o_sk;
    const T* g = p.g != nullptr ? static_cast<const T*>(p.g) + j * p.g_sj + step * p.g_sk
                                : nullptr;
    const Step<T> s(static_cast<const T*>(p.dt)[step * p.J + j], fac);
    Map<double> m{1.0, 0.0};
    for (int q = 0; q < cnt; ++q) {
      m.b = s.base * m.b + b[i0 + (s.up ? q : cnt - 1 - q)];
      m.a *= s.base;
    }
    const Map<double> inc = warp_scan(m, s.up, lane);
    if (lane == (s.up ? 31 : 0)) part[warp] = inc;
    __syncthreads();
    // the warps before this one in sequence order, then all of them
    Map<double> pre{1.0, 0.0}, total{1.0, 0.0};
    for (int q = 0; q < W; ++q) {
      const int v = s.up ? q : W - 1 - q;
      if (v == warp) pre = total;
      total = compose(total, part[v]);
    }
    Map<double> in = shfl(inc, s.up ? (lane + 31) % 32 : (lane + 1) % 32);
    if (s.up ? lane == 0 : lane == 31) in = Map<double>{1.0, 0.0};
    in = compose(pre, in);
    const double last = total.b / (1.0 - total.a);
    const double d = in.b + in.a * last;
    double acc = 0.0, pw = 1.0;
    for (int q = 0; q < cnt; ++q) {
      const int i = i0 + (s.up ? q : cnt - 1 - q);
      acc = s.base * acc + b[i];
      pw *= s.base;
      const T x = (T)(s.scale * (acc + pw * d));
      const int at = s.up ? i : (i == 0 ? n - 1 : i - 1);   // mirrored: u_{i-1}
      o[at] = g != nullptr ? g[at] + x : x;
    }
    __syncthreads();                          // the row is written before the next step reads it
  }
}

template <typename T>
int launch(const int64_t* args, double fac, void* stream) {
  Params p;
  p.seed = reinterpret_cast<const void*>(args[1]);
  p.dt = reinterpret_cast<const void*>(args[2]);
  p.out = reinterpret_cast<void*>(args[3]);
  p.g = reinterpret_cast<const void*>(args[4]);
  p.s_sj = args[5];
  p.o_sj = args[6];
  p.o_sk = args[7];
  p.g_sj = args[8];
  p.g_sk = args[9];
  p.J = args[10];
  p.L = args[11];
  p.n = (int)args[12];
  p.len = (int)args[13];
  const int64_t chunk = args[14], grid = args[15];
  p.fac = fac;
  if (p.J == 0 || p.L == 0 || p.n == 0) return 0;
  if (p.J < 0 || p.L < 0 || p.n < 1 || grid < 1 || grid > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {     // the warp route's register chunk; 0: the block route
    case 1: circulant_warp<T, 1><<<(unsigned)grid, kWarpThreads, 0, s>>>(p); break;
    case 2: circulant_warp<T, 2><<<(unsigned)grid, kWarpThreads, 0, s>>>(p); break;
    case 4: circulant_warp<T, 4><<<(unsigned)grid, kWarpThreads, 0, s>>>(p); break;
    case 8: circulant_warp<T, 8><<<(unsigned)grid, kWarpThreads, 0, s>>>(p); break;
    case 16: circulant_warp<T, 16><<<(unsigned)grid, kWarpThreads, 0, s>>>(p); break;
    case 0: circulant_block<T><<<(unsigned)grid, kBlockThreads, 0, s>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the packed argument array (ops/periodic.py::circulant_pack), fac, the stream
int pm_circulant_solve1d_f64(const int64_t* args, double fac, void* stream) {
  return launch<double>(args, fac, stream);
}

int pm_circulant_solve1d_f32(const int64_t* args, double fac, void* stream) {
  return launch<float>(args, fac, stream);
}

}  // extern "C"
