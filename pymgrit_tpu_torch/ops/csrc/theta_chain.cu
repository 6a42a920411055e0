// K2 theta_chain: J independent chains of L spectral theta-method steps,
//   x <- [g_k +] (x*(1 - th'*dt*Lam) + (th+th')*dt*lift + dt*rhs_k) / (1 + th*dt*Lam)
// with th' = 0 for backward Euler (theta == 1) and th' = theta otherwise;
// rhs_k = rhs(t_k+1) for BE and theta*rhs(t_k+1) + (1-theta)*rhs(t_k) else.
// Every step's x is written to out[j, k].
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D._step_spectral as the
// solver batches it: pymgrit_tpu/core/solver.py _f_relax_uniform for lvl > 0
// (lax.scan of m-1 steps plus g), the one-step Phi of _c_relax_uniform and
// _fas_residual (L = 1), and the sequential coarsest _forward_solve (J = 1).
//
// Bound: bytes.  Each step reads one g row and writes one out row per chain
// (8 + 8 bytes per coefficient in float64) against ~10 flops; the TOMS
// level-1 F-relaxation (J = 32, L = 15, N = 16129) moves 124 MB, 0.0383 ms
// at 3.35 TB/s.  What held the first version back was latency: one thread a
// coefficient walked its L steps with one dependent 8-byte g load each, so
// each thread waited L DRAM round trips with nothing else in flight.
// Design (ops/heat_kernels.py ``theta_chain_plan``, ``theta_chain_pack``):
// * a thread owns V = 16 bytes of coefficients (2 float64, 4 float32) of one
//   chain and carries them in registers across the L steps;
// * g (and, with a tabulated rhs, the rhs rows) are prefetched kStages
//   steps ahead by cp.async into a ring of shared memory (4 steps, or 2
//   where the rhs rows ride along; each thread copies and reads its own 16
//   bytes of a slot, so no barrier), so that kStages copies a thread are in
//   flight while it divides and stores; a step size that changes along the
//   chain is loaded one step ahead.  (A register ring, unrolled by its
//   depth so that every slot is a named register, spilled: each unrolled
//   copy holds V divides, whose slow paths are calls);
// * 16-byte loads and stores on every row whose pointer is 16-byte aligned;
//   a thread's elements start at a multiple of V from the row's start, so
//   the whole warp agrees on it.  Rows that are not (rows of 16129 float64
//   start at 8 mod 16 on every other row) take V element copies a thread
//   into the ring, and V stores a warp in which the lanes write 32
//   consecutive elements (values moved by shuffles): a thread's own V
//   element stores wrote each 32-byte sector in parts, which cost the level-1
//   F-relaxation 0.0560 against 0.0534 ms of device time (float32: 0.0385
//   against 0.0311; chip_smoke.py on an NVIDIA H100 80GB HBM3);
// * per chain and per coefficient data is read once an item: each warp
//   checks once whether the chain's step sizes are all equal (bit for bit;
//   no block barrier) while the item's first copies are in flight; if so,
//   the step size, dt*theta, the denominator 1 + shift*Lam, the lift
//   term and, with a time-independent rhs, the rhs term are formed once a
//   thread (the same bits as forming them every step); CN's rhs mix
//   theta*r1 + (1-theta)*r0 of a time-independent rhs is formed once too;
// * compile-time variants for BE / CN, with or without g, and a
//   time-independent (strides 0) or tabulated rhs;
// * every operation is an intrinsic that rounds once (__dmul_rn, __dadd_rn,
//   __dsub_rn, __ddiv_rn; the float32 forms), in theta_chain_plain's order,
//   so nvcc cannot contract them into FMAs: the kernel equals the plain
//   version bit for bit in float64 and float32;
// * the work is a range of items (chain, segment of kThreads * V
//   coefficients), one block an item, so the small coarse-level calls
//   (J = 1-8, L = 2-3) launch no idle blocks and the hardware starts the
//   next item's block as soon as one retires; a grid of the card's resident
//   blocks walking the items (SM count x kMinBlocks) measured 2-5 % slower
//   on the TOMS level-1 F-relaxation (two items a block: each waits on its
//   first copies in turn).  The kernel still walks the items with a grid
//   stride, so a smaller grid computes the same.
// Launched by one ctypes call: a packed int64 argument array and theta,
// 1 - theta as doubles, by value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 8 warps a block

// blocks an SM holds: 3 (85 registers a thread).  At 4 (64) the CN and
// tabulated variants and, with the whole-sector stores, the main path's BE
// variant spill; the BE level-1 F-relaxation measured 0.0512-0.0516 ms at
// 3 against 0.0529 at 4 with its spills (chip_smoke.py, NVIDIA H100 80GB HBM3)
constexpr int kMinBlocks = 3;

__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}
__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_int(a) == __float_as_int(b);
}

template <typename T>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};

// element e of a vector (e is a constant after unrolling: no local memory)
__device__ __forceinline__ double& lane(double2& v, int e) { return e == 0 ? v.x : v.y; }
__device__ __forceinline__ float& lane(float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// the V elements n0.. of a row: one 16-byte load where the row is aligned
// and all V lie in it, else element by element (absent ones read as 0)
template <typename T, int V>
__device__ __forceinline__ void load(T (&v)[V], const T* row, int64_t n0, int64_t N) {
  static_assert(V == Vec16<T>::n, "a thread owns 16 bytes");
  using VT = typename Vec16<T>::type;
  const T* p = row + n0;
  if (n0 + V <= N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    VT w = __ldg(reinterpret_cast<const VT*>(p));
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = lane(w, e);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = n0 + e < N ? __ldg(p + e) : (T)0;
  }
}

// this thread's V elements n0.. of a row: one 16-byte store where the row
// is aligned and all V lie in it; on a row off alignment, where the warp's
// 32 V elements all lie in the row, V stores in which each lane writes one
// element of a contiguous run of 32 (the values moved between lanes by
// shuffles), so that every store instruction writes whole sectors (V
// element stores a thread would write each sector in V parts); else
// element by element
template <typename T, int V>
__device__ __forceinline__ void store(T* row, int64_t n0, int64_t N, const T (&v)[V]) {
  static_assert(V == Vec16<T>::n, "a thread owns 16 bytes");
  using VT = typename Vec16<T>::type;
  T* p = row + n0;
  const int ln = threadIdx.x & 31;
  if (n0 + V <= N && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    VT w;
#pragma unroll
    for (int e = 0; e < V; ++e) lane(w, e) = v[e];
    *reinterpret_cast<VT*>(p) = w;
  } else if (n0 - V * ln + 32 * V <= N) {
    T* base = p - V * ln;  // the warp's first element
#pragma unroll
    for (int h = 0; h < V; ++h) {
      // element h * 32 + ln of the warp's run: lane h * 32 / V + ln / V's
      // component ln % V
      const int src = h * (32 / V) + ln / V;
      T w = (T)0;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const T t = __shfl_sync(0xffffffffu, v[c], src);
        if (c == (ln & (V - 1))) w = t;
      }
      base[h * 32 + ln] = w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      if (n0 + e < N) p[e] = v[e];
    }
  }
}

struct Params {
  const void* x0;
  void* out;
  const void* g;     // null: no g
  const void* dt;    // (L, J) contiguous
  const void* lam;
  const void* lift;
  const void* rhs1;  // rows at k * r_sk + j * r_sj
  const void* rhs0;
  int64_t x_sj, out_sj, out_sk, g_sj, g_sk, r_sk, r_sj;  // strides (elements)
  int64_t J, L, N;
  int64_t segs;      // segments a chain (kThreads * V coefficients each)
  double theta, omt; // theta and 1 - theta (as the host computes it)
};

// this thread's V elements n0.. of a row into its ring slot: one 16-byte
// cp.async where the row is aligned and all V lie in it, else one
// element-sized cp.async each (absent ones are not copied: never stored)
template <typename T>
__device__ __forceinline__ void copy_async(T* slot, const T* row, int64_t n0, int64_t N) {
  constexpr int V = Vec16<T>::n;
  const T* src = row + n0;
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
  if (n0 + V <= N && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
    return;
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    if (n0 + e < N) {
      if (sizeof(T) == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst + 8 * e),
                     "l"(src + e) : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst + 4 * e),
                     "l"(src + e) : "memory");
      }
    }
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the V elements of this thread's part of a ring slot
template <typename T, int V>
__device__ __forceinline__ void read_slot(T (&v)[V], const T* slot) {
  typename Vec16<T>::type w = *reinterpret_cast<const typename Vec16<T>::type*>(slot);
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = lane(w, e);
}

// The ring: kStages steps of g (and tabulated rhs rows) in flight, in
// kStages + 1 slots of shared memory (a slot is refilled one step after it
// was read, so no copy lands on a slot that is still being read); each
// thread copies and reads only its own 16 bytes of a slot, so no barrier
// is needed.  kStages 4, or 2 where the rhs rows ride along (36 KB at most
// a block).
template <bool CN, bool G, bool TAB>
struct Ring {
  static constexpr int kStages = TAB ? 2 : 4;
  static constexpr int kSlots = kStages + 1;
  static constexpr int kRows = (G ? 1 : 0) + (TAB ? (CN ? 2 : 1) : 0);  // rows a step
};

// One thread's part of an item: chain j's rows, its coefficients n0..n0+V-1
// and its slice of the block's ring (kSlots x kRows x kThreads * V
// elements).  CN: theta != 1; G: g added after each step; TAB: the rhs rows
// change with (k, j).
template <typename T, bool CN, bool G, bool TAB>
struct Chain {
  static constexpr int V = Vec16<T>::n;
  static constexpr int kRow = kThreads * V;  // elements of one row of a slot
  using R = Ring<CN, G, TAB>;
  const Params& p;
  int64_t n0;
  const T* seed;  // chain j's seed row
  const T* dt;    // chain j's column of step sizes (stride J)
  const T* gb;
  T* ob;
  const T* r1b;
  const T* r0b;
  T* mine;
  T x[V], lm[V], lf[V], mix[V];

  __device__ __forceinline__ Chain(const Params& q, int64_t j, int64_t n, T* ring)
      : p(q), n0(n), seed(static_cast<const T*>(q.x0) + j * q.x_sj),
        dt(static_cast<const T*>(q.dt) + j),
        gb(G ? static_cast<const T*>(q.g) + j * q.g_sj : nullptr),
        ob(static_cast<T*>(q.out) + j * q.out_sj),
        r1b(static_cast<const T*>(q.rhs1) + j * q.r_sj),
        r0b(static_cast<const T*>(q.rhs0) + j * q.r_sj), mine(ring + threadIdx.x * V) {}

  // step k's rows into slot s
  __device__ __forceinline__ void issue(int64_t k, int s) {
    T* slot = mine + s * R::kRows * kRow;
    if (G) copy_async(slot, gb + k * p.g_sk, n0, p.N);
    if (TAB) {
      copy_async(slot + (G ? kRow : 0), r1b + k * p.r_sk, n0, p.N);
      if (CN) copy_async(slot + (G ? 2 : 1) * kRow, r0b + k * p.r_sk, n0, p.N);
    }
  }

  // the first kStages steps' copies, then the seeds and the per-coefficient
  // data (a time-independent rhs: r1 (BE) or the mix theta*r1 +
  // (1-theta)*r0 (CN)), all in flight together
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int q = 0; q < R::kStages; ++q) {
      if (G || TAB) {
        if (q < p.L) issue(q, q);
        commit();
      }
    }
    load(x, seed, n0, p.N);
    load(lm, static_cast<const T*>(p.lam), n0, p.N);
    load(lf, static_cast<const T*>(p.lift), n0, p.N);
    if (!TAB) {
      load(mix, r1b, n0, p.N);
      if (CN) {
        T r0[V];
        load(r0, r0b, n0, p.N);
        const T th = (T)p.theta, omt = (T)p.omt;
#pragma unroll
        for (int e = 0; e < V; ++e) mix[e] = add_rn(mul_rn(th, mix[e]), mul_rn(omt, r0[e]));
      }
    }
  }

  // the L steps; UNI: the chain's step sizes are all equal, and the step's
  // terms are formed once
  template <bool UNI>
  __device__ __forceinline__ void walk() {
    const int64_t L = p.L, N = p.N;
    const T th = (T)p.theta, omt = (T)p.omt, one = (T)1, two = (T)2;
    T d = dt[0], shift = (T)0, den[V], sl[V], dr[V];
    if (UNI) {
      shift = CN ? mul_rn(d, th) : d;  // BE: d * 1.0 is d
#pragma unroll
      for (int e = 0; e < V; ++e) {
        den[e] = add_rn(one, mul_rn(shift, lm[e]));
        sl[e] = mul_rn(CN ? mul_rn(shift, two) : shift, lf[e]);
        if (!TAB) dr[e] = mul_rn(d, mix[e]);
      }
    }
    int s = 0, sn = R::kStages;        // the slot read at step k, the slot filled
#pragma unroll 1
    for (int64_t k = 0; k < L; ++k) {
      if (G || TAB) {
        if (k + R::kStages < L) issue(k + R::kStages, sn);
        commit();
        wait_groups<R::kStages>();     // step k's copies have landed
      }
      // step k's step size (the next one's load in flight meanwhile)
      const T dk = d;
      if (!UNI && k + 1 < L) d = __ldg(dt + (k + 1) * p.J);
      T gk[V], r1k[V], r0k[V];
      const T* slot = mine + s * R::kRows * kRow;
      if (G) read_slot(gk, slot);
      if (TAB) {
        read_slot(r1k, slot + (G ? kRow : 0));
        if (CN) read_slot(r0k, slot + (G ? 2 : 1) * kRow);
      }
      s = s == R::kSlots - 1 ? 0 : s + 1;
      sn = sn == R::kSlots - 1 ? 0 : sn + 1;
      const T sk = UNI ? shift : (CN ? mul_rn(dk, th) : dk);
      const T s2 = CN ? mul_rn(sk, two) : sk;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const T m = TAB ? (CN ? add_rn(mul_rn(th, r1k[e]), mul_rn(omt, r0k[e])) : r1k[e])
                        : mix[e];
        const T drk = UNI && !TAB ? dr[e] : mul_rn(dk, m);
        const T slk = UNI ? sl[e] : mul_rn(s2, lf[e]);
        const T dn = UNI ? den[e] : add_rn(one, mul_rn(sk, lm[e]));
        T b;
        if (CN) {
          b = add_rn(add_rn(sub_rn(x[e], mul_rn(sk, mul_rn(x[e], lm[e]))), slk), drk);
        } else {
          b = add_rn(add_rn(x[e], drk), slk);
        }
        x[e] = div_rn(b, dn);
        if (G) x[e] = add_rn(gk[e], x[e]);
      }
      store(ob + k * p.out_sk, n0, N, x);
    }
  }
};

template <typename T, bool CN, bool G, bool TAB>
__global__ void __launch_bounds__(kThreads, kMinBlocks) theta_chain_kernel(const Params p) {
  constexpr int V = Vec16<T>::n;
  using R = Ring<CN, G, TAB>;
  __shared__ __align__(16) T ring[(R::kRows > 0 ? R::kSlots * R::kRows : 1) * kThreads * V];
  const T* dt = static_cast<const T*>(p.dt);
  const int64_t items = p.J * p.segs;
  for (int64_t it = blockIdx.x; it < items; it += gridDim.x) {
    const int64_t j = it / p.segs;
    const int64_t n0 = (it - j * p.segs) * (kThreads * V) + (int64_t)threadIdx.x * V;
    const bool live = n0 < p.N;
    Chain<T, CN, G, TAB> c(p, j, n0, ring);
    if (live) c.start();
    // are chain j's step sizes all equal (bit for bit)?  Each warp's lanes
    // split the column while the item's first copies are in flight (a
    // warp's answer: no block barrier, so the warps of a block move on to
    // their next items independently)
    const T d0 = dt[j];
    int uniform = 1;
    for (int64_t k = 1 + (threadIdx.x & 31); k < p.L; k += 32) {
      uniform &= same_bits(dt[k * p.J + j], d0);
    }
    uniform = __all_sync(0xffffffffu, uniform);
    if (!live) continue;
    if (uniform) {
      c.template walk<true>();
    } else {
      c.template walk<false>();
    }
  }
}

template <typename T, bool CN, bool G>
void dispatch_rhs(bool tab, unsigned grid, cudaStream_t s, const Params& p) {
  if (tab) {
    theta_chain_kernel<T, CN, G, true><<<grid, kThreads, 0, s>>>(p);
  } else {
    theta_chain_kernel<T, CN, G, false><<<grid, kThreads, 0, s>>>(p);
  }
}

// args (int64): CUDA device, x0, out, g (0: none), dt, lam, lift, rhs1,
// rhs0, x0's chain stride, out's chain and step strides, g's chain and step
// strides, the rhs rows' step and chain strides, J, L, N, segments a chain,
// grid, CN (0: BE), g present, rhs tabulated, vector width (16 bytes: the
// launcher refuses another) (ops/heat_kernels.py::theta_chain_pack)
template <typename T>
int launch(const int64_t* a, double theta, double omt, void* stream) {
  Params p{};
  p.x0 = reinterpret_cast<const void*>(a[1]);
  p.out = reinterpret_cast<void*>(a[2]);
  p.g = reinterpret_cast<const void*>(a[3]);
  p.dt = reinterpret_cast<const void*>(a[4]);
  p.lam = reinterpret_cast<const void*>(a[5]);
  p.lift = reinterpret_cast<const void*>(a[6]);
  p.rhs1 = reinterpret_cast<const void*>(a[7]);
  p.rhs0 = reinterpret_cast<const void*>(a[8]);
  p.x_sj = a[9];
  p.out_sj = a[10];
  p.out_sk = a[11];
  p.g_sj = a[12];
  p.g_sk = a[13];
  p.r_sk = a[14];
  p.r_sj = a[15];
  p.J = a[16];
  p.L = a[17];
  p.N = a[18];
  p.segs = a[19];
  const unsigned grid = (unsigned)a[20];
  const bool cn = a[21] != 0, g = a[22] != 0, tab = a[23] != 0;
  const int vec = (int)a[24];
  p.theta = theta;
  p.omt = omt;
  if (p.J == 0 || p.L == 0 || p.N == 0) return 0;
  if (vec != Vec16<T>::n || grid == 0 || g != (p.g != nullptr)) return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cn && g) dispatch_rhs<T, true, true>(tab, grid, s, p);
  if (cn && !g) dispatch_rhs<T, true, false>(tab, grid, s, p);
  if (!cn && g) dispatch_rhs<T, false, true>(tab, grid, s, p);
  if (!cn && !g) dispatch_rhs<T, false, false>(tab, grid, s, p);
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_theta_chain_f64(const int64_t* args, double theta, double omt, void* stream) {
  return launch<double>(args, theta, omt, stream);
}

int pm_theta_chain_f32(const int64_t* args, double theta, double omt, void* stream) {
  return launch<float>(args, theta, omt, stream);
}

}  // extern "C"
