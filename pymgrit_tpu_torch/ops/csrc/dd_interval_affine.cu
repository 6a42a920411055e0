// K23 dd_interval_affine: K1's closed-form interval relaxation in
// double-double, out[j, r, n] = A[r0 + r, n] (x) x[j, n] (+) G[r0 + r, n]
// with DD mul (x) and add (+) (dd.cuh), every value a float32 pair;
// seed_out[j], when not null, receives x[j] (the tube's C-point row).
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.relax_interval, spectral
// DD branch (`A_k[:, None] * seed[None] + G_k[:, None]`, :528-537), the
// same in pymgrit_tpu/models/heat_1d.py (:191-200), and through it the
// condensed C-step and the materialization of the level-0 tube
// (pymgrit_tpu/core/solver.py _cnd_c_step, _cnd_materialize_expr).
//
// Bound: bytes written.  The materialization writes the whole 16385 x 16129
// DD tube (8 bytes a value, 2.1 GB: 0.65 ms at 3.35 TB/s) and reads the 512
// seeds and the (31, 16129) DD tables; a DD mul and add are 44 float32
// operations a value, 0.34 ms of the card's FP32 issue, so the kernel stays
// byte-bound only if each value is computed once.  The first design (one
// thread an (interval, coefficient), the grid's y walking the intervals)
// re-read all four tables for every interval (4.1 GB of loads beside 2.1 GB
// of stores), wrote with plain 4-byte stores that pushed the tables out of
// the L2 and split a warp's 128 bytes over five sectors on the packed
// tube's rows (their stride, 2 N floats, is 8 modulo 32 bytes, and lo = hi +
// N adds 4), and ran at 2.6x the bound.  This design is K1's (PR 11) in DD:
// * interval blocking: a block owns C = 512 coefficients for a group of JB
//   intervals (JB = 4, 2 or 1 from the shape: ops/heat_kernels.py
//   ``dd_interval_affine_plan``; 16 and 8 held too few blocks an SM and
//   ran slower); it copies the group's seeds (hi, lo) into shared memory
//   once (cp.async) and loads each table row (Ah, Al, Gh, Gl) once for all
//   of them, into registers a row ahead: a thread computes the same four
//   coefficients, cb + t + 128 u, of every interval and row of the group
//   (coalesced loads, conflict-free shared accesses), so table loads fall
//   JB-fold;
// * the condensed C-step (R = 1, no seed_out) reads each seed once: the
//   seeds go straight into registers, an interval ahead, and shared memory
//   holds the stage alone (the shared-memory copy cost the C-step a wait a
//   group, and blocks an SM);
// * each DD value computed once: a thread computes its four coefficients of
//   an (interval, row) and stages hi and lo in shared memory (two buffers,
//   one barrier an (interval, row));
// * streaming 16-byte stores in whole sectors, hi and lo rows each from its
//   own alignment: a row's first sector-aligned element e in the block's
//   range comes from its address (0 <= e < 8; cb is a multiple of 8),
//   thread t stores elements e + 4 t .. e + 4 t + 3 with __stcs (evict
//   first: the output does not push the tables out of the L2; plain stores
//   ran 10 % slower), read from the stage as one 16-byte vector where e is a
//   multiple of 4, else element by element;
//   the range's first e elements and its tail are stored alone (the sector
//   across a block boundary is shared by the two blocks);
// * every float32 operation a round-once intrinsic of dd.cuh, in
//   dd_interval_affine_plain's order: the kernel equals it bit for bit.
// hi and lo of x, out and seed_out are addressed by separate pointers with
// shared element strides, so the solver's packed (rows, 2, N) tubes (lo =
// hi + N) and DD pairs of separate tensors both work.  Launched by one
// ctypes call: a packed int64 argument array.

#include <cstdint>
#include <cuda_runtime.h>

#include "dd.cuh"

namespace {

constexpr int kThreads = 128;          // threads a block
constexpr int kVW = 4;                 // coefficients a thread computes
constexpr int kC = kVW * kThreads;     // coefficients a block
constexpr int kSA = 8;                 // float32 elements a 32-byte sector holds

struct Params {
  const float *xh, *xl;                // seeds, interval stride x_sj
  const float *Ah, *Al, *Gh, *Gl;      // (T, N) contiguous tables
  float *oh, *ol;                      // out at j * out_sj + r * out_sr + n
  float *sh, *sl;                      // seed_out (null: none), stride seed_sj
  int64_t x_sj, out_sj, out_sr, seed_sj;
  int64_t r0, R, J, N;
  int64_t groups;                      // groups of JB intervals
};

__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0) : "memory");
}

// Store elements [0, nb) of a block's range from shared memory s (16-byte
// aligned) into the output row o (o = the row's element cb): thread t the
// vector e + 4 t .. e + 4 t + 3 where it lies in the range, else its
// elements there alone, and threads t < e the head element t.
__device__ __forceinline__ void store_range(const float* __restrict__ s, float* o, int nb,
                                            int t) {
  const int e = (kSA - (int)((reinterpret_cast<uintptr_t>(o) / sizeof(float)) % kSA)) % kSA;
  const int i = e + 4 * t;
  if (i + 4 <= nb) {
    // one 16-byte shared load where e is a multiple of 4, else four (e is
    // the block's: no divergence; selecting from two aligned vectors cost
    // more issue)
    float4* dst = reinterpret_cast<float4*>(o + i);
    if ((e & 3) == 0) {
      __stcs(dst, *reinterpret_cast<const float4*>(s + i));
    } else {
      __stcs(dst, make_float4(s[i], s[i + 1], s[i + 2], s[i + 3]));
    }
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u < nb) __stcs(o + i + u, s[i + u]);
    }
  }
  if (t < e && t < nb) __stcs(o + t, s[t]);
}

// the hi and lo rows of a block's range, each from its own alignment
__device__ __forceinline__ void store_rows(const float* sh, const float* sl, float* oh,
                                           float* ol, int nb, int t) {
  store_range(sh, oh, nb, t);
  store_range(sl, ol, nb, t);
}

// the thread's coefficients n0 + kThreads u of table row r (0 past N)
__device__ __forceinline__ void load_row(const Params& p, int64_t r, int64_t n0, float (&ah)[kVW],
                                         float (&al)[kVW], float (&gh)[kVW], float (&gl)[kVW]) {
  const int64_t off = (p.r0 + r) * p.N + n0;
#pragma unroll
  for (int u = 0; u < kVW; ++u) {
    const bool in = n0 + u * kThreads < p.N;
    ah[u] = in ? __ldg(p.Ah + off + u * kThreads) : 0.0f;
    al[u] = in ? __ldg(p.Al + off + u * kThreads) : 0.0f;
    gh[u] = in ? __ldg(p.Gh + off + u * kThreads) : 0.0f;
    gl[u] = in ? __ldg(p.Gl + off + u * kThreads) : 0.0f;
  }
}

// the thread's coefficients n0 + kThreads u of seed row j (0 past N)
__device__ __forceinline__ void load_seed(const Params& p, int64_t j, int64_t n0, float (&xh)[kVW],
                                          float (&xl)[kVW]) {
  const int64_t off = j * p.x_sj + n0;
#pragma unroll
  for (int u = 0; u < kVW; ++u) {
    const bool in = n0 + u * kThreads < p.N;
    xh[u] = in ? __ldg(p.xh + off + u * kThreads) : 0.0f;
    xl[u] = in ? __ldg(p.xl + off + u * kThreads) : 0.0f;
  }
}

// y = A (x) x (+) G of the thread's coefficients, staged: hi into sh, lo
// into sl at t + kThreads u
__device__ __forceinline__ void stage_values(const float (&ah)[kVW], const float (&al)[kVW],
                                             const float (&gh)[kVW], const float (&gl)[kVW],
                                             const float (&xh)[kVW], const float (&xl)[kVW],
                                             float* sh, float* sl, int t) {
#pragma unroll
  for (int u = 0; u < kVW; ++u) {
    const dd::F2 y = dd::add(dd::mul(dd::F2{ah[u], al[u]}, dd::F2{xh[u], xl[u]}),
                             dd::F2{gh[u], gl[u]});
    sh[t + u * kThreads] = y.hi;
    sl[t + u * kThreads] = y.lo;
  }
}

// Block x: coefficients cb = C x .. cb + C - 1, thread t computing cb + t +
// kThreads u (coalesced loads, conflict-free shared accesses); the grid's y
// walks the groups of JB intervals.  STREAM (R = 1, no seed_out: the
// condensed C-step): each seed row is read once, straight into registers an
// interval ahead, and shared memory holds the stage alone.  Else the
// group's seeds go to shared memory once ([JB][hi, lo][C]), read by every
// row.  Then the stage, [2][hi, lo][kC].
template <int JB, bool STREAM>
__global__ void __launch_bounds__(kThreads) dd_interval_affine_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* seeds = reinterpret_cast<float*>(smem4);
  float* stage = seeds + (STREAM ? 0 : JB * 2 * kC);
  const int t = threadIdx.x;
  const int64_t cb = (int64_t)blockIdx.x * kC;
  const int nb = p.N - cb < kC ? (int)(p.N - cb) : kC;
  const int64_t n0 = cb + t;                // the thread's first coefficient
  int buf = 0;
  for (int64_t grp = blockIdx.y; grp < p.groups; grp += gridDim.y) {
    const int64_t j0 = grp * JB;
    const int jn = p.J - j0 < JB ? (int)(p.J - j0) : JB;
    float ah[kVW], al[kVW], gh[kVW], gl[kVW];
    if (STREAM) {
      load_row(p, 0, n0, ah, al, gh, gl);
      float xh[kVW], xl[kVW];
      load_seed(p, j0, n0, xh, xl);
      for (int b = 0; b < jn; ++b) {
        float nxh[kVW], nxl[kVW];          // interval b + 1's seeds, loaded during b
        if (b + 1 < jn) load_seed(p, j0 + b + 1, n0, nxh, nxl);
        float* sh = stage + buf * 2 * kC;
        float* sl = sh + kC;
        stage_values(ah, al, gh, gl, xh, xl, sh, sl, t);
        __syncthreads();
        const int64_t off = (j0 + b) * p.out_sj + cb;
        store_rows(sh, sl, p.oh + off, p.ol + off, nb, t);
        buf ^= 1;
        if (b + 1 < jn) {
#pragma unroll
          for (int u = 0; u < kVW; ++u) {
            xh[u] = nxh[u];
            xl[u] = nxl[u];
          }
        }
      }
      continue;
    }
    // the group's seeds, hi and lo (zero past N)
    for (int i = t; i < jn * 2 * kC; i += kThreads) {
      const int b = i / (2 * kC), comp = (i / kC) & 1, c = i % kC;
      const float* row = (comp ? p.xl : p.xh) + (j0 + b) * p.x_sj;
      copy4(seeds + i, c < nb ? row + cb + c : row, c < nb);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (p.R > 0) load_row(p, 0, n0, ah, al, gh, gl);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (p.sh != nullptr) {   // the seeds' copies: the tube's C-point rows
      for (int b = 0; b < jn; ++b) {
        const int64_t off = (j0 + b) * p.seed_sj + cb;
        store_rows(seeds + b * 2 * kC, seeds + b * 2 * kC + kC, p.sh + off, p.sl + off, nb, t);
      }
    }
    for (int64_t r = 0; r < p.R; ++r) {
      float nah[kVW], nal[kVW], ngh[kVW], ngl[kVW];    // row r + 1, loaded during row r
      if (r + 1 < p.R) load_row(p, r + 1, n0, nah, nal, ngh, ngl);
      for (int b = 0; b < jn; ++b) {
        float xh[kVW], xl[kVW];
#pragma unroll
        for (int u = 0; u < kVW; ++u) {
          xh[u] = seeds[b * 2 * kC + t + u * kThreads];
          xl[u] = seeds[b * 2 * kC + kC + t + u * kThreads];
        }
        float* sh = stage + buf * 2 * kC;
        float* sl = sh + kC;
        stage_values(ah, al, gh, gl, xh, xl, sh, sl, t);
        __syncthreads();
        const int64_t off = (j0 + b) * p.out_sj + r * p.out_sr + cb;
        store_rows(sh, sl, p.oh + off, p.ol + off, nb, t);
        buf ^= 1;
      }
      if (r + 1 < p.R) {
#pragma unroll
        for (int u = 0; u < kVW; ++u) {
          ah[u] = nah[u];
          al[u] = nal[u];
          gh[u] = ngh[u];
          gl[u] = ngl[u];
        }
      }
    }
    __syncthreads();   // the seeds are read before the next group's copies
  }
}

// at most 24 KB of dynamic shared memory (JB <= 4): no opt-in needed
template <int JB, bool STREAM>
cudaError_t launch_jb(const Params& p, unsigned bx, unsigned by, cudaStream_t s) {
  const size_t bytes = sizeof(float) * ((STREAM ? 0 : JB * 2 * kC) + 2 * 2 * kC);
  dd_interval_affine_kernel<JB, STREAM><<<dim3(bx, by), kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// args (int64): CUDA device; x hi, lo; A hi, lo; G hi, lo; out hi, lo;
// seed_out hi, lo (0: none); x's interval stride, out's interval and row
// strides, seed_out's interval stride; r0, R, J, N; the plan: JB, blocks
// along N, groups of JB intervals, the grid's y, seeds streamed (R = 1, no
// seed_out)
// (ops/heat_kernels.py::dd_interval_affine_pack)
int pm_dd_interval_affine(const int64_t* a, void* stream) {
  Params p{};
  const auto in = [a](int i) { return reinterpret_cast<const float*>(a[i]); };
  const auto out = [a](int i) { return reinterpret_cast<float*>(a[i]); };
  p.xh = in(1);
  p.xl = in(2);
  p.Ah = in(3);
  p.Al = in(4);
  p.Gh = in(5);
  p.Gl = in(6);
  p.oh = out(7);
  p.ol = out(8);
  p.sh = out(9);
  p.sl = out(10);
  p.x_sj = a[11];
  p.out_sj = a[12];
  p.out_sr = a[13];
  p.seed_sj = a[14];
  p.r0 = a[15];
  p.R = a[16];
  p.J = a[17];
  p.N = a[18];
  const int64_t jb = a[19], bx = a[20];
  p.groups = a[21];
  const int64_t by = a[22];
  const bool stream_ = a[23] != 0;
  if (p.J == 0 || p.N == 0) return 0;
  if (bx * kC < p.N || p.groups * jb < p.J || by <= 0 || by > 65535 || bx > 0x7fffffff
      || (p.sh == nullptr) != (p.sl == nullptr)
      || (stream_ && (p.R != 1 || p.sh != nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  const unsigned x = (unsigned)bx, y = (unsigned)by;
  switch (stream_ ? -jb : jb) {
    case -4: e = launch_jb<4, true>(p, x, y, s); break;
    case -2: e = launch_jb<2, true>(p, x, y, s); break;
    case -1: e = launch_jb<1, true>(p, x, y, s); break;
    case 4: e = launch_jb<4, false>(p, x, y, s); break;
    case 2: e = launch_jb<2, false>(p, x, y, s); break;
    case 1: e = launch_jb<1, false>(p, x, y, s); break;
    default: e = cudaErrorInvalidValue;
  }
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // extern "C"
