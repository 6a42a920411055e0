// K9 affine_windows: the truncated coarsest-level solves of AT-MGRIT for an
// elementwise affine step.  For every lane p = 0..nt-1 and column j:
//   x = u[ws(p), j],  ws(p) = max(0, p - k + 1);
//   for r = ws(p) .. p-1:  x = g[r, j] + (A[r, j] * x + b[r, j]);
//   out[p, j] = x.
// Row r of A, b and g is the step from point r to point r + 1 (the coarse
// tube's g rows 1..nt-1).  A lane whose window is empty (p = 0, or k = 1)
// is copied.
//
// Replaces: pymgrit_tpu/core/at_mgrit.py AtMgrit._forward_solve, a vmap
// over all coarsest points of a masked lax.scan of k-1 steps.
//
// Bound: bytes, with the FP64 instruction issue close behind.  u and g are
// read and out written once, 3 x 2049 x 16129 x 8 bytes = 794 MB at the
// TOMS width (nt = 2049, N = 16129, k = 64): 0.237 ms at 3.35 TB/s; each
// lane takes its own k-1 steps, an FMA and an add an entry and step (4.1 G
// FP64 instructions, ~0.245 ms at 64 a clock on 132 SMs).  What held the
// first version back: one thread a (lane, column), so each lane re-read up
// to k-1 rows of g through L2 (16.6 GB at the TOMS width).  Design:
// * a thread owns one column and a run of Q consecutive lanes p0..p0+Q-1
//   (Q = 32 where the runs still fill the card, else 1: ops/prefix.py
//   ``affine_windows_plan``) and walks the rows
//   ws(p0)..p0+Q-2 once, each row's g (and A, b where their row stride is
//   not 0; else they sit in registers) loaded once and applied to every
//   lane whose window covers it: a lane's rows from L2 fall from k-1 to
//   (Q+k-2)/Q (2.9 at Q = 32, k = 64), and the Q lanes' independent chains
//   keep the FP64 pipe busy;
// * a run away from the tube's start and end (p0 >= k-1, a whole run,
//   k > Q) has a fixed shape: Q head rows in which lane h starts (its
//   state read from u) and the row applies to lanes 0..h, k-1-Q rows that
//   apply to every lane, Q-1 tail rows before which lane h is stored; the
//   head and the tail are unrolled (no predicate a lane).  Its rows come
//   through a cp.async ring in shared memory, 8 rows ahead (4 where A and
//   b have rows and ride along), each thread copying and reading its own
//   column (no barrier): the loads run ahead without holding registers (a
//   head whose loads the compiler hoisted took 200 registers, one block an
//   SM, and 0.60 ms at the TOMS width on an NVIDIA H100 80GB HBM3).  The
//   other runs (the first (k-1)/Q, a partial last one, k <= Q: 2 of 65 at
//   the TOMS width) and runs of one lane (Q = 1: the narrow tubes, whose
//   rows stay in the caches; a ring there put a shared-memory round trip
//   in each dependent step) go lane by lane, each lane reading its own
//   rows, as the first version did, unrolled by 8 so that the loads run
//   ahead;
// * each lane's steps stay in order and its arithmetic is the first
//   version's, written out: x = g + fma(A, x, b), an FMA and an add that
//   round once each (the plain version rounds A x and + b apart: the kernel
//   is held at the kernel tolerance, a second launch gives the same bits);
// * threads are numbered column-fastest, so a warp reads 32 neighbouring
//   columns of a row (for N = 1, neighbouring runs of the one column).
// No lane writes a row another lane reads: out must not alias u.  Launched
// by one ctypes call: a packed int64 argument array.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ double fma_rn(double a, double x, double b) { return __fma_rn(a, x, b); }
__device__ __forceinline__ float fma_rn(float a, float x, float b) { return __fmaf_rn(a, x, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one element of global memory into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void copy_element(T* slot, const T* src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
  if (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
  }
}

// The ring of a fixed-shape run: each row's g (and u in the head; A and b
// where they have rows) kAhead rows ahead, in kAhead + 1 slots of
// kMaxThreads elements a row (a slot is refilled one row after it was
// read); each thread copies and reads its own column's elements, so no
// barrier: 36-40 KB a block in float64.
template <bool ROWS>
struct Ring {
  static constexpr int kAhead = ROWS ? 4 : 8;
  static constexpr int kSlots = kAhead + 1;
  static constexpr int kRows = ROWS ? 4 : 2;   // g, u[, A, b]
};

template <typename T, int Q, bool ROWS>
__global__ void __launch_bounds__(kMaxThreads, 2)
    affine_windows_kernel(const T* __restrict__ u, int64_t u_s, const T* __restrict__ A,
                          int64_t a_s, const T* __restrict__ B, int64_t b_s,
                          const T* __restrict__ g, int64_t g_s, T* __restrict__ out, int64_t o_s,
                          int64_t nt, int64_t N, int64_t k, int64_t runs) {
  using R = Ring<ROWS>;
  __shared__ __align__(16) T ring[R::kSlots * R::kRows * kMaxThreads];
  constexpr int row = kMaxThreads;   // elements of a slot's row
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * runs) return;
  const int64_t run = tid / N, j = tid - run * N;
  const int64_t p0 = run * Q;
  const int nq = (int)(nt - p0 < Q ? nt - p0 : Q);
  // a broadcast A and b in registers (a tube of one point has no rows: its
  // A and b may be null)
  const T a0 = ROWS || nt < 2 ? (T)0 : __ldg(A + j), b0 = ROWS || nt < 2 ? (T)0 : __ldg(B + j);
  if (Q > 1 && p0 >= k - 1 && nq == Q && k > Q) {
    T x[Q];
    // rows r0 + i, i = 0 .. S-1: Q head rows (lane i starts at row r0 + i),
    // k-1-Q middle rows (every lane), Q-1 tail rows (lane h ends before
    // row p0 + h)
    const int64_t r0 = p0 - k + 1, S = k + Q - 2;
    T* mine = ring + threadIdx.x;
    const auto issue = [&](int64_t i, int s) {
      T* slot = mine + s * R::kRows * row;
      const int64_t r = r0 + i;
      copy_element(slot, g + r * g_s + j);
      if (i < Q) copy_element(slot + row, u + r * u_s + j);
      if (ROWS) {
        copy_element(slot + 2 * row, A + r * a_s + j);
        copy_element(slot + 3 * row, B + r * b_s + j);
      }
    };
#pragma unroll
    for (int i = 0; i < R::kAhead; ++i) {
      if (i < S) issue(i, i);
      commit();
    }
    int s = 0, sn = R::kAhead;   // the slot read at row i, the slot filled
    T gv, uv, av = a0, bv = b0;
    // row i's operands from its slot, row i + kAhead's copies issued
    const auto next = [&](int64_t i) {
      if (i + R::kAhead < S) issue(i + R::kAhead, sn);
      commit();
      wait_groups<R::kAhead>();
      const T* slot = mine + s * R::kRows * row;
      gv = slot[0];
      if (i < Q) uv = slot[row];
      if (ROWS) {
        av = slot[2 * row];
        bv = slot[3 * row];
      }
      s = s == R::kSlots - 1 ? 0 : s + 1;
      sn = sn == R::kSlots - 1 ? 0 : sn + 1;
    };
#pragma unroll
    for (int h = 0; h < Q; ++h) {
      next(h);
      x[h] = uv;
#pragma unroll
      for (int q = 0; q <= h; ++q) x[q] = add_rn(gv, fma_rn(av, x[q], bv));
    }
#pragma unroll 1
    for (int64_t i = Q; i < k - 1; ++i) {
      next(i);
#pragma unroll
      for (int q = 0; q < Q; ++q) x[q] = add_rn(gv, fma_rn(av, x[q], bv));
    }
#pragma unroll
    for (int h = 0; h < Q - 1; ++h) {
      out[(p0 + h) * o_s + j] = x[h];
      next(k - 1 + h);
#pragma unroll
      for (int q = h + 1; q < Q; ++q) x[q] = add_rn(gv, fma_rn(av, x[q], bv));
    }
    out[(p0 + Q - 1) * o_s + j] = x[Q - 1];
    return;
  }
  // any other run (the first (k-1)/Q, a partial last one, k <= Q, and
  // every run of one lane): lane by lane, x = u[ws(p)] stepped through rows
  // ws(p)..p-1, unrolled so that the rows' loads run ahead of the steps
  for (int q = 0; q < nq; ++q) {
    const int64_t p = p0 + q, ws = p - k + 1 > 0 ? p - k + 1 : 0;
    T y = __ldg(u + ws * u_s + j);
#pragma unroll 8
    for (int64_t r = ws; r < p; ++r) {
      const T av = ROWS ? __ldg(A + r * a_s + j) : a0, bv = ROWS ? __ldg(B + r * b_s + j) : b0;
      y = add_rn(__ldg(g + r * g_s + j), fma_rn(av, y, bv));
    }
    out[p * o_s + j] = y;
  }
}

template <typename T, int Q>
void dispatch_rows(bool rows, unsigned grid, unsigned block, cudaStream_t s, const int64_t* a) {
  const T* u = reinterpret_cast<const T*>(a[1]);
  const T* A = reinterpret_cast<const T*>(a[2]);
  const T* B = reinterpret_cast<const T*>(a[3]);
  const T* g = reinterpret_cast<const T*>(a[4]);
  T* out = reinterpret_cast<T*>(a[5]);
  if (rows) {
    affine_windows_kernel<T, Q, true><<<grid, block, 0, s>>>(
        u, a[6], A, a[7], B, a[8], g, a[9], out, a[10], a[11], a[12], a[13], a[15]);
  } else {
    affine_windows_kernel<T, Q, false><<<grid, block, 0, s>>>(
        u, a[6], A, a[7], B, a[8], g, a[9], out, a[10], a[11], a[12], a[13], a[15]);
  }
}

// args (int64): CUDA device; u, A, b, g, out; their row strides; nt, N, k;
// Q (lanes a thread), runs a column (ceil(nt / Q)), A or b with rows
// (a row stride that is not 0), threads a block, grid
// (ops/prefix.py::affine_windows_pack)
template <typename T>
int launch(const int64_t* a, void* stream) {
  const int64_t nt = a[11], N = a[12], k = a[13];
  const int Q = (int)a[14];
  const bool rows = a[16] != 0;
  const unsigned block = (unsigned)a[17], grid = (unsigned)a[18];
  if (nt == 0 || N == 0) return 0;
  if (k < 1 || block == 0 || block > kMaxThreads || grid == 0 || a[15] != (nt + Q - 1) / Q) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (Q == 1) {
    dispatch_rows<T, 1>(rows, grid, block, s, a);
  } else if (Q == 32) {
    dispatch_rows<T, 32>(rows, grid, block, s, a);
  } else {
    e = cudaErrorInvalidValue;
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_affine_windows_f64(const int64_t* args, void* stream) { return launch<double>(args, stream); }

int pm_affine_windows_f32(const int64_t* args, void* stream) { return launch<float>(args, stream); }

}  // extern "C"
