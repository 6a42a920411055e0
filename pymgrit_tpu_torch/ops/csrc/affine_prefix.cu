// K8 affine_prefix: every state of the elementwise affine recurrence
//   out[k, j] = A[k, j] * out[k-1, j] + (b[k, j] [+ g[k, j]]),  k = 0..n-1,
// with out[-1, j] = x0[j].
//
// Replaces: pymgrit_tpu/ops/prefix.py affine_prefix_states (an
// associative scan over composed affine maps), which the coarsest level of
// pymgrit_tpu/core/solver.py Mgrit._forward_solve runs with
// coarsest_prefix=True instead of the sequential time march.
//
// Bound: bytes at the TOMS width (n = 2048 rows of N = 16129 columns: g
// read once and out written once, 2 x 264 MB in float64, 0.158 ms at 3.35
// TB/s); latency at Dahlquist's one column (n = 16384 rows), where the
// chain itself is the work.  The first version was a three-pass chunked
// scan in three launches through two scratch tensors: it read g twice
// (0.237 ms of traffic at the TOMS width) and put 2 sqrt(n) + sqrt(n)
// dependent steps, each waiting on a load, on Dahlquist's column.  Two
// regimes now, picked by ops/prefix.py ``affine_prefix_plan``, one launch
// each, no scratch:
// * wide (the columns fill the card): one thread a column walks all n
//   rows in order, x = fma(A, x, b + g), a block 128 columns (the TOMS
//   width: 127 blocks on 132 SMs).  The rows of g (and of A and b where
//   their row stride is not 0; else they sit in registers) come through a
//   cp.async ring in shared memory, kU = 4 rows a group, 40 rows of g (40
//   KB a block in float64) in flight, each thread copying and reading its
//   own column (no barrier): g is read once and out written once (with
//   streaming stores), the bound's bytes, and the chain of n FMAs (a few
//   microseconds) hides under the traffic.
// * narrow (Dahlquist's column, and widths whose columns alone leave most
//   SMs idle): a block of 1024 threads holds W columns (the least power of
//   two up to 32 that keeps the blocks to one wave) and walks the rows in
//   tiles of S = 1024 / W segments of R rows.  A tile's rows are staged in
//   shared memory, coalesced (a thread's own segment, read from global
//   memory, would put each lane of a warp on another row: the first
//   version of this regime spent 0.052 ms so on Dahlquist's column); each
//   thread composes its segment's steps into one map y -> P y + C, the
//   maps are scanned across the warp with shuffles and across the 32 warps
//   through shared memory, each thread replays its rows from its carry-in
//   into shared memory, and the tile's out rows are stored, coalesced.
//   Dahlquist's 16384 rows: two tiles, 8 rows a thread, 2 x 8 dependent
//   steps and 12 shuffle levels a tile instead of 16384 steps.
// Every operand row is addressed by its own element stride; A and b may
// have stride 0, g may be null.  The association order differs from the
// sequential recurrence and from JAX's associative scan, so the results
// agree with both to rounding, not bitwise (held at the kernel tolerance;
// a second launch gives the same bits).  Launched by one ctypes call: a
// packed int64 argument array.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWide = 128;      // threads (columns) of a wide block
constexpr int kNarrow = 1024;   // threads of a narrow block
constexpr int kWarps = kNarrow / 32;
constexpr int kMaxW = 32;       // columns of a narrow block
constexpr int kU = 4;           // rows of a ring group (wide)
constexpr int kNarrowSmem = 192 * 1024;   // a narrow block's tile buffers, at most

__device__ __forceinline__ double fma_rn(double a, double x, double b) { return __fma_rn(a, x, b); }
__device__ __forceinline__ float fma_rn(float a, float x, float b) { return __fmaf_rn(a, x, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

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

template <typename T>
struct Args {
  const T *A, *B, *g, *x0;
  T* out;
  int64_t a_s, b_s, g_s, o_s, n, N;
  int W;                        // narrow: columns a block
  int64_t R;                    // narrow: rows a segment
};

// The wide ring: the streamed operands (A and b where they have rows, g
// where given), kU rows a group, kAhead groups ahead in kAhead + 1 slots
// (a slot is refilled one group after it was read): 40 rows of g (36 KB
// of 128 float64 columns in flight a block), 20 of two operands, 12 of
// three, within 48 KB of static shared memory.
template <bool AR, bool BR, bool G>
struct WideRing {
  static constexpr int kOps = int(AR) + int(BR) + int(G);
  static constexpr int kAhead = kOps <= 1 ? 10 : kOps == 2 ? 5 : 3;
  static constexpr int kSlots = kAhead + 1;
  static constexpr int kSlot = (kOps > 0 ? kOps : 1) * kU * kWide;   // elements a slot
  static constexpr int kA = 0, kB = int(AR), kG = int(AR) + int(BR);  // operand rows in a slot
};

template <typename T, bool AR, bool BR, bool G>
__global__ void __launch_bounds__(kWide, 1) prefix_wide(const Args<T> p) {
  using R = WideRing<AR, BR, G>;
  __shared__ __align__(16) T ring[R::kOps > 0 ? R::kSlots * R::kSlot : 1];
  const int64_t j = (int64_t)blockIdx.x * kWide + threadIdx.x;
  if (j >= p.N) return;
  T* mine = ring + threadIdx.x;
  const T a0 = AR ? T(0) : p.A[j], b0 = BR ? T(0) : p.B[j];
  const int64_t n = p.n, groups = (n + kU - 1) / kU;
  // group q's rows q kU .. q kU + kU - 1 (those below n) into slot s
  const auto issue = [&](int64_t q, int s) {
    T* slot = mine + s * R::kSlot;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t r = q * kU + u;
      if (r < n) {
        if (AR) copy_element(slot + (R::kA * kU + u) * kWide, p.A + r * p.a_s + j);
        if (BR) copy_element(slot + (R::kB * kU + u) * kWide, p.B + r * p.b_s + j);
        if (G) copy_element(slot + (R::kG * kU + u) * kWide, p.g + r * p.g_s + j);
      }
    }
  };
  if (R::kOps > 0) {
#pragma unroll
    for (int i = 0; i < R::kAhead; ++i) {
      if (i < groups) issue(i, i);
      commit();
    }
  }
  T x = p.x0[j];
  T* o = p.out + j;
  int s = 0, sn = R::kAhead;   // the slot read at group q, the slot refilled
#pragma unroll 1
  for (int64_t q = 0; q < groups; ++q) {
    T av[kU], cv[kU];
    if (R::kOps > 0) {
      if (q + R::kAhead < groups) issue(q + R::kAhead, sn);
      commit();
      wait_groups<R::kAhead>();
      const T* slot = mine + s * R::kSlot;
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        av[u] = AR ? slot[(R::kA * kU + u) * kWide] : a0;
        const T bv = BR ? slot[(R::kB * kU + u) * kWide] : b0;
        cv[u] = G ? add_rn(bv, slot[(R::kG * kU + u) * kWide]) : bv;
      }
      s = s == R::kSlots - 1 ? 0 : s + 1;
      sn = sn == R::kSlots - 1 ? 0 : sn + 1;
    } else {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        av[u] = a0;
        cv[u] = b0;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int64_t r = q * kU + u;
      if (r < n) {
        x = fma_rn(av[u], x, cv[u]);
        __stcs(o + r * p.o_s, x);   // streamed: out is not read again here
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ T shfl_up(T v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}

// element e of a narrow tile's buffer, one element of padding every 32, so
// that the lanes of a warp reading their segments' runs spread over the
// banks
__device__ __forceinline__ int pad(int e) { return e + (e >> 5); }

// The narrow regime's tile: S segments of R rows of the block's W columns,
// staged in shared memory (dynamic): one buffer a streamed operand (A and
// b where they have rows, g where given; one when none is), each
// tile_elements(R) elements; buffer 0 takes the tile's out rows.
__host__ __device__ constexpr int64_t tile_elements(int64_t R) {
  return kNarrow * R + (kNarrow * R - 1) / 32 + 1;
}

template <typename T, bool AR, bool BR, bool G>
__global__ void __launch_bounds__(kNarrow, 1) prefix_narrow(const Args<T> p) {
  constexpr int kA = 0, kB = int(AR), kG = int(AR) + int(BR);   // buffer of each operand
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  // each warp's aggregate map per column, then the warps' exclusive
  // prefixes; each column's carry into the next tile
  __shared__ T aggP[kWarps][kMaxW], aggC[kWarps][kMaxW], carry[kMaxW];
  const int W = p.W, lw = __ffs(W) - 1, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int w = t & (W - 1), R = (int)p.R, k0 = (t >> lw) * R;   // this segment's first row
  const int TR = (kNarrow >> lw) * R;                              // rows a tile
  const int64_t stride = tile_elements(R), c0 = (int64_t)blockIdx.x * W, j = c0 + w;
  const bool col = j < p.N;
  const T a0 = !AR && col ? p.A[j] : T(1), b0 = !BR && col ? p.B[j] : T(0);
  if (t < W) carry[t] = c0 + t < p.N ? p.x0[c0 + t] : T(0);
  // row k of the tile, this thread's column: (A, b [+ g])
  const auto step = [&](int k, T& a, T& c) {
    const int e = pad((k << lw) + w);
    a = AR ? buf[kA * stride + e] : a0;
    const T bv = BR ? buf[kB * stride + e] : b0;
    c = G ? add_rn(bv, buf[kG * stride + e]) : bv;
  };
#pragma unroll 1
  for (int64_t r0 = 0; r0 < p.n; r0 += TR) {
    const int rows = p.n - r0 < TR ? (int)(p.n - r0) : TR;
    // the tile's rows of the streamed operands, coalesced: element e is
    // row e / W, column e % W
    for (int e = t; e < rows << lw; e += kNarrow) {
      const int64_t r = r0 + (e >> lw), jj = c0 + (e & (W - 1));
      if (jj < p.N) {
        T* d = buf + pad(e);
        if (AR) copy_element(d + kA * stride, p.A + r * p.a_s + jj);
        if (BR) copy_element(d + kB * stride, p.B + r * p.b_s + jj);
        if (G) copy_element(d + kG * stride, p.g + r * p.g_s + jj);
      }
    }
    commit();
    wait_groups<0>();
    __syncthreads();
    const int k1 = k0 + R < rows ? k0 + R : rows;
    // this segment's steps as one map y -> P y + C
    T P = T(1), C = T(0);
    if (col) {
      for (int k = k0; k < k1; ++k) {
        T a, c;
        step(k, a, c);
        P = mul_rn(a, P);
        C = fma_rn(a, C, c);
      }
    }
    // inclusive scan over the warp's segments of this column (lanes w,
    // w + W, ...): the earlier map first, then this one
    for (int d = W; d < 32; d *= 2) {
      const T Pe = shfl_up(P, d), Ce = shfl_up(C, d);
      if (lane >= d) {
        C = fma_rn(P, Ce, C);
        P = mul_rn(P, Pe);
      }
    }
    if (lane >= 32 - W) {
      aggP[warp][w] = P;
      aggC[warp][w] = C;
    }
    // exclusive within the warp
    T Pw = shfl_up(P, W), Cw = shfl_up(C, W);
    if (lane < W) {
      Pw = T(1);
      Cw = T(0);
    }
    __syncthreads();
    // warp v scans column v's 32 warp aggregates (lane = warp) and leaves
    // each warp's exclusive prefix
    if (warp < W) {
      T Pa = aggP[lane][warp], Ca = aggC[lane][warp];
      for (int d = 1; d < 32; d *= 2) {
        const T Pe = shfl_up(Pa, d), Ce = shfl_up(Ca, d);
        if (lane >= d) {
          Ca = fma_rn(Pa, Ce, Ca);
          Pa = mul_rn(Pa, Pe);
        }
      }
      T Px = shfl_up(Pa, 1), Cx = shfl_up(Ca, 1);
      if (lane == 0) {
        Px = T(1);
        Cx = T(0);
      }
      aggP[lane][warp] = Px;
      aggC[lane][warp] = Cx;
    }
    __syncthreads();
    // the carry-in: the column's carry through the earlier warps, then the
    // earlier segments; the replay writes x into buffer 0
    T x = fma_rn(aggP[warp][w], carry[w], aggC[warp][w]);
    x = fma_rn(Pw, x, Cw);
    if (col) {
      for (int k = k0; k < k1; ++k) {
        T a, c;
        step(k, a, c);
        x = fma_rn(a, x, c);
        buf[pad((k << lw) + w)] = x;
      }
    }
    __syncthreads();
    // the segment that holds the tile's last row carries its x on
    if (col && k0 < rows && rows <= k1) carry[w] = x;
    for (int e = t; e < rows << lw; e += kNarrow) {
      const int64_t jj = c0 + (e & (W - 1));
      if (jj < p.N) p.out[(r0 + (e >> lw)) * p.o_s + jj] = buf[pad(e)];
    }
    __syncthreads();
  }
}

template <typename T, bool AR, bool BR, bool G>
cudaError_t dispatch(bool wide, unsigned grid, int device, cudaStream_t s, const Args<T>& p) {
  if (wide) {
    prefix_wide<T, AR, BR, G><<<grid, kWide, 0, s>>>(p);
    return cudaGetLastError();
  }
  constexpr int kBufs = int(AR) + int(BR) + int(G) > 0 ? int(AR) + int(BR) + int(G) : 1;
  const int64_t bytes = kBufs * tile_elements(p.R) * (int64_t)sizeof(T);
  if (bytes > kNarrowSmem) return cudaErrorInvalidValue;
  // the opt-in above 48 KB, once a device
  static bool opted[64] = {};
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!opted[device]) {
    const cudaError_t e = cudaFuncSetAttribute(prefix_narrow<T, AR, BR, G>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               kNarrowSmem);
    if (e != cudaSuccess) return e;
    opted[device] = true;
  }
  prefix_narrow<T, AR, BR, G><<<grid, kNarrow, (size_t)bytes, s>>>(p);
  return cudaGetLastError();
}

// args (int64): CUDA device; A, b, g (0: none), x0, out; the row strides
// of A, b, g, out; n, N; the regime (0 wide, 1 narrow), columns a block,
// segments a column, rows a segment, grid
// (ops/prefix.py::affine_prefix_pack)
template <typename T>
int launch(const int64_t* a, void* stream) {
  Args<T> p{};
  p.A = reinterpret_cast<const T*>(a[1]);
  p.B = reinterpret_cast<const T*>(a[2]);
  p.g = reinterpret_cast<const T*>(a[3]);
  p.x0 = reinterpret_cast<const T*>(a[4]);
  p.out = reinterpret_cast<T*>(a[5]);
  p.a_s = a[6];
  p.b_s = a[7];
  p.g_s = a[8];
  p.o_s = a[9];
  p.n = a[10];
  p.N = a[11];
  const bool wide = a[12] == 0;
  const int64_t W = a[13], S = a[14], grid = a[16];
  p.W = (int)W;
  p.R = a[15];
  if (p.n == 0 || p.N == 0) return 0;
  const bool ok_wide = W == kWide && S == 1 && grid == (p.N + kWide - 1) / kWide;
  const bool ok_narrow = W >= 1 && W <= kMaxW && (W & (W - 1)) == 0 && S * W == kNarrow &&
                         p.R >= 1 && grid == (p.N + W - 1) / W;
  if (p.n < 0 || p.N < 0 || !(wide ? ok_wide : ok_narrow) || grid > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)a[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ar = p.a_s != 0, br = p.b_s != 0, g = p.g != nullptr;
  const unsigned blocks = (unsigned)grid;
  cudaError_t e;
  if (ar) {
    if (br) {
      e = g ? dispatch<T, true, true, true>(wide, blocks, device, s, p)
            : dispatch<T, true, true, false>(wide, blocks, device, s, p);
    } else {
      e = g ? dispatch<T, true, false, true>(wide, blocks, device, s, p)
            : dispatch<T, true, false, false>(wide, blocks, device, s, p);
    }
  } else if (br) {
    e = g ? dispatch<T, false, true, true>(wide, blocks, device, s, p)
          : dispatch<T, false, true, false>(wide, blocks, device, s, p);
  } else {
    e = g ? dispatch<T, false, false, true>(wide, blocks, device, s, p)
          : dispatch<T, false, false, false>(wide, blocks, device, s, p);
  }
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_affine_prefix_f64(const int64_t* args, void* stream) { return launch<double>(args, stream); }

int pm_affine_prefix_f32(const int64_t* args, void* stream) { return launch<float>(args, stream); }

}  // extern "C"
