// K26 dd_matmul: batched products C_b = A_b B_b of double-double operands
// (float32 pairs hi + lo) on the FP64 tensor cores.  Each operand value is
// formed as the exact float64 hi + lo while it is staged, the products
// accumulate in float64 with mma.sync.aligned.m8n8k4.row.col.f64 (DMMA, K22's
// tile), and the epilogue splits each float64 sum into its DD pair
// (hi = fl32(c), lo = fl32(c - hi), the JAX package's from_f64).
//
// Replaces: pymgrit_tpu/ops/ozaki.py matmul_dd (:84-162), the Ozaki-scheme
// DD product the JAX package runs on the TPU's bf16 MXU because that chip
// has no float64; Hopper has FP64 tensor cores, so the port accumulates in
// float64 instead: about k 2^-53 relative (k the contraction length)
// against Ozaki's 2^-48, and not bitwise equal to the JAX package.  Its
// callers are Heat2D's physical DD step (two-sided 63 x 63 sine products on
// every lane), Heat1D's physical DD step and Diffusion2D's DD step (dense
// 2400 x 2400 tables).
//
// Bound: operations, 2 M N K a product at the tensor cores' 67 TFLOP/s, or
// the bytes of the operands (8 a DD value) where the batch is small.
// Design: K22's plain block tile, no TMA or pipelining: 128 threads (2 x 2
// warps) own a 64 x 64 tile of one product (blockIdx.z walks the batch),
// walk the contraction in k-tiles of 16 staged through shared memory as
// float64 (rows padded to 20 values), and each warp holds 32 x 32 outputs as
// 4 x 4 m8n8 accumulators.  Every operand is addressed by element strides
// (batch, row, column; 0 for a broadcast batch), so a transposed table or a
// strided tube view needs no copy; B stages along whichever of its axes is
// contiguous.  Rows, columns and contraction indices past the edge stage as
// zeros and are not written.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kLd = kBK + 4;
constexpr int kThreads = 128;

struct Mat {
  const float *hi, *lo;
  int64_t sb, sr, sc;     // batch, row, column strides (elements)
};

struct Args {
  Mat a, b;
  float *ch, *cl;
  int64_t scb, scr, scc;
  int64_t batch, M, N, K;
};

__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

__device__ __forceinline__ double value(const Mat& m, int64_t off) {
  return __dadd_rn((double)m.hi[off], (double)m.lo[off]);
}

__global__ void __launch_bounds__(kThreads) dd_matmul_kernel(const Args p) {
  __shared__ double As[kBM][kLd];
  __shared__ double Bs[kBN][kLd];
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int64_t col0 = (int64_t)blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane >> 2, q = lane & 3;
  const bool b_k_fast = p.b.sr == 1;
  for (int64_t z = blockIdx.z; z < p.batch; z += gridDim.z) {
    const int64_t abase = z * p.a.sb, bbase = z * p.b.sb;
    double acc[4][4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
    for (int64_t k0 = 0; k0 < p.K; k0 += kBK) {
      for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, k = e % kBK;
        const int64_t row = row0 + r, kk = k0 + k;
        As[r][k] = (row < p.M && kk < p.K) ? value(p.a, abase + row * p.a.sr + kk * p.a.sc) : 0.0;
        const int c = b_k_fast ? e / kBK : e % kBN;
        const int kb = b_k_fast ? e % kBK : e / kBN;
        const int64_t col = col0 + c, kkb = k0 + kb;
        Bs[c][kb] = (col < p.N && kkb < p.K) ? value(p.b, bbase + kkb * p.b.sr + col * p.b.sc) : 0.0;
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 4) {
        double a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[wm + i * 8 + g][ks + q];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[wn + j * 8 + g][ks + q];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dmma(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t row = row0 + wm + i * 8 + g, col = col0 + wn + j * 8 + 2 * q + h;
          if (row < p.M && col < p.N) {
            const double v = acc[i][j][h];
            const float hi = __double2float_rn(v);
            const int64_t o = z * p.scb + row * p.scr + col * p.scc;
            p.ch[o] = hi;
            p.cl[o] = __double2float_rn(__dsub_rn(v, (double)hi));
          }
        }
  }
}

}  // namespace

extern "C" {

// ptrs: A hi, lo; B hi, lo; C hi, lo.  strides: A (batch, row, column),
// B (...), C (...).  dims: batch, M, N, K.
int pm_dd_matmul(void* const* ptrs, const int64_t* strides, const int64_t* dims, void* stream) {
  Args p;
  p.a = Mat{static_cast<const float*>(ptrs[0]), static_cast<const float*>(ptrs[1]), strides[0],
            strides[1], strides[2]};
  p.b = Mat{static_cast<const float*>(ptrs[2]), static_cast<const float*>(ptrs[3]), strides[3],
            strides[4], strides[5]};
  p.ch = static_cast<float*>(ptrs[4]);
  p.cl = static_cast<float*>(ptrs[5]);
  p.scb = strides[6];
  p.scr = strides[7];
  p.scc = strides[8];
  p.batch = dims[0];
  p.M = dims[1];
  p.N = dims[2];
  p.K = dims[3];
  if (p.batch == 0 || p.M == 0 || p.N == 0) return 0;
  const int64_t col_tiles = (p.N + kBN - 1) / kBN, row_tiles = (p.M + kBM - 1) / kBM;
  if (col_tiles > 0x7fffffff || row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)col_tiles, (unsigned)row_tiles,
                  (unsigned)(p.batch < 65535 ? p.batch : 65535));
  dd_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
