// K22 eig_step: the Diffusion2D backward-Euler step of B lanes in the
// generalized eigenbasis of its P1-DG operator,
//
//   y_b = ((x_b W^T) / (1 + dt_b lam)) V^T        (row form of V ((W u) / (1 + dt lam)))
//
// with dense (N x N) tables W = V^T M and V (N = 6 n^2 degrees of freedom).
//
// Replaces: pymgrit_tpu/models/diffusion_2d.py Diffusion2D.step (the two
// dense products around the diagonal scale, lines 195-198), which the JAX
// package vmaps over the C-points and F-chains and leaves to XLA's dot.
//
// Bound: at 8 lanes the bytes of the two tables (2 N^2 values, 92 MB at
// N = 2400) over the memory rate; at 128 lanes the 4 B N^2 operations over
// the FP64 tensor-core rate.  Design: each product C = A M^T (A the (B x N)
// lanes, M a row-major table) runs on the FP64 tensor cores with
// mma.sync.aligned.m8n8k4.row.col.f64 (DMMA): M^T is M read column-major,
// the layout the instruction's B operand takes, so both operands stage
// along the contiguous inner index.  A block of 128 threads (2 x 2 warps)
// owns a 64 x 64 output tile and walks the inner index in k-tiles of 16
// staged through shared memory (rows padded to 20 values: a half-warp's
// fragment loads hit 16 distinct 8-byte banks); each warp holds a 32 x 32
// tile as 4 x 4 m8n8 accumulators.  Any B, N and lane stride: rows, columns
// and inner indices past the edge stage as zeros and are not written.  The
// first launch divides by 1 + dt_b lam_j in its epilogue (explicitly
// rounded, as the plain version rounds it) into a (B x N) workspace; the
// second writes the output.  No TMA, no pipelining: a plain block tile.
// The float32 instantiation runs the same tiles on the CUDA cores (FFMA,
// 4 x 8 outputs a thread); it never uses TF32.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;        // lanes a block
constexpr int kBN = 64;        // output columns a block
constexpr int kBK = 16;        // inner index a stage
constexpr int kThreads = 128;

__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }

// d += a b for one m8n8k4 f64 fragment: a = A[g][q], b = B[q][g] (B = M^T,
// so b = M[g][q]), d = C[g][2q], C[g][2q + 1], with g = lane / 4, q = lane % 4
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(d[0]), "+d"(d[1])
               : "d"(a), "d"(b));
}

// Stage A[row0 .. row0+63][k0 .. k0+15] and M[col0 .. col0+63][k0 .. k0+15]
// (zeros past the edges).
template <typename T, int kLd>
__device__ __forceinline__ void stage(T (*As)[kLd], T (*Ms)[kLd], const T* __restrict__ A,
                                      int64_t sa, const T* __restrict__ M, int64_t N,
                                      int64_t B, int64_t row0, int64_t col0, int64_t k0) {
  for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
    const int r = e / kBK, k = e % kBK;
    const int64_t kk = k0 + k;
    const int64_t b = row0 + r, j = col0 + r;
    As[r][k] = (b < B && kk < N) ? A[b * sa + kk] : T(0);
    Ms[r][k] = (j < N && kk < N) ? M[j * N + kk] : T(0);
  }
}

template <typename T, bool kScale>
__device__ __forceinline__ void emit(T v, int64_t b, int64_t j, int64_t B, int64_t N,
                                     const T* __restrict__ dt, const T* __restrict__ lam,
                                     T* __restrict__ C, int64_t sc) {
  if (b >= B || j >= N) return;
  if (kScale) v = v / add_rn(T(1), mul_rn(dt[b], lam[j]));
  C[b * sc + j] = v;
}

// C = A M^T [/ (1 + dt lam)] in double on the FP64 tensor cores.
template <bool kScale>
__global__ void __launch_bounds__(kThreads)
    dmma_product(const double* __restrict__ A, int64_t sa, const double* __restrict__ M,
                 int64_t N, int64_t B, const double* __restrict__ dt,
                 const double* __restrict__ lam, double* __restrict__ C, int64_t sc) {
  constexpr int kLd = kBK + 4;
  __shared__ double As[kBM][kLd];
  __shared__ double Ms[kBN][kLd];
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int64_t col0 = (int64_t)blockIdx.x * kBN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int g = lane >> 2, q = lane & 3;
  double acc[4][4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = 0.0;
  for (int64_t k0 = 0; k0 < N; k0 += kBK) {
    stage<double, kLd>(As, Ms, A, sa, M, N, B, row0, col0, k0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 4) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[wm + i * 8 + g][ks + q];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ms[wn + j * 8 + g][ks + q];
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
      for (int h = 0; h < 2; ++h)
        emit<double, kScale>(acc[i][j][h], row0 + wm + i * 8 + g, col0 + wn + j * 8 + 2 * q + h,
                             B, N, dt, lam, C, sc);
}

// C = A M^T [/ (1 + dt lam)] in float on the CUDA cores (FFMA; no TF32):
// thread (ty, tx) owns rows ty + 8 i and columns tx + 16 j.
template <bool kScale>
__global__ void __launch_bounds__(kThreads)
    ffma_product(const float* __restrict__ A, int64_t sa, const float* __restrict__ M,
                 int64_t N, int64_t B, const float* __restrict__ dt,
                 const float* __restrict__ lam, float* __restrict__ C, int64_t sc) {
  constexpr int kLd = kBK + 1;
  __shared__ float As[kBM][kLd];
  __shared__ float Ms[kBN][kLd];
  const int64_t row0 = (int64_t)blockIdx.y * kBM;
  const int64_t col0 = (int64_t)blockIdx.x * kBN;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  for (int64_t k0 = 0; k0 < N; k0 += kBK) {
    stage<float, kLd>(As, Ms, A, sa, M, N, B, row0, col0, k0);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[ty + 8 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ms[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit<float, kScale>(acc[i][j], row0 + ty + 8 * i, col0 + tx + 16 * j, B, N, dt, lam, C,
                          sc);
}

template <bool kScale>
void product(const double* A, int64_t sa, const double* M, int64_t N, int64_t B,
             const double* dt, const double* lam, double* C, int64_t sc, dim3 grid,
             cudaStream_t s) {
  dmma_product<kScale><<<grid, kThreads, 0, s>>>(A, sa, M, N, B, dt, lam, C, sc);
}

template <bool kScale>
void product(const float* A, int64_t sa, const float* M, int64_t N, int64_t B, const float* dt,
             const float* lam, float* C, int64_t sc, dim3 grid, cudaStream_t s) {
  ffma_product<kScale><<<grid, kThreads, 0, s>>>(A, sa, M, N, B, dt, lam, C, sc);
}

template <typename T>
int launch(const T* x, int64_t sx, const T* W, const T* V, const T* lam, const T* dt, T* work,
           T* y, int64_t sy, int64_t B, int64_t N, void* stream) {
  if (B == 0 || N == 0) return 0;
  const int64_t col_tiles = (N + kBN - 1) / kBN;
  const int64_t row_tiles = (B + kBM - 1) / kBM;
  if (col_tiles > 0x7fffffff || row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)col_tiles, (unsigned)row_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // work = (x W^T) / (1 + dt lam), then y = work V^T
  product<true>(x, sx, W, N, B, dt, lam, work, N, grid, s);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  product<false>(work, N, V, N, B, (const T*)nullptr, (const T*)nullptr, y, sy, grid, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_eig_step_f64(const double* x, int64_t sx, const double* W, const double* V,
                    const double* lam, const double* dt, double* work, double* y, int64_t sy,
                    int64_t B, int64_t N, void* stream) {
  return launch<double>(x, sx, W, V, lam, dt, work, y, sy, B, N, stream);
}

int pm_eig_step_f32(const float* x, int64_t sx, const float* W, const float* V,
                    const float* lam, const float* dt, float* work, float* y, int64_t sy,
                    int64_t B, int64_t N, void* stream) {
  return launch<float>(x, sx, W, V, lam, dt, work, y, sy, B, N, stream);
}

}  // extern "C"
