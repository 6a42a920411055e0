// K6 sine_affine2d: the physical-basis closed-form interval relaxation,
// one (interval j, table row r) output state per block,
//   y[j, r] = Sx (xhat_j * A[r0+r] + G[r0+r] [+ (dhat_j * dscale) * A[r0+r-1]]) Sy
// with A[-1] = 1, written with its Dirichlet ring; blocks of row 0 also copy
// seed j into seed_out when it is given (the C-row of the tube).
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.relax_interval, physical
// branch (the back transform of A^k xhat + G_k, CN's ring correction
// delta * A^(k-1), the ring `.at[].set` chain and the chunked concat), and
// the physical side of pymgrit_tpu/core/solver.py Mgrit._cnd_materialize_expr.
//
// Bound: FP64 operations.  Each output state is two (127 x 127) products,
// 8.2 MFLOP; the materialization of the TOMS tube is 16384 of them and
// writes 2.18 GB.  Design: the block forms its coefficient tile in shared
// memory straight from xhat, the table rows and the correction (the
// prologue), so the (rows, J, 127, 127) workspace of the JAX version is
// never written; the back transform is the shared core (sine2d.cuh) with
// the products in the block's own loops.  The output is addressed by an
// interval stride, a row stride and a state-row stride, which covers the
// row-major, interval-major and in-tube layouts with one kernel.  Sides
// above 128 (the one-tile core's limit) take the tiled path of tiled2d.cuh:
// the coefficient tiles and the two products through a device workspace, a
// chunk of output states at a time.

#include "sine2d.cuh"
#include "tiled2d.cuh"

namespace {

using namespace sine2d;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sine_affine2d_kernel(const T* __restrict__ xhat, int64_t x_sj,
                         const T* __restrict__ A, const T* __restrict__ G, int64_t r0,
                         int64_t R, const T* __restrict__ dhat, int64_t d_sj,
                         const T* __restrict__ dscale, T* __restrict__ out, int64_t o_sj,
                         int64_t o_sr, int64_t o_row, const T* __restrict__ seed,
                         int64_t s_sj, int64_t s_row, T* __restrict__ seed_out,
                         int64_t so_sj, int64_t so_row, const T* __restrict__ Sx,
                         const T* __restrict__ Sy, const T* __restrict__ ring, int r,
                         int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int64_t j = blockIdx.x / R;
  const int64_t rr = blockIdx.x - j * R;
  const int64_t ra = r0 + rr;
  const int64_t N = (int64_t)r * c;
  const T* xh = xhat + j * x_sj;
  const T* a = A + ra * N;
  const T* gg = G + ra * N;
  const T* am1 = ra > 0 ? A + (ra - 1) * N : nullptr;
  const T* dh = dhat != nullptr ? dhat + j * d_sj : nullptr;
  clear_tile(M);
  __syncthreads();
  for (int idx = threadIdx.x; idx < r * c; idx += kThreads) {
    T v = xh[idx] * a[idx] + gg[idx];
    if (dh != nullptr) v = v + (dh[idx] * dscale[idx]) * (am1 != nullptr ? am1[idx] : T(1));
    const int i = idx / c;
    M[i * kLd + (idx - i * c)] = v;
  }
  __syncthreads();
  sandwich(M, r, c, Sx, Sy, static_cast<const T*>(nullptr), T(0));
  store_state(M, r, c, out + j * o_sj + rr * o_sr, o_row, ring, static_cast<const T*>(nullptr),
              0);
  if (seed_out != nullptr && rr == 0) {
    const int P = ring != nullptr ? r + 2 : r;
    const int Q = ring != nullptr ? c + 2 : c;
    for (int idx = threadIdx.x; idx < P * Q; idx += kThreads) {
      const int i = idx / Q;
      const int jj = idx - i * Q;
      seed_out[j * so_sj + i * so_row + jj] = seed[j * s_sj + i * s_row + jj];
    }
  }
}

// Tiled path: the coefficient tile of flat output state b0 + blockIdx.x
// (interval j, table row rr) into the workspace, as the kernel above forms
// it in shared memory.
template <typename T>
__global__ void affine_tile(const T* __restrict__ xhat, int64_t x_sj, const T* __restrict__ A,
                            const T* __restrict__ G, int64_t r0, int64_t R,
                            const T* __restrict__ dhat, int64_t d_sj,
                            const T* __restrict__ dscale, T* __restrict__ w, int64_t b0,
                            int64_t N) {
  const int64_t bg = b0 + blockIdx.x;
  const int64_t j = bg / R;
  const int64_t ra = r0 + (bg - j * R);
  const T* xh = xhat + j * x_sj;
  const T* a = A + ra * N;
  const T* gg = G + ra * N;
  const T* am1 = ra > 0 ? A + (ra - 1) * N : nullptr;
  const T* dh = dhat != nullptr ? dhat + j * d_sj : nullptr;
  for (int64_t idx = threadIdx.x; idx < N; idx += blockDim.x) {
    T v = xh[idx] * a[idx] + gg[idx];
    if (dh != nullptr) v = v + (dh[idx] * dscale[idx]) * (am1 != nullptr ? am1[idx] : T(1));
    w[blockIdx.x * N + idx] = v;
  }
}

template <typename T>
__global__ void copy_seeds(const T* __restrict__ seed, int64_t s_sj, int64_t s_row,
                           T* __restrict__ seed_out, int64_t so_sj, int64_t so_row, int P, int Q) {
  const int64_t j = blockIdx.x;
  for (int idx = threadIdx.x; idx < P * Q; idx += blockDim.x) {
    const int i = idx / Q;
    const int jj = idx - i * Q;
    seed_out[j * so_sj + i * so_row + jj] = seed[j * s_sj + i * s_row + jj];
  }
}

template <typename T>
int launch_tiled(const T* xhat, int64_t x_sj, const T* A, const T* G, int64_t r0, int64_t R,
                 int64_t J, const T* dhat, int64_t d_sj, const T* dscale, T* out, int64_t o_sj,
                 int64_t o_sr, int64_t o_row, const T* seed, int64_t s_sj, int64_t s_row,
                 T* seed_out, int64_t so_sj, int64_t so_row, const T* Sx, const T* Sy,
                 const T* ring, T* ws, int64_t chunk, int64_t r, int64_t c, cudaStream_t st) {
  if (ws == nullptr || chunk < 1) return (int)cudaErrorInvalidValue;
  const int64_t rc = r * c;
  const int64_t total = J * R;
  for (int64_t b0 = 0; b0 < total; b0 += chunk) {
    const int64_t nb = total - b0 < chunk ? total - b0 : chunk;
    affine_tile<T><<<(unsigned)nb, 256, 0, st>>>(xhat, x_sj, A, G, r0, R, dhat, d_sj, dscale, ws,
                                                  b0, rc);
    cudaError_t e = cudaGetLastError();
    tiled2d::Epilogue<T> last{};
    last.out = out;
    last.o_hi = o_sj;
    last.o_lo = o_sr;
    last.o_row = o_row;
    last.off = ring != nullptr ? 1 : 0;
    last.D = R;
    last.b0 = b0;
    if (e == cudaSuccess) {
      e = tiled2d::sandwich<T>({ws, rc, c}, (int)r, (int)c, Sx, Sy, ws, ws + chunk * rc, nb,
                               tiled2d::Epilogue<T>{}, last, false, st);
    }
    if (e == cudaSuccess && ring != nullptr) {
      e = tiled2d::ring<T>(ring, (int)r + 2, (int)c + 2, nb, last, st);
    }
    if (e != cudaSuccess) return (int)e;
  }
  if (seed_out != nullptr) {
    const int off = ring != nullptr ? 2 : 0;
    copy_seeds<T><<<(unsigned)J, 256, 0, st>>>(seed, s_sj, s_row, seed_out, so_sj, so_row,
                                               (int)r + off, (int)c + off);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* xhat, int64_t x_sj, const T* A, const T* G, int64_t r0, int64_t R,
           int64_t J, const T* dhat, int64_t d_sj, const T* dscale, T* out, int64_t o_sj,
           int64_t o_sr, int64_t o_row, const T* seed, int64_t s_sj, int64_t s_row,
           T* seed_out, int64_t so_sj, int64_t so_row, const T* Sx, const T* Sy,
           const T* ring, T* ws, int64_t chunk, int64_t r, int64_t c, void* stream) {
  if (J == 0 || R == 0) return 0;
  if (r < 1 || c < 1 || r > 0x7fffffff / c || J * R > 0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  if (r > kMaxN || c > kMaxN) {
    return launch_tiled<T>(xhat, x_sj, A, G, r0, R, J, dhat, d_sj, dscale, out, o_sj, o_sr, o_row,
                           seed, s_sj, s_row, seed_out, so_sj, so_row, Sx, Sy, ring, ws, chunk, r,
                           c, (cudaStream_t)stream);
  }
  const size_t smem = smem_bytes<T>();
  cudaError_t e = allow_smem(sine_affine2d_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  sine_affine2d_kernel<T><<<(unsigned)(J * R), kThreads, smem, (cudaStream_t)stream>>>(
      xhat, x_sj, A, G, r0, R, dhat, d_sj, dscale, out, o_sj, o_sr, o_row, seed, s_sj,
      s_row, seed_out, so_sj, so_row, Sx, Sy, ring, (int)r, (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_sine_affine2d_f64(const double* xhat, int64_t x_sj, const double* A,
                         const double* G, int64_t r0, int64_t R, int64_t J,
                         const double* dhat, int64_t d_sj, const double* dscale,
                         double* out, int64_t o_sj, int64_t o_sr, int64_t o_row,
                         const double* seed, int64_t s_sj, int64_t s_row,
                         double* seed_out, int64_t so_sj, int64_t so_row,
                         const double* Sx, const double* Sy, const double* ring,
                         double* ws, int64_t chunk, int64_t r, int64_t c, void* stream) {
  return launch<double>(xhat, x_sj, A, G, r0, R, J, dhat, d_sj, dscale, out, o_sj, o_sr,
                        o_row, seed, s_sj, s_row, seed_out, so_sj, so_row, Sx, Sy, ring, ws,
                        chunk, r, c, stream);
}

int pm_sine_affine2d_f32(const float* xhat, int64_t x_sj, const float* A, const float* G,
                         int64_t r0, int64_t R, int64_t J, const float* dhat, int64_t d_sj,
                         const float* dscale, float* out, int64_t o_sj, int64_t o_sr,
                         int64_t o_row, const float* seed, int64_t s_sj, int64_t s_row,
                         float* seed_out, int64_t so_sj, int64_t so_row, const float* Sx,
                         const float* Sy, const float* ring, float* ws, int64_t chunk,
                         int64_t r, int64_t c, void* stream) {
  return launch<float>(xhat, x_sj, A, G, r0, R, J, dhat, d_sj, dscale, out, o_sj, o_sr,
                       o_row, seed, s_sj, s_row, seed_out, so_sj, so_row, Sx, Sy, ring, ws,
                       chunk, r, c, stream);
}

}  // extern "C"
