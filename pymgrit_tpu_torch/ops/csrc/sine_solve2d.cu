// K5 sine_solve2d: the batched implicit solve of the physical-basis heat
// step, one state b per block,
//   solve:     x = Sx ((Sx b Sy) / (1 + shift_b * Lam)) Sy
//   transform: x = Sx b Sy                       (lam == nullptr)
// written into the interior of the output state, with the Dirichlet ring
// copied from a template field when ring != nullptr, and plus g when g is
// given (the coarse-level F-relaxation's  x <- g + Phi(x)).
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D._solve_interior_batched
// and the solve/ring part of Heat2D.step_batched (the `.at[].set` chain of
// the output), the forward transform of the seeds (and of CN's ring
// correction) in the physical Heat2D.relax_interval, and Heat2D.to_physical
// -- the batched two-sided spectral solve that the removed Pallas kernel
// computed.
//
// Bound: FP64 operations.  A solve is four (127 x 127) products per state,
// 16.4 MFLOP, against 2 x 129 KB of state read and written.  Design: one
// block per state, the state in shared memory and the partial products in
// registers (sine2d.cuh), so nothing but the input and the output touches
// device memory; b and the output are strided views (batch stride and row
// stride) of the level tubes, so no copy precedes or follows the kernel.
// The products are the block's own loops: no library GEMM is called.
// Sides above 128 (the one-tile core's limit) take the tiled path of
// tiled2d.cuh: the four products through a device workspace, a chunk of
// states at a time.

#include "sine2d.cuh"
#include "tiled2d.cuh"

namespace {

using namespace sine2d;

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    sine_solve2d_kernel(const T* __restrict__ b, int64_t b_sb, int64_t b_sr,
                        T* __restrict__ out, int64_t o_sb, int64_t o_sr,
                        const T* __restrict__ Sx, const T* __restrict__ Sy,
                        const T* __restrict__ lam, const T* __restrict__ shift,
                        T shift0, const T* __restrict__ ring,
                        const T* __restrict__ g, int64_t g_sb, int64_t g_sr, int r,
                        int c) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* M = reinterpret_cast<T*>(smem_raw);
  const int64_t s = blockIdx.x;
  clear_tile(M);
  __syncthreads();
  load_tile(M, b + s * b_sb, b_sr, r, c);
  __syncthreads();
  if (lam != nullptr) {
    sandwich(M, r, c, Sx, Sy, lam, shift != nullptr ? shift[s] : shift0);
  }
  sandwich(M, r, c, Sx, Sy, static_cast<const T*>(nullptr), T(0));
  store_state(M, r, c, out + s * o_sb, o_sr, ring, g != nullptr ? g + s * g_sb : nullptr,
              g_sr);
}

template <typename T>
int launch(const T* b, int64_t b_sb, int64_t b_sr, T* out, int64_t o_sb, int64_t o_sr,
           const T* Sx, const T* Sy, const T* lam, const T* shift, double shift0,
           const T* ring, const T* g, int64_t g_sb, int64_t g_sr, T* ws, int64_t chunk,
           int64_t B, int64_t r, int64_t c, void* stream) {
  if (B == 0) return 0;
  if (r < 1 || c < 1 || r > 0x7fffffff / c || B > 0x7fffffff) return (int)cudaErrorInvalidValue;
  if (r > kMaxN || c > kMaxN) {
    if (ws == nullptr || chunk < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    for (int64_t b0 = 0; b0 < B; b0 += chunk) {
      const int64_t nb = B - b0 < chunk ? B - b0 : chunk;
      tiled2d::Epilogue<T> div{};
      div.lam = lam;
      div.shift = shift;
      div.shift0 = (T)shift0;
      div.D = 1;
      div.b0 = b0;
      tiled2d::Epilogue<T> last{};
      last.out = out;
      last.o_hi = o_sb;
      last.o_row = o_sr;
      last.g = g;
      last.g_hi = g_sb;
      last.g_row = g_sr;
      last.off = ring != nullptr ? 1 : 0;
      last.D = 1;
      last.b0 = b0;
      cudaError_t e = tiled2d::sandwich<T>({b + b0 * b_sb, b_sb, b_sr}, (int)r, (int)c, Sx, Sy, ws,
                                           ws + chunk * r * c, nb, div, last, lam != nullptr, st);
      if (e == cudaSuccess && ring != nullptr) {
        e = tiled2d::ring<T>(ring, (int)r + 2, (int)c + 2, nb, last, st);
      }
      if (e != cudaSuccess) return (int)e;
    }
    return 0;
  }
  const size_t smem = smem_bytes<T>();
  cudaError_t e = allow_smem(sine_solve2d_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  sine_solve2d_kernel<T><<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
      b, b_sb, b_sr, out, o_sb, o_sr, Sx, Sy, lam, shift, (T)shift0, ring, g, g_sb,
      g_sr, (int)r, (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pm_sine_solve2d_f64(const double* b, int64_t b_sb, int64_t b_sr, double* out,
                        int64_t o_sb, int64_t o_sr, const double* Sx, const double* Sy,
                        const double* lam, const double* shift, double shift0,
                        const double* ring, const double* g, int64_t g_sb, int64_t g_sr,
                        double* ws, int64_t chunk, int64_t B, int64_t r, int64_t c,
                        void* stream) {
  return launch<double>(b, b_sb, b_sr, out, o_sb, o_sr, Sx, Sy, lam, shift, shift0, ring,
                        g, g_sb, g_sr, ws, chunk, B, r, c, stream);
}

int pm_sine_solve2d_f32(const float* b, int64_t b_sb, int64_t b_sr, float* out,
                        int64_t o_sb, int64_t o_sr, const float* Sx, const float* Sy,
                        const float* lam, const float* shift, double shift0,
                        const float* ring, const float* g, int64_t g_sb, int64_t g_sr,
                        float* ws, int64_t chunk, int64_t B, int64_t r, int64_t c,
                        void* stream) {
  return launch<float>(b, b_sb, b_sr, out, o_sb, o_sr, Sx, Sy, lam, shift, shift0, ring, g,
                       g_sb, g_sr, ws, chunk, B, r, c, stream);
}

}  // extern "C"
