// K5 sine_solve2d: the batched implicit solve of the physical-basis heat
// step, one (r x c) interior state b per batch entry,
//   solve:     x = Sx ((Sx b Sy) / (1 + shift_b * Lam)) Sy
//   transform: x = Sx b Sy                       (lam == nullptr)
// written into the interior of the output state, with the Dirichlet ring
// copied from a template field when ring != nullptr, and plus g when g is
// given (the coarse-level F-relaxation's  x <- g + Phi(x)).
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D._solve_interior_batched
// (:372-380) and the solve/ring part of Heat2D.step_batched (:382, the
// `.at[].set` chain of the output), the forward transform of the seeds (and
// of CN's ring correction) in the physical Heat2D.relax_interval
// (:543-610), and Heat2D.to_physical (:612) -- the batched two-sided
// spectral solve that the removed Pallas kernel computed.
//
// Bound: FP64 operations.  A solve is four (n x n) products a state, 8 n^3
// operations (16.4 MFLOP at n = 127) against 2 x 129 KB of state read and
// written: at 67 TFLOP/s on the FP64 tensor cores, B = 512 states take
// 0.125 ms, their bytes 0.040 ms.  Design:
// * float64, sides <= 128: sine2d_dmma.cuh -- one block holds its states
//   in shared memory from load to store and runs the four products on the
//   tensor cores (mma m16n8k4 f64, DMMA), the basis streamed through a
//   cp.async ring; several states a block at sides <= 64;
// * float64, wider states (toms257: n = 255): the same four right products,
//   each one launch of sine2d_dmma.cuh's band kernel over a chunk of states
//   through a workspace (16 warps a 64 x 256 block of a product, DMMA), the
//   divide after the second and g with the last in its store, the ring by
//   tiled2d.cuh's ring kernel.  (On an H100, dmma_tile.cuh's 64 x 64 tile
//   of K22 and K26 was the slower on toms257's 128 states, and above K5's
//   1 ms target: four warps a tile copy four times the operands a DMMA that
//   16 warps on a 64 x 256 block do);
// * float32: the FFMA cores of sine2d.cuh (sides <= 128) and tiled2d.cuh
//   (wider), as before: the tensor cores have no full-float32 product and
//   TF32 is not used.
// b, out and g are strided views (batch stride and row stride) of the level
// tubes, so no copy precedes or follows the kernel.  The products are the
// kernels' own: no library GEMM is called.
//
// Launch: one ctypes call with a packed int64 argument array that the
// wrapper caches with its checks (ops/heat_kernels.py::solve_pack) and
// fills with the call's pointers, the scalar shift and the stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "sine2d.cuh"
#include "sine2d_dmma.cuh"
#include "tiled2d.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(sine2d::kThreads, 1)
    sine_solve2d_kernel(const T* __restrict__ b, int64_t b_sb, int64_t b_sr,
                        T* __restrict__ out, int64_t o_sb, int64_t o_sr,
                        const T* __restrict__ Sx, const T* __restrict__ Sy,
                        const T* __restrict__ lam, const T* __restrict__ shift,
                        T shift0, const T* __restrict__ ring,
                        const T* __restrict__ g, int64_t g_sb, int64_t g_sr, int r,
                        int c) {
  using namespace sine2d;
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

// The call's operands, as the packed argument array gives them.
template <typename T>
struct Call {
  const T *b, *Sx, *Sy, *lam, *shift, *ring, *g;
  T *out, *ws;
  int64_t b_sb, b_sr, o_sb, o_sr, g_sb, g_sr, B, r, c, chunk;
  double shift0;
};

// float32 (and nothing else): the FFMA one-tile core, or tiled2d.cuh's
// 32 x 32 tiles through the workspace, a chunk of states at a time
cudaError_t ffma(const Call<float>& a, cudaStream_t st) {
  using T = float;
  if (a.r > sine2d::kMaxN || a.c > sine2d::kMaxN) {
    if (a.ws == nullptr || a.chunk < 1) return cudaErrorInvalidValue;
    for (int64_t b0 = 0; b0 < a.B; b0 += a.chunk) {
      const int64_t nb = a.B - b0 < a.chunk ? a.B - b0 : a.chunk;
      tiled2d::Epilogue<T> div{};
      div.lam = a.lam;
      div.shift = a.shift;
      div.shift0 = (T)a.shift0;
      div.D = 1;
      div.b0 = b0;
      tiled2d::Epilogue<T> last{};
      last.out = a.out;
      last.o_hi = a.o_sb;
      last.o_row = a.o_sr;
      last.g = a.g;
      last.g_hi = a.g_sb;
      last.g_row = a.g_sr;
      last.off = a.ring != nullptr ? 1 : 0;
      last.D = 1;
      last.b0 = b0;
      cudaError_t e = tiled2d::sandwich<T>({a.b + b0 * a.b_sb, a.b_sb, a.b_sr}, (int)a.r,
                                           (int)a.c, a.Sx, a.Sy, a.ws, a.ws + a.chunk * a.r * a.c,
                                           nb, div, last, a.lam != nullptr, st);
      if (e == cudaSuccess && a.ring != nullptr) {
        e = tiled2d::ring<T>(a.ring, (int)a.r + 2, (int)a.c + 2, nb, last, st);
      }
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
  // the 129 KB tile: opt in once a device
  static bool given[32] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const size_t smem = sine2d::smem_bytes<T>();
  if (dev >= 32 || !given[dev]) {
    e = sine2d::allow_smem(sine_solve2d_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    if (dev < 32) given[dev] = true;
  }
  sine_solve2d_kernel<T><<<(unsigned)a.B, sine2d::kThreads, smem, st>>>(
      a.b, a.b_sb, a.b_sr, a.out, a.o_sb, a.o_sr, a.Sx, a.Sy, a.lam, a.shift, (T)a.shift0,
      a.ring, a.g, a.g_sb, a.g_sr, (int)a.r, (int)a.c);
  return cudaGetLastError();
}

// float64 past the one-tile side on sine2d_dmma.cuh's band products: per
// chunk of nb states, with W1 (nb x c x ldr) and W0 (nb x r x ldc) the
// workspace's buffers and sx, sy its copies of the bases (even rows),
//   W1 = (X Sy)^T,  W0 = ((W1 Sx)^T) / (1 + shift Lam) = (Sx X Sy) / (..),
//   W1 = (W0 Sy)^T, out = [g +] (W1 Sx)^T = Sx W0 Sy
// (the transform: the first and the last), then the ring.
cudaError_t band_dmma(const Call<double>& a, cudaStream_t st) {
  if (a.ws == nullptr || a.chunk < 1) return cudaErrorInvalidValue;
  const int64_t r = a.r, c = a.c, ldr = r + (r & 1), ldc = c + (c & 1);
  double* sx = a.ws;                          // (r x ldr)
  double* sy = sx + r * ldr;                  // (c x ldc)
  double* w1 = sy + c * ldc;                  // chunk x (c x ldr)
  double* w0 = w1 + a.chunk * c * ldr;        // chunk x (r x ldc)
  cudaError_t e = cudaMemcpy2DAsync(sx, ldr * sizeof(double), a.Sx, r * sizeof(double),
                                    r * sizeof(double), r, cudaMemcpyDeviceToDevice, st);
  if (e == cudaSuccess)
    e = cudaMemcpy2DAsync(sy, ldc * sizeof(double), a.Sy, c * sizeof(double),
                          c * sizeof(double), c, cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  const int64_t off = a.ring != nullptr ? a.o_sr + 1 : 0;
  const int64_t goff = a.ring != nullptr ? a.g_sr + 1 : 0;
  // 16-byte copies of the states' rows where their pointer and strides allow
  const bool b16 = reinterpret_cast<uintptr_t>(a.b) % 16 == 0 && a.b_sr % 2 == 0 &&
                   a.b_sb % 2 == 0;
  // a right product of states (rows R, inner K) by a basis copy (K x N)
  auto right = [](const double* A, int64_t sb, int64_t sr, int R, int K, int ca,
                  const double* S, int64_t ld, int N) {
    sine2d_dmma::BandArgs p{};
    p.a = A;
    p.a_sb = sb;
    p.a_sr = sr;
    p.R = R;
    p.K = K;
    p.ca = ca;
    p.s = S;
    p.s_ld = ld;
    p.N = N;
    p.cs = 2;
    return p;
  };
  for (int64_t b0 = 0; b0 < a.B; b0 += a.chunk) {
    const int64_t nb = a.B - b0 < a.chunk ? a.B - b0 : a.chunk;
    sine2d_dmma::BandArgs p1 =
        right(a.b + b0 * a.b_sb, a.b_sb, a.b_sr, (int)r, (int)c, b16 ? 2 : 1, sy, ldc, (int)c);
    p1.dst = w1;
    p1.d_sb = c * ldr;
    p1.d_sr = ldr;
    e = sine2d_dmma::band(p1, nb, st);
    if (e != cudaSuccess) return e;
    if (a.lam != nullptr) {
      sine2d_dmma::BandArgs p2 = right(w1, c * ldr, ldr, (int)c, (int)r, 2, sx, ldr, (int)r);
      p2.dst = w0;
      p2.d_sb = r * ldc;
      p2.d_sr = ldc;
      p2.lam = a.lam;
      p2.lam_ld = c;
      p2.shift = a.shift != nullptr ? a.shift + b0 : nullptr;
      p2.shift0 = a.shift0;
      sine2d_dmma::BandArgs p3 = right(w0, r * ldc, ldc, (int)r, (int)c, 2, sy, ldc, (int)c);
      p3.dst = w1;
      p3.d_sb = c * ldr;
      p3.d_sr = ldr;
      e = sine2d_dmma::band(p2, nb, st);
      if (e == cudaSuccess) e = sine2d_dmma::band(p3, nb, st);
      if (e != cudaSuccess) return e;
    }
    sine2d_dmma::BandArgs p4 = right(w1, c * ldr, ldr, (int)c, (int)r, 2, sx, ldr, (int)r);
    p4.dst = a.out + b0 * a.o_sb + off;
    p4.d_sb = a.o_sb;
    p4.d_sr = a.o_sr;
    if (a.g != nullptr) {
      p4.g = a.g + b0 * a.g_sb + goff;
      p4.g_sb = a.g_sb;
      p4.g_sr = a.g_sr;
    }
    e = sine2d_dmma::band(p4, nb, st);
    if (e == cudaSuccess && a.ring != nullptr) {
      tiled2d::Epilogue<double> ring{};
      ring.out = a.out;
      ring.o_hi = a.o_sb;
      ring.o_row = a.o_sr;
      ring.g = a.g;
      ring.g_hi = a.g_sb;
      ring.g_row = a.g_sr;
      ring.D = 1;
      ring.b0 = b0;
      e = tiled2d::ring<double>(a.ring, (int)r + 2, (int)c + 2, nb, ring, st);
    }
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// float64: the DMMA one-tile core (sides <= 128), else the band products
cudaError_t dmma(const Call<double>& a, cudaStream_t st) {
  if (a.r > 128 || a.c > 128) return band_dmma(a, st);
  sine2d_dmma::Params p{};
  p.b = a.b;
  p.out = a.out;
  p.Sx = a.Sx;
  p.Sy = a.Sy;
  p.lam = a.lam;
  p.shift = a.shift;
  p.ring = a.ring;
  p.g = a.g;
  p.b_sb = a.b_sb;
  p.b_sr = a.b_sr;
  p.o_sb = a.o_sb;
  p.o_sr = a.o_sr;
  p.g_sb = a.g_sb;
  p.g_sr = a.g_sr;
  p.B = a.B;
  p.shift0 = a.shift0;
  p.r = (int)a.r;
  p.c = (int)a.c;
  // 16-byte copies of a basis's rows where its side is even and its
  // pointer 16-byte aligned
  p.cx = a.r % 2 == 0 && reinterpret_cast<uintptr_t>(a.Sx) % 16 == 0 ? 2 : 1;
  p.cy = a.c % 2 == 0 && reinterpret_cast<uintptr_t>(a.Sy) % 16 == 0 ? 2 : 1;
  return sine2d_dmma::solve(p, st);
}

// args (int64): CUDA device, then the pointers b, out, Sx, Sy, lam, ring,
// g, shift, workspace (0: none), b's, out's and g's batch and row strides,
// B, r, c, the workspace's chunk of states (ops/heat_kernels.py::solve_pack)
template <typename T>
int launch(const int64_t* g, double shift0, void* stream) {
  Call<T> a{};
  a.b = reinterpret_cast<const T*>(g[1]);
  a.out = reinterpret_cast<T*>(g[2]);
  a.Sx = reinterpret_cast<const T*>(g[3]);
  a.Sy = reinterpret_cast<const T*>(g[4]);
  a.lam = reinterpret_cast<const T*>(g[5]);
  a.ring = reinterpret_cast<const T*>(g[6]);
  a.g = reinterpret_cast<const T*>(g[7]);
  a.shift = reinterpret_cast<const T*>(g[8]);
  a.ws = reinterpret_cast<T*>(g[9]);
  a.b_sb = g[10];
  a.b_sr = g[11];
  a.o_sb = g[12];
  a.o_sr = g[13];
  a.g_sb = g[14];
  a.g_sr = g[15];
  a.B = g[16];
  a.r = g[17];
  a.c = g[18];
  a.chunk = g[19];
  a.shift0 = shift0;
  if (a.B == 0) return 0;
  if (a.r < 1 || a.c < 1 || a.r > 0x7fffffff / a.c || a.B > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)g[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if constexpr (sizeof(T) == 8)
    e = dmma(a, st);
  else
    e = ffma(a, st);
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_sine_solve2d_f64(const int64_t* args, double shift0, void* stream) {
  return launch<double>(args, shift0, stream);
}

int pm_sine_solve2d_f32(const int64_t* args, double shift0, void* stream) {
  return launch<float>(args, shift0, stream);
}

}  // extern "C"
