// K7 theta_rhs2d: the stencil pass of one physical theta-step of B states
// of P x Q points (the Dirichlet ring included), three modes:
//   0 BE:  out = u_int + dt r1 + shift lift                        (P-2 x Q-2)
//   1 CN:  out = (u_int - shift (L u)_int) + dt (theta r1 + (1 - theta) r0)
//                + shift lift                                      (P-2 x Q-2)
//   2 FE:  out = ring + u - dt L u, + dt r0 inside              (P x Q)
// with shift = theta dt, L the 5-point operator
//   (L u)_ij = 2 (fx + fy) u_ij - fy u_i,j-1 - fy u_i,j+1 - fx u_i-1,j - fx u_i+1,j
// on the interior (0 on the ring in FE), plus g where given (FE).
//
// Replaces: pymgrit_tpu/models/heat_2d.py Heat2D.step_batched (:382-410):
// the right-hand side of the implicit solve (BE, CN) and FE's whole
// explicit step with the reference's `ring + u` on the boundary.  The
// operations are the plain version's (ops/theta_rhs.py theta_rhs2d_plain),
// in its order, each rounded once (__dmul_rn, __dadd_rn, __dsub_rn and
// their float32 forms: no FMA contraction), so the kernel equals it bit
// for bit; the scalars (dt, theta, fx, fy) come by value as doubles, and
// the products of scalars the plain version forms in Python (theta dt,
// 1 - theta, 2 (fx + fy)) are formed in double here too, then rounded to
// the working type.  With a dt tensor, shift = dt_b * theta in the working
// type, as the plain version's tensor product.
//
// Bound: bytes.  BE reads u's interior, one rhs row and the lift and
// writes the interior: at the main path's 512 states of 129^2, 134 MB,
// 0.040 ms at 3.35 TB/s.  At the solve's coarse levels (B = 32, 8, 2) a
// call moves a few MB and what it costs is the launch's host time.
// Design:
// * one ctypes call: a packed int64 argument array the wrapper caches
//   with its checks (ops/theta_rhs.py), the four scalars, the stream;
// * one block a band of kRows = 2 rows of one state, a thread a column
//   (neighbouring threads on neighbouring addresses, so each warp's loads
//   and stores of a row are coalesced); a thread loads every value of its
//   column of the band into registers first, then combines and stores
//   them.  (Tried on an H100, device ms at B = 512: a walk of 16 rows, a
//   row's loads at a time, BE 0.0612 (1.5x its bound), and 0.0112 at
//   B = 32; bands of 1, 2, 4, 8, 16 rows loaded first: BE 0.0535, 0.0498,
//   0.0500, 0.0505, 0.0531, CN 0.0632, 0.0544, 0.0536, 0.0604, 0.1126, FE
//   0.0885, 0.0932, 0.1236, 0.1936, 0.3344);
// * CN (and FE) read the column's u rows once a band, plus one halo row
//   each side, and the west and east neighbours of each row, lines the
//   warp has just loaded, through L1; so each u element comes from device
//   memory about once;
// * the interior starts one element past the row start (and a row of odd
//   Q shifts the next row's alignment), so no 16-byte vector load is
//   aligned: the loads are 8-byte (4-byte) scalars, coalesced across the
//   warp, and the sectors they touch are the row's.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 2;           // rows a block covers (a band)
constexpr int kMaxThreads = 256;   // columns a block covers at once

__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
struct Args {
  const T *u, *r1, *r0, *lift, *ring, *g, *dt;
  T* out;
  int64_t u_sb, u_sr, o_sb, o_sr, r_sb, g_sb, g_sr;
  int B, P, Q, bands;
  // the scalars in the working type: dt (without a dt tensor), theta dt,
  // theta, 1 - theta, 2 (fx + fy), fx, fy
  T dt0, shift0, theta, omt, c2, fx, fy;
};

// (L u) at a point from its centre c and neighbours west, east, north,
// south, in the plain version's order
template <typename T>
__device__ __forceinline__ T stencil(const Args<T>& a, T c, T w, T e, T n, T s) {
  return sub(sub(sub(sub(mul(a.c2, c), mul(a.fy, w)), mul(a.fy, e)), mul(a.fx, n)), mul(a.fx, s));
}

// A thread's column of the band: every value it reads is loaded first (the
// band's rows of each operand, in registers), then combined and stored.
template <typename T, int MODE>
__global__ void __launch_bounds__(kMaxThreads) theta_rhs2d_kernel(const Args<T> a) {
  const int64_t b = blockIdx.x / a.bands;
  const int band = (int)(blockIdx.x - b * a.bands);
  const int rows = MODE == 2 ? a.P : a.P - 2;
  const int cols = MODE == 2 ? a.Q : a.Q - 2;
  const int i0 = band * kRows;
  const int n = rows - i0 < kRows ? rows - i0 : kRows;     // rows of this band
  T d = a.dt0, shift = a.shift0;
  if (a.dt != nullptr) {
    d = a.dt[b];
    shift = mul(d, a.theta);
  }
  const T* __restrict__ u = a.u + b * a.u_sb;
  const T* __restrict__ r1 = a.r1 + b * a.r_sb;
  const T* __restrict__ r0 = a.r0 + b * a.r_sb;
  const T* __restrict__ g = a.g != nullptr ? a.g + b * a.g_sb : nullptr;
  T* __restrict__ o = a.out + b * a.o_sb;
  const int64_t us = a.u_sr;
  for (int col = threadIdx.x; col < cols; col += blockDim.x) {
    if constexpr (MODE == 0) {
      T uc[kRows], rv[kRows], lv[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < n) {
          const int64_t i = i0 + k, f = i * cols + col;
          uc[k] = u[(i + 1) * us + col + 1];
          rv[k] = r1[f];
          lv[k] = a.lift[f];
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < n) {
          const int64_t i = i0 + k;
          T v = add(add(uc[k], mul(d, rv[k])), mul(shift, lv[k]));
          if (g != nullptr) v = add(g[i * a.g_sr + col], v);
          o[i * a.o_sr + col] = v;
        }
      }
    } else if constexpr (MODE == 1) {
      // the column's u rows i0 .. i0 + n + 1 (interior rows i0 .. i0 + n - 1
      // and one halo row each side), each row's west and east neighbours
      T uc[kRows + 2], uw[kRows], ue[kRows], rv1[kRows], rv0[kRows], lv[kRows];
      const T* __restrict__ ucol = u + i0 * us + col + 1;
#pragma unroll
      for (int k = 0; k < kRows + 2; ++k)
        if (k < n + 2) uc[k] = ucol[k * us];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < n) {
          const int64_t f = (int64_t)(i0 + k) * cols + col;
          uw[k] = ucol[(k + 1) * us - 1];
          ue[k] = ucol[(k + 1) * us + 1];
          rv1[k] = r1[f];
          rv0[k] = r0[f];
          lv[k] = a.lift[f];
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (k < n) {
          const int64_t i = i0 + k;
          const T lu = stencil(a, uc[k + 1], uw[k], ue[k], uc[k], uc[k + 2]);
          T v = add(add(sub(uc[k + 1], mul(shift, lu)),
                        mul(d, add(mul(a.theta, rv1[k]), mul(a.omt, rv0[k])))),
                    mul(shift, lv[k]));
          if (g != nullptr) v = add(g[i * a.g_sr + col], v);
          o[i * a.o_sr + col] = v;
        }
      }
    } else {
      // FE: the whole state; the ring's points keep ring + u
      T uc[kRows + 2], uw[kRows], ue[kRows], rg[kRows], rv0[kRows];
      const bool inner_col = col > 0 && col < cols - 1;
      const T* __restrict__ ucol = u + col;
#pragma unroll
      for (int k = 0; k < kRows + 2; ++k) {
        const int i = i0 + k - 1;
        if (k < n + 2 && i >= 0 && i < rows) uc[k] = ucol[i * us];
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k;
        if (k < n) {
          rg[k] = a.ring[(int64_t)i * cols + col];
          if (inner_col && i > 0 && i < rows - 1) {
            uw[k] = ucol[i * us - 1];
            ue[k] = ucol[i * us + 1];
            rv0[k] = r0[(int64_t)(i - 1) * (cols - 2) + col - 1];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int i = i0 + k;
        if (k < n) {
          T v = add(rg[k], uc[k + 1]);
          if (inner_col && i > 0 && i < rows - 1) {
            const T lu = stencil(a, uc[k + 1], uw[k], ue[k], uc[k], uc[k + 2]);
            v = add(sub(v, mul(d, lu)), mul(d, rv0[k]));
          }
          if (g != nullptr) v = add(g[i * a.g_sr + col], v);
          o[i * a.o_sr + col] = v;
        }
      }
    }
  }
}

// args (int64): CUDA device, then the pointers u, out, r1, r0, lift, ring,
// g, dt (0: none), u's batch and row strides, out's, the rhs rows' batch
// stride, g's batch and row strides, B, P, Q, the mode (0 BE, 1 CN, 2 FE)
// (ops/theta_rhs.py::pack)
template <typename T>
int launch(const int64_t* g, double dt, double theta, double fx, double fy, void* stream) {
  Args<T> a{};
  a.u = reinterpret_cast<const T*>(g[1]);
  a.out = reinterpret_cast<T*>(g[2]);
  a.r1 = reinterpret_cast<const T*>(g[3]);
  a.r0 = reinterpret_cast<const T*>(g[4]);
  a.lift = reinterpret_cast<const T*>(g[5]);
  a.ring = reinterpret_cast<const T*>(g[6]);
  a.g = reinterpret_cast<const T*>(g[7]);
  a.dt = reinterpret_cast<const T*>(g[8]);
  a.u_sb = g[9];
  a.u_sr = g[10];
  a.o_sb = g[11];
  a.o_sr = g[12];
  a.r_sb = g[13];
  a.g_sb = g[14];
  a.g_sr = g[15];
  const int64_t B = g[16], P = g[17], Q = g[18], mode = g[19];
  if (B == 0) return 0;
  if (P < 3 || Q < 3 || B > 0x7fffffff || P * Q > 0x7fffffff || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  a.B = (int)B;
  a.P = (int)P;
  a.Q = (int)Q;
  const int64_t rows = mode == 2 ? P : P - 2, cols = mode == 2 ? Q : Q - 2;
  a.bands = (int)((rows + kRows - 1) / kRows);
  if (B * a.bands > 0x7fffffff) return (int)cudaErrorInvalidValue;
  // the plain version's Python products of scalars, in double
  a.dt0 = (T)dt;
  a.shift0 = (T)(dt * theta);
  a.theta = (T)theta;
  a.omt = (T)(1.0 - theta);
  a.c2 = (T)(2.0 * (fx + fy));
  a.fx = (T)fx;
  a.fy = (T)fy;
  const int threads = cols >= kMaxThreads ? kMaxThreads : (int)((cols + 31) / 32 * 32);
  const unsigned blocks = (unsigned)(B * a.bands);
  int current = 0;
  cudaGetDevice(&current);
  const int device = (int)g[0];
  if (device != current) cudaSetDevice(device);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0)
    theta_rhs2d_kernel<T, 0><<<blocks, threads, 0, st>>>(a);
  else if (mode == 1)
    theta_rhs2d_kernel<T, 1><<<blocks, threads, 0, st>>>(a);
  else
    theta_rhs2d_kernel<T, 2><<<blocks, threads, 0, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (device != current) cudaSetDevice(current);
  return (int)e;
}

}  // namespace

extern "C" {

int pm_theta_rhs2d_f64(const int64_t* args, double dt, double theta, double fx, double fy,
                       void* stream) {
  return launch<double>(args, dt, theta, fx, fy, stream);
}

int pm_theta_rhs2d_f32(const int64_t* args, double dt, double theta, double fx, double fy,
                       void* stream) {
  return launch<float>(args, dt, theta, fx, fy, stream);
}

}  // extern "C"
