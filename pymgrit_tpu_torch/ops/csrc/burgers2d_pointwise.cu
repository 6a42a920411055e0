// K15 burgers2d_pointwise: one fused stencil pass over B periodic 2D
// Burgers velocity fields s = (u, v) of n x n, two modes:
//   0 residual:  out = (s - r) + dt (C(s) - nu L s), and gmax[b] = max |out_b|
//                over both components
//   1 jacobian:  out = w + dt (C'(s) w - nu L w)
// with the convection C(s) = (u Dx u + v Dy u, u Dx v + v Dy v), its
// linearisation
//   C'(s) w = (((u Dx wu + wu Dx u) + v Dy wu) + wv Dy u, and likewise for v),
// the central differences (Dx x)_ij = (x_i+1,j - x_i-1,j) / (2 dx) and
// (Dy x)_ij = (x_i,j+1 - x_i,j-1) / (2 dx), dt one value a lane, and L the
// periodic 5-point Laplacian of each component
//   (L x)_ij = ((((x_i-1,j + x_i+1,j) + x_i,j-1) + x_i,j+1) - 4 x_ij) / dx^2.
// Both modes also take a space shard's slab of R rows of each component
// and the halo rows (the rows above and below the slab, from the
// neighbouring shards; (B, 2, n) each) of s, and in the Jacobian of w too
// (its convection differences s as well as w in x): the halo mode, which
// wraps in y only and writes the slab's R rows (K11's design).
//
// Replaces: pymgrit_tpu/models/burgers.py Burgers2D._ddx, _ddy, _lap, _conv
// and the step's g_of and jac_mv (:102-132) (on a slab: the partitions of
// them GSPMD makes).  The operations are the plain
// version's (ops/pointwise.py burgers2d_pointwise_plain, _ddx, _ddy and
// periodic_lap_plain), in its order, each rounded once
// (csrc/periodic_pointwise.cuh: no FMA contraction, and true divisions by
// 2 dx and dx^2, as JAX divides), so the kernel equals the plain version
// bit for bit in float64 and float32, NaN included.  The scalars nu, 2 dx
// and dx^2 come by value as doubles and are rounded to the working type,
// as PyTorch rounds a Python scalar.
//
// Residual mode: one launch returns both g and its per-lane max over both
// components (periodic_pointwise.cuh lane_max: exact and NaN-propagating,
// through a workspace of two 64-bit words a lane that the kernel leaves
// zeroed; ops/pointwise.py _workspace).
//
// Bound: bytes.  The Jacobian at the Newton-BiCGStab lanes (B = 4 fields of
// 64^2) reads s and w and writes out: 0.79 MB, 0.0002 ms at 3.35 TB/s; what
// a call costs there is the launch's host time.  Design (K11's, both
// components a thread):
// * one ctypes call: a packed int64 argument array the wrapper caches with
//   its checks (ops/pointwise.py), nu, 2 dx and dx^2, the stream;
// * a block of TX x TY threads covers TY rows of one lane at a time (a
//   unit), a thread V consecutive columns of its row in both components
//   (the convection couples them at a point): 16-byte vectors (V = 2 in
//   float64, 4 in float32) where the side, the strides and the pointers
//   allow, else V = 1; s (and w in the Jacobian) with their neighbours as
//   periodic_pointwise.cuh's Cross;
// * the grid is sized to the card (blocks an SM times the SMs, at most one
//   block a unit): at B = 4, n = 64 in float64, 32 blocks of 8 rows.

#include "periodic_pointwise.cuh"

namespace {

using namespace pm_pointwise;

template <typename T>
struct Args {
  const T *s, *w, *r, *dt;
  // halo mode: (B, 2, n) rows above and below the slab of s (and w); else null
  const T *s_above, *s_below, *w_above, *w_below;
  T *out, *gmax;
  unsigned long long* ws;     // residual: B max slots, then B counters
  // batch, species and row strides
  int64_t s_sb, s_ss, s_sr, w_sb, w_ss, w_sr, r_sb, r_ss, r_sr, o_sb, o_ss, o_sr;
  Walk walk;                  // B lanes of R rows
  int n;                      // columns
  T nu, two_dx, dx2;          // the scalars in the working type
};

// the rows of a (B, 2, n) halo (null: none) of lane b's species p
template <typename T>
__device__ __forceinline__ const T* halo_row(const T* h, int64_t b, int p, int n) {
  return h != nullptr ? h + (2 * b + p) * n : nullptr;
}

// the central differences at point k: (x_i+1,j - x_i-1,j) / (2 dx) and
// (x_i,j+1 - x_i,j-1) / (2 dx)
template <typename T, int V>
__device__ __forceinline__ T ddx(const Cross<T, V>& x, int k, T two_dx) {
  return dvd(sub(x.s[k], x.n[k]), two_dx);
}

template <typename T, int V>
__device__ __forceinline__ T ddy(const Cross<T, V>& x, int k, T two_dx) {
  return dvd(sub(x.east(k), x.west(k)), two_dx);
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads) burgers2d_pointwise_kernel(const Args<T> a) {
  const int n = a.n, R = a.walk.n;
  const T h = a.two_dx;
  T m = T(0);   // the residual's max |g| over this thread's points since a fold
  walk_units(
      a.walk,
      [&](int64_t b, int i) {
        const T d = a.dt[b];
        const T* __restrict__ su = a.s + b * a.s_sb;
        T* __restrict__ ou = a.out + b * a.o_sb + i * a.o_sr;
        const Nbr<T> su_rows = nbr(su, a.s_sr, i, R, halo_row(a.s_above, b, 0, n),
                                   halo_row(a.s_below, b, 0, n));
        const Nbr<T> sv_rows = nbr(su + a.s_ss, a.s_sr, i, R, halo_row(a.s_above, b, 1, n),
                                   halo_row(a.s_below, b, 1, n));
        for (int j = (int)threadIdx.x * V; j < n; j += (int)blockDim.x * V) {
          Cross<T, V> xu, xv;
          T uo[V], vo[V];
          xu.load_at(su_rows, n, j);
          xv.load_at(sv_rows, n, j);
          if constexpr (MODE == 0) {
            T pu[V], pv[V];
            const T* rp = a.r + b * a.r_sb + i * a.r_sr + j;
            load<T, V>(pu, rp);
            load<T, V>(pv, rp + a.r_ss);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const T u = xu.c[k], v = xv.c[k];
              const T cu = add(mul(u, ddx(xu, k, h)), mul(v, ddy(xu, k, h)));
              const T cv = add(mul(u, ddx(xv, k, h)), mul(v, ddy(xv, k, h)));
              uo[k] = add(sub(u, pu[k]), mul(d, sub(cu, mul(a.nu, lap(xu, k, a.dx2)))));
              vo[k] = add(sub(v, pv[k]), mul(d, sub(cv, mul(a.nu, lap(xv, k, a.dx2)))));
              m = nanmax(nanmax(m, fabs(uo[k])), fabs(vo[k]));   // sign bits cleared
            }
          } else {
            const T* __restrict__ wp = a.w + b * a.w_sb;
            Cross<T, V> yu, yv;
            yu.load_at(nbr(wp, a.w_sr, i, R, halo_row(a.w_above, b, 0, n),
                           halo_row(a.w_below, b, 0, n)), n, j);
            yv.load_at(nbr(wp + a.w_ss, a.w_sr, i, R, halo_row(a.w_above, b, 1, n),
                           halo_row(a.w_below, b, 1, n)), n, j);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const T u = xu.c[k], v = xv.c[k], wu = yu.c[k], wv = yv.c[k];
              const T cu = add(add(add(mul(u, ddx(yu, k, h)), mul(wu, ddx(xu, k, h))),
                                   mul(v, ddy(yu, k, h))),
                               mul(wv, ddy(xu, k, h)));
              const T cv = add(add(add(mul(u, ddx(yv, k, h)), mul(wu, ddx(xv, k, h))),
                                   mul(v, ddy(yv, k, h))),
                               mul(wv, ddy(xv, k, h)));
              uo[k] = add(wu, mul(d, sub(cu, mul(a.nu, lap(yu, k, a.dx2)))));
              vo[k] = add(wv, mul(d, sub(cv, mul(a.nu, lap(yv, k, a.dx2)))));
            }
          }
          store<T, V>(ou + j, uo);
          store<T, V>(ou + a.o_ss + j, vo);
        }
      },
      [&](int64_t b, int k) {
        if constexpr (MODE == 0) {
          lane_max(m, b, k, a.walk, a.ws, a.gmax);
          m = T(0);
        }
      });
}

template <typename T, int MODE>
cudaError_t run(const Args<T>& a, int vec, dim3 block, unsigned grid, cudaStream_t st) {
  if (vec > 1)
    burgers2d_pointwise_kernel<T, MODE, 16 / sizeof(T)><<<grid, block, 0, st>>>(a);
  else
    burgers2d_pointwise_kernel<T, MODE, 1><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

// args (int64): K14's layout (ops/pointwise.py pair_pack): CUDA device,
// then the pointers s, w, r, g (unused: 0), dt, out, gmax, workspace (0:
// none), the batch, species and row strides of s, w, r, g (0) and out, B,
// n (columns), the mode (0 residual, 1 jacobian), then the plan: the
// vector width (1, or 16 bytes), TX, TY, units a block, grid; then R (the
// rows of a state: n, or a slab's), the halo rows' pointers of s above
// and below and of w above and below (0: none, the periodic wrap)
template <typename T>
int launch(const int64_t* g, double nu, double two_dx, double dx2, void* stream) {
  Args<T> a{};
  a.s = reinterpret_cast<const T*>(g[1]);
  a.w = reinterpret_cast<const T*>(g[2]);
  a.r = reinterpret_cast<const T*>(g[3]);
  a.dt = reinterpret_cast<const T*>(g[5]);
  a.out = reinterpret_cast<T*>(g[6]);
  a.gmax = reinterpret_cast<T*>(g[7]);
  a.ws = reinterpret_cast<unsigned long long*>(g[8]);
  a.s_sb = g[9];
  a.s_ss = g[10];
  a.s_sr = g[11];
  a.w_sb = g[12];
  a.w_ss = g[13];
  a.w_sr = g[14];
  a.r_sb = g[15];
  a.r_ss = g[16];
  a.r_sr = g[17];
  a.o_sb = g[21];
  a.o_ss = g[22];
  a.o_sr = g[23];
  const int64_t B = g[24], n = g[25], mode = g[26];
  int64_t vec = g[27];
  const int64_t tx = g[28], ty = g[29], per = g[30], grid = g[31], R = g[32];
  a.s_above = reinterpret_cast<const T*>(g[33]);
  a.s_below = reinterpret_cast<const T*>(g[34]);
  a.w_above = reinterpret_cast<const T*>(g[35]);
  a.w_below = reinterpret_cast<const T*>(g[36]);
  if (B == 0 || n == 0 || R == 0) return 0;
  const bool halo = a.s_above != nullptr;
  const bool w_halo = mode == 1 && halo;
  if (!walk_of(a.walk, B, R, tx, ty, per, grid) || n > 0x3fffffff || mode < 0 || mode > 1 ||
      (mode == 0 && (a.ws == nullptr || a.gmax == nullptr || a.r == nullptr)) ||
      (mode == 1 && a.w == nullptr) || (halo != (a.s_below != nullptr)) ||
      (w_halo != (a.w_above != nullptr && a.w_below != nullptr)) ||
      (!w_halo && (a.w_above != nullptr || a.w_below != nullptr)) || (!halo && R != n))
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors only where every row the call reads or writes starts
  // on 16 bytes (the plan checked the side and the strides)
  if (vec > 1 && !aligned16({a.s, a.out, mode == 1 ? a.w : nullptr, mode == 0 ? a.r : nullptr,
                             a.s_above, a.s_below, a.w_above, a.w_below}))
    vec = 1;
  a.n = (int)n;
  a.nu = (T)nu;
  a.two_dx = (T)two_dx;
  a.dx2 = (T)dx2;
  const OnDevice on((int)g[0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block((unsigned)tx, (unsigned)ty);
  if (mode == 0) return (int)run<T, 0>(a, (int)vec, block, (unsigned)grid, st);
  return (int)run<T, 1>(a, (int)vec, block, (unsigned)grid, st);
}

}  // namespace

extern "C" {

int pm_burgers2d_pointwise_f64(const int64_t* args, double nu, double two_dx, double dx2,
                               void* stream) {
  return launch<double>(args, nu, two_dx, dx2, stream);
}

int pm_burgers2d_pointwise_f32(const int64_t* args, double nu, double two_dx, double dx2,
                               void* stream) {
  return launch<float>(args, nu, two_dx, dx2, stream);
}

}  // extern "C"
