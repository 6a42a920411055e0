// K14 gray_scott_pointwise: one fused stencil and reaction pass over B
// periodic Gray-Scott pairs s = (u, v) of n x n, three modes:
//   0 expl:      out = s + dt (D L s + R(s)) [+ g: out = g + that]   (EXPL step)
//   1 residual:  out = (s - dt (D L s + R(s))) - r, and gmax[b] = max |out_b|
//                over both species
//   2 jacobian:  out = w - dt (D L w + R'(s) w)
// with D = diag(du, dv), R(u, v) = (-u v^2 + a (1 - u), u v^2 - b v), its
// Jacobian R'(s) = [[-v^2 - a, -2 u v], [v^2, 2 u v - b]], dt one value a
// lane, and L the periodic 5-point Laplacian of each species
//   (L x)_ij = ((((x_i-1,j + x_i+1,j) + x_i,j-1) + x_i,j+1) - 4 x_ij) / dx^2.
//
// Replaces: pymgrit_tpu/models/gray_scott_2d.py GrayScott2D._lap,
// _reaction, _diffuse, the EXPL step and the residual and Jacobian matvec
// of _newton (:71-114).  The operations are the plain version's
// (ops/pointwise.py gray_scott_pointwise_plain and periodic_lap_plain), in
// its order, each rounded once (csrc/periodic_pointwise.cuh: no FMA
// contraction, and a true division by dx^2), so the kernel equals the plain
// version bit for bit in float64 and float32, NaN included.  The scalars
// du, dv, a, b and dx^2 come by value as doubles and are rounded to the
// working type, as PyTorch rounds a Python scalar.
//
// Residual mode: one launch returns both g and its per-lane max over both
// species (periodic_pointwise.cuh lane_max: exact and NaN-propagating,
// through a workspace of two 64-bit words a lane that the kernel leaves
// zeroed; ops/pointwise.py _workspace).
//
// Bound: bytes.  The Jacobian at the Newton-BiCGStab lanes (B = 8 pairs of
// 128^2) reads s and w and writes out: 6.3 MB, 0.0019 ms at 3.35 TB/s;
// what a call costs there is the launch's host time.  An EXPL step of the
// level-0 F-relaxation (128 pairs + g) moves 100 MB (0.030 ms), where the
// bandwidth sets the time.  Design (K11's, both species a thread):
// * one ctypes call: a packed int64 argument array the wrapper caches with
//   its checks (ops/pointwise.py), the five scalars, the stream;
// * a block of TX x TY threads covers TY rows of one lane at a time (a
//   unit), a thread V consecutive columns of its row in both species (the
//   reaction couples them at a point): 16-byte vectors (V = 2 in float64,
//   4 in float32) where the side, the strides and the pointers allow,
//   else V = 1; the Laplacian's operand (s, or w in the Jacobian) with its
//   neighbours as periodic_pointwise.cuh's Cross, s only at the centre in
//   the Jacobian;
// * the grid is sized to the card (blocks an SM times the SMs, at most one
//   block a unit); a block walks consecutive units (a whole lane of 17
//   rows where 1024 lanes fill the grid three times over), folding each of
//   its lanes' maxima once.

#include "periodic_pointwise.cuh"

namespace {

using namespace pm_pointwise;

template <typename T>
struct Args {
  const T *s, *w, *r, *g, *dt;
  T *out, *gmax;
  unsigned long long* ws;     // residual: B max slots, then B counters
  // batch, species and row strides
  int64_t s_sb, s_ss, s_sr, w_sb, w_ss, w_sr, r_sb, r_ss, r_sr, g_sb, g_ss, g_sr, o_sb, o_ss,
      o_sr;
  Walk walk;
  T du, dv, a, b, dx2;        // the scalars in the working type
};

template <typename T, int MODE, bool G, int V>
__global__ void __launch_bounds__(kThreads) gray_scott_pointwise_kernel(const Args<T> a) {
  const int n = a.walk.n;
  T m = T(0);   // the residual's max |g| over this thread's points since a fold
  walk_units(
      a.walk,
      [&](int64_t b, int i) {
        const Rows rw = rows(n, i);
        const T d = a.dt[b];
        const T* __restrict__ su = a.s + b * a.s_sb;
        T* __restrict__ ou = a.out + b * a.o_sb + i * a.o_sr;
        for (int j = (int)threadIdx.x * V; j < n; j += (int)blockDim.x * V) {
          T uo[V], vo[V];
          if constexpr (MODE == 2) {
            const T* __restrict__ wu = a.w + b * a.w_sb;
            Cross<T, V> xu, xv;
            T u[V], v[V];
            xu.load_at(wu, a.w_sr, rw, j);
            xv.load_at(wu + a.w_ss, a.w_sr, rw, j);
            load<T, V>(u, su + i * a.s_sr + j);
            load<T, V>(v, su + a.s_ss + i * a.s_sr + j);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const T vv = mul(v[k], v[k]);
              const T ru = add(mul(sub(-vv, a.a), xu.c[k]),
                               mul(mul(mul(T(-2), u[k]), v[k]), xv.c[k]));
              const T rv = add(mul(vv, xu.c[k]),
                               mul(sub(mul(mul(T(2), u[k]), v[k]), a.b), xv.c[k]));
              uo[k] = sub(xu.c[k], mul(d, add(mul(a.du, lap(xu, k, a.dx2)), ru)));
              vo[k] = sub(xv.c[k], mul(d, add(mul(a.dv, lap(xv, k, a.dx2)), rv)));
            }
          } else {
            Cross<T, V> xu, xv;
            T pu[V], pv[V];   // r (residual) or g (EXPL + g), both species
            xu.load_at(su, a.s_sr, rw, j);
            xv.load_at(su + a.s_ss, a.s_sr, rw, j);
            if constexpr (MODE == 1) {
              const T* rp = a.r + b * a.r_sb + i * a.r_sr + j;
              load<T, V>(pu, rp);
              load<T, V>(pv, rp + a.r_ss);
            } else if constexpr (G) {
              const T* gp = a.g + b * a.g_sb + i * a.g_sr + j;
              load<T, V>(pu, gp);
              load<T, V>(pv, gp + a.g_ss);
            }
#pragma unroll
            for (int k = 0; k < V; ++k) {
              const T u = xu.c[k], v = xv.c[k];
              const T uv2 = mul(u, mul(v, v));
              const T fu =
                  add(mul(a.du, lap(xu, k, a.dx2)), add(-uv2, mul(a.a, sub(T(1), u))));
              const T fv = add(mul(a.dv, lap(xv, k, a.dx2)), sub(uv2, mul(a.b, v)));
              if constexpr (MODE == 0) {
                uo[k] = add(u, mul(d, fu));
                vo[k] = add(v, mul(d, fv));
                if constexpr (G) {
                  uo[k] = add(pu[k], uo[k]);
                  vo[k] = add(pv[k], vo[k]);
                }
              } else {
                uo[k] = sub(sub(u, mul(d, fu)), pu[k]);
                vo[k] = sub(sub(v, mul(d, fv)), pv[k]);
                m = nanmax(nanmax(m, fabs(uo[k])), fabs(vo[k]));   // sign bits cleared
              }
            }
          }
          store<T, V>(ou + j, uo);
          store<T, V>(ou + a.o_ss + j, vo);
        }
      },
      [&](int64_t b, int k) {
        if constexpr (MODE == 1) {
          lane_max(m, b, k, a.walk, a.ws, a.gmax);
          m = T(0);
        }
      });
}

template <typename T, int MODE, bool G>
cudaError_t run(const Args<T>& a, int vec, dim3 block, unsigned grid, cudaStream_t st) {
  if (vec > 1)
    gray_scott_pointwise_kernel<T, MODE, G, 16 / sizeof(T)><<<grid, block, 0, st>>>(a);
  else
    gray_scott_pointwise_kernel<T, MODE, G, 1><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

// args (int64): CUDA device, then the pointers s, w, r, g, dt, out, gmax,
// workspace (0: none; g given only to an EXPL step that adds it), the
// batch, species and row strides of s, w, r, g and out, B, n, the mode (0
// expl, 1 residual, 2 jacobian), then the plan: the vector width (1, or
// 16 bytes), TX, TY, units a block, grid (ops/pointwise.py pair_pack)
template <typename T>
int launch(const int64_t* g, double du, double dv, double ra, double rb, double dx2,
           void* stream) {
  Args<T> a{};
  a.s = reinterpret_cast<const T*>(g[1]);
  a.w = reinterpret_cast<const T*>(g[2]);
  a.r = reinterpret_cast<const T*>(g[3]);
  a.g = reinterpret_cast<const T*>(g[4]);
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
  a.g_sb = g[18];
  a.g_ss = g[19];
  a.g_sr = g[20];
  a.o_sb = g[21];
  a.o_ss = g[22];
  a.o_sr = g[23];
  const int64_t B = g[24], n = g[25], mode = g[26];
  int64_t vec = g[27];
  const int64_t tx = g[28], ty = g[29], per = g[30], grid = g[31];
  if (B == 0 || n == 0) return 0;
  const bool has_g = mode == 0 && a.g != nullptr;
  if (!walk_of(a.walk, B, n, tx, ty, per, grid) || mode < 0 || mode > 2 ||
      (mode == 1 && (a.ws == nullptr || a.gmax == nullptr || a.r == nullptr)) ||
      (mode == 2 && a.w == nullptr))
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors only where every row the call reads or writes starts
  // on 16 bytes (the plan checked the side and the strides)
  if (vec > 1 && !aligned16({a.s, a.out, mode == 2 ? a.w : nullptr, mode == 1 ? a.r : nullptr,
                             has_g ? a.g : nullptr}))
    vec = 1;
  a.du = (T)du;
  a.dv = (T)dv;
  a.a = (T)ra;
  a.b = (T)rb;
  a.dx2 = (T)dx2;
  const OnDevice on((int)g[0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block((unsigned)tx, (unsigned)ty);
  if (mode == 0 && has_g) return (int)run<T, 0, true>(a, (int)vec, block, (unsigned)grid, st);
  if (mode == 0) return (int)run<T, 0, false>(a, (int)vec, block, (unsigned)grid, st);
  if (mode == 1) return (int)run<T, 1, false>(a, (int)vec, block, (unsigned)grid, st);
  return (int)run<T, 2, false>(a, (int)vec, block, (unsigned)grid, st);
}

}  // namespace

extern "C" {

int pm_gray_scott_pointwise_f64(const int64_t* args, double du, double dv, double a, double b,
                                double dx2, void* stream) {
  return launch<double>(args, du, dv, a, b, dx2, stream);
}

int pm_gray_scott_pointwise_f32(const int64_t* args, double du, double dv, double a, double b,
                                double dx2, void* stream) {
  return launch<float>(args, du, dv, a, b, dx2, stream);
}

}  // extern "C"
