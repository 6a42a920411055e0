// K11 allen_cahn_pointwise: one fused stencil and reaction pass over B
// periodic n x n states of the Allen-Cahn equation, four modes:
//   0 rhs:       out = u + fac (L u + f(u))                  (CN right-hand side)
//   1 residual:  out = (u - fac (L u + f(u))) - rhs, and gmax[b] = max |out_b|
//   2 jacobian:  out = x - fac (L x + (inv_eps2 (1 - (nu + 1) u^nu)) x)
//   3 prologue:  out = u + fac f(u)                   (the IMEX right-hand side)
// with f(u) = (inv_eps2 u)(1 - u^nu), fac one value a state, and L the
// periodic 5-point Laplacian
//   (L x)_ij = ((((x_i-1,j + x_i+1,j) + x_i,j-1) + x_i,j+1) - 4 x_ij) / dx^2.
// Modes 0-2 also take a space shard's slab of R rows of each state and the
// two halo rows of L's operand (u, or x in the Jacobian; the rows above
// and below the slab, from the neighbouring shards): the halo mode, which
// wraps in y only and writes the slab's R rows.  Mode 3 is pointwise (any
// R): K10's fused prologue (ops/periodic.py imex_prologue_plain), written
// out for the pencil solve of a slab, whose K20 passes have none.
//
// Replaces: pymgrit_tpu/models/allen_cahn.py AllenCahn._lap, _nonlin and
// the residual and Jacobian of _newton_solve (:76-122), and the CN
// right-hand side and IMEX reaction of AllenCahn.step (on a slab: the
// partitions of them GSPMD makes).  The operations are the plain
// version's (ops/pointwise.py allen_cahn_pointwise_plain and
// periodic_lap_plain), in its order, each rounded once (__dadd_rn,
// __dsub_rn, __dmul_rn, __ddiv_rn and their float32 forms: no FMA
// contraction, and a true division by dx^2), so the kernel equals the plain
// version bit for bit in float64 and float32.  The scalars inv_eps2 and
// dx^2 come by value as doubles and are rounded to the working type, as
// PyTorch rounds a Python scalar.
//
// Residual mode: one launch returns both g and its per-lane max.  Each
// block reduces |g| over its rows (NaN-propagating: a NaN anywhere gives
// NaN, as jnp.max), then folds its maximum into the lane's slot of a device
// workspace by an atomic max on the bit pattern (for non-negative values,
// and a NaN with its sign cleared, the bit patterns order as the values
// do), and counts itself in the lane's counter after a __threadfence; the
// last block of the lane takes the slot (resetting it and the counter to
// 0 for the next launch) and writes gmax[b].  The max is exact.  The
// workspace (two 64-bit words a lane, one for each device and stream) is
// zeroed once when the wrapper makes it, and dropped by the wrapper when a
// launch fails (ops/pointwise.py).
//
// Bound: bytes.  The Jacobian at the Newton-Krylov preconditioned lanes (B
// = 8 of 128^2) reads u and x and writes out: 3.1 MB, 0.0009 ms at 3.35
// TB/s; what a call costs there is the launch's host time.  Design:
// * one ctypes call: a packed int64 argument array the wrapper caches with
//   its checks (ops/pointwise.py), inv_eps2 and dx^2, the stream;
// * a block of TX x TY threads covers TY rows of one state at a time (a
//   unit), a thread V consecutive columns of its row: 16-byte vectors (V =
//   2 in float64, 4 in float32) where the side, the strides and the
//   pointers allow, else V = 1; a row's north and south neighbours are the
//   same columns of rows i - 1 and i + 1, its west and east halo one
//   scalar each; the wrapped indices are a compare each, no division;
// * the grid is sized to the card (blocks an SM times the SMs, at most
//   one block a unit); a block walks consecutive units and folds each of
//   its lanes' maxima once.
// The rounding helpers, the row loads, the walk and the lane max are
// csrc/periodic_pointwise.cuh's, which K14 and K15 share.

#include "periodic_pointwise.cuh"

namespace {

using namespace pm_pointwise;

template <typename T>
struct Args {
  const T *u, *x, *rhs, *fac;
  const T *above, *below;     // halo mode: (B, n) rows of L's operand; else null
  T *out, *gmax;
  unsigned long long* ws;     // residual: B max slots, then B counters
  int64_t u_sb, u_sr, x_sb, x_sr, r_sb, r_sr, o_sb, o_sr;
  Walk walk;                  // B lanes of R rows
  int n, nu;                  // columns; the power
  T inv_eps2, dx2, nu1;       // the scalars in the working type; nu1 = nu + 1
};

// one point, from the centre uc of u (the reaction), the Laplacian lap of
// its operand (x in the Jacobian, else u) and that operand's centre c, and
// r (the residual's rhs)
template <typename T, int MODE>
__device__ __forceinline__ T point(const Args<T>& a, T f, T uc, T lap, T c, T r) {
  T p = uc;
  for (int k = 1; k < a.nu; ++k) p = mul(p, uc);
  if constexpr (MODE == 3) {
    return add(uc, mul(f, mul(mul(a.inv_eps2, uc), sub(T(1), p))));
  } else if constexpr (MODE == 2) {
    return sub(c, mul(f, add(lap, mul(mul(a.inv_eps2, sub(T(1), mul(a.nu1, p))), c))));
  } else {
    const T lap_f = add(lap, mul(mul(a.inv_eps2, uc), sub(T(1), p)));
    if constexpr (MODE == 0) return add(uc, mul(f, lap_f));
    return sub(sub(uc, mul(f, lap_f)), r);
  }
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads) allen_cahn_pointwise_kernel(const Args<T> a) {
  const int n = a.n, R = a.walk.n;
  T m = T(0);   // the residual's max |g| over this thread's points since a fold
  walk_units(
      a.walk,
      [&](int64_t b, int i) {
        const T f = a.fac[b];
        const T* __restrict__ u = a.u + b * a.u_sb;
        T* __restrict__ o = a.out + b * a.o_sb + i * a.o_sr;
        if constexpr (MODE == 3) {
          for (int j = (int)threadIdx.x * V; j < n; j += (int)blockDim.x * V) {
            T uc[V], v[V];
            load<T, V>(uc, u + i * a.u_sr + j);
#pragma unroll
            for (int k = 0; k < V; ++k) v[k] = point<T, 3>(a, f, uc[k], T(0), T(0), T(0));
            store<T, V>(o + j, v);
          }
        } else {
          const T* __restrict__ x = MODE == 2 ? a.x + b * a.x_sb : u;
          const Nbr<T> r = nbr(x, MODE == 2 ? a.x_sr : a.u_sr, i, R,
                               a.above != nullptr ? a.above + b * n : nullptr,
                               a.below != nullptr ? a.below + b * n : nullptr);
          for (int j = (int)threadIdx.x * V; j < n; j += (int)blockDim.x * V) {
            Cross<T, V> c;
            T uc[V], rv[V];
            c.load_at(r, n, j);
            if constexpr (MODE == 2) {
              load<T, V>(uc, u + i * a.u_sr + j);
            }
            if constexpr (MODE == 1) {
              load<T, V>(rv, a.rhs + b * a.r_sb + i * a.r_sr + j);
            }
            T v[V];
#pragma unroll
            for (int k = 0; k < V; ++k) {
              v[k] = point<T, MODE>(a, f, MODE == 2 ? uc[k] : c.c[k], lap(c, k, a.dx2), c.c[k],
                                    MODE == 1 ? rv[k] : T(0));
              if constexpr (MODE == 1) m = nanmax(m, fabs(v[k]));   // sign bit cleared
            }
            store<T, V>(o + j, v);
          }
        }
      },
      [&](int64_t b, int k) {
        if constexpr (MODE == 1) {
          lane_max(m, b, k, a.walk, a.ws, a.gmax);
          m = T(0);
        }
      });
}

template <typename T, int MODE>
cudaError_t run(const Args<T>& a, int vec, dim3 block, unsigned grid, cudaStream_t st) {
  if (vec > 1)
    allen_cahn_pointwise_kernel<T, MODE, 16 / sizeof(T)><<<grid, block, 0, st>>>(a);
  else
    allen_cahn_pointwise_kernel<T, MODE, 1><<<grid, block, 0, st>>>(a);
  return cudaGetLastError();
}

// args (int64): CUDA device, then the pointers u, x, rhs, fac, out, gmax,
// workspace (0: none), u's, x's, rhs's and out's batch and row strides, B,
// n (columns), nu, the mode (0 rhs, 1 residual, 2 jacobian, 3 prologue),
// then the plan: the vector width (1, or 16 bytes), TX, TY, units a block,
// grid; then R (the rows of a state: n, or a slab's) and the halo rows'
// pointers above, below (0: none, the periodic wrap) (ops/pointwise.py::pack)
template <typename T>
int launch(const int64_t* g, double inv_eps2, double dx2, void* stream) {
  Args<T> a{};
  a.u = reinterpret_cast<const T*>(g[1]);
  a.x = reinterpret_cast<const T*>(g[2]);
  a.rhs = reinterpret_cast<const T*>(g[3]);
  a.fac = reinterpret_cast<const T*>(g[4]);
  a.out = reinterpret_cast<T*>(g[5]);
  a.gmax = reinterpret_cast<T*>(g[6]);
  a.ws = reinterpret_cast<unsigned long long*>(g[7]);
  a.u_sb = g[8];
  a.u_sr = g[9];
  a.x_sb = g[10];
  a.x_sr = g[11];
  a.r_sb = g[12];
  a.r_sr = g[13];
  a.o_sb = g[14];
  a.o_sr = g[15];
  const int64_t B = g[16], n = g[17], nu = g[18], mode = g[19];
  int64_t vec = g[20];
  const int64_t tx = g[21], ty = g[22], per = g[23], grid = g[24], R = g[25];
  a.above = reinterpret_cast<const T*>(g[26]);
  a.below = reinterpret_cast<const T*>(g[27]);
  if (B == 0 || n == 0 || R == 0) return 0;
  const bool halo = a.above != nullptr || a.below != nullptr;
  if (!walk_of(a.walk, B, R, tx, ty, per, grid) || n > 0x3fffffff || nu < 1 || nu > 64 ||
      mode < 0 || mode > 3 || (mode == 1 && (a.ws == nullptr || a.gmax == nullptr)) ||
      (halo && (a.above == nullptr || a.below == nullptr || mode == 3)) ||
      (!halo && mode != 3 && R != n))
    return (int)cudaErrorInvalidValue;
  // 16-byte vectors only where every row the call reads or writes starts
  // on 16 bytes (the plan checked the side and the strides)
  if (vec > 1 && !aligned16({a.u, a.out, mode == 2 ? a.x : nullptr, mode == 1 ? a.rhs : nullptr,
                             a.above, a.below}))
    vec = 1;
  a.n = (int)n;
  a.nu = (int)nu;
  a.inv_eps2 = (T)inv_eps2;
  a.dx2 = (T)dx2;
  a.nu1 = (T)(nu + 1);
  const OnDevice on((int)g[0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block((unsigned)tx, (unsigned)ty);
  if (mode == 0) return (int)run<T, 0>(a, (int)vec, block, (unsigned)grid, st);
  if (mode == 1) return (int)run<T, 1>(a, (int)vec, block, (unsigned)grid, st);
  if (mode == 2) return (int)run<T, 2>(a, (int)vec, block, (unsigned)grid, st);
  return (int)run<T, 3>(a, (int)vec, block, (unsigned)grid, st);
}

}  // namespace

extern "C" {

int pm_allen_cahn_pointwise_f64(const int64_t* args, double inv_eps2, double dx2, void* stream) {
  return launch<double>(args, inv_eps2, dx2, stream);
}

int pm_allen_cahn_pointwise_f32(const int64_t* args, double inv_eps2, double dx2, void* stream) {
  return launch<float>(args, inv_eps2, dx2, stream);
}

}  // extern "C"
