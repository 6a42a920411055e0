// K20 sine_solve1d: the physical-basis Heat1D backward-Euler step, the BDF2
// step of the pair-state heat model, and the 1D sine transform of B rows of
// n interior values,
//
//   BE:         y_b = ((x_b + dt_b r_b) S / (1 + dt_b lam)) S
//               (lam one row, or a table of D rows of which lane b reads row
//               b % D: the distributed Heat2D solve's x-pass, lane b a
//               column of a state and its divisor 1 + dt Lam[:, j])
//   BDF2:       y_b = (((r_b - c2_b x_b) + c1_b x2_b) S / (lam + coeff_b)) S
//   transform:  y_b = x_b S
//
// with the symmetric orthonormal sine basis S (so x S == S x).
//
// Replaces: pymgrit_tpu/models/heat_1d.py Heat1D.step_batched (physical
// branch: `b @ S`, the diagonal scale, `xh @ S`) and Heat1D.relax_interval
// (physical branch: the two einsums around the closed-form tables, which
// run through K1 between two transforms); pymgrit_tpu/models/heat_1d_2pts.py
// Heat1DBDF1.step (two BE solves, solve_shifted_1d) and Heat1DBDF2.step (two
// Helmholtz solves, solve_helmholtz_1d, after the three-term right-hand
// side `rhs - coeffm2 * first + coeffm1 * second`).
//
// Bound: a solve does 4 B n^2 operations of dense FP64 products on 2 B n + n^2
// values (an output row of every input row): from about 80 lanes up the
// operations over the FP64 tensor cores' rate (the BDF example's 128 pairs
// of 999 points), below that the bytes of S read once (its coarsest march,
// one lane).  Design: each product runs on the FP64 product tile that K22
// and K26 share (dmma_tile.cuh; float32 on the CUDA cores' FFMA, never
// TF32), with the plan the wrapper picks (ops/product_tile.py
// ::lanes_plan): S on the tile's M side and the lanes on its N side, a
// 64 x 8 tile streaming S once through the cp.async ring up to 16 lanes and
// wherever n <= 32 (the inner index split so that every SM holds blocks),
// 64 x 64 x 32 tiles otherwise, the inner index split wherever the tiles
// are fewer than a wave.  On the skinny tile a solve's first product forms
// its right-hand side as the lanes are staged (x + dt r, or (r - c2 x) +
// c1 x2: every component through the ring, formed in shared memory with
// each operation rounded once in the plain version's order); on the wide
// tile a first pass writes the right-hand side rows into the workspace
// (two or three components in the ring would leave one 64 x 64 block an
// SM).  The first product divides by 1 + dt lam (or lam + coeff) in its
// epilogue into a work buffer, or in the slices' sum pass where the inner
// index is split; the second product writes the output rows, so a solve
// may write over its inputs.  A small solve (n within one k-tile of the
// skinny tile) runs both products in one launch: the block keeps its
// divided lanes in shared memory and multiplies them by the same S tile.
// Output rows are addressed as b = hi * D + lo with a stride for hi and
// one for lo, which covers a (B, n) view and the (interval, row) layouts
// of relax_interval.  The sums run in the tile's order (not the plain
// version's): a call repeats bit for bit and agrees with the plain version
// to rounding.

#include <cstdint>
#include <cuda_runtime.h>

#include "dmma_tile.cuh"

namespace {

using pm_tile::Args;
using pm_tile::Operand;
using pm_tile::Plan;

// The packed int64 argument array (ops/heat_kernels.py::sine_solve1d_pack;
// keep the two in step): 0 device, pointers 1 x, 2 r, 3 x2, 4 dt, 5 c2,
// 6 c1, 7 S, 8 lam, 9 coeff, 10 work, 11 partials, 12 y; 13 x's, 14 r's and
// 15 x2's row strides; 16 D, 17 s_hi, 18 s_lo; 19 B, 20 n; 21 mode (0
// transform, 1 BE, 2 BE + dt r, 3 BDF2); then the plan of the first product
// (22-31) and of the second (32-41), each: swap (0), bm, bn, bk, stages,
// splits, kps, copy bytes of S and of the lanes, batch walkers (1); 42
// whether a first pass forms the right-hand side (else the first product
// forms it as it stages the lanes), 43 the rows it writes; 44 whether one
// launch runs both products (a small solve: n within one k-tile).
constexpr int kPlan1 = 22, kPlan2 = 32, kPrepass = 42, kRhs = 43, kFused = 44;

Plan plan_at(const int64_t* a) {
  return Plan{(int)a[1], (int)a[2], (int)a[3], (int)a[4], (int)a[5], a[6], (int)a[9]};
}

// The right-hand side rows out[b] = x_b + dt_b r_b (BE) or (r_b - c2_b x_b)
// + c1_b x2_b (BDF2), each operation rounded once in the plain version's
// order; a block takes 256 entries of a row, gridDim.y rows at a stride.
template <typename T, int LANES>
__global__ void __launch_bounds__(256)
    form_rhs(const T* __restrict__ x, int64_t sx, const T* __restrict__ r, int64_t sr,
             const T* __restrict__ x2, int64_t sx2, const T* __restrict__ c0,
             const T* __restrict__ c1, T* __restrict__ out, int64_t B, int64_t n) {
  const int64_t k = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (k >= n) return;
  for (int64_t b = blockIdx.y; b < B; b += gridDim.y) {
    T v;
    if constexpr (LANES == pm_tile::kBe)
      v = pm_tile::add_rn(x[b * sx + k], pm_tile::mul_rn(c0[b], r[b * sr + k]));
    else
      v = pm_tile::add_rn(pm_tile::sub_rn(r[b * sr + k], pm_tile::mul_rn(c0[b], x[b * sx + k])),
                          pm_tile::mul_rn(c1[b], x2[b * sx2 + k]));
    out[b * n + k] = v;
  }
}

// lam_rows: the rows of a lam table (lane b reads row b % lam_rows; 1 for
// one row)
template <typename T>
int launch(const int64_t* args, void* stream, int64_t lam_rows) {
  auto ptr = [&](int i) { return reinterpret_cast<T*>(args[i]); };
  const int64_t B = args[19], n = args[20], mode = args[21];
  if (B == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one product C^T = S L^T of lanes L (rows of stride sl) and the table S:
  // the tile's M axis is S's row j, its N axis the lane b
  auto base = [&](const int64_t* pl, const T* L, int64_t sl) {
    Args p{};
    p.a = Operand{ptr(7), nullptr, 0, n, 1, n, (int)(pl[7] / (int64_t)sizeof(T))};
    p.b = Operand{L, nullptr, 0, sl, 1, B, (int)(pl[8] / (int64_t)sizeof(T))};
    p.batch = 1;
    p.M = n;
    p.N = B;
    p.K = n;
    p.ws = ptr(11);
    return p;
  };
  const bool solve = mode != 0, fused = solve && args[kFused] != 0;
  // the output rows: b = hi D + lo at hi s_hi + lo s_lo
  pm_tile::Epilogue out{};
  out.c0 = ptr(12);
  out.sr = 1;
  out.sc = args[18];
  out.D = args[16];
  out.s_hi = args[17];
  const int64_t* pl1 = args + kPlan1;
  Args p = base(pl1, ptr(1), args[13]);
  if (fused) {                // both products in one launch, through epi2
    p.fused = true;
    p.epi2 = out;
  }
  if (solve) {
    // work[b][j] = (rhs_b S)_j / (1 + dt_b lam_j), or / (lam_j + coeff_b)
    p.epi.c0 = ptr(10);
    p.epi.sr = 1;
    p.epi.sc = n;
    p.epi.D = 1;
    p.epi.s_hi = n;
    p.epi.lam = ptr(8);
    p.epi.lam_r = 1;
    p.epi.lam_rows = lam_rows;
    p.epi.lam_ld = n;
    p.epi.dt_c = 1;
    if (mode == 3)
      p.epi.shift = ptr(9);
    else
      p.epi.dt = ptr(4);
  } else {
    p.epi = out;
  }
  cudaError_t e;
  if ((mode == 2 || mode == 3) && args[kPrepass] != 0) {
    // a first pass writes the right-hand side rows; the product stages them
    const dim3 grid((unsigned)((n + 255) / 256), (unsigned)(B < 65535 ? B : 65535));
    T* rhs = ptr(kRhs);
    if (mode == 3)
      form_rhs<T, pm_tile::kBdf2><<<grid, 256, 0, s>>>(ptr(1), args[13], ptr(2), args[14],
                                                       ptr(3), args[15], ptr(5), ptr(6), rhs, B, n);
    else
      form_rhs<T, pm_tile::kBe><<<grid, 256, 0, s>>>(ptr(1), args[13], ptr(2), args[14], nullptr,
                                                     0, ptr(4), nullptr, rhs, B, n);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const pm_tile::Epilogue epi = p.epi;
    p = base(pl1, rhs, n);
    p.epi = epi;
    p.fused = fused;
    p.epi2 = out;
    e = pm_tile::product<T, false, pm_tile::kRows>(p, plan_at(pl1), s);
  } else if (mode == 2 || mode == 3) {
    p.r = Operand{ptr(2), nullptr, 0, args[14], 1, B, p.b.chunk};
    p.cf0 = mode == 2 ? ptr(4) : ptr(5);
    if (mode == 3) {
      p.x2 = Operand{ptr(3), nullptr, 0, args[15], 1, B, p.b.chunk};
      p.cf1 = ptr(6);
      e = pm_tile::product<T, false, pm_tile::kBdf2>(p, plan_at(pl1), s);
    } else {
      e = pm_tile::product<T, false, pm_tile::kBe>(p, plan_at(pl1), s);
    }
  } else {
    e = pm_tile::product<T, false, pm_tile::kRows>(p, plan_at(pl1), s);
  }
  if (e != cudaSuccess || !solve || fused) return (int)e;
  // y = work S, rows b = hi D + lo at hi s_hi + lo s_lo
  const int64_t* pl2 = args + kPlan2;
  Args q = base(pl2, ptr(10), n);
  q.epi = out;
  return (int)pm_tile::product<T, false, pm_tile::kRows>(q, plan_at(pl2), s);
}

}  // namespace

extern "C" {

int pm_sine_solve1d_f64(const int64_t* args, void* stream) {
  return launch<double>(args, stream, 1);
}

int pm_sine_solve1d_f32(const int64_t* args, void* stream) {
  return launch<float>(args, stream, 1);
}

// a solve with a (lam_rows, n) lam table
int pm_sine_solve1d_lam_rows_f64(const int64_t* args, int64_t lam_rows, void* stream) {
  return launch<double>(args, stream, lam_rows);
}

int pm_sine_solve1d_lam_rows_f32(const int64_t* args, int64_t lam_rows, void* stream) {
  return launch<float>(args, stream, lam_rows);
}

}  // extern "C"
