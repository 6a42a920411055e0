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
// Bound: below about 80 lanes the bytes of the two tables (2 N^2 values,
// 92 MB at N = 2400) over the memory rate (a product of B lanes does B / 4
// operations a table byte, the FP64 tensor cores' ridge is ~20); above, the
// 4 B N^2 operations over the FP64 tensor-core rate.  Design: the two
// products work = (x W^T) / (1 + dt lam) and y = work V^T run on the shared
// FP64 product tile (dmma_tile.cuh) with the plan the wrapper picks
// (ops/product_tile.py::product_plan): the table on the tile's M side and
// the lanes on its N side (8 wide at few lanes: the table is streamed once
// through a cp.async ring, split along the inner index so that every SM
// holds two blocks; 64 wide above), float64 partials summed in slice
// order by a second pass that also applies the scale, explicitly rounded as
// the plain version rounds it.  The float32 instantiation runs the same plan
// on the CUDA cores (FFMA); it never uses TF32.  x is read by the first
// product before the second writes y, so out may be x.

#include <cstdint>
#include <cuda_runtime.h>

#include "dmma_tile.cuh"

namespace {

using pm_tile::Args;
using pm_tile::Operand;
using pm_tile::Plan;

// args (int64): x, its lane stride, W, V, lam, dt, work, workspace, y, its
// lane stride, B, N, then the plan: swap, bm, bn, bk, stages, splits, kps,
// copy bytes of the tile's A side and of its B side (with swap the table's
// and the lanes', else the lanes' and the table's), batch walkers (1)
template <typename T>
int launch(const int64_t* args, void* stream) {
  const T* x = reinterpret_cast<const T*>(args[0]);
  const int64_t sx = args[1];
  const T* W = reinterpret_cast<const T*>(args[2]);
  const T* V = reinterpret_cast<const T*>(args[3]);
  const T* lam = reinterpret_cast<const T*>(args[4]);
  const T* dt = reinterpret_cast<const T*>(args[5]);
  T* work = reinterpret_cast<T*>(args[6]);
  T* ws = reinterpret_cast<T*>(args[7]);
  T* y = reinterpret_cast<T*>(args[8]);
  const int64_t sy = args[9], B = args[10], N = args[11];
  const int64_t* plan = args + 12;
  if (B == 0 || N == 0) return 0;
  const bool swap = plan[0] != 0;
  const Plan pl{(int)plan[1], (int)plan[2], (int)plan[3], (int)plan[4], (int)plan[5], plan[6],
                (int)plan[9]};
  const int chunk_a = (int)(plan[7] / (int64_t)sizeof(T));
  const int chunk_b = (int)(plan[8] / (int64_t)sizeof(T));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one product C = L M^T of the (B x N) lanes L and a table M; with swap
  // the tile computes C^T = M L^T, the table on its M side
  auto product = [&](const T* L, int64_t sl, const T* M, T* C, int64_t sc,
                     bool scale) -> cudaError_t {
    const Operand lanes{L, nullptr, 0, sl, 1, B, 0};
    const Operand table{M, nullptr, 0, N, 1, N, 0};
    Args p{};
    p.a = swap ? table : lanes;
    p.b = swap ? lanes : table;
    p.a.chunk = chunk_a;
    p.b.chunk = chunk_b;
    p.batch = 1;
    p.M = swap ? N : B;
    p.N = swap ? B : N;
    p.K = N;
    p.ws = ws;
    p.epi.c0 = C;
    p.epi.sr = swap ? 1 : sc;
    p.epi.sc = swap ? sc : 1;
    if (scale) {
      p.epi.dt = dt;
      p.epi.lam = lam;
      p.epi.dt_r = swap ? 0 : 1;
      p.epi.dt_c = swap ? 1 : 0;
      p.epi.lam_r = swap ? 1 : 0;
      p.epi.lam_c = swap ? 0 : 1;
    }
    return pm_tile::product<T, false>(p, pl, s);
  };
  cudaError_t e = product(x, sx, W, work, N, true);
  if (e != cudaSuccess) return (int)e;
  return (int)product(work, N, V, y, sy, false);
}

}  // namespace

extern "C" {

int pm_eig_step_f64(const int64_t* args, void* stream) { return launch<double>(args, stream); }

int pm_eig_step_f32(const int64_t* args, void* stream) { return launch<float>(args, stream); }

}  // extern "C"
