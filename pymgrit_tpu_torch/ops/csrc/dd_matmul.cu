// K26 dd_matmul: batched products C_b = A_b B_b of double-double operands
// (float32 pairs hi + lo) on the FP64 tensor cores.  Each operand value is
// formed as the exact float64 hi + lo when its fragment is read from shared
// memory, the products accumulate in float64 with
// mma.sync.aligned.m16n8k4.row.col.f64 (DMMA), and the epilogue splits each
// float64 sum into its DD pair (hi = fl32(c), lo = fl32(c - hi), the JAX
// package's from_f64).
//
// Replaces: pymgrit_tpu/ops/ozaki.py matmul_dd (:84-162), the Ozaki-scheme
// DD product the JAX package runs on the TPU's bf16 MXU because that chip
// has no float64; Hopper has FP64 tensor cores, so the port accumulates in
// float64 instead: about k 2^-53 relative (k the contraction length)
// against Ozaki's 2^-48, and not bitwise equal to the JAX package.  Its
// callers are Heat2D's physical DD step (two-sided 63 x 63 sine products on
// every lane), Heat1D's physical DD step and Diffusion2D's DD step (dense
// 2400 x 2400 tables).
//
// Bound: operations, 2 M N K a product at the tensor cores' 67 TFLOP/s, or
// the bytes of the operands (8 a DD value) where the batch is small.
// Design: the shared FP64 product tile (dmma_tile.cuh) with the plan the
// wrapper picks (ops/product_tile.py::product_plan): hi and lo staged side
// by side through one cp.async ring; a few-row product (Diffusion2D's 8
// lanes against its table) puts its long axis on the tile's M side and is
// split along the inner index into float64 partials, summed in slice order
// by a second pass that also splits the sums into pairs; the batched small
// products take one 64 x 64 tile each (blockIdx.z walks the batch) with no
// split.  Every operand is addressed by element strides (batch, row,
// column; 0 for a broadcast batch), so a transposed table or a strided tube
// view needs no copy: each stages along whichever of its axes is
// contiguous, with 16-byte copies where its rows are 16-byte aligned and
// 4-byte copies otherwise (the 63-wide rows of the Heat2D products).  Rows,
// columns and contraction indices past the edge stage as zeros and are not
// written.

#include <cstdint>
#include <cuda_runtime.h>

#include "dmma_tile.cuh"

extern "C" {

// args (int64): the pointers A hi, lo, B hi, lo, C hi, lo, workspace; the
// strides A (batch, row, column), B (...), C (...); batch, M, N, K; then the
// plan: swap, bm, bn, bk, stages, splits, kps, copy bytes of the tile's A
// side and of its B side, blocks walking the batch.
int pm_dd_matmul(const int64_t* args, void* stream) {
  void* ptrs[7];
  for (int i = 0; i < 7; ++i) ptrs[i] = reinterpret_cast<void*>(args[i]);
  const int64_t* strides = args + 7;
  const int64_t batch = args[16], M = args[17], N = args[18], K = args[19];
  const int64_t* plan = args + 20;
  if (batch == 0 || M == 0 || N == 0) return 0;
  const bool swap = plan[0] != 0;
  const pm_tile::Plan pl{(int)plan[1], (int)plan[2], (int)plan[3], (int)plan[4], (int)plan[5],
                         plan[6], (int)plan[9]};
  const int chunk_a = (int)(plan[7] / 4), chunk_b = (int)(plan[8] / 4);
  // A as (M x K) rows; B as B^T, (N x K) rows
  const pm_tile::Operand a{ptrs[0], ptrs[1], strides[0], strides[1], strides[2], M, 0};
  const pm_tile::Operand bt{ptrs[2], ptrs[3], strides[3], strides[5], strides[4], N, 0};
  pm_tile::Args p{};
  // with swap the tile computes C^T = B^T A^T, the long axis N on its M side
  p.a = swap ? bt : a;
  p.b = swap ? a : bt;
  p.a.chunk = chunk_a;
  p.b.chunk = chunk_b;
  p.batch = batch;
  p.M = swap ? N : M;
  p.N = swap ? M : N;
  p.K = K;
  p.ws = ptrs[6];
  p.epi.c0 = ptrs[4];
  p.epi.c1 = ptrs[5];
  p.epi.sb = strides[6];
  p.epi.sr = swap ? strides[8] : strides[7];
  p.epi.sc = swap ? strides[7] : strides[8];
  return (int)pm_tile::product<float, true>(p, pl, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
