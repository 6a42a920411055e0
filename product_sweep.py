#!/usr/bin/env python3
"""The FP64 product tile that K22 ``eig_step`` and K26 ``dd_matmul`` share
(``pymgrit_tpu_torch/ops/csrc/dmma_tile.cuh``) on one NVIDIA GPU (H100,
sm_90a), measured past what ``chip_smoke.py`` checks:

    python3 product_sweep.py

1. ``[dmma]`` the FP64 tensor-core rate of the two ``mma.sync`` shapes the
   tile could use, m8n8k4 and m16n8k4, from a stand-alone CUDA program with
   no memory traffic (why the tile uses m16n8k4);
2. ``[sweep]`` K22 (float64) and K26's Diffusion2D table product at 1-256
   lanes x 2400: each call's time (median of CUDA-event-timed calls, wrapper
   included) beside one PyTorch call for the same function (cuBLAS), its
   bound and its plan; then the launch alone (no checks, no plan) on the
   plan's regime and on the other one, forced, each held against the plain
   version: the crossover that ``product_tile.SKINNY_MAX`` rests on.

Needs a CUDA device and exits non-zero without one; every line is measured
in this run on this card, whose name and power limit come first.
"""

import math
import subprocess

import numpy as np

import chip_smoke
from chip_smoke import DIFFUSION, SEED, bound_ms, check, cuda_ms

LANES = (1, 8, 16, 32, 64, 128, 256)
RTOL = {"eig_step": 1e-12, "dd_matmul": 1e-14}   # the kernels' tolerances on the card

# eight independent accumulators a warp, 8 warps a block, 4 blocks an SM
DMMA_SHAPES_CU = r"""
#include <cstdio>
#include <cuda_runtime.h>
template <int S> __global__ void k(double* out, int iters) {
  double a0 = threadIdx.x * 1e-3, a1 = a0 + 1, b = 1.0 + blockIdx.x * 1e-6, d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (S == 884)
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
                     : "+d"(d[j][0]), "+d"(d[j][1]) : "d"(a0), "d"(b));
      else
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
                     "{%0,%1,%2,%3};" : "+d"(d[j][0]), "+d"(d[j][1]), "+d"(d[j][2]), "+d"(d[j][3])
                     : "d"(a0), "d"(a1), "d"(b));
    }
  double s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int S> void run(double* out, int m) {
  const int blocks = 132 * 4, threads = 256, iters = 2048;
  k<S><<<blocks, threads>>>(out, 16);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  cudaEventRecord(e0); k<S><<<blocks, threads>>>(out, iters); cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms; cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * m * 8 * 4 * 8 * iters * (blocks * threads / 32);
  printf("m%dn8k4 %.2f TFLOP/s %s\n", m, flop / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}
int main() {
  double* out; cudaMalloc(&out, 132 * 4 * 256 * 8);
  run<884>(out, 8); run<1684>(out, 16);
  return 0;
}
"""


def dmma_shape_rates():
    """Build and run DMMA_SHAPES_CU: {shape: TFLOP/s}."""
    from pymgrit_tpu_torch.ops import _build
    d = _build.BUILD_ROOT.parent / "dmma_shapes"
    d.mkdir(parents=True, exist_ok=True)
    (d / "dmma_shapes.cu").write_text(DMMA_SHAPES_CU)
    nvcc = subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                           "-o", str(d / "dmma_shapes"), str(d / "dmma_shapes.cu")],
                          capture_output=True, text=True, timeout=300)
    check(nvcc.returncode == 0, "dmma_shapes build failed: " + nvcc.stdout + nvcc.stderr)
    out = subprocess.run([str(d / "dmma_shapes")], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0 and "no error" in out.stdout, "dmma_shapes: " + out.stdout)
    return {ln.split()[0]: float(ln.split()[1]) for ln in out.stdout.splitlines()}


def forced(plan, batch, M, N, K, dtype, regime):
    """``plan`` (of a product_plan(batch, M, N, K, dtype, ...) call) on
    ``regime``, with the same copy widths."""
    from pymgrit_tpu_torch.ops import product_tile
    tile_a, tile_b = zip(plan.copy, plan.kmajor)
    a, b = (tile_b, tile_a) if plan.swap else (tile_a, tile_b)
    return product_tile._product_plan(batch, M, N, K, dtype, a, b, regime)


def sweep(card):
    import torch
    from pymgrit_tpu_torch.ops import dd
    from pymgrit_tpu_torch.ops import dd_matmul as k26
    from pymgrit_tpu_torch.ops import eig_step as k22
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 9)
    Ne = 6 * DIFFUSION["n"] ** 2

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    def held(name, label, got, want):
        err = float((got - want).abs().max()) / float(want.abs().max())
        check(err <= RTOL[name], f"{name} {label}: rel err {err:.3e} > {RTOL[name]:.0e}")

    W, V = (t(rng.uniform(-1, 1, (Ne, Ne)) / math.sqrt(Ne)) for _ in range(2))
    lam = t(rng.uniform(0, 2, Ne))
    X = t(rng.uniform(-1, 1, (max(LANES), Ne)))
    Wd = dd.from_f64(rng.uniform(-1, 1, (Ne, Ne)) / math.sqrt(Ne), dev)
    Wd64 = Wd.hi.double() + Wd.lo.double()
    Xd = dd.from_f64(rng.uniform(-1, 1, (max(LANES), Ne)), dev)
    rows = []
    for B in LANES:
        x, dt = X[:B], t(np.full(B, 10.0 / 16))
        out = torch.empty_like(x)
        want = k22.eig_step_plain(x, torch.empty_like(x), W, V, lam, dt)
        plan = k22.plan(x, W, V)
        other = forced(plan, 1, B, Ne, Ne, "float64",
                       "wide" if plan.regime == "skinny" else "skinny")
        ms = cuda_ms(lambda: k22.eig_step(x, out, W, V, lam, dt))
        alone = {}
        for p in (plan, other):
            alone[p.regime] = cuda_ms(lambda p=p: k22._launch(x, out, W, V, lam, dt, p))
            held("eig_step", f"{B} lanes {p.regime}", out, want)
        lib = cuda_ms(lambda: (x @ W.T) @ V.T)
        b_ms, b_by = bound_ms("eig_step", None, (8 * (2 * Ne * Ne + 2 * B * Ne + Ne + B),
                                                 4 * B * Ne * Ne + 3 * B * Ne))
        print(f"[sweep] K22 {B:>3} lanes x {Ne} f64: kernel {ms:.4f} ms ({plan.describe()}) | "
              f"launch alone: skinny {alone['skinny']:.4f} ms, wide {alone['wide']:.4f} ms "
              f"(other: {other.describe()}; both within {RTOL['eig_step']:.0e}) | cuBLAS "
              f"{lib:.4f} ms | bound {b_ms:.4f} ms ({b_by}), kernel at {ms / b_ms:.1f}x | {card}")
        rows.append(dict(kernel="eig_step", lanes=B, regime=plan.regime, ms=ms, **{
            f"alone_{k}_ms": v for k, v in alone.items()}, library_ms=lib, bound_ms=b_ms))
        del out, want
        xd, b = Xd[:B][None], Wd.T[None]
        x64 = Xd.hi[:B].double() + Xd.lo[:B].double()
        want = torch.matmul(x64, Wd64.T)
        scale = float((x64.abs() @ Wd64.abs().T).max())
        outd = k26.dd_matmul(xd, b)
        plan = k26.plan(xd, b)
        other = forced(plan, 1, B, Ne, Ne, "dd", "wide" if plan.regime == "skinny" else "skinny")
        ms = cuda_ms(lambda: k26.dd_matmul(xd, b))
        alone = {}
        for p in (plan, other):
            alone[p.regime] = cuda_ms(lambda p=p: k26._launch(xd, b, outd, p))
            err = float((outd.hi[0].double() + outd.lo[0].double() - want).abs().max())
            check(err <= RTOL["dd_matmul"] * scale,
                  f"dd_matmul {B} rows {p.regime}: abs err {err:.3e} > "
                  f"{RTOL['dd_matmul']:.0e} max(|A||B|) = {RTOL['dd_matmul'] * scale:.3e}")
        lib = cuda_ms(lambda: torch.matmul(x64, Wd64.T))
        b_ms, b_by = bound_ms("dd_matmul", None, (8 * (Ne * Ne + 2 * B * Ne), 2 * B * Ne * Ne))
        print(f"[sweep] K26 table {B:>3} rows x {Ne} DD: kernel {ms:.4f} ms ({plan.describe()}) "
              f"| launch alone: skinny {alone['skinny']:.4f} ms, wide {alone['wide']:.4f} ms "
              f"(other: {other.describe()}; both within {RTOL['dd_matmul']:.0e} max(|A||B|)) | "
              f"torch.matmul f64 {lib:.4f} ms | bound {b_ms:.4f} ms ({b_by}), kernel at "
              f"{ms / b_ms:.1f}x | {card}")
        rows.append(dict(kernel="dd_matmul", lanes=B, regime=plan.regime, ms=ms, **{
            f"alone_{k}_ms": v for k, v in alone.items()}, library_ms=lib, bound_ms=b_ms))
        del outd, want
    return rows


def main():
    import json

    from pymgrit_tpu_torch.ops import _build
    card = chip_smoke.phase_device()
    _build.library()
    rates = dmma_shape_rates()
    print("[dmma] FP64 tensor-core rate by mma.sync shape (no memory traffic): "
          + ", ".join(f"{k} {v:.2f} TFLOP/s" for k, v in rates.items()) + f" | {card}")
    rows = sweep(card)
    print(card)
    print(json.dumps({"dmma_tflops": rates, "sweep": rows}))


if __name__ == "__main__":
    main()
