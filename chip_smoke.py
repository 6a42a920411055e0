#!/usr/bin/env python3
"""Smoke run of ``pymgrit_tpu_torch`` on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Drives the port's two main paths -- TOMS example 3: Heat2D 129x129,
backward Euler, nt = 16385, five levels with coarsening 32/16/4/4,
FCF-relaxation, V-cycles, nested iteration, condensed level-0 carry,
``Mgrit.solve_compiled()`` -- in float64 on the card, in the spectral basis
and in the physical basis (``bench.py``'s ``toms129_physical`` row), in
phases:

1. device    the card's name and power limit (nvidia-smi); a CUDA device is
             required, there is no CPU carry-on;
2. build     nvcc builds the CUDA C++ kernels (K1-K26, every kernel of
             the port) from ``csrc/``, one process per source,
             all started together; ``cuobjdump`` counts the DMMA instructions
             of K5's, K6's and K10's float64 kernels (required in each, with
             no spills, by instantiation), K22 and K26, and ptxas's log
             gives the registers, spills and static shared memory of K2-K17
             and K23-K25 (no spills) and the FP64 product tile
             K22 and K26 share (``csrc/dmma_tile.cuh``);
3. kernels   K1-K22 against their plain PyTorch versions at the main paths'
             shapes (and odd ones, and K5/K6/K10/K16/K17 past the sizes
             their wrappers once refused, K16 on both of its routes),
             float32 and float64, with timings (K1-K21 and K23-K25 in
             rounds, the output made untimed, with their device time on a
             cold L2; the card's plain K13 against the CPU's; K16's Newton
             iterations and K12's attempts (float64) equal to the plain
             version's; K8's and K12's latency floors, at the FMA, shuffle,
             division, root and pow latencies that ``csrc/latency_probe.cu``
             measures); for each kernel's headline case (and each
             case that records its work) its bound (bytes or FP64 operations over the
             H100's peaks) and, where one PyTorch call computes the same
             function, that call's time; then the double-double K23-K26
             (``[dd-kernels]``) at the [dd] phase's shapes (K25 also at
             dd65's: the 5-point combine on one lane and on the level-0
             lane batch), K23-K25 bit for
             bit and K26 within 1e-14 of max(|A| |B|); K22 (1, 8 and 128
             lanes) and K26 print each case's product plan and repeat bit
             for bit on a second launch (``product_sweep.py`` times both
             at 1-256 lanes on each regime);
4. small     Heat2D nx=17, nt=129, ms=(4, 4): the port on the CPU (plain
             versions) against the port on the GPU (kernels); then
             ``[pytree]``: multi-leaf states (a dict and a tuple of a (3,)
             and a (2,) leaf, two levels with m = 4 and a ragged three-level
             hierarchy) and ``Application.state_norm`` (max |x|), kernels
             against the plain path and against the JAX package's
             histories (``PYTREE_JAX``), K3 launched only without the hook;
5. main      the full spectral TOMS solve through K1-K4: launch counts,
             history, agreement with the plain versions on the GPU, the
             materialized tube against a sequential time march, wall times,
             steps/s;
6. physical  the full physical TOMS solve through K3-K7: launch counts,
             history against the plain versions and against the spectral
             path, the materialized tube against the spectral tube brought
             to the physical basis, wall times, steps/s, peak memory;
7. cn, fe    CN at the TOMS width and a smaller depth (kernels against
             plain and against the spectral basis), and FE on a grid stable
             on every level (GPU against CPU, the full-tube executor);
8. coarsest  the coarsest-level strategies: the sequential scan,
             ``AtMgrit`` (K9) and ``Mgrit(coarsest_prefix=True)`` (K8) on
             ``bench.py``'s Dahlquist row (coarsest nt = 8193) and on the
             TOMS width with two levels (coarsest 2049 x 16129), and the
             Heat1D AT-MGRIT golden history;
9. allen_cahn the nonlinear Allen-Cahn model: ``bench.py``'s row (128^2,
             IMEX, nt = 4097, coarsening 8/8, five iterations) through K10,
             the IMPL configuration of ``examples/example_allen_cahn.py``
             and CN at the same short horizon through K10 and K11 (Newton-CG),
             each against the plain versions, with walls, launches, Newton
             and CG counts and the final radius;
10. ode      ``examples/example_arenstorf.py`` (nt = 80001, m = 320) through
             K12 against the plain path and the plain path on the CPU, the
             user-defined criterion of
             ``examples/example_convergence_criterion.py`` against its
             golden, and the Brusselator (K13) against its golden;
11. gray_scott ``examples/at_mgrit/example_at_mgrit_gray_scott.py`` at 128^2,
             nt = 2^14 + 1 (AtMgrit(k=8) through K10 with its species axis and
             Gray-Scott prologue), the demo's Parareal run against the
             sequential fine march through K10, IMPL (K10 + K14 in
             Newton-BiCGStab) and EXPL (K14), each against the plain path;
12. burgers  ``examples/example_burgers.py`` (K16) against its JAX golden, a
             deep Burgers1D grid (K16 on 256 lanes), Burgers2D at 64^2 (K15 +
             K10), kernels against plain;
13. advection ``examples/example_advection.py`` (K17) against its JAX golden,
             a deep grid (K17 on 4096 lanes), kernels against plain;
14. spatial  ``bench.py``'s ``spatial65`` row: Heat2D (physical) 65^2 -> 33^2
             -> 17^2 -> 9^2 through ``GridTransferHeat2D`` (K18, K19), nt =
             4097, coarsening 4/4/4, condensed level 0, kernels against
             plain in alternating pairs and against the JAX package's
             history; then ``examples/example_spatial_coarsening.py``
             (Heat1D physical through K20, ``GridTransferHeat``) against
             its golden and its JAX history (``[spatial1d]``);
15. c2       ``bench.py``'s toms257 physical row (257^2, nt = 4097, 32/16/4,
             two iterations): K5 and K6 past their one-tile side, kernels
             against plain;
16. ragged   ``bench.py``'s ragged_nonuniform row (Heat2D physical 65^2,
             nt = 4097, levels 4097/515/129/33, levels 0 and 1 non-uniform)
             through K21 and K5/K7, kernels against plain in alternating
             pairs and against the JAX history; the varying_coarsening
             golden (Dahlquist, weight_c 1 and 0.5);
17. bdf      ``examples/example_heat_1d_bdf2.py`` (nx = 1001, pair grids
             257/129/65, BDF2/BDF1/BDF1) through K20's BE and BDF2 modes,
             against the JAX history and the plain path;
18. diffusion ``examples/example_diffusion_2d.py`` (n = 20, N = 2400, nt 17/9)
             through K22 against its JAX history, then nt = 1025 with m = 8
             (128 lanes), kernels against plain, mass conservation;
19. dd       ``precision='dd'`` (float32 pairs): bench.py's dd_toms129 row
             (the TOMS configuration in the spectral basis, 14 iterations:
             K23-K25 and K3) and dd65 row (Heat2D physical 65^2, nt =
             4097, 4/4/4, tol 1e-10: K25, K26 and K3), kernels against
             plain in alternating pairs after a warm solve and against the
             JAX package's histories (the DD floor included), with no
             float64 kernel launched; the Dahlquist README golden and
             Diffusion2D (n = 8) against the float64 history, in DD;
20. observe  the solver's observability on the full spectral TOMS solve:
             ``profile_phases`` (the JAX package's keys, every time
             positive, the next solve bit for bit a solve's without it),
             ``solve_profiled``'s trace (it must name K1-K4's kernels),
             and a compiled max-C-point-jump criterion against ``solve()``
             with the condensed carry declined, its wall and peak memory
             against the condensed solve's;
21. callback ``CallbackApplication`` stepping Heat1D (nx = 129, nt = 257,
             4/4) on the host with scipy, against the port's Heat1D on
             the card, one round trip each way a batched call;
22. machine  the induction machine against a mock GetDP it writes into a
             temporary directory (``MOCK_GETDP``): ``MgritMachineConvJl``
             in ``solve`` and ``solve_compiled`` against each other,
             ``MACHINE_JAX`` and the sequential march, ``MgritMachine``'s
             PWM flag on the mock's argv log, and the machine on the two
             fixture meshes through ``GridTransferMachine`` against
             ``TWO_MESH_JAX``;
23. shard    the time-sharded executor (``pymgrit_tpu_torch.parallel``): the
             TOMS solve at P = 1 in an NCCL world of one (solve and
             solve_compiled with kernels, once with the plain versions,
             against the serial condensed history, fine_solution against
             the serial tube), then two gloo processes on cuda:0 (the
             collectives staged through pinned host buffers): TOMS against
             P = 1, ShardedAtMgrit(64) on the TOMS width with two levels
             against the serial AtMgrit(64), the varying-coarsening golden
             (the general path) and dd_toms129 against the JAX history;
             every rank's history equal to rank 0's bit for bit; walls,
             launches per rank, collectives and bytes (moved, staged) per
             iteration, peak memory per rank;
24. space    a ('time', 'space') grid: four gloo processes on cuda:0 at
             (2, 2), each cell also at (2, 1) and serially: Heat2D
             (spectral TOMS at width 130, the physical pencil, spectral
             AtMgrit(64)), then the periodic models on row slabs
             (Allen-Cahn IMEX at bench.py's row and CN, Gray-Scott
             AtMgrit(8) IMEX and IMPL at 128^2, Burgers2D at 64^2; nt
             and iterations cut, ``SPACE_AC`` ...): the Hartley pencil
             on K20, K11/K14/K15 in their halo and prologue modes; every
             rank equal to rank 0, the histories within the floor of
             (2, 1) and of the serial solve, every rank's Newton and
             Krylov counts those of (2, 1); walls, peak memory,
             launches by mode, collectives a rank an iteration.

``python3 chip_smoke.py --kernels=interval_affine,interpolate_combine`` runs
phases 1-3 (and ``[dd-kernels]``) for the named kernels alone (float64 and
float32) and ends in
``{"kernels_only": true, ...}``, never the ``"ok"`` of a full run.

``python3 chip_smoke.py --profile`` runs phases 1-2 and then one profiled
solve of each configuration of phases 11-13, of Allen-Cahn's IMPL and CN
runs (with K11's wrapper time a call; K14's in Gray-Scott IMPL, K15's in
Burgers2D), of the Brusselator (K13's) and of the spectral and physical
TOMS solves, the ragged row, the spatial row, the BDF example, the
`[coarsest]` AtMgrit solve, the two DD rows (with K23's, K24's and K25's
wrapper time a call) and the deep diffusion grid (``torch.profiler``): device
busy and idle share, the leading device ops, the device time of K1, K2,
K4-K7, K10, K11, K14-K16, K25 and the row kernels,
launches and syncs.  It compares and checks
nothing, so its last line is ``{"profile": true, ...}`` and never the
``"ok"`` of a checked run.

Each phase prints one line (phase 3 one per case); any failure raises and
exits non-zero.  The line before the last is the card again; the last line
is the JSON result.  Numbers are measured in this run on this card.
"""

import json
import math
import os
import re
import shutil
import stat
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20240917
DEVICE = "cuda"     # every tensor of phases 3-5 lives here

TOMS = dict(nx=129, nt=2 ** 14 + 1, ms=(32, 16, 4, 4))
SMALL = dict(nx=17, nt=129, ms=(4, 4))
CN_CFG = dict(nx=129, nt=2 ** 11 + 1, ms=(32, 16, 4))
# FE is stable on every level of this grid: coarsest dt = 4/1024 = dx^2/(4a)
FE_CFG = dict(nx=9, nt=65, ms=(2, 2), t_end=1.0 / 16)
MAIN_TOL, MAIN_MAX_ITER = 1e-10, 30
SMALL_MAX_ITER = 5
FE_MAX_ITER = 8
# bench.py's run_atmgrit_equal_accuracy_row: Dahlquist BE, lambda = -1, two
# levels with m = 8, coarsest dt 0.2, AT window k = 128, three iterations;
# cut in depth from the row's nt = 2^19 + 1 to 2^16 + 1 (same dt), to keep
# the run's time: the port's sequential scan is a Python loop of one
# batched step a point
DAHLQUIST = dict(nt=2 ** 16 + 1, t_end=1638.4, m=8, k=128, max_iter=3)
# the coarse tube of phase 3's Dahlquist cases (K8, K9): the row's
# coarsest level at nt = 2^17 + 1, whatever the phase's depth
DAHLQUIST_CASE_NT = 2 ** 14 + 1
# bench.py's run_atmgrit_coarsest_row at the TOMS width: two levels, m = 8
TOMS2 = dict(nx=129, nt=2 ** 14 + 1, ms=(8,))
TOMS2_AT_K, TOMS2_AT_ITERS = 64, 3
# AT against the scan on Dahlquist: the bench's own check (bench.py:698-700);
# the window truncation is (1/1.2)^128 ~ 7e-11 relative
AT_SCAN_RTOL = 1e-3
# tests/core/test_solver_goldens_2.py::test_at_mgrit_golden, at its rtol
AT_GOLDEN, AT_GOLDEN_RTOL = np.array([0.1767778, 0.01223507]), 1e-3

# Kernel against plain version, normwise: max|k - p| / max|p|.  Kernels that
# contract a*b + c into one FMA (nvcc's default --fmad=true) or sum in
# another order (K3) agree with the plain versions to
# rounding, not bitwise: a few ulp per operation, or a blocked sum of 16129
# terms (K3).
KERNEL_RTOL = {"float64": 1e-13, "float32": 1e-5}
# Small config, CPU plain against GPU kernels: histories to rtol 1e-10, with
# an atol at the float64 residual floor (FMA moves each residual by ulps).
SMALL_RTOL = 1e-10
# Main path, GPU kernels against GPU plain versions: rtol 1e-9, with the same
# floor as atol.
MAIN_RTOL = 1e-9
FLOOR_OPS = 8      # rounded operations per residual entry in the floor bound
# The physical basis rounds through four length-n products per step (n =
# nx - 2), each adding ~sqrt(n) roundings of independent sign to an entry:
# its floor counts 4 sqrt(n) + 8 operations.  Against the spectral history
# the physical one is held to the JAX package's own physical-vs-spectral
# tolerance, rtol 1e-6 (tests/models/test_heat2d_spectral.py), plus that
# floor.
PHYS_SPEC_RTOL = 1e-6
PHYSICAL_KERNELS = ("sine_solve2d", "sine_affine2d", "theta_rhs2d", "residual_row_norms",
                    "cpoint_combine")
# bench.py's run_allen_cahn_row: 128^2, IMEX, t in [0, 0.032], nt = 4097,
# three levels (coarsening 8/8), tol 1e-300, five iterations
AC_BENCH = dict(nx=128, method="IMEX", t_stop=0.032, nt=4097, ms=(8, 8), tol=1e-300, max_iter=5)
# the reference's first iteration on that row, measured on the CPU
# (BENCH_BASELINE_CACHE.json "allen_cahn4097"); held at rtol 1e-6
AC_BENCH_REF_ITER1, AC_REF_RTOL = 0.6997827923616363, 1e-6
# examples/example_allen_cahn.py (IMPL, two levels, m = 4, tol 1e-7) and CN
# at the same short horizon, which converges
AC_IMPL = dict(nx=128, method="IMPL", t_stop=0.024, nt=33, ms=(4,), tol=1e-7, max_iter=10)
AC_CN = dict(AC_IMPL, method="CN")
# examples/example_arenstorf.py, examples/example_convergence_criterion.py
# (golden of tests/models/test_arenstorf_parity.py), and the Brusselator of
# tests/core/test_solver_goldens.py with its golden and rtol
T_ORBIT = 17.06521656015796
ARENSTORF = dict(nt=80001, m=320, cf_iter=0, tol=1e-2)
CRITERION = dict(nt=10001, m=100, tol=1)
CRITERION_ITER1, CRITERION_RTOL = 14439.989448185017, 1e-8
BRUSSELATOR = dict(nt=641, m=20, tol=1e-10)
BRUSSELATOR_GOLDEN, BRUSSELATOR_RTOL = np.array([0.0142, 8.20e-5, 1.13e-7, 3.36e-10]), 5e-3
# Arenstorf is chaotic: iteration 1 of the orbit's history, kernels against
# plain and GPU against CPU, at the custom criterion's golden tolerance;
# the C-point states at rtol 1e-6 of the orbit's scale
ORBIT_RTOL, ORBIT_STATE_RTOL = 1e-8, 1e-6
# K12 integrates adaptively: its decisions follow the plain version's, but
# the orbit amplifies the contracted roundings of the stages (f64: up to
# 1e-13 on phase 3's cases on an NVIDIA H100); in f32
# the error estimate sits at float32 rounding and decisions flip, each flip
# moving a step by up to a few of the controller's rtol 1e-3
KERNEL_RTOL_BY_NAME = {"dopri45_arenstorf": {"float64": 1e-12, "float32": 1e-2}}
# K12's dependent chain, counted from csrc/dopri45_arenstorf.cu: the
# operations on the longest path, by kind (an FMA, add or multiply; CUDA's
# division, square root and pow, each timed by the latency probe).  An
# attempt: six right-hand sides, each the stage's last FMA and y + h dy,
# y1^2, s = p^2 + y1^2, sqrt(s), s sqrt(s), a division, two subtractions;
# the error norm (the last weight, x h, a division, the sum of squares,
# / 4, a root); the step factor (pow(err, -0.2), the product, the clamp,
# h_abs x factor, min(h_abs, t1 - t)).  A step adds Hairer's initial step:
# two right-hand sides, three norms, h0's and d2's divisions, a pow.
K12_CHAIN_ATTEMPT = dict(fma=53, div=7, sqrt=7, pow=1)
K12_CHAIN_STEP = dict(fma=30, div=6, sqrt=4, pow=1)
AC_KERNELS = {"IMEX": ("periodic_solve2d",), "IMPL": ("periodic_solve2d", "allen_cahn_pointwise"),
              "CN": ("periodic_solve2d", "allen_cahn_pointwise")}
SPECTRAL_KERNELS = ("interval_affine", "theta_chain", "residual_row_norms", "cpoint_combine")
COARSEST_KERNELS = ("affine_prefix", "affine_windows")
# examples/at_mgrit/example_at_mgrit_gray_scott.py at the reference's width
# and depth (its comments: NX 128, NT 2**14): IMEX on [0, 8], three levels
# 16385 / 1025 / 257 (coarsening 16/4), AtMgrit(k=8), tol 1e-7, capped at
# max_iter iterations; IMPL (Newton-BiCGStab) on a short horizon; EXPL on a
# grid stable on every level (coarsest dt 0.25 <= dx^2 / (8 du) = 0.38)
GS_AT = dict(nx=128, method="IMEX", t_stop=8.0, nt=2 ** 14 + 1, ms=(16, 4), k=8, tol=1e-7,
             max_iter=12)
GS_IMPL = dict(nx=128, method="IMPL", t_stop=8.0, nt=33, ms=(4,), tol=1e-7, max_iter=10)
GS_EXPL = dict(nx=128, method="EXPL", t_stop=8.0, nt=513, ms=(4, 4), tol=1e-7, max_iter=10)
GS_COEF = dict(du=8e-5, dv=4e-5, a=0.024, b=0.084)      # GrayScott2D's defaults
# the demo's Parareal run (two levels, cf_iter = 0) at the same size, whose
# C-points are held against the sequential march
GS_PARAREAL = dict(GS_AT, ms=(16,), max_iter=10)
# examples/example_burgers.py (Burgers1D nx = 128, nu = 0.02, nt = 65, m = 4,
# tol 1e-8) and its history from the JAX package on the CPU (float64,
# measured when this phase was written); a deeper Burgers1D grid whose level
# 0 runs K16 on 256 lanes; Burgers2D at the JAX default nx = 64
BURGERS_EX = dict(nx=128, nu=0.02, t_stop=1.0, nt=65, ms=(4,), tol=1e-8, max_iter=100)
BURGERS_GOLDEN = np.array([0.026734549894857684, 0.001919905812316594, 0.00010347363345991814,
                           4.867841252871992e-06, 2.929102166993383e-07, 1.0581693788509958e-08,
                           1.164493119669576e-10])
BURGERS_DEEP = dict(nx=128, nu=0.02, t_stop=1.0, nt=4097, ms=(16, 16), tol=1e-8, max_iter=10)
BURGERS_2D = dict(nx=64, nu=0.05, t_stop=0.5, nt=17, ms=(4,), tol=1e-8, max_iter=10)
# examples/example_advection.py (nx = 129, nt 129 / 65, FCF, no nested
# iteration, tol 1e-7) and its JAX history (CPU, float64); a deeper grid
# whose level 0 runs K17 on 4096 lanes
ADVECTION_EX = dict(nx=129, nt=129, ms=(2,), tol=1e-7, max_iter=100)
ADVECTION_GOLDEN = np.array([0.037335188578707254, 0.003945783784051717, 0.0006657546923948921,
                             0.00014133471106459255, 3.1165050341693756e-05,
                             6.834139864526759e-06, 1.4709941457482217e-06,
                             3.0733746503941436e-07, 6.176127206792768e-08])
ADVECTION_DEEP = dict(nx=129, nt=2 ** 14 + 1, ms=(4, 4, 4), tol=1e-7, max_iter=10)
# a model's history against the JAX package's: rtol 1e-8 with the float64
# floor (the two packages round their solves differently)
GOLDEN_RTOL = 1e-8
# bench.py's spatial65 row (run_spatial_row, CONFIGS["base65"]): Heat2D
# physical, spatial sizes 65/33/17/9, nt = 4097, coarsening 4/4/4, FCF,
# condensed level 0, tol 1e-300 (five iterations); its history from the
# JAX package on the CPU (float64, measured when this phase was written)
SPATIAL = dict(sizes=(65, 33, 17, 9), nt=4097, ms=(4, 4, 4), tol=1e-300, max_iter=5)
SPATIAL_JAX = np.array([0.002975422173066239, 0.00021810992106929722, 1.4544992642190462e-05,
                        9.954000009896153e-07, 6.922021547896727e-08])
# examples/example_spatial_coarsening.py: Heat1D 17/9/5/5 points on [0, 2],
# nt = 129, coarsening 2/2/2, GridTransferHeat on the first two pairs;
# tests/core/test_solver_goldens_2.py::test_spatial_coarsening's golden
# (rtol 2e-3) and the JAX package's history (CPU, float64)
SPATIAL1D_GOLDEN, SPATIAL1D_GOLDEN_RTOL = np.array([3.3795e-2, 2.9794e-3, 3.2555e-4, 4.0429e-5,
                                                    4.9316e-6, 6.1785e-7, 7.7088e-8]), 2e-3
SPATIAL1D_JAX = np.array([0.03379534189415516, 0.0029793978719819237, 0.0003255502806465037,
                          4.042946916027581e-05, 4.931580578188496e-06, 6.178527942871324e-07,
                          7.708784684451865e-08])
# bench.py's toms257 physical row in its nt = 4097 fallback (run_xl_row:
# 257^2, coarsening 32/16/4), cut to two iterations: K5 and K6 run past the
# one-tile side (interior 255 > 128)
TOMS257 = dict(nx=257, nt=4097, ms=(32, 16, 4), tol=1e-300, max_iter=2)
TRANSFER_KERNELS = ("restrict_combine", "interpolate_combine")
SPATIAL_AB_PAIRS = 6      # fused hooks against the unfused route on spatial65
SPATIAL_KERNELS = ("sine_solve2d", "sine_affine2d", "theta_rhs2d", "residual_row_norms")
SPATIAL1D_KERNELS = ("restrict_combine", "interpolate_combine", "sine_solve1d",
                     "residual_row_norms", "cpoint_combine")
SLICE_KERNELS = {"gray_scott": {"IMEX": ("periodic_solve2d",),
                                "IMPL": ("periodic_solve2d", "gray_scott_pointwise"),
                                "EXPL": ("gray_scott_pointwise",)},
                 "Burgers1D": ("burgers1d_newton",),
                 "Burgers2D": ("periodic_solve2d", "burgers2d_pointwise"),
                 "Advection1D": ("circulant_solve1d",)}
# bench.py's ragged_nonuniform row (run_ragged_row): Heat2D physical 65^2,
# nt = 4097, level-1 C-points at stride 8 moved by up to +-3
# (np.random.default_rng(0)), then [::4] and [::4]: levels 4097 / 515 / 129
# / 33 (levels 0 and 1 non-uniform), zero initial condition, tol 1e-300,
# three iterations; its history from the JAX package (CPU, float64;
# tests/test_torch_chip_histories.py recomputes it)
RAGGED = dict(nx=65, nt=4097, stride=8, jitter=3, seed=0, tol=1e-300, max_iter=3)
RAGGED_JAX = np.array([0.0005997708663602085, 5.004357263633654e-05, 4.740011698572717e-06])
RAGGED_KERNELS = ("indexed_combine", "sine_solve2d", "theta_rhs2d", "residual_row_norms")
# tests/core/test_solver_goldens_2.py::test_varying_coarsening (Dahlquist,
# a run of adjacent C-points on level 0) and its golden at the reference's rtol
VARYING_IDX = [0, 3, 10, 12, 14, 17, 23, 27, 33, 34, 55, 57, 59, 61, 63, 64]
VARYING_GOLDEN = np.array([3.7312e-2, 3.1242e-3, 3.1292e-5, 1.8515e-7, 4.9959e-10, 4.8216e-13])
# examples/example_heat_1d_bdf2.py: Heat1DBDF2 / BDF1 / BDF1 pair states,
# nx = 1001 (999 interior points), nt = 512 time points on [0, 2] grouped in
# pairs: pair grids of 257 / 129 / 65 points (level 0: 128 lanes); tol 1e-7;
# its history from the JAX package (CPU, float64; recomputed by
# tests/test_torch_chip_histories.py)
BDF = dict(nx=1001, nt=512, t_stop=2.0, tol=1e-7, max_iter=100)
BDF_JAX = np.array([0.0010946421490864355, 7.547288987998757e-05, 5.233458803278994e-06,
                    3.632980652140187e-07, 2.5073381705149255e-08])
# examples/example_diffusion_2d.py: Diffusion2D n = 20 (N = 6 n^2 = 2400
# degrees of freedom), nt 17 / 9, tol 1e-7, and its JAX history (CPU,
# float64; recomputed by tests/test_torch_chip_histories.py); then a deeper two-level grid, nt = 1025 with m = 8 (128 lanes x 7
# steps on level 0), kernels against plain
# [pytree] (C4, C5): the multi-leaf and state_norm applications of
# pytree_app, each case (kind, grids, solve entry, conv_crit); PYTREE_JAX:
# the JAX package's histories (tests/test_torch_chip_histories.py
# recomputes them), held at PYTREE_RTOL with the float64 floor as atol
PYTREE = dict(nt=33, m=4, tol=1e-13, max_iter=8)
PYTREE_CASES = {"dict m=4": ("dict", "uniform", "solve_compiled", 0),
                "tuple ragged": ("tuple", "ragged", "solve", 1),
                "max-norm m=4": ("vector", "uniform", "solve_compiled", 2)}
PYTREE_JAX = {
    "dict m=4": np.array([0.003763578619013627, 0.0001650078773609116, 2.6995093246776345e-06,
                          2.44389613438953e-16]),
    "tuple ragged": np.array([0.11221888366157023, 0.007327793184304115, 0.0003285196032959578,
                              8.830338297792439e-06, 1.333413088687199e-07,
                              9.893412437313776e-10, 2.5455612295462345e-12,
                              1.1658167788096346e-15]),
    "max-norm m=4": np.array([0.00041355167584608907, 1.2876276710503649e-05,
                              1.4259587424622235e-07, 1.9292121753525021e-16])}
PYTREE_RTOL = 1e-12
DIFFUSION = dict(n=20, nts=(17, 9), tol=1e-7, max_iter=100)
DIFFUSION_JAX = np.array([0.004854124361638421, 0.00015798615095824288, 2.7488539064243935e-06,
                          1.7515845464831638e-14])
DIFFUSION_DEEP = dict(n=20, nt=1025, m=8, tol=1e-9, max_iter=10)
MASS_RTOL = 1e-10
# K22 sums two length-2400 products per entry in another order than cuBLAS
# (DMMA's k4 groups, or FFMA in f32): ~sqrt(N) roundings of independent sign
KERNEL_RTOL_BY_NAME["eig_step"] = {"float64": 1e-12, "float32": 1e-4}
# precision='dd' ([dd]): bench.py's dd_toms129 row (Heat2D 129^2 spectral,
# nt = 16385, 32/16/4/4, 14 iterations) and its dd65 row (physical 65^2,
# nt = 4097, 4/4/4, tol 1e-10)
DD_TOMS = dict(nx=129, nt=2 ** 14 + 1, ms=(32, 16, 4, 4), tol=0.0, max_iter=14)
DD65 = dict(nx=65, nt=4097, ms=(4, 4, 4), tol=1e-10, max_iter=14)
# their histories in the JAX package on the CPU (recomputed by
# tests/test_torch_chip_histories.py): 1e-10 at iteration 9, then the DD floor
DD_TOMS_JAX = np.array([0.03031408041715622, 0.0014784247614443302, 9.209801646647975e-05,
                        6.1574983192258514e-06, 4.144012279994058e-07, 2.885895789006554e-08,
                        2.1798611804513257e-09, 1.5679567366699843e-10, 9.348763950478567e-12,
                        5.361147723675908e-13, 2.7546264965219724e-13, 2.794933609637923e-13,
                        2.6562655070297425e-13, 2.7688271055266445e-13])
DD65_JAX = np.array([0.0029827668331563473, 0.00019982218509539962, 1.4706996807944961e-05,
                     1.122591470448242e-06, 8.738655310480681e-08, 6.885314984828028e-09,
                     5.46690359648494e-10, 4.356228919255578e-11])
# a DD history is a float32 norm of a residual that carries rounding noise
# at the DD floor: held to JAX at rtol 1e-5 plus a quarter of JAX's
# dd_toms129 floor, 6.6e-14 (the port's CPU runs differ by 2.7e-14 at
# dd_toms129's iteration 8, 1.568e-10, and by 2.1e-14 at dd65's last); floor iterations (10-14 of dd_toms129) within 10x of JAX's,
# never below 1e-14 (a lower floor is a float64 state, not DD)
DD_RTOL, DD_FLOOR_FACTOR, DD_FLOOR_MIN = 1e-5, 10.0, 1e-14
DD_ATOL = 0.25 * DD_TOMS_JAX[9:].min()
DD_TOMS_FLOOR_FROM = 9          # iterations 10-14 sit at the floor
DD_DAHLQUIST_GOLDEN = np.array([7.186185937e-05, 1.2461067e-06, 2.1015566e-08, 3.1441273e-10,
                                3.975e-12])
DD_DIFFUSION = dict(n=8, nts=(17, 9), tol=1e-11, max_iter=10)
# kernels a DD solve must not launch (the float64 paths' kernels)
DD_FORBIDDEN = ("interval_affine", "theta_chain", "cpoint_combine", "sine_solve2d",
                "sine_affine2d", "theta_rhs2d", "restrict_combine", "interpolate_combine",
                "eig_step")
# K26 sums float64 products in DMMA's k4 groups, torch.matmul in cuBLAS's
# order: within 1e-14 of the largest |A| |B| entry
DD_MATMUL_RTOL = 1e-14
# [observe]: profile_phases (the JAX package's keys), solve_profiled's trace
# (which must name K1-K4) and a max-C-point-jump compiled criterion on the
# full spectral TOMS solve (TOMS, MAIN_TOL, MAIN_MAX_ITER)
OBSERVE_SYMBOLS = ("interval_affine_kernel", "theta_chain_kernel", "residual_row_norms_kernel",
                   "cpoint_combine_kernel")
OBSERVE_RTOL = 1e-10
# [callback]: a CallbackApplication stepping Heat1D by backward Euler on
# the host (a dense LU a step size), against the port's Heat1D (K20)
CALLBACK = dict(nx=129, nt=257, ms=(4, 4), t_stop=2.0, tol=1e-9, max_iter=8)
CALLBACK_RTOL = 1e-9
# [machine]: the induction machine against a mock GetDP (backward Euler on
# u' = -u + 1, one sub-step per dtime, the protocol of
# tests/models/test_induction_machine_e2e.py); MACHINE_JAX: the JAX
# package's MgritMachineConvJl history (tests/test_torch_induction_machine.py
# recomputes it)
MACHINE = dict(nts=(9, 3), t_stop=0.8, tol=1e-6, max_iter=6)
MACHINE_PWM = dict(nts=(5, 3), t_stop=0.8, tol=1e-12, max_iter=1)
MACHINE_JAX = np.array([100.0, 18.757691435941737, 0.0])
# two meshes (tests/models/fixtures/im: the middle leaf 64 unknowns on level
# 0, 32 on level 1, GridTransferMachine between them), two iterations of
# Mgrit with the machine's state_norm: the JAX package's history
# (tests/test_torch_induction_machine.py recomputes it)
TWO_MESH_JAX = np.array([0.5835742134951456, 0.4900747706315435])
MACHINE_RTOL = 1e-10
MACHINE_MIDDLE = 5                          # unknowns in the mock's grid .pre
MOCK_GETDP = '''#!{python} -S
"""Mock GetDP: the CLI surface InductionMachine.run_getdp drives.
Dynamics: backward Euler on u' = -u + 1, one sub-step per dtime."""
import os
import sys

NUM_DOFS = {num_dofs}
LOG = {log!r}

with open(LOG, "a") as f:
    f.write(" ".join(sys.argv[1:]) + chr(10))

if "--version" in sys.argv:
    sys.stdout.write("mock-getdp 2.10.0" + chr(10))
    sys.exit(0)


def opt(flag):
    return sys.argv[sys.argv.index(flag) + 1]


def setnum(name):
    for i, a in enumerate(sys.argv):
        if a == "-setnumber" and sys.argv[i + 1] == name:
            return float(sys.argv[i + 2])
    raise SystemExit("missing -setnumber " + name)


name = opt("-name")
res = opt("-res")
timemax = setnum("timemax")
dtime = setnum("dtime")

if "-pre" in sys.argv:
    # get_preresolution reads the 6th line after $DofData, last field
    lines = ["$Resolution /* mock */", "1 1", "$EndResolution",
             "$DofData  /* #0 */", "1 1", "0", "0", "0",
             "1 %d" % NUM_DOFS, "$EndDofData"]
    with open(name + ".pre", "w") as f:
        f.write(chr(10).join(lines) + chr(10))
    sys.exit(0)

# -restart: read the step-0 seed written by set_resolution
with open(res) as f:
    content = f.readlines()
i = next(k for k, s in enumerate(content) if "$Solution" in s)
t0 = float(content[i + 1].split()[1])
u = [float(s.split()[0]) for s in content[i + 2:i + 2 + NUM_DOFS]]

n = max(1, int(round((timemax - t0) / dtime)))
blocks = []
t = t0
for k in range(1, n + 1):
    t = t0 + k * dtime
    u = [(x + dtime) / (1.0 + dtime) for x in u]
    blocks.append("$Solution  /* DofData #0 */")
    blocks.append("0 %r 0 %d" % (t, k))
    blocks += ["%r 0" % x for x in u]
    blocks.append("$EndSolution")
with open(res, "a") as f:
    f.write(chr(10) + chr(10).join(blocks) + chr(10))

jl = sum(x * x for x in u)
outdir = os.path.dirname(name)
scal = {{"JL": jl, "Ia": 1.0, "Ib": 2.0, "Ic": 3.0,
         "Ua": 4.0, "Ub": 5.0, "Uc": 6.0, "Tr": 7.0}}
for suffix, val in scal.items():
    with open(os.path.join(outdir, "res%s.dat" % suffix), "w") as f:
        f.write("0 %r %r" % (t, val) + chr(10))
sys.exit(0)
'''
# H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s and the peak rates of
# the units that could do the kernels' operations (FP64 and FP32 outside the
# tensor cores; FP64 on the tensor cores, DMMA, for dense products)
HBM_BYTES_PER_S = 3.35e12
# its L2 holds 50 MB: device_ms reads three times that before each timed
# launch, so that the launch finds none of its operands there
L2_FLUSH_BYTES = 3 * 50 * 2 ** 20
_FLUSH = []
# phase 3 times each row case in this many rounds (5 until the script
# neared its time limit; the cold-L2 device time is taken apart)
ROW_ROUNDS = 2
# the solve walls: one fresh kernel solve, then one plain (no check reads
# them; until the script neared its time limit, plain, kernel, kernel,
# plain, and six such pairs in the cells K5 carries)
WALL_ORDER = ("kernel", "plain")
E2E_ORDER = WALL_ORDER
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}
PEAK_DMMA_OPS_PER_S = 67e12
# the kernels whose operations are dense FP64 products, which the tensor
# cores could run: the sine transforms of K5, K6 and K20, K10's Hartley
# transforms, K22's eigenbasis products and K26's DD products
PRODUCT_KERNELS = ("sine_solve2d", "sine_affine2d", "periodic_solve2d", "sine_solve1d",
                   "eig_step", "dd_matmul", "sine_solve1d_lam_table", "sine_solve1d_hartley",
                   "sine_solve1d_hartley_lam_table")
DD_FP32_KERNELS = ("dd_interval_affine", "dd_theta_chain", "dd_arith")


def fail(msg):
    raise SystemExit("chip_smoke FAILED: " + msg)


def check(cond, msg):
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# problem setup (the bench's TOMS problem, built per level like bench.py)
# ---------------------------------------------------------------------------

def rhs(x, y, t):
    return np.sin(np.pi * x) * np.sin(np.pi * y) * np.ones_like(t * x * y)


def init_cond(x, y):
    return np.sin(np.pi * x) * np.sin(np.pi * y)


def build_problem(P, nx, nt, ms, device, ops, method="BE", basis="spectral", t_end=1.0,
                  precision=None):
    t = np.linspace(0, t_end, nt)
    problem, stride = [], 1
    for lvl in range(len(ms) + 1):
        problem.append(P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=nx, ny=nx,
                                a=1.0, rhs=rhs, init_cond=init_cond, t_interval=t[::stride],
                                basis=basis, method=method, device=device, ops=ops,
                                precision=precision))
        if lvl < len(ms):
            stride *= ms[lvl]
    return problem


def count_fine_steps_per_iter(mgrit, first):
    """Fine-level Phi evaluations per MGRIT iteration (bench.py's count)."""
    info = mgrit.levels[0]
    nf = info.fpts.size
    nc1 = info.cpts.size - 1
    steps = nf if first else 0
    steps += mgrit.cf_iter[0] * (nc1 + nf)
    return steps + nc1 + nf + nc1


def residual_floor(mgrit, ops=FLOOR_OPS):
    """float64 floor of the residual history: ``ops`` roundings of every
    C-point value, in the 2-norm over C-points and coefficients (read at the
    level's C-points, evenly strided or not)."""
    import torch
    u0 = mgrit.u[0]
    u_c = u0[torch.as_tensor(mgrit.levels[0].cpts, device=u0.device)]
    return ops * float(torch.finfo(torch.float64).eps) * float(torch.linalg.vector_norm(u_c))


def physical_floor(mgrit):
    return residual_floor(mgrit, 4 * math.sqrt(mgrit.problem[0].nx - 2) + FLOOR_OPS)


def histories_agree(h, ref, atol, rtol):
    """(ok, max abs diff): same length and |h - ref| <= atol + rtol |ref|."""
    if h.shape != ref.shape:
        return False, float("inf")
    err = np.abs(h - ref)
    return bool(np.all(err <= atol + rtol * np.abs(ref))), float(err.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), "nvidia-smi failed: " + smi.stderr)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    import pymgrit_tpu_torch
    pkg = Path(pymgrit_tpu_torch.__file__).resolve().parent
    check(pkg == ROOT / "pymgrit_tpu_torch", f"imported {pkg}, not the package beside this script")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | python {sys.version.split()[0]}")
    return card


def phase_build():
    from pymgrit_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    seconds = time.perf_counter() - t0
    regs = [ln.strip() for ln in _build.build_log().splitlines() if "registers" in ln]
    print(f"[build] nvcc sm_90a libpymgrit_kernels.so in {seconds:.2f} s "
          f"(nvcc {_build.build_seconds}) | ptxas: {' ; '.join(regs)}")
    print("[build] K1 / K18 / K19 / K21 (csrc/interval_affine.cu, restrict_combine.cu, "
          "interpolate_combine.cu, indexed_combine.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B"
                       for name, (regs, st, ld, _) in ptxas(_build.build_log(), ROW_NAME,
                                                            row_label).items()))
    k35 = ptxas(_build.build_log(), K3_K5_NAME, k3_k5_label)
    print("[build] K3 / K5 / K6 / K7 (csrc/residual_row_norms.cu, sine_solve2d.cu and "
          "sine_affine2d.cu on sine2d_dmma.cuh, theta_rhs2d.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B"
                       for name, (regs, st, ld, _) in k35.items()))
    k1011 = ptxas(_build.build_log(), K10_K11_NAME, k10_k11_label)
    print("[build] K10 / K11 (csrc/periodic_solve2d.cu on sine2d_dmma.cuh, "
          "allen_cahn_pointwise.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B"
                       for name, (regs, st, ld, _) in k1011.items()))
    # K10's eight f64 one-tile kernels (T = 16-128, prologue by cp.async or
    # formed), its rhs pass (three prologues) and its f32 FFMA kernel;
    # K11's sixteen (f64 / f32 x four modes x vectors or scalars; the halo
    # modes are the whole-state kernels with halo pointers)
    for prefix, n in {"K10 f64": 11, "K10 f32": 1, "K11": 16}.items():
        ks = [k for k in k1011 if k.startswith(prefix)]
        check(len(ks) == n and all(k1011[k][1] == 0 and k1011[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k1011}")
    k1415 = ptxas(_build.build_log(), K14_K15_NAME, k14_k15_label)
    print("[build] K14 / K15 (csrc/gray_scott_pointwise.cu, burgers2d_pointwise.cu on "
          "periodic_pointwise.cuh), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B"
                       for name, (regs, st, ld, _) in k1415.items()))
    # K14's twenty (f64 / f32 x EXPL, EXPL + g, residual, jacobian, prologue
    # x vectors or scalars) and K15's eight (f64 / f32 x two modes x vectors
    # or scalars)
    for prefix, n in {"K14": 20, "K15": 8}.items():
        ks = [k for k in k1415 if k.startswith(prefix)]
        check(len(ks) == n and all(k1415[k][1] == 0 and k1415[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k1415}")
    k24 = ptxas(_build.build_log(), K2_K4_NAME, k2_k4_label)
    print("[build] K2 / K4 (csrc/theta_chain.cu, K4 on K21's row body in indexed_combine.cu), "
          "ptxas: " + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B"
                                 for name, (regs, st, ld, _) in k24.items()))
    # K2's sixteen kernels (f64 / f32 x BE / CN x g or not x rhs time-independent
    # or tabulated) and K4's six (f64 / f32 x 1-3 terms)
    for prefix, n in {"K2": 16, "K4": 6}.items():
        ks = [k for k in k24 if k.startswith(prefix)]
        check(len(ks) == n and all(k24[k][1] == 0 and k24[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k24}")
    k924 = ptxas(_build.build_log(), K9_K24_NAME, k9_k24_label)
    print("[build] K9 / K24 (csrc/affine_windows.cu, dd_theta_chain.cu), "
          "ptxas: " + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B, "
                                 f"static smem {sm} B"
                                 for name, (regs, st, ld, sm) in k924.items()))
    # K9's eight kernels (f64 / f32 x Q = 1, 32 lanes a thread x A, b with
    # rows or broadcast) and K24's twelve (chains of steps: BE / CN x g or
    # not x rhs time-independent or tabulated; one step: BE / CN x g or not)
    for prefix, n in {"K9": 8, "K24": 12}.items():
        ks = [k for k in k924 if k.startswith(prefix)]
        check(len(ks) == n and all(k924[k][1] == 0 and k924[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k924}")
    k1323 = ptxas(_build.build_log(), K13_K23_NAME, k13_k23_label)
    print("[build] K13 / K23 (csrc/rk4_brusselator.cu, dd_interval_affine.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B, static "
                       f"smem {sm} B" for name, (regs, st, ld, sm) in k1323.items())
          + " (K23's dynamic smem: JB x 4096 + 8192 B, 8192 B streamed)")
    # K13's four kernels (f64 / f32 x g or not) and K23's six (JB = 4, 2, 1
    # intervals a group x the seeds in shared memory or streamed)
    for prefix, n in {"K13": 4, "K23": 6}.items():
        ks = [k for k in k1323 if k.startswith(prefix)]
        check(len(ks) == n and all(k1323[k][1] == 0 and k1323[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k1323}")
    k812 = ptxas(_build.build_log(), K8_K12_NAME, k8_k12_label)
    print("[build] K8 / K12 (csrc/affine_prefix.cu, dopri45_arenstorf.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B, static "
                       f"smem {sm} B" for name, (regs, st, ld, sm) in k812.items()))
    # K8's 32 kernels (f64 / f32 x wide / narrow x A with rows or broadcast
    # x b alike x g or not) and K12's two (f64 / f32)
    for prefix, n in {"K8 ": 32, "K12 ": 2}.items():
        ks = [k for k in k812 if k.startswith(prefix)]
        check(len(ks) == n and all(k812[k][1] == 0 and k812[k][2] == 0 for k in ks),
              f"build: {n} {prefix}kernels must compile without spills: {k812}")
    k1625 = ptxas(_build.build_log(), K16_K25_NAME, k16_k25_label)
    print("[build] K16 / K25 (csrc/burgers1d_newton.cu, dd_arith.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B, static "
                       f"smem {sm} B" for name, (regs, st, ld, sm) in k1625.items())
          + " (K16's shared route: 8 n values a lane in dynamic shared memory, "
          + ", ".join(f"n = {n} {e}: {8 * n * b} B" for n, e, b in ((128, "f64", 8),
                                                                      (512, "f64", 8),
                                                                      (128, "f32", 4)))
          + ")")
    # K16's four kernels (f64 / f32 x shared memory or the device workspace)
    # and K25's sixty (fifteen ops, combine by its term count, x V = 1 or 4
    # x 32- or 64-bit indexing)
    for prefix, n in {"K16": 4, "K25": 60}.items():
        ks = [k for k in k1625 if k.startswith(prefix)]
        check(len(ks) == n and all(k1625[k][1] == 0 and k1625[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k1625}")
    # K5's five f64 kernels (one-tile T = 16-128, band), K6's five (one-tile
    # T = 16-128, the split band store) and K7's six (f64 / f32 x three modes)
    want = {"K5 f64": 5, "K6 f64": 5, "K7": 6}
    for prefix, n in want.items():
        ks = [k for k in k35 if k.startswith(prefix)]
        check(len(ks) == n and all(k35[k][1] == 0 and k35[k][2] == 0 for k in ks),
              f"build: {n} {prefix} kernels must compile without spills: {k35}")
    tiles = ptxas(_build.build_log(), TILE_OR_REDUCE, tile_label)
    print("[build] product tile (csrc/dmma_tile.cuh; K20 csrc/sine_solve1d.cu, K22, K26), "
          "ptxas: " + " ; ".join(
              f"{name}: {regs} registers, spill stores/loads {st}/{ld} B, static smem {sm} B"
              for name, (regs, st, ld, sm) in tiles.items())
          + " (dynamic smem: each case's plan)")
    # K20's eight tile instantiations (f64 / f32 x plain lanes on the skinny
    # and wide tiles, BE and BDF2 lanes on the skinny tile) and its two
    # reductions
    k20 = [k for k in tiles if k.startswith("K20")]
    check(len(k20) == 10 and all(tiles[k][1] == 0 and tiles[k][2] == 0 for k in k20),
          f"build: K20's 10 tile kernels must compile without spills: {tiles}")
    k17 = ptxas(_build.build_log(), K17_NAME, k17_label)
    print("[build] K17 (csrc/circulant_solve1d.cu), ptxas: "
          + " ; ".join(f"{name}: {regs} registers, spill stores/loads {st}/{ld} B"
                       for name, (regs, st, ld, _) in k17.items()))
    # K17's twelve kernels (f64 / f32 x the warp route's five register chunks
    # and the block route)
    check(len(k17) == 12 and all(v[1] == 0 and v[2] == 0 for v in k17.values()),
          f"build: K17's 12 kernels must compile without spills: {k17}")
    # K5 (float64), K22 and K26 run their f64 products on the FP64 tensor
    # cores (DMMA); no kernel of the library uses the other tensor-core paths
    # (HMMA: TF32 and below)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(_build._lib_dir / "libpymgrit_kernels.so")],
                          capture_output=True, text=True, timeout=300).stdout
    dmma, hmma, fn = {}, 0, ""
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
        elif "DMMA" in ln:
            key = tile_owner(fn)
            dmma[key] = dmma.get(key, 0) + 1
        hmma += "HMMA" in ln
    print(f"[build] cuobjdump -sass: DMMA instructions by kernel {dmma} (K5's, K6's and "
          f"K10's f64 kernels: one-tile by side (K10's also by load: cp.async or the formed "
          f"prologue), band past 128 (K5's, which K6's first product and K10's first three "
          f"share; the split last product of K6 and K10); K20 f64 by lanes and tile; K22 f64, "
          f"K26 DD products), {hmma} HMMA (TF32 and half precision: none expected)")
    k5_dmma = [k for k in dmma if k.startswith("sine_solve2d")]
    k6_dmma = [k for k in dmma if k.startswith("sine_affine2d")]
    k10_dmma = [k for k in dmma if k.startswith("periodic_solve2d")]
    k20_dmma = [k for k in dmma if k.startswith("sine_solve1d")]
    check(dmma.get("eig_step", 0) > 0 and dmma.get("dd_matmul", 0) > 0 and len(k5_dmma) == 5
          and len(k6_dmma) == 5 and len(k10_dmma) == 8 and len(k20_dmma) == 4
          and all(dmma[k] > 0 for k in k5_dmma + k6_dmma + k10_dmma + k20_dmma) and hmma == 0,
          f"build: DMMA {dmma} (each of K5's and K6's five f64 kernels, K10's eight one-tile "
          f"kernels (its band products are K5's and K6's), K20's four f64 tile kernels, K22 and "
          f"K26 must have some) and {hmma} HMMA in the SASS")


# tile_product<E, pair, BM, BN, BK, stages, min blocks, lanes> as mangled by
# nvcc (lanes: 0 K22 / K26, 1-3 K20's plain, BE and BDF2 lanes; a build
# before K20 ran on the tile had no lanes argument)
TILE_NAME = re.compile(r"tile_productI([df])Lb([01])ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E"
                       r"(?:Li(\d)E)?")
K20_LANES = ("plain", "rows", "BE", "BDF2")


def tile_owner(fn):
    """The kernel a SASS function belongs to: the product tile's float64
    instantiations are K22's or, by their lanes argument, K20's (by mode and
    tile), its double-double ones K26's; K5's, K6's and
    K10's float64 kernels by their tile side (K10's by its load too), the
    band kernel past 128 by its store (K5's, whose products K6's first one
    and K10's first three share; the split store of K6 and K10)."""
    k = K10_K11_NAME.search(fn)
    if k is not None and k.group(1) is not None:
        return f"periodic_solve2d T={k.group(1)} {'cp.async' if k.group(2) == '1' else 'formed'}"
    k = K3_K5_NAME.search(fn)
    if k is not None and k.group(2) is not None:
        return f"{k.group(1)} T={k.group(2)}"
    if k is not None and k.group(3) is not None:
        return "sine_affine2d band split" if k.group(4) == "1" else "sine_solve2d band"
    m = TILE_NAME.search(fn)
    if m is None:
        return fn
    if m.group(8) not in (None, "0"):
        return f"sine_solve1d {K20_LANES[int(m.group(8))]} {m.group(3)}x{m.group(4)}"
    return "dd_matmul" if m.group(2) == "1" else "eig_step"


# sine_solve2d_dmma_kernel<T> (K5 float64, tile side T) /
# sine_affine2d_dmma_kernel<T> (K6 float64) / band_product<SPLIT> (past 128:
# K5's four products and K6's first, SPLIT = 0; K6's last, SPLIT = 1) /
# residual_row_norms_kernel<T> (K3) / theta_rhs2d_kernel<T, MODE> (K7)
# (a build before the split store named the band kernel without a template
# argument: K5's)
K3_K5_NAME = re.compile(r"(sine_solve2d|sine_affine2d)_dmma_kernelILi(\d+)E|"
                        r"(band)_product(?:ILb([01])E)?|residual_row_norms_kernelI([df])E|"
                        r"theta_rhs2d_kernelI([df])Li(\d)E")


def k3_k5_label(m, ln):
    name, side, band, split, e3, e7, mode = m.groups()
    if side is not None:
        return f"{'K5' if name == 'sine_solve2d' else 'K6'} f64 T={side}"
    if band is not None:
        return "K6 f64 band split" if split == "1" else "K5 f64 band"
    if e3 is not None:
        return f"K3 {'f64' if e3 == 'd' else 'f32'}"
    return f"K7 {'f64' if e7 == 'd' else 'f32'} {('BE', 'CN', 'FE')[int(mode)]}"


# periodic_solve2d_dmma_kernel<T, ASYNC> (K10 float64) / periodic_rhs (K10's
# right-hand side pass) / periodic_solve2d_kernel<float> (K10 float32, FFMA)
# / allen_cahn_pointwise_kernel<T, MODE, V> (K11)
K10_K11_NAME = re.compile(r"periodic_solve2d_dmma_kernelILi(\d+)ELb([01])E|periodic_rhsILi(\d)E"
                          r"|periodic_solve2d_kernelI(f)E"
                          r"|allen_cahn_pointwise_kernelI([df])Li(\d)ELi(\d)E")


def k10_k11_label(m, ln):
    side, async_, rhs, f32, e11, mode, vec = m.groups()
    if side is not None:
        return f"K10 f64 T={side} {'cp.async' if async_ == '1' else 'formed'}"
    if rhs is not None:
        return f"K10 f64 rhs pass {('copy', 'Allen-Cahn', 'Gray-Scott')[int(rhs)]}"
    if f32 is not None:
        return "K10 f32 FFMA"
    return (f"K11 {'f64' if e11 == 'd' else 'f32'} "
            f"{('rhs', 'residual', 'jacobian', 'prologue')[int(mode)]} V={vec}")


# gray_scott_pointwise_kernel<T, MODE, G, V> (K14) /
# burgers2d_pointwise_kernel<T, MODE, V> (K15)
K14_K15_NAME = re.compile(r"(gray_scott|burgers2d)_pointwise_kernelI([df])Li(\d)E(?:Lb([01])E)?"
                          r"Li(\d)E")


def k14_k15_label(m, ln):
    name, e, mode, g, vec = m.groups()
    dt = "f64" if e == "d" else "f32"
    if name == "gray_scott":
        mode = ("EXPL + g" if g == "1" else "EXPL", "residual", "jacobian", "prologue")[int(mode)]
        return f"K14 {dt} {mode} V={vec}"
    return f"K15 {dt} {('residual', 'jacobian')[int(mode)]} V={vec}"


# theta_chain_kernel<T, CN, G, TAB> (K2) / cpoint_combine_kernel<T, NT> (K4)
K2_K4_NAME = re.compile(r"theta_chain_kernelI([df])Lb([01])ELb([01])ELb([01])E"
                        r"|cpoint_combine_kernelI([df])Li(\d)E")


def k2_k4_label(m, ln):
    e2, cn, g, tab, e4, nt = m.groups()
    if e2 is not None:
        return (f"K2 {'f64' if e2 == 'd' else 'f32'} {'CN' if cn == '1' else 'BE'}"
                f"{' +g' if g == '1' else ''} rhs {'tabulated' if tab == '1' else 'constant'}")
    return f"K4 {'f64' if e4 == 'd' else 'f32'} terms {nt}"


# affine_windows_kernel<T, Q, ROWS> (K9) / dd_theta_chain_kernel<LONG, CN, G, TAB> (K24)
K9_K24_NAME = re.compile(r"affine_windows_kernelI([df])Li(\d+)ELb([01])E"
                         r"|dd_theta_chain_kernelILb([01])ELb([01])ELb([01])ELb([01])E")


def k9_k24_label(m, ln):
    e9, q, rows, lng, cn, g, tab = m.groups()
    if e9 is not None:
        return (f"K9 {'f64' if e9 == 'd' else 'f32'} Q={q} A, b "
                f"{'with rows' if rows == '1' else 'broadcast'}")
    return (f"K24 {'chains' if lng == '1' else 'one step'} {'CN' if cn == '1' else 'BE'}"
            f"{' +g' if g == '1' else ''} rhs {'tabulated' if tab == '1' else 'constant'}")


# rk4_brusselator_kernel<T, G> (K13) / dd_interval_affine_kernel<JB> (K23)
K13_K23_NAME = re.compile(r"rk4_brusselator_kernelI([df])Lb([01])E"
                          r"|dd_interval_affine_kernelILi(\d+)ELb([01])E")


def k13_k23_label(m, ln):
    e13, g, jb, stream = m.groups()
    if e13 is not None:
        return f"K13 {'f64' if e13 == 'd' else 'f32'}{' +g' if g == '1' else ''}"
    return f"K23 JB={jb}{' streamed' if stream == '1' else ''}"


# prefix_wide / prefix_narrow<T, A rows, b rows, g> (K8) /
# dopri45_arenstorf_kernel<T> (K12)
K8_K12_NAME = re.compile(r"prefix_(wide|narrow)I([df])Lb([01])ELb([01])ELb([01])E"
                         r"|dopri45_arenstorf_kernelI([df])E")


def k8_k12_label(m, ln):
    regime, e8, ar, br, g, e12 = m.groups()
    if e8 is not None:
        return (f"K8 {'f64' if e8 == 'd' else 'f32'} {regime} A "
                f"{'rows' if ar == '1' else 'broadcast'}, b {'rows' if br == '1' else 'broadcast'}"
                f"{' +g' if g == '1' else ''}")
    return f"K12 {'f64' if e12 == 'd' else 'f32'}"


# burgers1d_newton_kernel<T, SHARED> (K16) / dd_arith_kernel<OP, NT, V, I> (K25)
K16_K25_NAME = re.compile(r"burgers1d_newton_kernelI([df])Lb([01])E"
                          r"|dd_arith_kernelILi(\d)ELi(\d)ELi(\d)E([ix])E")
K25_OPS = ("add", "sub", "mul", "div", "sqrt", "neg", "combine", "resid")


def k16_k25_label(m, ln):
    e16, shared, op, nt, v, idx = m.groups()
    if e16 is not None:
        return (f"K16 {'f64' if e16 == 'd' else 'f32'} "
                f"{'shared memory' if shared == '1' else 'device workspace'}")
    name = K25_OPS[int(op)] + (f" {nt}" if K25_OPS[int(op)] == "combine" else "")
    return f"K25 {name} V={v} {'32' if idx == 'i' else '64'}-bit"


# circulant_warp<T, CH> (K17's warp route, CH register values a thread) /
# circulant_block<T> (its block route)
K17_NAME = re.compile(r"circulant_(warp|block)I([df])(?:Li(\d+)E)?E")


def k17_label(m, ln):
    route, e, ch = m.groups()
    return f"K17 {'f64' if e == 'd' else 'f32'} " + (f"warp CH={ch}" if route == "warp"
                                                     else "block")


# restrict_combine_kernel<T, DIM, NT, NA> / indexed_combine_kernel<T, NT> /
# interpolate_combine_kernel<T, DIM, HAS_B> / interval_affine_kernel<T, JB>
ROW_NAME = re.compile(r"(restrict|indexed|interpolate)_combine_kernelI([df])((?:L[ib]\d+E)+)E"
                      r"|interval_affine_kernelI([df])Li(\d+)E")
# the product tile's kernels and its reductions of the split's partials
# (reduce_lanes: K20's)
TILE_OR_REDUCE = re.compile(TILE_NAME.pattern + "|reduce_slicesI|reduce_lanesI")


def row_label(m, ln):
    kind, e, params, e1, jb = m.groups()
    if kind is None:
        return f"K1 {'f64' if e1 == 'd' else 'f32'} intervals {jb}"
    dt = "f64" if e == "d" else "f32"
    p = re.findall(r"L[ib](\d+)E", params)
    if kind == "restrict":
        return f"K18 {dt} dim {p[0]} terms {p[1]} adds {p[2]}"
    if kind == "interpolate":
        return f"K19 {dt} dim {p[0]} b {p[1]}"
    return f"K21 {dt} terms {p[0]}"


def tile_label(m, ln):
    if m.group(1) is None and "reduce_lanesI" in ln:     # reduce_lanes<Acc>: K20's
        return "K20 " + ("f64" if "reduce_lanesId" in ln else "f32") + " reduce"
    if m.group(1) is None:              # reduce_slices<E, pair>
        return "reduce " + ("dd" if "IdLb1" in ln else "f64" if "IdLb0" in ln else "f32")
    e, pair, bm, bn, bk, st, mb, lanes = m.groups()
    kind = ("K26 dd" if pair == "1" else f"K22 {'f64' if e == 'd' else 'f32'}"
            if lanes in (None, "0") else
            f"K20 {'f64' if e == 'd' else 'f32'} {K20_LANES[int(lanes)]}")
    return f"{kind} {bm}x{bn}x{bk}x{st}"


def ptxas(log, name, label):
    """{label(match, line): (registers, spill store bytes, spill load bytes,
    static smem bytes)} of the entry functions of the ptxas log whose
    mangled name matches the regex ``name``."""
    out, key = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = name.search(ln)
            key = label(m, ln) if m else None
        elif key and "spill stores" in ln:
            nums = re.findall(r"(\d+) bytes", ln)
            out[key] = [None, int(nums[1]), int(nums[2]), 0]
        elif key and "Used" in ln and "registers" in ln and key in out:
            out[key][0] = int(re.search(r"Used (\d+) registers", ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            out[key][3] = int(sm.group(1)) if sm else 0
            key = None
    return {k: tuple(v) for k, v in out.items()}


def cuda_ms(fn, reps=20, budget_ms=1000.0):
    """Median ms of one call, CUDA events around each call (after one warm
    call); includes the wrapper's host time where the card waits for it.
    A slow call (a plain loop of many launches) is timed fewer times, at
    least 3, so that the timing stays near budget_ms."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < reps:
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
        if len(times) == 1:
            reps = max(3, min(reps, int(budget_ms / max(times[0], 1e-3))))
    return float(np.median(times))


def device_ms(fn, kernel, count=20, reps=10):
    """Device time of one call with a cold L2: ``count`` calls on fixed
    arguments, each after a read of L2_FLUSH_BYTES that leaves none of its
    operands in the L2, captured in one CUDA graph, and the same reads
    alone in another; the two replayed in turns (median over ``reps`` turns
    of their difference, divided by the count; no host time between the
    launches).  Where capture fails, torch.profiler's device time of the
    kernel's launches over ``count`` calls, each after a read.  Returns
    (ms, "graph" or "profiler")."""
    import torch
    if not _FLUSH:
        _FLUSH.append(torch.zeros(L2_FLUSH_BYTES // 8, dtype=torch.float64, device=DEVICE))
    flush = _FLUSH[0].sum

    def flushed():
        flush()
        fn()

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            flushed()
        torch.cuda.current_stream().wait_stream(side)
        graphs = []
        for body in (flushed, flush):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(count):
                    body()
            graph.replay()
            graphs.append(graph)
        torch.cuda.synchronize()
        diffs = []
        for _ in range(reps):
            t = []
            for graph in graphs:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                stop.record()
                stop.synchronize()
                t.append(start.elapsed_time(stop))
            diffs.append((t[0] - t[1]) / count)
        del graphs
        return float(np.median(diffs)), "graph"
    except Exception as exc:            # noqa: BLE001 -- any capture failure: say so, use the profiler
        torch.cuda.synchronize()
        print(f"[kernels] {kernel}: CUDA graph capture failed ({exc!r}); device time from "
              "torch.profiler")
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(count):
                flushed()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
                 for e in prof.key_averages() if f"{kernel}_kernel" in e.key)
        return us / 1e3 / count, "profiler"


_LATENCY = []


def latency():
    """{op: cycles of one dependent operation, "ghz": the SM clock} for the
    FP64 FMA ("fma"), a warp shuffle of a double ("shfl"), and CUDA's FP64
    division, square root and pow ("div", "sqrt", "pow"), measured once on
    the card by csrc/latency_probe.cu (one warp; chains of 2^20 FMAs and
    shuffles, 2^16 of the others), the clock from the cycles over the
    launch's CUDA-event time; None where the kernel library has no probe."""
    import torch
    from pymgrit_tpu_torch.ops import _build
    if not _LATENCY:
        fn = getattr(_build.library(), "pm_latency_probe", None)
        if fn is None:
            _LATENCY.append(None)
        else:
            n = 2 ** 20
            cycles = torch.zeros(5, dtype=torch.int64, device=DEVICE)
            sink = torch.tensor([0.5, 1.0 - 2.0 ** -30, 2.0 ** -20] + [0.0] * 32,
                                dtype=torch.float64, device=DEVICE)
            stream = torch.cuda.current_stream().cuda_stream
            _build.check(fn(cycles.data_ptr(), sink.data_ptr(), n, stream), "latency_probe")
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            _build.check(fn(cycles.data_ptr(), sink.data_ptr(), n, stream), "latency_probe")
            stop.record()
            stop.synchronize()
            c = cycles.cpu().tolist()
            lat = dict(zip(("fma", "shfl", "div", "sqrt", "pow"),
                           (c[0] / n, c[1] / n, *(x / (n // 16) for x in c[2:]))))
            lat["ghz"] = sum(c) / (start.elapsed_time(stop) * 1e6)
            _LATENCY.append(lat)
            print("[kernels] latency probe (one warp): a dependent "
                  + ", ".join(f"{k} {v:.2f} cycles" for k, v in lat.items() if k != "ghz")
                  + f"; SM clock {lat['ghz']:.3f} GHz")
    return _LATENCY[0]


def k8_floor(n, N, streamed, es=8):
    """K8's latency floor (ms, how) at n rows of N columns with
    ``streamed`` operands read by rows, from its plan: narrow, a tile's 2 R
    dependent FMAs (compose, replay), one a scan level (log2(32 / W) in
    the warp, 5 across the warps) and 2 for the carry-in, and its shuffle
    levels (those, and the two exclusive shifts), times the tiles; wide,
    the n FMAs of a column's chain; at the probe's latencies and clock.
    None where the package has no plan or the library no probe."""
    from pymgrit_tpu_torch.ops import prefix
    lat, plan_fn = latency(), getattr(prefix, "affine_prefix_plan", None)
    if lat is None or plan_fn is None:
        return None
    from pymgrit_tpu_torch.ops import _build
    regime, _, W, S, R, _ = plan_fn(n, N, _build.sm_count(0), streamed, es)
    fma, shfl, ghz = lat["fma"], lat["shfl"], lat["ghz"]
    if regime == "wide":
        return n * fma / ghz / 1e6, f"wide: {n} dependent FMAs x {fma:.2f} cycles at {ghz:.3f} GHz"
    levels, tiles = int(math.log2(32 // W)), -(-n // (S * R))
    fmas, shuffles = tiles * (2 * R + levels + 5 + 2), tiles * (levels + 5 + 2)
    return ((fmas * fma + shuffles * shfl) / ghz / 1e6,
            f"narrow W={W} R={R}, {tiles} tiles: {fmas} dependent FMAs x {fma:.2f} cycles + "
            f"{shuffles} shuffle levels x {shfl:.2f} cycles at {ghz:.3f} GHz")


def k12_floor(att):
    """K12's latency floor (ms, how, the slowest warp's attempts) for the
    (L, J) attempt counts of a launch: the warp (32 lanes) whose attempts,
    summed over the steps of the slowest lane of each step, are most, times
    K12_CHAIN_ATTEMPT, plus K12_CHAIN_STEP a step, each operation at the
    probe's latency of its kind and clock.  None without a probe."""
    lat = latency()
    if lat is None:
        return None
    L, J = att.shape
    pad = np.zeros((L, -(-J // 32) * 32), dtype=np.int64)
    pad[:, :J] = att
    warp = int(pad.reshape(L, -1, 32).max(axis=2).sum(axis=0).max())

    def cycles(chain):
        return sum(k * lat[op] for op, k in chain.items())

    total = warp * cycles(K12_CHAIN_ATTEMPT) + L * cycles(K12_CHAIN_STEP)
    kinds = " + ".join(f"{k} {op}" for op, k in K12_CHAIN_ATTEMPT.items())
    return (total / lat["ghz"] / 1e6, f"{warp} attempts of the slowest warp x ({kinds}: "
            f"{cycles(K12_CHAIN_ATTEMPT):.0f} cycles) + {L} steps x "
            f"{cycles(K12_CHAIN_STEP):.0f} cycles at {lat['ghz']:.3f} GHz", warp)


def kernel_cases(dtype, dev, stash):
    """(kernel, case, run(ops) -> output tensor) at the main paths' shapes:
    N = 127^2 coefficients and J = 512 level-0 intervals (K1), level-1
    F-relaxation J = 32, L = 15 and the coarsest solve J = 1, L = 2 (K2),
    512 C-rows (K3, K4); physical 129^2 states with their ring: the 512
    level-0 C-rows and the level-1 F-step with g (K5, K7), the seed
    transform (K5), the condensed C-step and the 16384-row materialization
    of the level-0 tube (K6); K8 and K9 at the coarsest levels of the
    [coarsest] phase (``coarsest_cases``)."""
    import torch
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
    rng = np.random.default_rng(SEED)
    n, nt0, ms = TOMS["nx"] - 2, TOMS["nt"], TOMS["ms"]
    N, m0 = n * n, ms[0]
    J = (nt0 - 1) // m0

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    _, lam1 = sine_eigenbasis(n, (n + 1.0) ** 2)
    lam = t((lam1[:, None] + lam1[None, :]).reshape(-1))
    cases = []

    # K1 interval_affine: tables (T, N), T = m-1 (F-sweep, materialize) and
    # T = m (condensed C-step); the seeds are the level-0 C-rows.
    seeds = t(rng.uniform(-1, 1, (J, N)))
    A_by_T = {}
    for T in (m0 - 1, m0):
        A, G = t(rng.uniform(0, 1, (T, N))), t(rng.uniform(-1, 1, (T, N)))
        A_by_T[T] = (A, G)

        # each call writes into a fresh tensor made outside the timed call
        # (RowCase.prepare)
        def row_major(k, out, A=A, G=G):
            k.interval_affine(seeds, A, G, out.transpose(0, 1), 0)
            return out

        def interval_major(k, out, A=A, G=G):
            return k.interval_affine(seeds, A, G, out, 0)

        def only_last(k, out, A=A, G=G, T=T):
            k.interval_affine(seeds, A, G, out.transpose(0, 1), T - 1)
            return out

        def empty(*shape):
            return lambda: torch.empty(shape, dtype=dtype, device=dev)

        cases += [("interval_affine", f"T={T} row-major",
                   RowCase(empty(T, J, N), row_major)),
                  ("interval_affine", f"T={T} interval-major",
                   RowCase(empty(J, T, N), interval_major)),
                  ("interval_affine", f"T={T} only_last",
                   RowCase(empty(1, J, N), only_last))]
        if T == m0 - 1:
            seeds_c = t(rng.uniform(-1, 1, (J + 1, N)))

            def materialize(k, tube, A=A, G=G):
                blocks = tube[:J * m0].view(J, m0, N)
                k.interval_affine(seeds_c[:J], A, G, blocks[:, 1:], 0, blocks[:, 0])
                tube[nt0 - 1].copy_(seeds_c[J])
                return tube

            cases.append(("interval_affine", "materialize",
                          RowCase(empty(nt0, N), materialize)))
            # the write-rate yardstick: fill_ of the same tube, which the
            # port never calls
            stash[("probe", "interval_affine", "materialize")] = (
                "fill_", lambda tube: tube.fill_(0.0), 8 * nt0 * N)

    # K2 theta_chain: chains read their seeds from C-rows and write the
    # F-rows of a level tube (strided views, into a tube made outside the
    # timed call: RowCase.prepare); the rhs is time-independent.
    # (J, L, m, theta, g?, dt): level-1 F-relaxation in BE and CN, the
    # coarsest forward solve, a one-step Phi of the level-1 C-rows
    # (C-relaxation, FAS).
    lift, rhs_row = t(rng.uniform(-1, 1, N)), t(rng.uniform(-1, 1, N))
    m1, dt1 = ms[1], m0 / (nt0 - 1)
    J1 = J // m1
    dtc = float(np.prod(ms)) / (nt0 - 1)
    nt_c = (nt0 - 1) // int(np.prod(ms)) + 1
    for Jc, L, m, theta, with_g, step in ((J1, m1 - 1, m1, 1.0, True, dt1),
                                          (J1, m1 - 1, m1, 0.5, True, dt1),
                                          (1, nt_c - 1, nt_c, 1.0, True, dtc),
                                          (J1, 1, m1, 1.0, False, dt1)):
        nt = Jc * m + 1
        u_tube = t(rng.uniform(-1, 1, (nt, N)))
        g_tube = t(rng.uniform(-1e-3, 1e-3, (nt, N)))
        dt = t(np.full((L, Jc), step))
        rhs1 = rhs_row.expand(L, Jc, N)
        seeds2 = u_tube[0:nt - 1:m]
        g = g_tube[1:nt].view(Jc, m, N)[:, :L] if with_g else None

        # the F-rows of a fresh tube, made outside the timed call
        def f_rows(Jc=Jc, L=L, m=m, nt=nt):
            return torch.empty((nt, N), dtype=dtype, device=dev)[1:].view(Jc, m, N)[:, :L]

        def chain(k, out, theta=theta, g=g, seeds2=seeds2, dt=dt, rhs1=rhs1):
            return k.theta_chain(seeds2, out, dt, lam, lift, rhs1, rhs1, theta, g)

        kind = "BE" if theta == 1.0 else "CN"
        label = f"J={Jc} L={L} {kind}{' +g' if with_g else ''}"
        if (Jc, L, theta, with_g) == (J1, m1 - 1, 1.0, True):
            label = "level-1 F-relax " + label
        cases.append(("theta_chain", label, RowCase(f_rows, chain)))
        if label.startswith("level-1"):
            # the read-write yardstick: copy_ of g into the same rows (the
            # bytes K2 moves, without its steps), which the port never calls
            stash[("probe", "theta_chain", label)] = (
                "copy_ of g", lambda out, g=g: out.copy_(g), 8 * Jc * L * N)
        stash[("work", "theta_chain", label)] = k2_work(Jc, L, N, theta, with_g)

    # K3 residual_row_norms / K4 cpoint_combine on 512 C-rows of a tube
    # (K3: the solver's s = Phi(u_{c-1}) rows against u_c, of odd N: the two
    # operands' rows disagree in 16-byte alignment); K4 writes into a
    # tensor made outside the timed call (in place: a fresh copy)
    a, b, c = (t(rng.uniform(-1, 1, (J + 1, N))) for _ in range(3))
    cases.append(("residual_row_norms", "C-rows",
                  RowCase(lambda: None, lambda k, _: k.residual_row_norms(a[1:], b[:J]),
                          exact=False)))

    def rows_out():
        return torch.empty((J, N), dtype=dtype, device=dev)

    strided = t(rng.uniform(-1, 1, (2 * J, N)))
    lib_dst = a[1:].clone()
    for case, prepare, terms, coeffs, library in (
            ("FAS g_tail", rows_out, (a[1:], b[:J], c[1:]), (1.0, -1.0, 1.0), None),
            # 1.3 s1 - 0.3 s0 = s0 + 1.3 (s1 - s0): torch.lerp, another rounding
            ("weighted C strided", rows_out, (strided[1::2], strided[0::2]), (1.3, -0.3),
             lambda: torch.lerp(strided[0::2], strided[1::2], 1.3)),
            ("correction in place", lambda: a[1:].clone(), (None, b[:J]), (1.0, 1.0),
             lambda: lib_dst.add_(b[:J]))):
        def combine(k, out, terms=terms, coeffs=coeffs):
            return k.cpoint_combine(out, [out if x is None else x for x in terms], list(coeffs))

        cases.append(("cpoint_combine", case, RowCase(prepare, combine)))
        stash[("work", "cpoint_combine", case)] = (8 * (len(terms) + 1) * J * N,
                                                   (2 * len(terms) - 1) * J * N)
        if library is not None:
            stash[("library", "cpoint_combine", case)] = library

    # K5 sine_solve2d, K6 sine_affine2d, K7 theta_rhs2d on physical states:
    # C-rows of a level tube with random rings (the kernels must carry a
    # ring that is not the bc data), a bc ring template, dt of levels 0/1.
    nx, fx = n + 2, (n + 1.0) ** 2
    S = t(sine_eigenbasis(n, fx)[0])
    lam2 = lam.view(n, n)
    ring_np = rng.uniform(-1, 1, (nx, nx))
    ring_np[1:-1, 1:-1] = 0.0
    ring = t(ring_np)
    lift2 = t(rng.uniform(-1, 1, (n, n)))
    ptube = t(rng.uniform(-1, 1, (J + 1, nx, nx)))
    pg = t(rng.uniform(-1e-3, 1e-3, (J1 * m1 + 1, nx, nx)))
    dt0 = 1.0 / (nt0 - 1)
    shifts = t(rng.uniform(0.5, 1.0, J) * dt0)
    rows_a, rows_b = (t(rng.uniform(-1, 1, N)).expand(J, N) for _ in range(2))

    def k5(B, shift, with_g=False, solve=True, into_tube=True):
        # each call writes into a fresh tube made outside the timed call
        def launch(k, tube):
            out = tube[1:].view(B, m1, nx, nx)[:, 0] if into_tube else tube[:B, 1:-1, 1:-1]
            g = pg[1:B * m1 + 1].view(B, m1, nx, nx)[:, 0] if with_g else None
            return k.sine_solve2d(ptube[:B, 1:-1, 1:-1], out, S, S, lam2 if solve else None,
                                  shift if solve else None, ring if into_tube else None, g)
        return RowCase(lambda: torch.empty((B * m1 + 1, nx, nx), dtype=dtype, device=dev),
                       launch, exact=False)

    cases += [("sine_solve2d", f"solve B={J}", k5(J, dt0)),
              ("sine_solve2d", f"level-1 F-step B={J1} +g", k5(J1, m0 * dt0, with_g=True)),
              ("sine_solve2d", f"solve B={J} shift tensor", k5(J, shifts)),
              ("sine_solve2d", f"transform B={J}", k5(J, None, solve=False, into_tube=False))]
    for case, B, nk, how in K5_SMALL:
        cases.append(("sine_solve2d", case, k5_small(dtype, dev, rng, B, nk, how)))
        stash[("work", "sine_solve2d", case)] = k5_work(B, nk, how)
    nbytes, nops = k5_work(J, n, "solve")
    stash.update({("work", "sine_solve2d", f"solve B={J}"): (nbytes, nops),
                  ("work", "sine_solve2d", f"solve B={J} shift tensor"): (nbytes + 8 * J, nops),
                  ("work", "sine_solve2d", f"level-1 F-step B={J1} +g"): k5_work(J1, n, "solve +g"),
                  ("work", "sine_solve2d", f"transform B={J}"): k5_work(J, n, "transform"),
                  ("work", "residual_row_norms", "C-rows"): headline_work("residual_row_norms",
                                                                          stash)})

    # K6 sine_affine2d (each call writes into a tensor made outside the
    # timed call): the condensed C-step (BE and CN) and the 16384-row
    # materialization of the level-0 tube; spatial65's level-0 C-step
    # (K6_SMALL)
    xhat, dhat = (t(rng.uniform(-1, 1, (J, N))) for _ in range(2))
    dscale = t(rng.uniform(0, 1e-4, N))
    for T in (m0 - 1, m0):
        A, G = t(rng.uniform(0, 1, (T, N))), t(rng.uniform(-1, 1, (T, N)))
        if T == m0:
            def c_step(k, out, A=A, G=G, cn=False):
                k.sine_affine2d(xhat, A, G, out.transpose(0, 1), S, S, m0 - 1, ring,
                                dhat if cn else None, dscale if cn else None)
                return out

            def one_row():
                return torch.empty((1, J, nx, nx), dtype=dtype, device=dev)

            cases += [("sine_affine2d", f"C-step J={J} only_last",
                       RowCase(one_row, c_step, exact=False)),
                      ("sine_affine2d", f"C-step J={J} only_last CN",
                       RowCase(one_row, lambda k, out, f=c_step: f(k, out, cn=True), exact=False))]
            for cn in (False, True):
                stash[("work", "sine_affine2d", f"C-step J={J} only_last" + " CN" * cn)] = \
                    k6_work(J, 1, n, cn)
        else:
            def materialize_phys(k, tube, A=A, G=G):
                blocks = tube[:J * m0].view(J, m0, nx, nx)
                k.sine_affine2d(xhat, A, G, blocks[:, 1:], S, S, 0, ring, seed=ptube[:J],
                                seed_out=blocks[:, 0])
                tube[nt0 - 1].copy_(ptube[J])
                return tube

            cases.append(("sine_affine2d", "materialize",
                          RowCase(lambda: torch.empty((nt0, nx, nx), dtype=dtype, device=dev),
                                  materialize_phys, exact=False)))
            stash[("work", "sine_affine2d", "materialize")] = headline_work("sine_affine2d", stash)
    for case, Jk, nk in K6_SMALL:
        cases.append(("sine_affine2d", case, k6_small(dtype, dev, rng, Jk, nk)))
        stash[("work", "sine_affine2d", case)] = k6_work(Jk, 1, nk, False)

    # K7 theta_rhs2d: the level-0 batch (512 states) in each mode and the
    # level-1 batch of the solve's F-steps (32 states, dt of level 1); the
    # kernel rounds the plain version's operations once each, in its order
    # (float64: bit for bit; float32: held at the tolerance)
    def k7(theta, dt, B=J):
        # the views a call reads, made once outside the timed call
        u, ra, rb, g = ptube[:B] if theta == 0.0 else ptube[1:B + 1], rows_a[:B], rows_b[:B], pg[:B]

        def launch(k, out):
            if theta == 0.0:
                return k.theta_rhs2d(u, out, dt, 0.0, fx, fx, ra, rb, ring=ring, g=g)
            return k.theta_rhs2d(u, out, dt, theta, fx, fx, ra, rb, lift=lift2)
        shape = (B, nx, nx) if theta == 0.0 else (B, n, n)
        return RowCase(lambda: torch.empty(shape, dtype=dtype, device=dev), launch,
                       exact=dtype == torch.float64)

    for case, theta, dt, B in ((f"BE B={J}", 1.0, dt0, J), (f"CN B={J}", 0.5, dt0, J),
                               (f"FE B={J} +g", 0.0, dt0, J), (f"CN B={J} dt tensor", 0.5, shifts, J),
                               (f"level-1 BE B={J1}", 1.0, m0 * dt0, J1),
                               (f"level-1 CN B={J1}", 0.5, m0 * dt0, J1)):
        cases.append(("theta_rhs2d", case, k7(theta, dt, B)))
        stash[("work", "theta_rhs2d", case)] = k7_work(B, n, theta, dt is shifts)
    # one PyTorch call that computes the same function, timed beside K1's
    # and K3's headline cases (no other kernel of the path has one)
    A31, G31 = A_by_T[m0 - 1]
    stash[("library", "interval_affine")] = stash[("library", "interval_affine", "materialize")] = \
        lambda: torch.addcmul(G31, seeds_c[:J, None], A31)
    stash[("work", "interval_affine", "materialize")] = headline_work("interval_affine", stash)
    stash[("library", "residual_row_norms")] = stash[("library", "residual_row_norms", "C-rows")] = \
        lambda: torch.linalg.vector_norm(a[1:] - b[:J], dim=1)
    return (cases + coarsest_cases(dtype, dev, rng, lam, stash)
            + nonlinear_cases(dtype, dev, rng, stash) + slice_cases(dtype, dev, rng, stash)
            + transfer_cases(dtype, dev, rng, stash) + heat1d_cases(dtype, dev, rng, stash)
            + past_cap_cases(dtype, dev, rng, stash) + slice7_cases(dtype, dev, rng, stash)
            + space_kernel_cases(dtype, dev, stash)
            + periodic_space_kernel_cases(dtype, dev, stash)
            + slab_mode_cases(dtype, dev, stash))


def coarsest_work(kernel, nt, N, k, A, b, es=8, with_g=True):
    """(bytes, operations) of a K8 or K9 call on an (nt, N) coarse tube:
    A and b read once (one row where their row stride is 0), g's nt - 1
    rows read (K8 without g: none); K8 reads the seed row x0 and writes
    rows 1..nt-1, K9 reads the rows of u that start a window (lane p starts
    from u[max(0, p - k + 1)]: rows 0..max(0, nt - k)) and writes nt rows;
    a multiply and two sums an entry and step (K8 nt - 1 steps, K9 min(p, k
    - 1) steps for lane p; K8 without g: one sum)."""
    rows = sum(1 if t.stride(0) == 0 else nt - 1 for t in (A, b))
    if kernel == "affine_prefix":
        return (es * N * (rows + 1 + (1 + with_g) * (nt - 1)),
                (2 + with_g) * (nt - 1) * N)
    steps = sum(min(p, k - 1) for p in range(nt))
    return es * N * (rows + max(1, nt - k + 1) + (nt - 1) + nt), 3 * steps * N


def coarsest_cases(dtype, dev, rng, lam, stash):
    """K8 and K9 at the coarsest levels of the [coarsest] phase: the
    Dahlquist row (16385 points of one value, A = 1/1.2 per step, b = 0 with
    stride 0) and the TOMS width with two levels (2049 points of 16129
    coefficients, the BE step's A = 1/(1 + dt lam) and its b as rows with
    stride 0); g is a coarse tube's rows 1..nt-1, out its rows 1..nt (K8)
    or a fresh tube (K9), made untimed (``RowCase``).  K8 also at a middle
    width (2049 points of 999 columns, + g: its narrow regime with 8
    columns a block) and without g with A and b as rows (4097 points of
    300 columns), drawn from a generator of their own; each K8 case records
    its latency floor (``k8_floor``)."""
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    nt_d = DAHLQUIST_CASE_NT
    nt_h = (TOMS2["nt"] - 1) // TOMS2["ms"][0] + 1
    dt_h = TOMS2["ms"][0] / (TOMS2["nt"] - 1)
    N = lam.shape[0]
    shapes = {
        "Dahlquist": (nt_d, t(np.full((nt_d - 1, 1), 1 / 1.2)),
                      t(np.zeros((1, 1))).expand(nt_d - 1, 1), DAHLQUIST["k"]),
        "TOMS": (nt_h, (1.0 / (1.0 + dt_h * lam))[None].expand(nt_h - 1, N),
                 t(rng.uniform(0, dt_h, (1, N))).expand(nt_h - 1, N), TOMS2_AT_K),
    }
    cases = []
    for label, (nt, A, b, k) in shapes.items():
        width = A.shape[1]
        stash[("floor", "affine_prefix", f"{label} n={nt - 1} N={width} +g")] = \
            lambda n=nt - 1, N=width, k=(A.stride(0) != 0) + (b.stride(0) != 0) + 1: \
            k8_floor(n, N, k)
        u = t(rng.uniform(-1, 1, (nt, width)))
        g = t(rng.uniform(-1e-3, 1e-3, (nt, width)))[1:]

        def prefix_out(u=u):
            out = torch.empty_like(u)
            out[0] = u[0]
            return out

        def prefix(ops, out, u=u, g=g, A=A, b=b):
            ops.affine_prefix(A, b, u[0], out[1:], g)
            return out

        def windows(ops, out, u=u, g=g, A=A, b=b, k=k):
            return ops.affine_windows(u, A, b, g, out, k)

        # K8's bytes without its steps: g copied into the same out rows
        stash[("probe", "affine_prefix", f"{label} n={nt - 1} N={width} +g")] = (
            "copy_ of g", lambda out, g=g: out[1:].copy_(g), g.numel() * g.element_size())
        for kernel, case, run in (
                ("affine_prefix", f"{label} n={nt - 1} N={width} +g",
                 RowCase(prefix_out, prefix, exact=False)),
                ("affine_windows", f"{label} nt={nt} N={width} k={k}",
                 RowCase(lambda u=u: torch.empty_like(u), windows, exact=False))):
            cases.append((kernel, case, run))
            stash[("work", kernel, case)] = coarsest_work(kernel, nt, width, k, A, b,
                                                          u.element_size())
    r8 = np.random.default_rng(SEED + 8)
    for nt, width, with_g, rows in ((nt_h, 999, True, False), (4097, 300, False, True)):
        A = t(r8.uniform(0.5, 1.0, (nt - 1 if rows else 1, width))).expand(nt - 1, width)
        b = t(r8.uniform(-1e-3, 1e-3, (nt - 1 if rows else 1, width))).expand(nt - 1, width)
        u = t(r8.uniform(-1, 1, (nt, width)))
        g = t(r8.uniform(-1e-3, 1e-3, (nt, width)))[1:] if with_g else None

        def prefix_out(u=u):
            out = torch.empty_like(u)
            out[0] = u[0]
            return out

        def prefix(ops, out, u=u, g=g, A=A, b=b):
            ops.affine_prefix(A, b, u[0], out[1:], g)
            return out

        case = (f"{'narrow' if rows else 'middle'} n={nt - 1} N={width}"
                + (" +g" if with_g else "") + (" A, b rows" if rows else ""))
        cases.append(("affine_prefix", case, RowCase(prefix_out, prefix, exact=False)))
        stash[("work", "affine_prefix", case)] = coarsest_work(
            "affine_prefix", nt, width, 0, A, b, u.element_size(), with_g)
        stash[("floor", "affine_prefix", case)] = \
            lambda n=nt - 1, N=width, k=2 * rows + with_g: k8_floor(n, N, k)
    return cases


def nonlinear_cases(dtype, dev, rng, stash):
    """K10-K13 at the shapes of phases 9 and 10, and odd ones.  K10: the
    bench row's level-0 IMEX step (512 states of 128^2 from C-rows into a
    strided tube view), its level-1 F-step (64 states, + g) and coarsest
    step (one state), the IMPL preconditioner (8 states, no prologue), and
    n = 17 at B = 512 and 1.  K11: the IMPL level-0 lanes (8 states of
    128^2) in its three modes, and n = 17 at B = 512.  K12 (``RowCase``s,
    their attempt counts held equal to the plain version's): the Arenstorf
    level-0 F-relaxation (250 lanes; 8 of its 319 steps, so the plain loop
    stays short), 16 steps of the coarsest chain, and J = 512 and 1.  K13
    (``RowCase``s, bit for bit; the card's plain version against the CPU's):
    the Brusselator level-0 F-relaxation (32 lanes x 19 steps, + g), the
    coarsest chain (1 x 32), and 512 lanes."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    from pymgrit_tpu_torch.ops.periodic import hartley_basis

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def table(n):
        k = np.arange(n)
        lam1 = (2.0 * np.cos(2.0 * np.pi * k / n) - 2.0) * n ** 2
        return t(hartley_basis(n)), t(-(lam1[:, None] + lam1[None, :]))

    cases = []
    n = AC_BENCH["nx"]
    m0, m1 = AC_BENCH["ms"]
    J0 = (AC_BENCH["nt"] - 1) // m0
    J1 = J0 // m1
    dt0 = AC_BENCH["t_stop"] / (AC_BENCH["nt"] - 1)
    dt_impl = AC_IMPL["t_stop"] / (AC_IMPL["nt"] - 1)
    inv_eps2 = 1.0 / 0.04 ** 2

    def k10(B, side, step, nu, with_g):
        H, lam = table(side)
        seeds = t(rng.uniform(-1, 1, (B + 1, side, side)))
        g_rows = t(rng.uniform(-1e-3, 1e-3, (B, side, side))) if with_g else None
        shift = t(np.full(B, step))

        # into a strided view of a tensor made outside the timed call
        def launch(ops, out):
            return ops.periodic_solve2d(seeds[:B], out, H, lam, shift, nu=nu, inv_eps2=inv_eps2,
                                        g=g_rows)
        return RowCase(lambda: torch.empty((B, 2, side, side), dtype=dtype, device=dev)[:, 1],
                       launch, exact=False)

    k10_cases = ((f"IMEX B={J0} n={n}", J0, n, dt0, 2, False),
                 (f"level-1 F-step B={J1} n={n} +g", J1, n, m0 * dt0, 2, True),
                 (f"coarsest step B=1 n={n} +g", 1, n, m0 * m1 * dt0, 2, True),
                 (f"precond B=8 n={n}", 8, n, dt_impl, 0, False),
                 (f"IMEX B={J0} n=17", J0, 17, dt0, 2, False),
                 ("precond B=1 n=17", 1, 17, dt_impl, 0, False))
    for case, B, side, step, nu, with_g in k10_cases:
        cases.append(("periodic_solve2d", case, k10(B, side, step, nu, with_g)))
        stash[("work", "periodic_solve2d", case)] = k10_work(B, 1, side, with_g)

    def k11(mode, B, side):
        u = t(rng.uniform(-1, 1, (2 * B, side, side)))[::2]
        x = t(rng.uniform(-1, 1, (B, side, side)))
        fac = t(np.full(B, dt_impl))

        def launch(ops, out):
            return ops.allen_cahn_pointwise(mode, u, out, fac, inv_eps2, 1.0 / side ** 2, 2, x=x,
                                            rhs=x)

        def view(r):                    # the residual and its per-lane max as one tensor
            return torch.cat([r[0].flatten(), r[1]]) if mode == "residual" else r
        # K11 rounds each operation of its plain version once, in its order
        return RowCase(lambda: torch.empty((B, side, side), dtype=dtype, device=dev), launch,
                       view=view)

    for mode, B, side in (("jacobian", 8, n), ("residual", 8, n), ("rhs", 8, n),
                          ("residual", J0, 17)):
        case = f"{mode} B={B} n={side}"
        cases.append(("allen_cahn_pointwise", case, k11(mode, B, side)))
        stash[("work", "allen_cahn_pointwise", case)] = k11_work(mode, B, side)

    # Arenstorf: lanes start on the orbit (a K12 march of the coarse grid)
    nt_a, m_a = ARENSTORF["nt"], ARENSTORF["m"]
    ta = np.linspace(0, T_ORBIT, nt_a)
    tca = ta[::m_a]
    J_a = (nt_a - 1) // m_a
    x0 = torch.tensor([0.994, 0.0, 0.0, -2.00158510637908], dtype=torch.float64, device=dev)
    march = torch.empty((1, J_a, 4), dtype=torch.float64, device=dev)
    DISPATCH.dopri45_arenstorf(x0[None], *(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                                           for a in (tca[:-1, None], tca[1:, None])), march)
    orbit = torch.cat([x0[None], march[0, :-1]]).to(dtype)

    def k12(case, seeds, tp, tc):
        """A K12 RowCase: the chain rows of a fresh (J, L + 1, 4) tube made
        untimed; each launch leaves its attempt counts in ``att`` (by
        whether the kernel ran), which phase 3 holds equal to the plain
        version's and reads the latency floor from."""
        J, L = tp.shape[1], tp.shape[0]
        tp, tc = t(tp), t(tc)
        att = {}

        def prepare():
            return torch.empty((J, L + 1, 4), dtype=dtype, device=dev)[:, 1:]

        def launch(ops, out):
            a = torch.zeros((L, J), dtype=torch.int32, device=dev)
            ops.dopri45_arenstorf(seeds, tp, tc, out, attempts=a)
            att[ops is DISPATCH] = a
            return out

        stash[("attempts", "dopri45_arenstorf", case)] = att
        return case, RowCase(prepare, launch, exact=False)

    L8 = 8
    tp0 = np.stack([ta[j * m_a:j * m_a + L8] for j in range(J_a)], 1)
    tc0 = np.stack([ta[j * m_a + 1:j * m_a + L8 + 1] for j in range(J_a)], 1)
    wide = orbit[torch.arange(512, device=dev) % J_a] * (1 + 1e-6 * t(rng.standard_normal((512, 4))))
    cases += [("dopri45_arenstorf", *k12(f"level-0 F-relax J={J_a} L={L8}", orbit, tp0, tc0)),
              ("dopri45_arenstorf", *k12("coarsest chain J=1 L=16", orbit[:1], tca[:16, None],
                                         tca[1:17, None])),
              ("dopri45_arenstorf", *k12("J=512 L=2", wide, np.stack([tca[:2]] * 512, 1),
                                         np.stack([tca[1:3]] * 512, 1))),
              ("dopri45_arenstorf", *k12("J=1 L=2", orbit[5:6], tca[5:7, None],
                                         tca[6:8, None]))]

    nt_b, m_b = BRUSSELATOR["nt"], BRUSSELATOR["m"]
    J_b = (nt_b - 1) // m_b

    def k13(J, L, m, with_g, case):
        """A K13 RowCase: the chain rows of a fresh (J, L + 1, 2) tube made
        untimed; the plain version on the CPU, on the same inputs, recorded
        beside it (the card's plain version must equal it)."""
        seeds = t(rng.uniform(0, 3, (J, 2)))
        g = t(rng.uniform(-1e-3, 1e-3, (J, L, 2))) if with_g else None
        tt = np.linspace(0, 12, J * m + 1)
        tp, tc = (t(np.stack([tt[j * m + o:j * m + o + L] for j in range(J)], 1)) for o in (0, 1))

        def prepare():
            return torch.empty((J, L + 1, 2), dtype=dtype, device=dev)[:, 1:]

        def launch(ops, out):
            return ops.rk4_brusselator(seeds, tp, tc, out, g)

        def on_cpu():
            out = torch.empty((J, L + 1, 2), dtype=dtype)[:, 1:]
            return PLAIN.rk4_brusselator(seeds.cpu(), tp.cpu(), tc.cpu(), out,
                                         None if g is None else g.cpu())
        stash[("cpu plain", "rk4_brusselator", case)] = on_cpu
        return case, RowCase(prepare, launch)

    for J, L, m, with_g, label in ((J_b, m_b - 1, m_b, True, "level-0 F-relax"),
                                   (1, J_b, J_b, False, "coarsest chain"),
                                   (512, m_b - 1, m_b, False, "")):
        case = f"{label + ' ' if label else ''}J={J} L={L}{' +g' if with_g else ''}"
        cases.append(("rk4_brusselator", *k13(J, L, m, with_g, case)))
    return cases


def slice_cases(dtype, dev, rng, stash):
    """K10's species axis and K14-K17 at the shapes of the [gray_scott],
    [burgers] and [advection] phases.  K10: the AT run's level-0 IMEX step
    (1024 Gray-Scott pairs of 128^2 from C-rows into a strided tube view, the
    Gray-Scott prologue, one coefficient per species), the IMPL
    preconditioner (8 pairs) and Burgers2D's (4 pairs of 64^2, coefficient
    nu on both).  K14: the IMPL level-0 lanes (8 pairs) in the residual and
    Jacobian modes, the EXPL level-0 step (128 pairs + g), and the residual
    at n = 17 on the AT run's 1024 level-0 lanes (scalar accesses).  K15:
    Burgers2D's 4 lanes of 64^2 in both modes, and the residual at n = 17.
    K14 and K15 are bit for bit ``RowCase``s.  K16: the deep Burgers1D
    level-0 F-relaxation (256
    lanes x 15 steps + g) and the example's (16 x 3).  K17: the deep
    advection level-0 F-relaxation (4096 lanes x 3 steps + g), the example's
    (64 x 1), and 4096 lanes with c < -1/2 (the kernel's second branch)."""
    import torch
    from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def table(n, dx):
        return t(hartley_basis(n)), t(-periodic_lap_eigs(n, dx))

    cases = []
    n = GS_AT["nx"]
    dx_gs = 2.0 / n
    H, lam = table(n, dx_gs)
    coef_gs = t([GS_COEF["du"], GS_COEF["dv"]])
    J0 = (GS_AT["nt"] - 1) // GS_AT["ms"][0]
    dt0 = GS_AT["t_stop"] / (GS_AT["nt"] - 1)
    dt_impl = GS_IMPL["t_stop"] / (GS_IMPL["nt"] - 1)
    nb = BURGERS_2D["nx"]
    Hb, lamb = table(nb, 1.0 / nb)
    dt_b2 = BURGERS_2D["t_stop"] / (BURGERS_2D["nt"] - 1)
    B2 = (BURGERS_2D["nt"] - 1) // BURGERS_2D["ms"][0]

    def pairs(B, side, lo=0.0, hi=1.0):
        return t(rng.uniform(lo, hi, (B + 1, 2, side, side)))

    def k10(B, side, step, gray_scott, H_, lam_, coef):
        seeds = pairs(B, side)
        shift = t(np.full(B, step))

        # into a strided view of a tensor made outside the timed call
        def launch(ops, out):
            return ops.periodic_solve2d(seeds[:B], out, H_, lam_, shift, coef=coef,
                                        gray_scott=gray_scott)
        return RowCase(lambda: torch.empty((B, 2, 2, side, side), dtype=dtype, device=dev)[:, 1],
                       launch, exact=False)

    gs_ab = (GS_COEF["a"], GS_COEF["b"])
    for case, B, side, step, gs_, H_, lam_, coef in (
            (f"Gray-Scott IMEX B={J0} S=2 n={n}", J0, n, dt0, gs_ab, H, lam, coef_gs),
            (f"Gray-Scott precond B=8 S=2 n={n}", 8, n, dt_impl, None, H, lam, coef_gs),
            (f"Burgers2D precond B={B2} S=2 n={nb}", B2, nb, dt_b2, None, Hb, lamb,
             t([BURGERS_2D["nu"]] * 2))):
        cases.append(("periodic_solve2d", case, k10(B, side, step, gs_, H_, lam_, coef)))
        stash[("work", "periodic_solve2d", case)] = k10_work(B, 2, side, False)

    def k14(mode, B, side, step, with_g):
        s_ = pairs(2 * B, side)[::2][:B]
        w = pairs(B, side, -1.0, 1.0)[:B]
        g = w * 1e-3 if with_g else None
        dt = t(np.full(B, step))

        def launch(ops, out):
            return ops.gray_scott_pointwise(mode, s_, out, dt, GS_COEF["du"], GS_COEF["dv"],
                                            GS_COEF["a"], GS_COEF["b"], (2.0 / side) ** 2, w=w,
                                            r=w if mode == "residual" else None, g=g)

        def view(r):                    # the residual and its per-lane max as one tensor
            return torch.cat([r[0].flatten(), r[1]]) if mode == "residual" else r
        # K14 rounds each operation of its plain version once, in its order
        return RowCase(lambda: torch.empty((B, 2, side, side), dtype=dtype, device=dev), launch,
                       exact=True, view=view)

    J_expl = (GS_EXPL["nt"] - 1) // GS_EXPL["ms"][0]
    dt_expl = GS_EXPL["t_stop"] / (GS_EXPL["nt"] - 1)
    for mode, B, side, step, with_g in (("jacobian", 8, n, dt_impl, False),
                                        ("residual", 8, n, dt_impl, False),
                                        ("expl", J_expl, n, dt_expl, True),
                                        ("residual", J0, 17, dt_impl, False)):
        case = f"{'EXPL' if mode == 'expl' else mode} B={B} n={side}" + (" +g" if with_g else "")
        cases.append(("gray_scott_pointwise", case, k14(mode, B, side, step, with_g)))
        stash[("work", "gray_scott_pointwise", case)] = k14_work(mode, B, side, with_g)

    def k15(mode, side):
        s_ = pairs(B2, side, -1.0, 1.0)[:B2]
        w = pairs(B2, side, -1.0, 1.0)[1:]
        dt = t(np.full(B2, dt_b2))

        def launch(ops, out):
            return ops.burgers2d_pointwise(mode, s_, out, dt, BURGERS_2D["nu"], 1.0 / side, w=w,
                                           r=w if mode == "residual" else None)

        def view(r):
            return torch.cat([r[0].flatten(), r[1]]) if mode == "residual" else r
        # K15 rounds each operation of its plain version once, in its order
        return RowCase(lambda: torch.empty((B2, 2, side, side), dtype=dtype, device=dev), launch,
                       exact=True, view=view)

    for mode, side in (("jacobian", nb), ("residual", nb), ("residual", 17)):
        case = f"{mode} B={B2} n={side}"
        cases.append(("burgers2d_pointwise", case, k15(mode, side)))
        stash[("work", "burgers2d_pointwise", case)] = k15_work(mode, B2, side)

    def k16(cfg, J, L, with_g):
        x1 = np.linspace(0, 1, cfg["nx"], endpoint=False)
        seeds = t(np.sin(2 * np.pi * x1) * rng.uniform(0.8, 1.2, (J, 1)))
        g = t(rng.uniform(-1e-3, 1e-3, (J, L, cfg["nx"]))) if with_g else None
        dts = t(np.full((L, J), cfg["t_stop"] / (cfg["nt"] - 1)))
        return k16_case(seeds, dts, g, cfg["nu"], 1.0 / cfg["nx"], dtype, stash)

    md, me = BURGERS_DEEP["ms"][0], BURGERS_EX["ms"][0]
    Jd, Je = (BURGERS_DEEP["nt"] - 1) // md, (BURGERS_EX["nt"] - 1) // me
    for case, cfg, J, L, with_g in (
            (f"deep level-0 F-relax J={Jd} L={md - 1} +g", BURGERS_DEEP, Jd, md - 1, True),
            (f"example level-0 F-relax J={Je} L={me - 1}", BURGERS_EX, Je, me - 1, False)):
        cases.append(("burgers1d_newton", case, k16(cfg, J, L, with_g)))
        stash[("iters_len", "burgers1d_newton", case)] = L * J
        # the seeds, steps and out (and g) once; about 60 n operations a
        # Newton iteration of this run (headline_work's count)
        stash[("work", "burgers1d_newton", case)] = lambda J=J, L=L, n=cfg["nx"], gs=with_g: (
            8 * (J * n + L * J + J * L * n * (2 if gs else 1)),
            stash[("burgers1d_newton", J, L)] * 60 * n + J * L * n)

    xa = np.linspace(-1, 1, ADVECTION_DEEP["nx"])[:-1]
    fac = 1.0 / (xa[1] - xa[0])

    def k17(J, L, step, sign, with_g, r=rng):
        seeds = t(np.exp(-xa ** 2) * r.uniform(0.5, 1.5, (J, 1)))
        g = t(r.uniform(-1e-3, 1e-3, (J, L, xa.size))) if with_g else None
        dts = t(np.full((L, J), step))

        def launch(ops, out):
            return ops.circulant_solve1d(seeds, dts, out, g, sign * fac)
        # into a strided (J, L, n) view of a tube made outside the timed call
        return RowCase(lambda: torch.empty((J, L + 1, xa.size), dtype=dtype, device=dev)[:, 1:],
                       launch, exact=False)

    ma = ADVECTION_DEEP["ms"][0]
    Ja = (ADVECTION_DEEP["nt"] - 1) // ma
    dta = 2.0 / (ADVECTION_DEEP["nt"] - 1)
    # the deep grid's coarsest level: nt = 257 points, one chain of 256 steps
    Lc = (ADVECTION_DEEP["nt"] - 1) // ma ** len(ADVECTION_DEEP["ms"])
    for case, J, L, step, sign, with_g in (
            (f"deep level-0 F-relax J={Ja} L={ma - 1} +g", Ja, ma - 1, dta, 1.0, True),
            ("example level-0 F-relax J=64 L=1", 64, 1, 2.0 / 128, 1.0, False),
            (f"c<-1/2 J={Ja} L={ma - 1}", Ja, ma - 1, 0.05, -1.0, False),
            (f"coarsest march J=1 L={Lc}", 1, Lc, dta * ma ** len(ADVECTION_DEEP["ms"]), 1.0,
             False)):
        # (the added coarsest march draws from its own generator)
        cases.append(("circulant_solve1d", case, k17(
            J, L, step, sign, with_g, rng if J > 1 else np.random.default_rng(SEED + 22))))
        stash[("work", "circulant_solve1d", case)] = (
            8 * (J * xa.size + L * J + J * L * xa.size * (2 if with_g else 1)),
            J * L * 6 * xa.size)
    return cases


def k16_case(seeds, dts, g, nu, dx, dtype, stash):
    """A K16 RowCase: J lanes of L chained Newton steps from seeds into a
    strided (J, L, n) view of a tube made untimed, with each lane's and
    step's iterations; run(ops) returns out and the iterations (as dtype)
    in one tensor and records the iterations' sum (stash[(kernel, J, L)]
    and, for n other than the Burgers cells', stash[(kernel, J, L, n)]) for
    the bound.  float32 cannot reach the float64 Newton tolerance: a fixed
    count of 4."""
    import torch
    (L, J), n = dts.shape, seeds.shape[1]
    tol, maxiter = (1e-12, 30) if dtype == torch.float64 else (0.0, 4)

    def prepare():
        return (torch.empty((J, L + 1, n), dtype=dtype, device=seeds.device)[:, 1:],
                torch.zeros((L, J), dtype=torch.int32, device=seeds.device))

    def launch(ops, state):
        out, iters = state
        ops.burgers1d_newton(seeds, dts, out, g, nu, dx, tol, maxiter, iters)
        return out, iters

    def view(result):
        out, iters = result
        stash[("burgers1d_newton", J, L)] = stash[("burgers1d_newton", J, L, n)] = int(iters.sum())
        return torch.cat([out.flatten(), iters.flatten().to(dtype)])
    return RowCase(prepare, launch, exact=False, view=view)


def space_kernel_cases(dtype, dev, stash):
    """The two kernel modes of the [space] phase at its (2, 2) shapes, from
    a generator of their own: K3's squares mode on a rank's 256 level-0
    C-rows of the spectral slab (64 x 128 coefficients), and K20's BE solve
    with a lam table, the physical pencil's x-pass at the level-0 C-step (32
    states x 64 columns = 2048 lanes of 128 points, a (64, 128) table of
    Lam's columns); each a ``RowCase`` held at the kernel tolerance (a
    second launch bit for bit) with the bytes and operations its function
    needs.  Neither has a single PyTorch call that computes it."""
    import torch
    from pymgrit_tpu_torch.ops import heat_kernels
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
    rng = np.random.default_rng(SEED + 30)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    n = SPACE_TOMS["nx"] - 2
    J, N = (SPACE_TOMS["nt"] - 1) // SPACE_TOMS["ms"][0] // SPACE_MESH[0], n * n // SPACE_MESH[1]
    a, b = (t(rng.uniform(-1, 1, (J + 1, N))) for _ in range(2))
    case = f"squares C-rows J={J} N={N}"
    cases = [("residual_row_norms_squares", case,
              RowCase(lambda: None, lambda k, _: k.residual_row_norms(a[1:], b[:J], squares=True),
                      exact=False))]
    stash[("work", "residual_row_norms_squares", case)] = (8 * (2 * J * N + J), 3 * J * N)

    S_np, lamx = sine_eigenbasis(n, (n + 1.0) ** 2)
    D = n // SPACE_MESH[1]
    Js = (SPACE_PHYS["nt"] - 1) // SPACE_PHYS["ms"][0] // SPACE_MESH[0]
    B = Js * D
    S = t(S_np)
    table = t(lamx[None, :] + lamx[:D, None])            # Lam[:, j] of the first D columns
    X = t(rng.uniform(-1, 1, (B, n)))
    dt = t(np.full(B, 1.0 / (SPACE_PHYS["nt"] - 1)))

    def x_pass(ops, out):
        return ops.sine_solve1d(X, out, S, table, dt)

    case = f"x-pass lam table B={B} n={n} D={D}"
    cases.append(("sine_solve1d_lam_table", case,
                  RowCase(lambda: torch.empty((B, n), dtype=dtype, device=dev), x_pass,
                          exact=False)))
    stash[("plan", "sine_solve1d_lam_table", case)] = ProductPlans(
        heat_kernels.sine_solve1d_plans(X, S, table))
    stash[("work", "sine_solve1d_lam_table", case)] = (8 * (2 * B * n + n * n + D * n + B),
                                                       4 * B * n * n + 3 * B * n)
    return cases


def halo_fe_work(B, R, Q, n_in):
    """(bytes, operations) of K7's FE halo call on B slabs of R rows of Q
    points, n_in of them off the grid's ring, with g: the slabs, one halo
    row each, g and the slab's rows of the ring read, one rhs row (stride
    0) read once, the slabs written; 13 operations an interior point, as
    ``k7_work`` counts FE."""
    return 8 * (3 * B * R * Q + B * Q + R * Q + n_in * (Q - 2)), 13 * B * n_in * (Q - 2)


def slab_mode_cases(dtype, dev, stash):
    """The modes the Heat2D FE and spectral DD space slabs add, at a (2, 2)
    rank's shapes of the [space] cells, from a generator of their own:
    K7's halo mode, FE with g, on 512 states of slab 1 of 2 (rows 65-129 of
    130: the row above from the halo operand, the last row the grid's
    ring), held bit for bit against its plain version, after both slabs of
    the same states are held bit for bit against the kernel's whole-state
    FE mode; in float32, K3's squares mode on the dd_spectral cell's
    C-rows of a slab (K25's float32 resid rows against a zero row)."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH
    rng = np.random.default_rng(SEED + 26)
    dname = str(dtype).split(".")[-1]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    B, P_, S_ = 512, SPACE_FE["nx"], SPACE_MESH[1]
    Q, R = P_, P_ // S_
    fx = fy = (P_ - 1.0) ** 2
    dt = SPACE_FE["t_end"] / (SPACE_FE["nt"] - 1)
    u = t(rng.uniform(-1, 1, (B, P_, Q)))
    ring = t(rng.uniform(-1, 1, (P_, Q)))
    ring[1:-1, 1:-1] = 0.0
    r0 = t(rng.uniform(-1, 1, (P_ - 2) * (Q - 2)))
    g = t(rng.uniform(-1e-3, 1e-3, (B, P_, Q)))

    def slab(s):
        """Slab s's operands: rows, halo rows (None at the ring), the rhs
        rows of its rows off the ring (stride 0), its rows of the ring."""
        rows = slice(s * R, (s + 1) * R)
        i0, i1 = max(rows.start, 1) - 1, min(rows.stop, P_ - 1) - 1
        rr = r0[i0 * (Q - 2):i1 * (Q - 2)].expand(B, (i1 - i0) * (Q - 2))
        return (rows, (None if s == 0 else u[:, rows.start - 1],
                       None if s == S_ - 1 else u[:, rows.stop]), rr, ring[rows].contiguous())

    whole = DISPATCH.theta_rhs2d(u, torch.empty_like(u), dt, 0.0, fx, fy,
                                 r0.expand(B, r0.numel()), r0.expand(B, r0.numel()), ring=ring,
                                 g=g)
    for s in range(S_):
        rows, halo, rr, ring_s = slab(s)
        got = DISPATCH.theta_rhs2d(u[:, rows], torch.empty((B, R, Q), dtype=dtype, device=dev),
                                   dt, 0.0, fx, fy, rr, rr, ring=ring_s, g=g[:, rows], halo=halo)
        torch.cuda.synchronize()
        same = torch.equal(got, whole[:, rows])
        print(f"[kernels] theta_rhs2d_halo_fe slab {s} of {S_} ({R} of {P_} rows) {dname}: bit "
              f"for bit with the whole-state FE mode's rows: {same}")
        check(same, f"theta_rhs2d halo FE slab {s} {dname}: differs from the whole-state mode")
    del whole
    rows, halo, rr, ring_s = slab(S_ - 1)
    u_s, g_s = u[:, rows], g[:, rows]
    n_in = R - 1
    case = f"FE halo B={B} R={R} of {P_} +g"

    def launch(ops, out):
        return ops.theta_rhs2d(u_s, out, dt, 0.0, fx, fy, rr, rr, ring=ring_s, g=g_s, halo=halo)

    cases = [("theta_rhs2d_halo_fe", case,
              RowCase(lambda: torch.empty((B, R, Q), dtype=dtype, device=dev), launch))]
    stash[("work", "theta_rhs2d_halo_fe", case)] = halo_fe_work(B, R, Q, n_in)
    if dtype == torch.float32:
        n = SPACE_DD["nx"] - 2
        J, N = (SPACE_DD["nt"] - 1) // SPACE_DD["ms"][0] // SPACE_MESH[0], n * (n // S_)
        d = t(rng.uniform(-1, 1, (J, N)))
        zero = torch.zeros(N, dtype=dtype, device=dev).expand(J, N)
        case = f"squares DD C-rows J={J} N={N}"
        cases.append(("residual_row_norms_squares", case,
                      RowCase(lambda: None,
                              lambda k, _: k.residual_row_norms(d, zero, squares=True),
                              exact=False)))
        stash[("work32", "residual_row_norms_squares", case)] = (4 * (J * N + N + J), 3 * J * N)
    return cases


def slab_work(kernel, mode, B, R, n, with_g=False):
    """(bytes, operations) of a halo call on B lanes' slabs of R of n rows
    (K11: one plane a lane; K14, K15: two): the whole-state call's on R
    rows, plus the halo rows read (K15's Jacobian two pairs of them)."""
    if kernel == "allen_cahn_pointwise":
        nbytes, ops = k11_work(mode, B, n)
        planes, halos = 1, 1
    elif kernel == "gray_scott_pointwise":
        nbytes, ops = k14_work(mode, B, n, with_g)
        planes, halos = 2, 1
    else:
        nbytes, ops = k15_work(mode, B, n)
        planes, halos = 2, 2 if mode == "jacobian" else 1
    lanes = 8 * B * (2 if mode == "residual" else 1)
    return ((nbytes - lanes) * R // n + lanes + 8 * 2 * halos * planes * B * n,
            ops * R // n)


def prologue_work(kernel, B, R, n):
    """(bytes, operations) of a prologue call on B lanes' R x n rows: the
    state read and written and dt read; operations a point: Allen-Cahn's
    u^2, inv_eps2 u, 1 - u^2, the product, dt times it and the add (6);
    Gray-Scott's two species: v v, u v^2, 1 - u, a (1 - u), the sum, dt
    times it, the add; b v, the difference, dt times it, the add (11)."""
    planes, ops = (1, 6) if kernel == "allen_cahn_pointwise" else (2, 11)
    return 8 * (2 * planes * B * R * n + B), ops * B * R * n


def periodic_space_kernel_cases(dtype, dev, stash):
    """The kernel modes of the periodic models' space slabs at a (2, 2)
    rank's shapes of the [space] cells, from a generator of their own:
    K11's and K14's halo modes on the Newton-Krylov lanes (Allen-Cahn CN:
    2 lanes, Gray-Scott IMPL: 2 pairs, slabs of 64 of 128 rows), K15's on
    Burgers2D's (1 pair, 32 of 64 rows), each with its two halo rows; the
    prologue modes on the IMEX level-0 lanes (Allen-Cahn's bench row at
    [space]'s cut, the Gray-Scott AT run's); K20 on the Hartley basis: the
    y-transform of the Allen-Cahn IMEX lanes' slab rows (the library call
    ``x @ H`` beside it) and the x-pass with the species-scaled lam table
    at the Allen-Cahn and Gray-Scott pencil shapes (lanes (lane, species,
    column)).  The halo and prologue modes bit for bit ``RowCase``s, K20's
    at the kernel tolerance."""
    import torch
    from pymgrit_tpu_torch.ops import heat_kernels
    from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs
    rng = np.random.default_rng(SEED + 40)
    S = SPACE_MESH[1]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def residual_view(mode):
        def view(r):                    # the residual and its per-lane max as one tensor
            return torch.cat([r[0].flatten(), r[1]]) if mode == "residual" else r
        return view

    cases = []
    n = SPACE_AC_CN["nx"]
    R = n // S
    B = (SPACE_AC_CN["nt"] - 1) // SPACE_AC_CN["ms"][0] // SPACE_MESH[0]   # level-0 lanes a rank
    dt_cn = SPACE_AC_CN["t_stop"] / (SPACE_AC_CN["nt"] - 1)
    eps = 0.04

    def k11(mode, B, R, n):
        u = t(rng.uniform(-1, 1, (B, R, n)))
        x = t(rng.uniform(-1, 1, (B, R, n)))
        above, below = (t(rng.uniform(-1, 1, (B, n))) for _ in range(2))
        fac = t(np.full(B, 0.5 * dt_cn))

        def launch(ops, out):
            return ops.allen_cahn_pointwise(mode, u, out, fac, 1.0 / eps ** 2, 1.0 / n ** 2, 2,
                                            x=x, rhs=x, halo=(above, below))
        return RowCase(lambda: torch.empty((B, R, n), dtype=dtype, device=dev), launch,
                       view=residual_view(mode))

    for mode in ("jacobian", "residual", "rhs"):
        case = f"{mode} B={B} R={R} n={n} halo"
        cases.append(("allen_cahn_pointwise_halo", case, k11(mode, B, R, n)))
        stash[("work", "allen_cahn_pointwise_halo", case)] = slab_work(
            "allen_cahn_pointwise", mode, B, R, n)

    gs = GS_COEF
    ng = SPACE_GS_IMPL["nx"]
    Rg = ng // S
    Bg = (SPACE_GS_IMPL["nt"] - 1) // SPACE_GS_IMPL["ms"][0] // SPACE_MESH[0]
    dt_gs = SPACE_GS_IMPL["t_stop"] / (SPACE_GS_IMPL["nt"] - 1)

    def k14(mode, B, R, n, dt):
        s_ = t(rng.uniform(0, 1, (B, 2, R, n)))
        w = t(rng.uniform(-1, 1, (B, 2, R, n)))
        above, below = (t(rng.uniform(0, 1, (B, 2, n))) for _ in range(2))
        steps = t(np.full(B, dt))

        def launch(ops, out):
            return ops.gray_scott_pointwise(mode, s_, out, steps, gs["du"], gs["dv"], gs["a"],
                                            gs["b"], (2.0 / n) ** 2, w=w,
                                            r=w if mode == "residual" else None,
                                            halo=None if mode == "prologue" else (above, below))
        return RowCase(lambda: torch.empty((B, 2, R, n), dtype=dtype, device=dev), launch,
                       view=residual_view(mode))

    for mode in ("jacobian", "residual", "expl"):
        case = f"{mode} B={Bg} R={Rg} n={ng} halo"
        cases.append(("gray_scott_pointwise_halo", case, k14(mode, Bg, Rg, ng, dt_gs)))
        stash[("work", "gray_scott_pointwise_halo", case)] = slab_work(
            "gray_scott_pointwise", mode, Bg, Rg, ng)

    nb = SPACE_B2["nx"]
    Rb = nb // S
    Bb = (SPACE_B2["nt"] - 1) // SPACE_B2["ms"][0] // SPACE_MESH[0]
    dt_b = SPACE_B2["t_stop"] / (SPACE_B2["nt"] - 1)

    def k15(mode):
        s_ = t(rng.uniform(-1, 1, (Bb, 2, Rb, nb)))
        w = t(rng.uniform(-1, 1, (Bb, 2, Rb, nb)))
        rows = [t(rng.uniform(-1, 1, (Bb, 2, nb))) for _ in range(4)]
        steps = t(np.full(Bb, dt_b))

        def launch(ops, out):
            return ops.burgers2d_pointwise(mode, s_, out, steps, BURGERS_2D["nu"], 1.0 / nb,
                                           w=w, r=w if mode == "residual" else None,
                                           halo=tuple(rows[:2]),
                                           w_halo=tuple(rows[2:]) if mode == "jacobian" else None)
        return RowCase(lambda: torch.empty((Bb, 2, Rb, nb), dtype=dtype, device=dev), launch,
                       view=residual_view(mode))

    for mode in ("jacobian", "residual"):
        case = f"{mode} B={Bb} R={Rb} n={nb} halo"
        cases.append(("burgers2d_pointwise_halo", case, k15(mode)))
        stash[("work", "burgers2d_pointwise_halo", case)] = slab_work(
            "burgers2d_pointwise", mode, Bb, Rb, nb)

    # the IMEX prologues on the level-0 lanes of a (2, 2) rank
    n_ac = SPACE_AC["nx"]
    J_ac = (SPACE_AC["nt"] - 1) // SPACE_AC["ms"][0] // SPACE_MESH[0]
    dt_ac = SPACE_AC["t_stop"] / (SPACE_AC["nt"] - 1)
    u_ac = t(rng.uniform(-1, 1, (J_ac, n_ac // S, n_ac)))
    step_ac = t(np.full(J_ac, dt_ac))
    case = f"IMEX prologue B={J_ac} R={n_ac // S} n={n_ac}"
    cases.append(("allen_cahn_pointwise_prologue", case, RowCase(
        lambda: torch.empty_like(u_ac),
        lambda ops, out: ops.allen_cahn_pointwise("prologue", u_ac, out, step_ac,
                                                  1.0 / eps ** 2, 1.0 / n_ac ** 2, 2))))
    stash[("work", "allen_cahn_pointwise_prologue", case)] = prologue_work(
        "allen_cahn_pointwise", J_ac, n_ac // S, n_ac)
    n_at = SPACE_GS_AT["nx"]
    J_at = (SPACE_GS_AT["nt"] - 1) // SPACE_GS_AT["ms"][0] // SPACE_MESH[0]
    dt_at = SPACE_GS_AT["t_stop"] / (SPACE_GS_AT["nt"] - 1)
    case = f"IMEX prologue B={J_at} R={n_at // S} n={n_at}"
    cases.append(("gray_scott_pointwise_prologue", case, k14("prologue", J_at, n_at // S, n_at,
                                                            dt_at)))
    stash[("work", "gray_scott_pointwise_prologue", case)] = prologue_work(
        "gray_scott_pointwise", J_at, n_at // S, n_at)

    # K20 on H: the y-transform of the Allen-Cahn IMEX slab rows, and the
    # x-pass at the Allen-Cahn and Gray-Scott pencil shapes
    H = t(hartley_basis(n_ac))
    rows_ac = t(rng.uniform(-1, 1, (J_ac * (n_ac // S), n_ac)))
    case = f"transform B={rows_ac.shape[0]} n={n_ac}"
    cases.append(("sine_solve1d_hartley", case, RowCase(
        lambda: torch.empty_like(rows_ac),
        lambda ops, out: ops.sine_solve1d(rows_ac, out, H), exact=False)))
    stash[("plan", "sine_solve1d_hartley", case)] = ProductPlans(
        heat_kernels.sine_solve1d_plans(rows_ac, H))
    stash[("work", "sine_solve1d_hartley", case)] = (
        8 * (2 * rows_ac.numel() + n_ac * n_ac), 2 * rows_ac.shape[0] * n_ac * n_ac)
    stash[("library", "sine_solve1d_hartley")] = stash[("library", "sine_solve1d_hartley", case)] \
        = lambda: torch.matmul(rows_ac, H)
    for label, cfg, J, coef in (("Allen-Cahn", SPACE_AC, J_ac, [1.0]),
                                ("Gray-Scott", SPACE_GS_AT, J_at, [gs["du"], gs["dv"]])):
        nn = cfg["nx"]
        D = nn // S
        dx = 1.0 / nn if cfg["model"] == "AllenCahn" else 2.0 / nn
        table = t(-periodic_lap_eigs(nn, dx)[:, :D].T)       # the first shard's columns
        lanes = J * len(coef) * D
        X = t(rng.uniform(-1, 1, (lanes, nn)))
        dt = cfg["t_stop"] / (cfg["nt"] - 1)
        lane_dt = t(np.repeat((dt * np.asarray(coef))[None].repeat(J, 0).reshape(-1), D))
        Hx = t(hartley_basis(nn))

        def x_pass(ops, out, X=X, Hx=Hx, table=table, lane_dt=lane_dt):
            return ops.sine_solve1d(X, out, Hx, table, lane_dt)

        case = f"x-pass {label} B={lanes} n={nn} D={D} S={len(coef)}"
        cases.append(("sine_solve1d_hartley_lam_table", case, RowCase(
            lambda X=X: torch.empty_like(X), x_pass, exact=False)))
        stash[("plan", "sine_solve1d_hartley_lam_table", case)] = ProductPlans(
            heat_kernels.sine_solve1d_plans(X, Hx, table))
        stash[("work", "sine_solve1d_hartley_lam_table", case)] = (
            8 * (2 * lanes * nn + nn * nn + D * nn + lanes), 4 * lanes * nn * nn + 3 * lanes * nn)
    return cases


class ProductPlans(tuple):
    """K20's two product plans (the second None for a transform), printed
    beside its cases as K22's one plan is."""

    def describe(self):
        return " | then ".join(p.describe() for p in self if p is not None)


class RowCase:
    """A K1-K21 or K23-K25 case in two steps:
    ``prepare()`` makes what the call writes into where the call updates a
    tube in place or into a given out (untimed: the fresh copy of a tube,
    the empty tube), ``launch(ops, state)`` makes the call and returns its
    output.  ``run(ops)`` does both: the correctness comparison's fresh
    operands (``view`` turns what the call returns into one tensor: K11's,
    K14's and K15's residual and its per-lane max; K16's out and
    iterations).  With ``exact`` (K1, K2, K4, K7 in float64, K11, K13, K14,
    K15, K18, K19, K21, K23-K25) the kernel equals its plain version bit for
    bit; without (K3, K5, K6, K10, K16, K17 and K20 sum in another order,
    K8 composes its steps in another order, K9 and K12 contract a multiply
    and an add into an FMA) it is held at the kernel tolerance; a second
    launch must give the same bits."""

    def __init__(self, prepare, launch, exact=True, view=None):
        self.prepare, self.launch, self.exact, self.view = prepare, launch, exact, view

    def __call__(self, ops):
        out = self.launch(ops, self.prepare())
        return out if self.view is None else self.view(out)



def transfer_cases(dtype, dev, rng, stash):
    """K18 and K19 at the shapes of the [spatial] and [spatial1d] phases.
    2D: spatial65's level 0, 1024 C-rows of 65^2 (strided rows of the
    condensed tube) <-> 33^2: the FAS right-hand side (two terms, two adds),
    the restriction of the C-rows (one term, into a given out), the
    correction and nested iteration's interpolation.  1D: the example's
    level 0, 64 C-rows of 15 <-> 7 interior points, the same four calls.
    The bytes of each are recorded, and one PyTorch call for the function a
    case computes where there is one: the strided slice copy (injection)
    and F.conv1d with stride 2 (full weighting) beside the restriction of
    the C-rows; F.interpolate bilinear with aligned corners and
    F.conv_transpose1d with stride 2 beside K19's correction (the
    interpolation alone)."""
    import torch
    import torch.nn.functional as F

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    cases = []
    for dim, fine, coarse, rows in ((2, (65, 65), (33, 33), 1024), (1, (15,), (7,), 64)):
        tube_f = t(rng.uniform(-1, 1, (rows + 1,) + fine))
        step_f = t(rng.uniform(-1, 1, (rows,) + fine))
        tube_c, step_c = (t(rng.uniform(-1, 1, (rows + 1,) + coarse)) for _ in range(2))
        label = f"{'spatial65' if dim == 2 else 'example'} {dim}D R={rows}"
        nf, ncs = int(np.prod(fine)), int(np.prod(coarse))

        def fas(ops, _, tube_f=tube_f, step_f=step_f, tube_c=tube_c, step_c=step_c, dim=dim):
            out = torch.empty_like(tube_c)[1:]
            return ops.restrict_combine(out, [step_f, tube_f[1:]], [1.0, -1.0],
                                        [tube_c[1:], step_c[1:]], [1.0, -1.0], dim)

        def restrict(ops, out, tube_f=tube_f, dim=dim):
            return ops.restrict_combine(out, [tube_f], [1.0], dim=dim)

        # the correction updates a copy of the fine tube, made outside the
        # timed call (RowCase.prepare), as the library call beside it copies
        # nothing
        def correct(ops, dst, tube_c=tube_c, step_c=step_c, dim=dim):
            ops.interpolate_combine(dst[1:], tube_c[1:], step_c[1:], dim)
            return dst

        def nested(ops, dst, tube_c=tube_c, dim=dim):
            return ops.interpolate_combine(dst[1:], tube_c[1:], None, dim)[1:]

        cases += [("restrict_combine", f"FAS {label}", RowCase(lambda: None, fas)),
                  ("restrict_combine", f"restrict C-rows {label}",
                   RowCase(lambda tube_c=tube_c: torch.empty_like(tube_c), restrict)),
                  ("interpolate_combine", f"correction {label}", RowCase(tube_f.clone, correct)),
                  ("interpolate_combine", f"nested {label}",
                   RowCase(lambda tube_f=tube_f: torch.empty_like(tube_f), nested))]
        # the bytes each function needs: injection reads the coincident fine
        # points only, full weighting every fine point; the correction reads
        # and writes dst
        need = ncs if dim == 2 else nf
        stash[("work", "restrict_combine", f"FAS {label}")] = (8 * rows * (2 * need + 3 * ncs), 0)
        stash[("work", "restrict_combine", f"restrict C-rows {label}")] = (
            8 * (rows + 1) * (need + ncs), 0)
        stash[("work", "interpolate_combine", f"correction {label}")] = (
            8 * rows * (2 * ncs + 2 * nf), 0)
        stash[("work", "interpolate_combine", f"nested {label}")] = (8 * rows * (ncs + nf), 0)
        if dim == 2:
            inj_out = torch.empty_like(tube_c)
            stash[("library", "restrict_combine", f"restrict C-rows {label}")] = \
                lambda f=tube_f, o=inj_out: o.copy_(f[:, ::2, ::2])
            stash[("library", "interpolate_combine", f"correction {label}")] = \
                lambda c=tube_c, size=fine: F.interpolate(c[1:, None], size=size, mode="bilinear",
                                                          align_corners=True)
        else:
            w_r = t([[[0.25, 0.5, 0.25]]])
            w_p = t([[[0.5, 1.0, 0.5]]])
            stash[("library", "restrict_combine", f"restrict C-rows {label}")] = \
                lambda f=tube_f, w=w_r: F.conv1d(f[:, None], w, stride=2)
            stash[("library", "interpolate_combine", f"correction {label}")] = \
                lambda c=tube_c, w=w_p: F.conv_transpose1d(c[1:, None], w, stride=2)
    # the headline cases: K18's FAS call has no one-call counterpart (the
    # summary's library_ms is null); K19's correction is held against the
    # interpolation alone
    stash[("library", "interpolate_combine")] = stash[
        ("library", "interpolate_combine", "correction spatial65 2D R=1024")]
    return cases


def heat1d_cases(dtype, dev, rng, stash):
    """K20 at the [spatial1d] phase's level-0 shape: the physical Heat1D
    step of 64 rows of 15 interior points (the F- and C-relaxation's
    step_batched, a time-dependent rhs row per state), the sine transform
    of those rows (relax_interval's), a wide step (1024 rows of 1023
    points), and [bdf]'s coarsest march (one BE solve of one row of 999
    points, a BDF1 sub-step: the skinny plan, the table streamed once) and
    a transform of 8 rows of 999 points (skinny); each a ``RowCase`` (the
    output made untimed, a fixed summation order: held at the kernel
    tolerance, a second launch bit for bit) with the bytes and operations
    its function needs, the transform with torch.matmul beside it."""
    import torch
    from pymgrit_tpu_torch.ops import heat_kernels
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def empty(B, n):
        return lambda: torch.empty((B, n), dtype=dtype, device=dev)

    cases = []
    nb = BDF["nx"] - 2
    for label, B, n, fac, step in (("example", 64, 15, 64.0, 2.0 / 128),
                                   ("wide", 1024, 1023, 1024.0 ** 2, 1.0 / 4096),
                                   ("coarsest march", 1, nb, (nb + 1.0) ** 2, 1.0 / 64)):
        S_np, lam_np = sine_eigenbasis(n, fac)
        S, lam = t(S_np), t(lam_np)
        # the cases added after the first two draw from a generator of their
        # own, so that every other case keeps its inputs (kernel_digest.py)
        r = rng if label != "coarsest march" else np.random.default_rng(SEED + 20)
        tube = t(r.uniform(-1, 1, (max(B, 8) + 1, n)))
        rhs_rows = t(r.uniform(-1, 1, (B, n)))
        dt = t(np.full(B, step))

        def step_(ops, out, tube=tube, rhs_rows=rhs_rows, dt=dt, S=S, lam=lam, B=B):
            return ops.sine_solve1d(tube[:B], out, S, lam, dt, rhs_rows)

        case = f"{label} step B={B} n={n}"
        cases.append(("sine_solve1d", case, RowCase(empty(B, n), step_, exact=False)))
        stash[("plan", "sine_solve1d", case)] = ProductPlans(
            heat_kernels.sine_solve1d_plans(tube[:B], S, lam, rhs_rows))
        stash[("work", "sine_solve1d", case)] = (8 * (3 * B * n + n * n + n + B),
                                                 4 * B * n * n + 5 * B * n)
        if label in ("example", "coarsest march"):
            Bt = B if label == "example" else 8

            def transform(ops, out, tube=tube, S=S, Bt=Bt):
                return ops.sine_solve1d(tube[1:Bt + 1], out, S)

            case = f"{label} transform B={Bt} n={n}"
            cases.append(("sine_solve1d", case, RowCase(empty(Bt, n), transform, exact=False)))
            stash[("plan", "sine_solve1d", case)] = ProductPlans(
                heat_kernels.sine_solve1d_plans(tube[1:Bt + 1], S))
            stash[("work", "sine_solve1d", case)] = (8 * (2 * Bt * n + n * n), 2 * Bt * n * n)
            stash[("library", "sine_solve1d", case)] = lambda x=tube[1:Bt + 1], S=S: x @ S
    return cases


def ragged_grids():
    """The [ragged] phase's four nested time grids (bench.py's construction)."""
    nt = RAGGED["nt"]
    rng = np.random.default_rng(RAGGED["seed"])
    base = np.arange(0, nt, RAGGED["stride"])
    jit = np.clip(base + rng.integers(-RAGGED["jitter"], RAGGED["jitter"] + 1, size=base.size),
                  0, nt - 1)
    idx1 = np.unique(np.concatenate([[0, nt - 1], jit]))
    t = np.linspace(0, 1, nt)
    return [t, t[idx1], t[idx1][::4], t[idx1][::4][::4]]


def slice7_cases(dtype, dev, rng, stash):
    """K20's BDF2 mode at [bdf]'s level-0 shape (128 pairs of 999 points,
    the second solve of a step: first = the pair's second slot, second = the
    new first slot of the same output tube); K21 at [ragged]'s level-0
    shapes (65^2 states: the gather of the 515 C-rows, the drop-scatter of
    the 514 x 13 chain slots into the 4097-row tube, the weighted C-update
    of 514 rows in place); K22 at 1, 8 and 128 lanes x 2400 (the deep
    grid's coarsest march, the diffusion example's level-0 F-step and the
    deep grid's level 0; each with its product plan); each with the bytes and
    operations its function needs and, where one exists, one PyTorch call
    (index_select / index_copy_ for K21, the two cuBLAS GEMMs for K22)."""
    import torch
    from pymgrit_tpu_torch.core.levels import build_level_infos
    from pymgrit_tpu_torch.ops import heat_kernels
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def idx(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64).reshape(-1), device=dev)

    cases = []
    # K20 BDF2: lanes of the level-0 pair tube (B, 2, n), per-lane
    # coefficients; and 4 lanes (the skinny plan)
    n = BDF["nx"] - 2
    S_np, lam_np = sine_eigenbasis(n, (n + 1.0) ** 2)
    S, lam = t(S_np), t(lam_np)
    for B, r in (((BDF["nt"] // 2) // 2, rng), (4, np.random.default_rng(SEED + 21))):
        pairs = t(r.uniform(-1, 1, (B + 1, 2, n)))
        rhs_row = t(r.uniform(-1, 1, n)).expand(B, n)
        coef = t(np.stack([r.uniform(100, 300, B) for _ in range(3)]))

        def bdf2(ops, out, pairs=pairs, rhs_row=rhs_row, coef=coef, B=B):
            return ops.sine_solve1d(pairs[:B, 1], out[:, 1], S, lam, rhs=rhs_row,
                                    second=out[:, 0], c2=coef[0], c1=coef[1], coeff=coef[2])

        case = f"BDF2 B={B} n={n}"
        cases.append(("sine_solve1d", case,
                      RowCase(lambda pairs=pairs: pairs[1:].clone(), bdf2, exact=False)))
        out = pairs[1:]       # the output's second slot, as bdf2 reads it (its alignment)
        stash[("plan", "sine_solve1d", case)] = ProductPlans(heat_kernels.sine_solve1d_plans(
            pairs[:B, 1], S, lam, rhs_row, out[:, 0], coef[2]))
        stash[("work", "sine_solve1d", case)] = (8 * (4 * B * n + n * n + n + 3 * B),
                                                 4 * B * n * n + 6 * B * n)

    # K21 at the ragged level 0 of [ragged]
    info = build_level_infos(ragged_grids())[0]
    nt, N = info.nt, (RAGGED["nx"]) ** 2
    ch = info.chains
    J, L = ch.seed.size, ch.lmax
    valid = ch.f_idx[ch.mask]
    tube = t(rng.uniform(-1, 1, (nt, N)))
    slots = t(rng.uniform(-1, 1, (J * L, N)))
    cpts, ci = idx(info.cpts), idx(info.cpts[1:])
    f_out, valid_i = idx(ch.f_idx), idx(valid)
    slots_valid = slots[torch.as_tensor(np.flatnonzero(ch.mask.reshape(-1)), device=dev)]
    stepped = t(rng.uniform(-1, 1, (ci.shape[0], N)))
    nc = cpts.shape[0]

    def gather(ops, _):
        out = torch.empty((nc, N), dtype=dtype, device=dev)
        return ops.indexed_combine(out, [tube], [1.0], idx=[cpts])

    def scatter(ops, out):
        return ops.indexed_combine(out, [slots], [1.0], io=f_out)

    def weighted(ops, out):
        return ops.indexed_combine(out, [stepped, out], [0.5, 0.5], io=ci, idx=[None, ci])

    # the drop-scatter and the weighted update write into a fresh copy of
    # the tube, made outside the timed call (RowCase.prepare)
    kc = [(f"gather C-rows R={nc} N={N}", RowCase(lambda: None, gather), 8 * (2 * nc * N + nc), 0),
          (f"drop-scatter J={J} L={L} N={N}", RowCase(tube.clone, scatter),
           8 * (2 * valid.size * N + J * L), 0),
          (f"weighted C-update R={nc - 1} N={N}", RowCase(tube.clone, weighted),
           8 * (3 * (nc - 1) * N + nc - 1), 3 * (nc - 1) * N)]
    for label, run, nbytes, nops in kc:
        cases.append(("indexed_combine", label, run))
        stash[("work", "indexed_combine", label)] = (nbytes, nops)
    dst = tube.clone()
    stash[("library", "indexed_combine", kc[0][0])] = lambda: torch.index_select(tube, 0, cpts)
    stash[("library", "indexed_combine", kc[1][0])] = lambda: dst.index_copy_(0, valid_i,
                                                                             slots_valid)
    stash[("library", "indexed_combine")] = stash[("library", "indexed_combine", kc[1][0])]

    # K22 at the diffusion example's N = 2400: random tables scaled so that
    # every output is O(1); 1 lane (the deep grid's coarsest march), 8 (the
    # example's level-0 F-step) and 128 (the deep grid's level 0)
    from pymgrit_tpu_torch.ops import eig_step as k22_mod
    Ne = 6 * DIFFUSION["n"] ** 2
    W, V = (t(rng.uniform(-1, 1, (Ne, Ne)) / math.sqrt(Ne)) for _ in range(2))
    lam_e = t(rng.uniform(0, 2, Ne))
    xe = t(rng.uniform(-1, 1, (129, Ne)))
    for Bl in (1, 8, 128):
        dt = t(np.full(Bl, 10.0 / 16))

        def k22(ops, Bl=Bl, dt=dt):
            out = torch.empty((Bl, Ne), dtype=dtype, device=dev)
            return ops.eig_step(xe[1:Bl + 1], out, W, V, lam_e, dt)

        case = f"{Bl} lanes N={Ne}"
        cases.append(("eig_step", case, k22))
        stash[("work", "eig_step", case)] = (8 * (2 * Ne * Ne + 2 * Bl * Ne + Ne + Bl),
                                             4 * Bl * Ne * Ne + 3 * Bl * Ne)
        stash[("library", "eig_step", case)] = lambda x=xe[1:Bl + 1]: (x @ W.T) @ V.T
        stash[("plan", "eig_step", case)] = k22_mod.plan(xe[1:Bl + 1], W, V)
    stash[("library", "eig_step")] = stash[("library", "eig_step", f"128 lanes N={Ne}")]
    return cases


# float32 operations of one double-double operation of csrc/dd.cuh (split
# 4, two_prod 17, two_sum 6, quick_two_sum 3): what K23-K25 execute an element
DD_FLOPS = {"add": 20, "sub": 20, "mul": 24, "div": 114, "sqrt": 67, "neg": 2, "resid": 21}


def dd_cases(dev, rng, stash):
    """K23-K26 at the shapes of the [dd] phase, each run(ops) returning a DD
    (or K25's float32 residual): K23 (``RowCase``s) the materialization of
    [dd]'s TOMS level-0 tube (512 intervals x 31 F-rows of 127^2 DD
    coefficients, the seeds copied to the C-rows) and the condensed C-step
    (the last row); K24 (``RowCase``s) dd_toms129's chains with g: level 1's F-relaxation
    (32 chains x 15 steps), BE and CN, level 2's (8 x 3), a level-1 C-step
    (32 x 1) and the coarsest march (1 x 2);
    K25 the FAS combine, the weighted C-update and the residual difference
    over 512 packed C-rows of 127^2, each elementwise op on wild-scale
    inputs of that size (magnitudes 1e-8 .. 1e8), the cancellation case of
    tests/ops/test_dd.py and Dahlquist's 0-d steps with immediate scalars;
    K26 [dd65]'s two-sided 63 x 63 sine products on 1024 lanes of the
    65^2 states and Diffusion2D's (8, 2400) @ (2400, 2400) table product
    (and the same at 1 and 128 rows), each with its product plan.
    Records each case's bytes (8 a DD value, 4 a float32 one) and float32
    operations (K26: FP64 tensor-core operations) in stash, and K26's
    torch.matmul on the float64 hi + lo operands as its library call."""
    import torch
    from pymgrit_tpu_torch.ops import dd
    from pymgrit_tpu_torch.ops import dd_matmul as dd_matmul_mod
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
    F, A_ = DD_FLOPS, "add"

    def pair(a):
        return dd.from_f64(np.ascontiguousarray(a), dev)

    def packed(a):
        """(rows, 2, ...) float32 tube rows holding the DD split of a."""
        x = pair(a)
        return torch.stack([x.hi, x.lo], 1)

    n = DD_TOMS["nx"] - 2
    N, m0 = n * n, DD_TOMS["ms"][0]
    J = (DD_TOMS["nt"] - 1) // m0
    cases = []

    # K23 (RowCases): the materialization into the (nt, 2, N) tube and the
    # C-step, each into a tube made untimed
    seeds = packed(rng.uniform(-1, 1, (J, N)))
    A, G = pair(rng.uniform(0, 1, (m0, N))), pair(rng.uniform(-1, 1, (m0, N)))
    A31, G31 = A[:m0 - 1], G[:m0 - 1]

    def materialize(ops, tube):
        out = dd.pair(tube[:J * m0].view(J, m0, 2, N)[:, 1:], ops, 2)
        ops.dd_interval_affine(dd.pair(seeds, ops), A31, G31, out, 0,
                               dd.pair(tube[0:J * m0:m0], ops))
        return dd.pair(tube[:J * m0], ops)

    def c_step(ops, out):
        ops.dd_interval_affine(dd.pair(seeds, ops), A, G, dd.pair(out, ops, 2), m0 - 1)
        return dd.pair(out[:, 0], ops)

    case = f"materialize J={J} R={m0 - 1} N={N}"
    cases.append(("dd_interval_affine", case, RowCase(
        lambda: torch.empty((J * m0 + 1, 2, N), dtype=torch.float32, device=dev), materialize)))
    stash[("work", "dd_interval_affine", case)] = (8 * (J * N + 2 * (m0 - 1) * N + J * m0 * N),
                                                   (F["mul"] + F[A_]) * J * (m0 - 1) * N)
    case = f"C-step J={J} N={N}"
    cases.append(("dd_interval_affine", case, RowCase(
        lambda: torch.empty((J, 1, 2, N), dtype=torch.float32, device=dev), c_step)))
    stash[("work", "dd_interval_affine", case)] = (8 * (2 * J * N + 2 * N),
                                                   (F["mul"] + F[A_]) * J * N)

    # K24: dd_toms129's chains, each with g: level 1's F-relaxation (32
    # chains of 15 steps), BE and CN; level 2's (8 chains of 3 steps); a
    # level-1 C-step (32 chains of one step); the coarsest march (one chain
    # of 2 steps); each at its level's step size, out made untimed
    # (level 1's operands take the shared generator's draws in the order
    # they always had, so that K25's inputs stay as they were; the other
    # chains draw from a generator of their own)
    m1, m2 = DD_TOMS["ms"][1], DD_TOMS["ms"][2]
    m_all = int(np.prod(DD_TOMS["ms"]))
    dt0 = 1.0 / (DD_TOMS["nt"] - 1)
    J1, J2 = J // m1, J // (m1 * m2)
    _, lam1 = sine_eigenbasis(n, (n + 1.0) ** 2)
    lam = pair((lam1[:, None] + lam1[None, :]).reshape(-1))
    lift = pair(rng.uniform(-1, 1, N))
    x0_1 = packed(rng.uniform(-1, 1, (J1, N)))
    g_1 = torch.stack([packed(rng.uniform(-1e-3, 1e-3, (J1, N))) for _ in range(m1 - 1)], 1)
    r1_row = torch.as_tensor(rng.uniform(-1, 1, N).astype(np.float32), device=dev)
    rng24 = np.random.default_rng(24)

    def k24(Jc, Lc, theta, dtc):
        if (Jc, Lc) == (J1, m1 - 1):
            x0, g = x0_1, g_1
        else:
            x0 = packed(rng24.uniform(-1, 1, (Jc, N)))
            g = packed(rng24.uniform(-1e-3, 1e-3, (Jc * Lc, N))).view(Jc, Lc, 2, N)
        dt = pair(np.full((Lc, Jc), dtc))
        r1 = r1_row.expand(Lc, Jc, N)

        def launch(ops, out):
            ops.dd_theta_chain(dd.pair(x0, ops), dd.pair(out, ops, 2), dt, lam, lift, r1, r1,
                               theta, dd.pair(g, ops, 2))
            return dd.pair(out, ops, 2)
        return RowCase(lambda: torch.empty((Jc, Lc, 2, N), dtype=torch.float32, device=dev),
                       launch)

    for label, Jc, Lc, theta, dtc in (
            ("level-1 F-relax BE", J1, m1 - 1, 1.0, m0 * dt0),
            ("level-1 F-relax CN", J1, m1 - 1, 0.5, m0 * dt0),
            ("level-2 F-relax BE", J2, m2 - 1, 1.0, m0 * m1 * dt0),
            ("level-1 C-step BE", J1, 1, 1.0, m0 * dt0),
            ("coarsest march BE", 1, 2, 1.0, m_all * dt0)):
        per = 4 * F["mul"] + 3 * F[A_] + F["div"] + F[A_] + (0 if theta == 1.0 else F["mul"] + 3)
        case = f"{label} J={Jc} L={Lc} N={N}"
        cases.append(("dd_theta_chain", case, k24(Jc, Lc, theta, dtc)))
        stash[("work", "dd_theta_chain", case)] = (
            8 * (Jc * N + 2 * Jc * Lc * N + 2 * N + Lc * Jc) + 4 * N, per * Jc * Lc * N)

    # K25: the solver's combines over 512 packed C-rows, then each op; every
    # case writes into a buffer made untimed (packed rows, or a (2, ...)
    # buffer viewed as hi and lo)
    R = J
    terms = [packed(rng.uniform(-1, 1, (R, N))) for _ in range(3)]

    def k25(op, args, shape, coeffs=None, rows=False):
        """A K25 RowCase: the operands' DD views made once (packed tensors
        viewed as pairs), out made untimed by prepare (resid's float32
        tensor, packed rows, or a (2, ...) buffer viewed as hi and lo)."""
        args = [dd.pair(a) if isinstance(a, torch.Tensor) else a for a in args]

        def prepare():
            if op == "resid":
                return torch.empty(shape, dtype=torch.float32, device=dev)
            if rows:
                return dd.pair(torch.empty((shape[0], 2, *shape[1:]), dtype=torch.float32,
                                           device=dev))
            return dd.pair(torch.empty((2, *shape), dtype=torch.float32, device=dev), None, 0)

        def launch(ops, out):
            return ops.dd_arith(op, *args, coeffs=coeffs, out=out)
        return RowCase(prepare, launch)

    case = f"FAS combine R={R} N={N}"
    cases.append(("dd_arith", case, k25("combine", terms, (R, N), [1.0, -1.0, 1.0], True)))
    stash[("work", "dd_arith", case)] = (8 * 4 * R * N, (2 * F[A_] + F["neg"]) * R * N)
    case = f"weighted C-update w=1.3 R={R} N={N}"
    cases.append(("dd_arith", case, k25("combine", terms[:2], (R, N), [1.3, 1.0 - 1.3], True)))
    stash[("work", "dd_arith", case)] = (8 * 3 * R * N, (2 * F["mul"] + F[A_]) * R * N)
    case = f"resid R={R} N={N}"
    cases.append(("dd_arith", case, k25("resid", terms[:2], (R, N))))
    stash[("work", "dd_arith", case)] = (8 * 2 * R * N + 4 * R * N, F["resid"] * R * N)

    def wild(shape):
        mag = 10.0 ** rng.uniform(-8, 8, shape)
        return rng.standard_normal(shape) * mag

    xw = pair(wild((R, N)))
    yw = pair(np.abs(wild((R, N))) + 1e-8)
    for op in ("add", "sub", "mul", "div", "sqrt", "neg"):
        args = (yw,) if op == "sqrt" else (xw,) if op == "neg" else (xw, yw)
        case = f"{op} wild R={R} N={N}"
        cases.append(("dd_arith", case, k25(op, args, (R, N))))
        stash[("work", "dd_arith", case)] = (8 * (len(args) + 1) * R * N, F[op] * R * N)
    base = 1.0 + 3.975e-12 * rng.uniform(0.5, 1.5, N)
    xc = pair(base)
    case = f"cancellation (1 + tiny) - 1 N={N}"
    cases.append(("dd_arith", case, k25("sub", (xc, dd.from_f64(1.0)), (N,))))
    stash[("work", "dd_arith", case)] = (8 * 2 * N, F["sub"] * N)
    u0, lam_d = pair(np.float64(0.7371)), pair(np.float64(-1.0))
    t0, t1 = pair(np.float64(0.1)), pair(np.float64(0.15))

    one = dd.from_f64(1.0)

    def dahlquist(ops, out):
        d = ops.dd_arith("sub", t1, t0)
        den = ops.dd_arith("sub", one, ops.dd_arith("mul", d, lam_d))
        return ops.dd_arith("div", u0, den, out=out)

    cases.append(("dd_arith", "Dahlquist BE step 0-d", RowCase(lambda: dd.pair(
        torch.empty((2, *u0.shape), dtype=torch.float32, device=dev), None, 0), dahlquist)))
    stash[("work", "dd_arith", "Dahlquist BE step 0-d")] = (8 * 9, F["sub"] * 2 + F["mul"]
                                                            + F["div"])
    # [dd65]'s physical step: the 5-point operator (Heat2D._dd_apply_L, one
    # five-term combine of shifted 63 x 63 interior views of the packed
    # (B, 2, 65, 65) states) on one lane and on the level-0 lane batch
    nx65 = DD65["nx"]
    f65 = float((nx65 - 1) ** 2)
    for B65 in (1, (DD65["nt"] - 1) // DD65["ms"][0]):
        u65 = dd.pair(packed(rng.uniform(-1, 1, (B65, nx65, nx65))))
        views = (u65[:, 1:-1, 1:-1], u65[:, 1:-1, :-2], u65[:, 1:-1, 2:], u65[:, :-2, 1:-1],
                 u65[:, 2:, 1:-1])
        case = f"dd65 5-point combine B={B65} of (B, 2, {nx65}, {nx65})"
        cases.append(("dd_arith", case, k25("combine", views, (B65, nx65 - 2, nx65 - 2),
                                           [2 * (f65 + f65), -f65, -f65, -f65, -f65])))
        stash[("work", "dd_arith", case)] = (
            8 * B65 * (nx65 * nx65 - 4 + (nx65 - 2) ** 2),
            (5 * F["mul"] + 4 * F[A_]) * B65 * (nx65 - 2) ** 2)

    # K26: [dd65]'s physical step products and Diffusion2D's table product
    n2, B = DD65["nx"] - 2, (DD65["nt"] - 1) // DD65["ms"][0]
    S_np, _ = sine_eigenbasis(n2, (n2 + 1.0) ** 2)
    S = pair(S_np)
    states = pair(rng.uniform(-1, 1, (B, n2 + 2, n2 + 2)))
    b = states[:, 1:-1, 1:-1]
    Sb = S.expand(B, n2, n2)

    def two_sided(ops):
        return ops.dd_matmul(ops.dd_matmul(Sb, b), Sb)

    case = f"Heat2D physical two-sided B={B} n={n2}"
    cases.append(("dd_matmul", case, two_sided))
    stash[("work", "dd_matmul", case)] = (8 * (n2 * n2 + 2 * B * n2 * n2), 4 * B * n2 ** 3)
    S64 = S_np.copy()
    b64 = states.hi.double()[:, 1:-1, 1:-1] + states.lo.double()[:, 1:-1, 1:-1]
    S64t = torch.as_tensor(S64, device=dev)
    stash[("library", "dd_matmul", case)] = lambda: torch.matmul(torch.matmul(S64t, b64), S64t)
    stash[("bound_scale", "dd_matmul", case)] = lambda: float(
        (torch.matmul(torch.matmul(S64t.abs(), b64.abs()), S64t.abs())).max())
    stash[("plan", "dd_matmul", case)] = dd_matmul_mod.plan(Sb, b)
    # Diffusion2D's DD table product at its 8 rows, and at 1 and 128
    Ne = 6 * DIFFUSION["n"] ** 2
    W = pair(rng.uniform(-1, 1, (Ne, Ne)) / math.sqrt(Ne))
    W64 = W.hi.double() + W.lo.double()
    for Bd in (8, 1, 128):
        xe = pair(rng.uniform(-1, 1, (Bd, Ne)))

        def table(ops, xe=xe):
            return ops.dd_matmul(xe[None], W.T[None])

        case = f"Diffusion2D table B={Bd} N={Ne}"
        cases.append(("dd_matmul", case, table))
        stash[("work", "dd_matmul", case)] = (8 * (Ne * Ne + 2 * Bd * Ne), 2 * Bd * Ne * Ne)
        x64 = xe.hi.double() + xe.lo.double()
        stash[("library", "dd_matmul", case)] = lambda x64=x64: torch.matmul(x64, W64.T)
        stash[("bound_scale", "dd_matmul", case)] = lambda x64=x64: float(
            (x64.abs() @ W64.abs().T).max())
        stash[("plan", "dd_matmul", case)] = dd_matmul_mod.plan(xe[None], W.T[None])

    # the dd_spectral [space] cell's slabs (a (2, 2) rank: 64 level-0
    # intervals and 4 level-1 chains of 15 steps, each state 64 of 128 rows
    # of 128 coefficients): K23's C-step and K24's level-1 F-relaxation
    # with g on the slab's rows of the tables (a generator of their own:
    # the cases above keep their draws)
    rng26 = np.random.default_rng(26)
    ns = SPACE_DD["nx"] - 2
    Rs = ns // SPACE_MESH[1]
    Ns, m0s, m1s = Rs * ns, SPACE_DD["ms"][0], SPACE_DD["ms"][1]
    Js = (SPACE_DD["nt"] - 1) // m0s // SPACE_MESH[0]
    J1s, L1s = Js // m1s, m1s - 1
    seeds_s = packed(rng26.uniform(-1, 1, (Js, Ns)))
    A_s, G_s = pair(rng26.uniform(0, 1, (m0s, Ns))), pair(rng26.uniform(-1, 1, (m0s, Ns)))

    def c_step_slab(ops, out):
        ops.dd_interval_affine(dd.pair(seeds_s, ops), A_s, G_s, dd.pair(out, ops, 2), m0s - 1)
        return dd.pair(out[:, 0], ops)

    case = f"slab C-step J={Js} N={Ns}"
    cases.append(("dd_interval_affine", case, RowCase(
        lambda: torch.empty((Js, 1, 2, Ns), dtype=torch.float32, device=dev), c_step_slab)))
    stash[("work", "dd_interval_affine", case)] = (8 * (2 * Js * Ns + 2 * Ns),
                                                   (F["mul"] + F[A_]) * Js * Ns)
    _, lam_x = sine_eigenbasis(ns, (ns + 1.0) ** 2)
    lam_s = pair((lam_x[:Rs, None] + lam_x[None, :]).reshape(-1))
    lift_s = pair(rng26.uniform(-1, 1, Ns))
    x0_s = packed(rng26.uniform(-1, 1, (J1s, Ns)))
    g_s = packed(rng26.uniform(-1e-3, 1e-3, (J1s * L1s, Ns))).view(J1s, L1s, 2, Ns)
    dt_s = pair(np.full((L1s, J1s), m0s / (SPACE_DD["nt"] - 1)))
    r1_s = torch.as_tensor(rng26.uniform(-1, 1, Ns).astype(np.float32),
                           device=dev).expand(L1s, J1s, Ns)

    def f_relax_slab(ops, out):
        ops.dd_theta_chain(dd.pair(x0_s, ops), dd.pair(out, ops, 2), dt_s, lam_s, lift_s, r1_s,
                           r1_s, 1.0, dd.pair(g_s, ops, 2))
        return dd.pair(out, ops, 2)

    case = f"slab level-1 F-relax BE J={J1s} L={L1s} N={Ns}"
    cases.append(("dd_theta_chain", case, RowCase(
        lambda: torch.empty((J1s, L1s, 2, Ns), dtype=torch.float32, device=dev), f_relax_slab)))
    per = 4 * F["mul"] + 3 * F[A_] + F["div"] + F[A_]
    stash[("work", "dd_theta_chain", case)] = (
        8 * (J1s * Ns + 2 * J1s * L1s * Ns + 2 * Ns + L1s * J1s) + 4 * Ns, per * J1s * L1s * Ns)
    return cases


# K5 at the smaller sides of the spatial65 and ragged65 rows, at their
# solves' batches (case, B, interior side, kind): ragged65's level-0
# F-steps (514 chains of a 65^2 grid, dt 1/4096, the ring), spatial65's
# level-1 F-steps (256 chains of 33^2, dt 4/4096, the ring and g) and its
# seed transforms (1024 C-rows of 65^2, no ring)
K5_SMALL = (("ragged65 F-step B=514 n=63", 514, 63, "solve"),
            ("spatial65 level-1 F-step B=256 n=31 +g", 256, 31, "solve +g"),
            ("spatial65 transform B=1024 n=63", 1024, 63, "transform"))


# K6 at spatial65's level-0 C-step (case, intervals, interior side): 1024
# intervals of a 65^2 grid, the table's last row (only_last), the ring
K6_SMALL = (("spatial65 C-step J=1024 n=63", 1024, 63),)


def k6_work(J, R, n, cn):
    """(bytes, operations) of a K6 call writing R rows of J intervals of
    interior side n (with the ring): xhat (and dhat, dscale, the row
    before) read, R rows of A and G, Sx, Sy and the ring read, the J R
    states written; two length-n products a state and the prologue's
    multiply-add (CN: three more operations)."""
    N, P2 = n * n, (n + 2) ** 2
    nbytes = 8 * (J * N + 2 * R * N + 2 * N + P2 + J * R * P2)
    if cn:
        nbytes += 8 * (J * N + 2 * N)
    return nbytes, J * R * (4 * n ** 3 + (5 if cn else 2) * N)


def k6_small(dtype, dev, rng, J, n):
    """The K6 case of ``K6_SMALL``: the C-step of J intervals, written into a
    row-major (1, J) output made outside the timed call."""
    import torch
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    nx, N = n + 2, n * n
    S = t(sine_eigenbasis(n, (n + 1.0) ** 2)[0])
    ring_np = rng.uniform(-1, 1, (nx, nx))
    ring_np[1:-1, 1:-1] = 0.0
    ring = t(ring_np)
    xhat = t(rng.uniform(-1, 1, (J, N)))
    A, G = t(rng.uniform(0, 1, (4, N))), t(rng.uniform(-1, 1, (4, N)))

    def launch(k, out):
        k.sine_affine2d(xhat, A, G, out.transpose(0, 1), S, S, 3, ring)
        return out
    return RowCase(lambda: torch.empty((1, J, nx, nx), dtype=dtype, device=dev), launch,
                   exact=False)


def k7_work(B, n, theta, dt_tensor):
    """(bytes, operations) of a K7 call on B states of interior side n, the
    rhs rows of stride 0 (one row read): the states u (as the call hands
    them: with their ring), the rows and the lift (BE, CN) or the ring and
    g (FE) read, the output written (FE: whole states).  Operations a
    point: BE 5 (as PR 2 counted them), CN 16, FE 13."""
    N, P2 = n * n, (n + 2) ** 2
    if theta == 1.0:
        nbytes, ops = 8 * (B * P2 + 2 * N + B * N), 5 * B * N
    elif theta > 0.0:
        nbytes, ops = 8 * (B * P2 + 3 * N + B * N), 16 * B * N
    else:
        nbytes, ops = 8 * (B * P2 + N + P2 + 2 * B * P2), 13 * B * N
    return nbytes + (8 * B if dt_tensor else 0), ops


def k2_work(J, L, N, theta, with_g):
    """(bytes, operations) of a K2 call of J chains of L steps on N
    coefficients with a time-independent rhs: the seeds, the (L, J) step
    sizes, lam, lift and the rhs row (CN: two) read, g read (with g) and
    the J L rows written; operations an entry and step: BE 7 (d rhs, shift
    lift, shift lam and three sums, the divide), CN 14, and the sum of g."""
    nbytes = 8 * (J * N + L * J + (4 if theta != 1.0 else 3) * N
                  + J * L * N * (2 if with_g else 1))
    return nbytes, ((7 if theta == 1.0 else 14) + (1 if with_g else 0)) * J * L * N


def k5_work(B, n, how):
    """(bytes, operations) of a K5 call on B states of interior side n
    (``K5_SMALL``'s kinds): the states read, Sx, Sy (and lam) read, the ring
    read and the output written (with g: read too); four length-n products a
    state and the divide (a solve), two (the transform)."""
    N, P2 = n * n, (n + 2) ** 2
    if how == "transform":
        return 8 * (B * N + 2 * N + B * N), B * 4 * n ** 3
    return (8 * (B * N + 3 * N + P2 + B * P2 * (2 if "+g" in how else 1)),
            B * (8 * n ** 3 + 3 * N))


def k5_small(dtype, dev, rng, B, n, how):
    """A K5 case of ``K5_SMALL``: states read from a tube's C-rows (strided),
    written into the next rows of a fresh tube with the ring (or, the
    transform, into its interiors)."""
    import torch
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    nx = n + 2
    S = t(sine_eigenbasis(n, (n + 1.0) ** 2)[0])
    lam1 = sine_eigenbasis(n, (n + 1.0) ** 2)[1]
    lam = t(lam1[:, None] + lam1[None, :])
    ring_np = rng.uniform(-1, 1, (nx, nx))
    ring_np[1:-1, 1:-1] = 0.0
    ring = t(ring_np)
    seeds = t(rng.uniform(-1, 1, (2 * B, nx, nx)))
    g = t(rng.uniform(-1e-3, 1e-3, (2 * B, nx, nx))) if "+g" in how else None
    dt = (4.0 if "+g" in how else 1.0) / 4096

    def launch(k, tube):
        if how == "transform":
            return k.sine_solve2d(seeds[0::2, 1:-1, 1:-1], tube[:B, 1:-1, 1:-1], S, S)
        return k.sine_solve2d(seeds[0::2, 1:-1, 1:-1], tube[1::2], S, S, lam, dt, ring,
                              None if g is None else g[1::2])
    return RowCase(lambda: torch.empty((2 * B, nx, nx), dtype=dtype, device=dev), launch,
                   exact=False)


def k10_work(B, S, n, with_g):
    """(bytes, operations) of a K10 call on B lanes of S species of n x n
    states: the states read (g too, with g), H, lam, the steps and the
    coefficients read, the results written; four length-n products a state,
    the divide and the prologue (10 a point)."""
    return (8 * (B * S * n * n * (3 if with_g else 2) + 2 * n * n + B + S),
            B * S * (8 * n ** 3 + 10 * n * n))


def k11_work(mode, B, n):
    """(bytes, operations) of a K11 call on B states of n x n: u read (x
    too for the Jacobian, rhs for the residual), the output written (and
    the residual's per-lane max), fac read; operations a point: the
    Laplacian's six, then the Jacobian's eight, the residual's nine (its
    max included) or the right-hand side's seven."""
    arrays = {"jacobian": 3, "residual": 3, "rhs": 2}[mode]
    ops = {"jacobian": 14, "residual": 15, "rhs": 13}[mode]
    return 8 * (arrays * B * n * n + B * (2 if mode == "residual" else 1)), ops * B * n * n


def k14_work(mode, B, n, with_g=False):
    """(bytes, operations) of a K14 call on B Gray-Scott pairs of n x n:
    s read (w too for the Jacobian, r for the residual, g for an EXPL step
    with g), both species written (and the residual's per-lane max), dt
    read; operations a point (both species): the two Laplacians' twelve,
    then the Jacobian's 21, the residual's 21 (its max included) or the
    EXPL step's 15 (17 with g)."""
    arrays = {"jacobian": 3, "residual": 3, "expl": 3 if with_g else 2}[mode]
    ops = 12 + {"jacobian": 21, "residual": 21, "expl": 17 if with_g else 15}[mode]
    return (8 * (arrays * B * 2 * n * n + B * (2 if mode == "residual" else 1)),
            ops * B * n * n)


def k15_work(mode, B, n):
    """(bytes, operations) of a K15 call on B Burgers2D velocity fields of
    n x n: s read (w too for the Jacobian, r for the residual), both
    components written (and the residual's per-lane max), dt read;
    operations a point (both components): the Jacobian's eight central
    differences (16), its two linearised convections (14), the two
    Laplacians of w (12) and the update (8); the residual's four
    differences (8), convections (6), Laplacians of s (12), update (10) and
    max (4)."""
    ops = {"jacobian": 50, "residual": 40}[mode]
    return (8 * (3 * B * 2 * n * n + B * (2 if mode == "residual" else 1)),
            ops * B * n * n)


def past_cap_cases(dtype, dev, rng, stash):
    """K5, K6, K10, K16 and K17 past the sizes at which their wrappers
    raised before: K5 and K6 at the toms257 interior 255 (K5: the
    level-0 seed solve of 128 states with the ring; K6: the condensed
    C-step of 128 intervals), K10 at n = 256 (64 Allen-Cahn IMEX states),
    K16 at n = 512 (32 lanes x 3 steps) and n = 4096 (2 lanes x 1 step:
    past the shared-memory opt-in in float64, the device workspace), K17 at
    n = 4096 (256 lanes x 3 steps, both branches); each with the bytes and
    operations its function needs."""
    import torch
    from pymgrit_tpu_torch.ops.dirichlet_spectral import sine_eigenbasis
    from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    cases = []
    n = TOMS257["nx"] - 2
    B, P2, N = (TOMS257["nt"] - 1) // TOMS257["ms"][0], (n + 2) ** 2, n * n
    S = t(sine_eigenbasis(n, (n + 1.0) ** 2)[0])
    lam = t(rng.uniform(0, 4e5, (n, n)))
    ring_np = rng.uniform(-1, 1, (n + 2, n + 2))
    ring_np[1:-1, 1:-1] = 0.0
    ring = t(ring_np)
    tube = t(rng.uniform(-1, 1, (B + 1, n + 2, n + 2)))
    dt0 = 1.0 / (TOMS257["nt"] - 1)

    def k5(ops, out):
        return ops.sine_solve2d(tube[:B, 1:-1, 1:-1], out[1:], S, S, lam, dt0, ring)

    xhat = t(rng.uniform(-1, 1, (B, N)))
    A, G = t(rng.uniform(0, 1, (32, N))), t(rng.uniform(-1, 1, (32, N)))

    def k6(ops, out):
        ops.sine_affine2d(xhat, A, G, out.transpose(0, 1), S, S, 31, ring)
        return out

    cases += [("sine_solve2d", f"toms257 solve B={B} n={n}",
               RowCase(lambda: torch.empty_like(tube), k5, exact=False)),
              ("sine_affine2d", f"toms257 C-step J={B} n={n}",
               RowCase(lambda: torch.empty((1, B, n + 2, n + 2), dtype=dtype, device=dev), k6,
                       exact=False))]
    stash[("work", "sine_solve2d", f"toms257 solve B={B} n={n}")] = (
        8 * (B * N + B * P2 + 3 * N + P2), B * (8 * n ** 3 + 3 * N))
    stash[("work", "sine_affine2d", f"toms257 C-step J={B} n={n}")] = k6_work(B, 1, n, False)

    nh, Bh = 256, 64
    H, lam_h = t(hartley_basis(nh)), t(-periodic_lap_eigs(nh, 1.0 / nh))
    states = t(rng.uniform(-1, 1, (Bh, nh, nh)))
    shift = t(np.full(Bh, 1e-5))

    def k10(ops, out):
        return ops.periodic_solve2d(states, out, H, lam_h, shift, nu=2, inv_eps2=625.0)

    cases.append(("periodic_solve2d", f"IMEX B={Bh} n={nh}",
                  RowCase(lambda: torch.empty_like(states), k10, exact=False)))
    stash[("work", "periodic_solve2d", f"IMEX B={Bh} n={nh}")] = k10_work(Bh, 1, nh, False)

    # K16 at n = 512 (shared memory) and past the card's shared-memory
    # opt-in (n = 4096 in float64: the device workspace; float32 still fits)
    for nb, Jb, Lb, route in ((512, 32, 3, "wide"), (4096, 2, 1, "long (f64 device route)")):
        xb = np.linspace(0, 1, nb, endpoint=False)
        seeds = t(np.sin(2 * np.pi * xb) * rng.uniform(0.8, 1.2, (Jb, 1)))
        dts = t(np.full((Lb, Jb), 1.0 / 4096))
        case16 = f"{route} J={Jb} L={Lb} n={nb}"
        cases.append(("burgers1d_newton", case16,
                      k16_case(seeds, dts, None, 0.02, 1.0 / nb, dtype, stash)))
        stash[("iters_len", "burgers1d_newton", case16)] = Lb * Jb
        stash[("work", "burgers1d_newton", case16)] = lambda Jb=Jb, Lb=Lb, nb=nb: (
            8 * (Jb * nb + Lb * Jb + Jb * Lb * nb),
            stash[("burgers1d_newton", Jb, Lb, nb)] * 60 * nb + Jb * Lb * nb)

    na, Ja, La = 4096, 256, 3
    xa = np.linspace(-1, 1, na + 1)[:-1]
    seeds_a = t(np.exp(-xa ** 2) * rng.uniform(0.5, 1.5, (Ja, 1)))
    fac = 1.0 / (xa[1] - xa[0])
    for sign, step in ((1.0, 2.0 / 16384), (-1.0, 0.05)):
        dts_a = t(np.full((La, Ja), step))

        def k17(ops, out, dts_a=dts_a, sign=sign):
            return ops.circulant_solve1d(seeds_a, dts_a, out, None, sign * fac)

        case17 = f"long J={Ja} L={La} n={na}" + (" c<-1/2" if sign < 0 else "")
        cases.append(("circulant_solve1d", case17,
                      RowCase(lambda: torch.empty((Ja, La, na), dtype=dtype, device=dev), k17,
                              exact=False)))
        stash[("work", "circulant_solve1d", case17)] = (
            8 * (Ja * na + La * Ja + Ja * La * na), Ja * La * 6 * na)
    return cases


def headline_work(kernel, stash):
    """(bytes, operations) of a kernel's headline case in float64: each
    input read once and each output written once; the operations the
    kernel's arithmetic does on these inputs (a multiply-add counts two;
    K12's attempts and K16's Newton iterations are those of this run, which
    the cases record in ``stash``)."""
    n, m0 = TOMS["nx"] - 2, TOMS["ms"][0]
    N, J, T = n * n, (TOMS["nt"] - 1) // m0, m0 - 1
    J1, L1 = J // TOMS["ms"][1], TOMS["ms"][1] - 1
    P2 = (n + 2) ** 2
    if kernel == "interval_affine":        # materialize: seeds, A, G -> J x m0 rows
        return 8 * (J * N + 2 * T * N + J * m0 * N), 2 * J * T * N
    if kernel == "theta_chain":            # BE level-1 F-relax + g
        return k2_work(J1, L1, N, 1.0, True)
    if kernel == "residual_row_norms":
        return 8 * (2 * J * N + J), 3 * J * N + J
    if kernel == "cpoint_combine":         # three terms
        return 8 * 4 * J * N, 5 * J * N
    if kernel == "sine_solve2d":           # four length-n products a state, the divide
        return 8 * (J * N + J * P2 + 3 * N + P2), J * (8 * n ** 3 + 3 * N)
    if kernel == "sine_affine2d":          # materialize: T transforms of J states
        return 8 * (J * N + 2 * T * N + 2 * N + J * P2 + J * m0 * P2), J * T * (4 * n ** 3 + 2 * N)
    if kernel == "theta_rhs2d":            # BE: u_int + dt r1 + dt lift
        return k7_work(J, n, 1.0, False)
    if kernel == "periodic_solve2d":       # Allen-Cahn IMEX B=512 n=128
        return k10_work((AC_BENCH["nt"] - 1) // AC_BENCH["ms"][0], 1, AC_BENCH["nx"], False)
    if kernel == "allen_cahn_pointwise":   # jacobian B=8 n=128
        return k11_work("jacobian", 8, AC_IMPL["nx"])
    if kernel == "dopri45_arenstorf":      # ~300 operations an attempt (7 stages)
        Ja, L = (ARENSTORF["nt"] - 1) // ARENSTORF["m"], 8
        att = stash[("attempts", kernel, f"level-0 F-relax J={Ja} L={L}")][True]
        return 8 * (Ja * 4 + 2 * L * Ja + Ja * L * 4), 300 * int(att.sum())
    if kernel == "rk4_brusselator":        # four stages, ~70 operations a step
        Jb, L = (BRUSSELATOR["nt"] - 1) // BRUSSELATOR["m"], BRUSSELATOR["m"] - 1
        return 8 * (2 * Jb + 2 * L * Jb + 2 * 2 * Jb * L), 70 * Jb * L
    if kernel == "gray_scott_pointwise":   # jacobian B=8 n=128
        return k14_work("jacobian", 8, GS_IMPL["nx"])
    if kernel == "burgers2d_pointwise":    # jacobian B=4 n=64
        return k15_work("jacobian", (BURGERS_2D["nt"] - 1) // BURGERS_2D["ms"][0],
                        BURGERS_2D["nx"])
    if kernel == "burgers1d_newton":       # about 60 n operations a Newton iteration
        nn, m = BURGERS_DEEP["nx"], BURGERS_DEEP["ms"][0]
        Jd, L = (BURGERS_DEEP["nt"] - 1) // m, m - 1
        its = stash[(kernel, Jd, L)]
        return 8 * (Jd * nn + L * Jd + 2 * Jd * L * nn), its * 60 * nn + Jd * L * nn
    if kernel == "circulant_solve1d":      # a cyclic bidiagonal solve a step
        nn, m = ADVECTION_DEEP["nx"] - 1, ADVECTION_DEEP["ms"][0]
        Ja, L = (ADVECTION_DEEP["nt"] - 1) // m, m - 1
        return 8 * (Ja * nn + L * Ja + 2 * Ja * L * nn), Ja * L * 6 * nn
    if kernel in TRANSFER_KERNELS:         # spatial65 2D: FAS, correction (no products)
        case = ("FAS" if kernel == "restrict_combine" else "correction") + " spatial65 2D R=1024"
        return stash[("work", kernel, case)]
    if kernel in ("indexed_combine", "eig_step", "sine_solve1d", "affine_prefix",
                  "affine_windows", "residual_row_norms_squares", "sine_solve1d_lam_table",
                  "theta_rhs2d_halo_fe", *PERIODIC_SPACE_ROWS):
        # the headline's recorded work (K8, K9: coarsest_work)
        return next(w for k, w in stash.items()
                    if k[:2] == ("work", kernel) and k[2].startswith(HEADLINE[kernel]))
    raise KeyError(kernel)


def op_peak(kernel):
    """The FP64 peak the card could do a kernel's operations at: the tensor
    cores' (DMMA) for the dense products of PRODUCT_KERNELS, whatever units
    the kernel uses now; the CUDA cores' for every other kernel (their FP32
    rate for the float32-pair kernels K23-K25)."""
    if kernel in PRODUCT_KERNELS:
        return PEAK_DMMA_OPS_PER_S
    return PEAK_OPS_PER_S["float32" if kernel in DD_FP32_KERNELS else "float64"]


def bound_ms(kernel, stash, work=None, peak=None):
    """The least time the card could take for the headline case (or for
    ``work`` = (bytes, operations)): the larger of its bytes over the HBM
    rate and its operations over the FP64 peak of the units that could do
    them (``op_peak``; or ``peak`` operations a second); (ms, which)."""
    nbytes, ops = work if work is not None else headline_work(kernel, stash)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (peak if peak is not None else op_peak(kernel)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the case whose time the summary reports: the kernel's largest call on the
# main path
HEADLINE = {"interval_affine": "materialize", "theta_chain": "level-1 F-relax",
            "residual_row_norms": "C-rows", "cpoint_combine": "FAS g_tail",
            "sine_solve2d": "solve B=512", "sine_affine2d": "materialize",
            "theta_rhs2d": "BE B=512", "affine_prefix": "TOMS",
            "affine_windows": "TOMS", "periodic_solve2d": "IMEX B=512 n=128",
            "allen_cahn_pointwise": "jacobian B=8", "dopri45_arenstorf": "level-0 F-relax",
            "rk4_brusselator": "level-0 F-relax", "gray_scott_pointwise": "jacobian B=8",
            "burgers2d_pointwise": "jacobian B=4", "burgers1d_newton": "deep level-0",
            "circulant_solve1d": "deep level-0", "restrict_combine": "FAS spatial65",
            "interpolate_combine": "correction spatial65", "sine_solve1d": "BDF2 B=128",
            "indexed_combine": "drop-scatter", "eig_step": "128 lanes",
            "dd_interval_affine": "materialize", "dd_theta_chain": "level-1 F-relax BE",
            "dd_arith": "FAS combine", "dd_matmul": "Heat2D physical",
            "residual_row_norms_squares": "squares", "sine_solve1d_lam_table": "x-pass",
            "allen_cahn_pointwise_halo": "jacobian", "gray_scott_pointwise_halo": "jacobian",
            "burgers2d_pointwise_halo": "jacobian",
            "allen_cahn_pointwise_prologue": "IMEX prologue",
            "gray_scott_pointwise_prologue": "IMEX prologue",
            "sine_solve1d_hartley": "transform",
            "sine_solve1d_hartley_lam_table": "x-pass Gray-Scott",
            "theta_rhs2d_halo_fe": "FE halo"}
# the summary's rows of the periodic slabs' kernel modes (phase 3's
# ``periodic_space_kernel_cases``; launches from the [space] cells)
PERIODIC_SPACE_ROWS = ("allen_cahn_pointwise_halo", "gray_scott_pointwise_halo",
                       "burgers2d_pointwise_halo", "allen_cahn_pointwise_prologue",
                       "gray_scott_pointwise_prologue", "sine_solve1d_hartley",
                       "sine_solve1d_hartley_lam_table")


def row_times(kernel, case, run, stash, f64=True):
    """Times of a RowCase: ROW_ROUNDS rounds (one in float32, whose times
    no summary reads) of kernel, plain (library, probe) in turns, each the
    median of its calls (the plain version's calls within a budget of a
    tenth of a second a round), the full times the medians of the rounds'
    medians; the kernel's device time with a cold
    L2 (``device_ms``) and the library call's alike.  The fresh copy a call
    writes into is made untimed (``prepare``).  Returns (kernel ms, plain
    ms, device ms, the printed detail, the library call's rounds)."""
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    st_k, st_p = run.prepare(), run.prepare()
    lib = stash.get(("library", kernel, case)) if f64 else None
    probe = stash.get(("probe", kernel, case)) if f64 else None
    rounds = [(cuda_ms(lambda: run.launch(DISPATCH, st_k)),
               cuda_ms(lambda: run.launch(PLAIN, st_p), budget_ms=100.0),
               cuda_ms(lib) if lib is not None else None,
               cuda_ms(lambda: probe[1](st_p)) if probe is not None else None)
              for _ in range(ROW_ROUNDS if f64 else 1)]
    ms_k, ms_p = (float(np.median([r[i] for r in rounds])) for i in (0, 1))
    lib_rounds = [r[2] for r in rounds] if lib is not None else None
    dev_ms, how = device_ms(lambda: run.launch(DISPATCH, st_k), kernel)
    dev_txt = (f" (rounds {', '.join(f'{r[0]:.4f}' for r in rounds)}) device "
               f"{dev_ms:.4f} ms ({how}, cold L2)")
    if lib is not None:         # the library call's device time, alike
        lib_dev, lib_how = device_ms(lib, "library")
        dev_txt += f"; library call device {lib_dev:.4f} ms ({lib_how}, cold L2)"
    if probe is not None:
        label, fn, nbytes = probe
        p_ms = float(np.median([r[3] for r in rounds]))
        p_dev, p_how = device_ms(lambda: fn(st_p), label)
        print(f"[kernels] {kernel:<20} {case}: probe {label} of the same tube "
              f"{p_ms:.4f} ms (rounds {', '.join(f'{r[3]:.4f}' for r in rounds)}) "
              f"device {p_dev:.4f} ms ({p_how}, cold L2): "
              f"{nbytes / p_ms / 1e9:.3f} TB/s written; kernel at "
              f"{ms_k / p_ms:.2f}x (device {dev_ms / p_dev:.2f}x)")
    del st_k, st_p
    return ms_k, ms_p, dev_ms, dev_txt, lib_rounds


def phase_kernels(only=None):
    """Every kernel (or those named in ``only``) against its plain version;
    returns the per-kernel rows of the JSON summary (float64, the main
    path's dtype)."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    dev = torch.device(DEVICE)
    headline = HEADLINE
    rows, stash = {}, {}
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).split(".")[-1]
        for kernel, case, run in kernel_cases(dtype, dev, stash):
            if only is not None and kernel not in only:
                continue
            out_k = run(DISPATCH)
            torch.cuda.synchronize()
            out_p = run(PLAIN)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out_k).all()), f"{kernel} {case} {dname}: non-finite output")
            abs_err = float((out_k - out_p).abs().max())
            rel = abs_err / max(float(out_p.abs().max()), 1e-300)
            row_case = isinstance(run, RowCase)
            if row_case and run.exact:  # the plain version's operations, each rounded once
                same = torch.equal(out_k, out_p)
                print(f"[kernels] {kernel:<20} {case} {dname}: bit for bit: {same}")
                check(same, f"{kernel} {case} {dname}: the kernel differs from its plain version")
            elif row_case:              # a fixed summation order: a call repeats bit for bit
                same = torch.equal(out_k, run(DISPATCH))
                print(f"[kernels] {kernel:<20} {case} {dname}: second launch bit for bit: {same}")
                check(same, f"{kernel} {case} {dname}: a second launch differs")
            cpu = stash.get(("cpu plain", kernel, case))
            if cpu is not None:         # K13: the card's plain version is the CPU's, bit for bit
                same = torch.equal(out_p.cpu(), cpu())
                print(f"[kernels] {kernel:<20} {case} {dname}: plain on the card equals plain "
                      f"on the CPU: {same}")
                check(same, f"{kernel} {case} {dname}: the plain version differs on the card")
            n_it = stash.get(("iters_len", kernel, case))
            if n_it:                    # K16: each lane and step took the plain version's iterations
                same = torch.equal(out_k[-n_it:], out_p[-n_it:])
                print(f"[kernels] {kernel:<20} {case} {dname}: Newton iterations equal: {same} "
                      f"(sum {int(out_k[-n_it:].sum())})")
                check(same, f"{kernel} {case} {dname}: the Newton iterations differ from plain")
            att = stash.get(("attempts", kernel, case))
            if att is not None:         # K12: each lane and step took the plain version's attempts
                same = torch.equal(att[True], att[False])
                print(f"[kernels] {kernel:<20} {case} {dname}: attempt counts equal: {same} "
                      f"(kernel {int(att[True].sum())}, plain {int(att[False].sum())})")
                # float32's error estimate sits at float32 rounding: decisions may flip
                check(same or dtype == torch.float32,
                      f"{kernel} {case} {dname}: the attempt counts differ from plain")
            plan = stash.get(("plan", kernel, case))
            if plan is not None:        # the product tile: a second launch gives the same bits
                same = torch.equal(out_k, run(DISPATCH))
                print(f"[kernels] {kernel:<20} {case} {dname}: plan {plan.describe()} | "
                      f"second launch bit for bit: {same}")
                check(same, f"{kernel} {case} {dname}: a second launch differs")
            del out_k, out_p
            if row_case:
                ms_k, ms_p, dev_ms, dev_txt, lib_rounds = row_times(kernel, case, run, stash,
                                                                    dtype == torch.float64)
            else:
                ms_k, ms_p = cuda_ms(lambda: run(DISPATCH)), cuda_ms(lambda: run(PLAIN))
                dev_txt, dev_ms, lib_rounds = "", None, None
            tol = KERNEL_RTOL_BY_NAME.get(kernel, KERNEL_RTOL)[dname]
            ok = rel <= tol
            print(f"[kernels] {kernel:<20} {case:<34} {dname} rel {rel:.3e} "
                  f"(tol {tol:.0e}) abs {abs_err:.3e} | kernel {ms_k:.4f} ms{dev_txt} "
                  f"plain {ms_p:.4f} ms | {'ok' if ok else 'FAIL'}")
            check(ok, f"{kernel} {case} {dname}: rel err {rel:.3e} > {tol:.0e}")
            floor = None
            if dtype == torch.float64 and dev_ms is not None:
                if att is not None:
                    floor = k12_floor(att[True].cpu().numpy())
                elif ("floor", kernel, case) in stash:
                    floor = stash[("floor", kernel, case)]()
            if floor is not None:       # K8, K12: the dependent chain's least time
                per = (f"; {dev_ms * 1e6 * latency()['ghz'] / floor[2]:.0f} cycles an attempt of "
                       "the slowest warp (device time)" if len(floor) > 2 else "")
                print(f"[kernels] {kernel:<20} {case}: latency floor {floor[0]:.4f} ms ({floor[1]}); "
                      f"device {dev_ms:.4f} ms, {dev_ms / floor[0]:.2f}x the floor{per}")
            # the bound of each float64 case, and of a float32 case that
            # records its own work (a float32 path's case)
            work = stash.get(("work" if dtype == torch.float64 else "work32", kernel, case))
            if work is not None:
                work = work() if callable(work) else work
                peak = op_peak(kernel) if dtype == torch.float64 else PEAK_OPS_PER_S["float32"]
                c_ms, c_by = bound_ms(kernel, stash, work, peak)
                lib = stash.get(("library", kernel, case))
                lib_ms = (float(np.median(lib_rounds)) if lib_rounds is not None
                          else cuda_ms(lib) if lib is not None else None)
                print(f"[kernels] {kernel:<20} {case}: bound {c_ms:.4f} ms ({c_by}): bytes "
                      f"{work[0] / 1e6:.3f} MB / 3.35 TB/s = {work[0] / HBM_BYTES_PER_S * 1e3:.4f} ms, "
                      f"{work[1] / 1e9:.4f} GFLOP / {peak / 1e12:.0f} TFLOP/s = "
                      f"{work[1] / peak * 1e3:.4f} ms"
                      + (f" (at 34 TFLOP/s: {work[1] / PEAK_OPS_PER_S['float64'] * 1e3:.4f} ms)"
                         if peak != PEAK_OPS_PER_S["float64"] else "") + "; kernel at "
                      f"{ms_k / c_ms:.1f}x its bound"
                      + (f" (device {dev_ms / c_ms:.1f}x)" if dev_ms is not None else "")
                      + " | library call "
                      + (f"{lib_ms:.4f} ms (kernel {ms_k / lib_ms:.2f}x)" if lib is not None
                         else "none")
                      + (" (rounds " + ", ".join(f"{r:.4f}" for r in lib_rounds) + ")"
                         if lib_rounds is not None else ""))
            if dtype == torch.float64 and kernel not in rows and case.startswith(headline[kernel]):
                b_ms, b_by = bound_ms(kernel, stash)
                lib = stash.get(("library", kernel))
                # the rounds' median where the case timed this library call
                lib_ms = (float(np.median(lib_rounds))
                          if lib_rounds is not None and lib is stash.get(("library", kernel, case))
                          else cuda_ms(lib) if lib is not None else None)
                rows[kernel] = dict(max_abs_err=abs_err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
                                    bound_by=b_by, library_ms=lib_ms)
                nbytes, nops = headline_work(kernel, stash)
                print(f"[kernels] {kernel:<20} headline: bound {b_ms:.4f} ms ({b_by}; "
                      f"{nbytes / 1e6:.3f} MB, {nops / 1e9:.4f} GFLOP)"
                      + " | library call " + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none"))
        torch.cuda.empty_cache()
    return rows


def phase_dd_kernels(only=None):
    """K23-K26 (or those named in ``only``) against their plain versions on
    the card (``dd_cases``): K23,
    K24 and K25 bit for bit in hi and lo (the same float32 operations in
    the same order, each rounded once), K26 within DD_MATMUL_RTOL of
    max(|A| |B|) (float64 sums in another order); times, bounds (bytes at
    8 bytes a DD value over the HBM rate, or float32 operations over the
    FP32 rate; K26's FP64 tensor-core operations over the DMMA rate) and
    K26's torch.matmul.  Returns the per-kernel summary rows."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, dd
    dev = torch.device(DEVICE)
    rows, stash = {}, {}
    rng = np.random.default_rng(SEED + 8)

    def parts(o):
        return (o.hi, o.lo) if isinstance(o, dd.DD) else (o,)

    for kernel, case, run in dd_cases(dev, rng, stash):
        if only is not None and kernel not in only:
            continue
        out_k = parts(run(DISPATCH))
        torch.cuda.synchronize()
        out_p = parts(run(PLAIN))
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in out_k), f"{kernel} {case}: non-finite")
        val_k, val_p = (sum(x.double() for x in o) for o in (out_k, out_p))
        abs_err = float((val_k - val_p).abs().max())
        if kernel == "dd_matmul":
            scale = stash[("bound_scale", kernel, case)]()
            tol = DD_MATMUL_RTOL * scale
            ok, how = abs_err <= tol, f"tol {tol:.2e} = {DD_MATMUL_RTOL:.0e} max(|A||B|)"
        else:
            same = [torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
                    for a, b in zip(out_k, out_p)]
            ok, how = all(same), "bitwise hi, lo: " + ", ".join(map(str, same))
        plan = stash.get(("plan", kernel, case))
        if plan is not None or isinstance(run, RowCase):   # a second launch gives the same bits
            again = parts(run(DISPATCH))
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(out_k, again))
            print(f"[dd-kernels] {kernel:<18} {case}: "
                  + (f"plan {plan.describe()} | " if plan is not None else "")
                  + f"second launch bit for bit: {same}")
            check(same, f"{kernel} {case}: a second launch differs")
            del again
        del out_k, out_p, val_k, val_p
        dev_txt = ""
        if isinstance(run, RowCase):    # K25: the output made untimed, a cold-L2 device time
            ms_k, ms_p, dev_ms, dev_txt, _ = row_times(kernel, case, run, stash)
        else:
            ms_k, ms_p = cuda_ms(lambda: run(DISPATCH)), cuda_ms(lambda: run(PLAIN))
        work = stash[("work", kernel, case)]
        c_ms, c_by = bound_ms(kernel, stash, work)
        lib = stash.get(("library", kernel, case))
        lib_ms = cuda_ms(lib) if lib is not None else None
        peak = op_peak(kernel)
        print(f"[dd-kernels] {kernel:<18} {case:<44} abs {abs_err:.3e} ({how}) | kernel "
              f"{ms_k:.4f} ms{dev_txt} plain {ms_p:.4f} ms | bound {c_ms:.4f} ms ({c_by}: "
              f"{work[0] / 1e6:.3f} MB, {work[1] / 1e9:.4f} GFLOP at {peak / 1e12:.0f} TFLOP/s), "
              f"kernel at {ms_k / c_ms:.1f}x | library call "
              + (f"{lib_ms:.4f} ms" if lib_ms is not None else "none")
              + f" | {'ok' if ok else 'FAIL'}")
        check(ok, f"{kernel} {case}: kernel differs from its plain version ({how}, abs {abs_err})")
        if kernel not in rows and case.startswith(HEADLINE[kernel]):
            rows[kernel] = dict(max_abs_err=abs_err, ms=ms_k, plain_ms=ms_p, bound_ms=c_ms,
                                bound_by=c_by, library_ms=lib_ms)
    del stash
    torch.cuda.empty_cache()
    return rows


def solve_history(P, ops, device, nx, nt, ms, tol, max_iter):
    mg = P.Mgrit(problem=build_problem(P, nx, nt, ms, device, ops), tol=tol,
                 max_iter=max_iter, logging_lvl=30)
    check(mg._condensed0, "the condensed level-0 carry was declined: " + str(mg._cnd_decline_reason))
    return mg, mg.solve_compiled()["conv"]


def phase_small():
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH
    cpu, hc = solve_history(P, DISPATCH, "cpu", tol=MAIN_TOL, max_iter=SMALL_MAX_ITER, **SMALL)
    gpu, hg = solve_history(P, DISPATCH, DEVICE, tol=MAIN_TOL, max_iter=SMALL_MAX_ITER, **SMALL)
    atol = max(1e-14, residual_floor(cpu))
    check(hc.shape == hg.shape, f"small: {hc.size} CPU iterations against {hg.size} on the GPU")
    err = np.abs(hg - hc)
    ok = bool(np.all(err <= atol + SMALL_RTOL * np.abs(hc)))
    du = float((gpu.u[0].cpu() - cpu.u[0]).abs().max())
    print(f"[small] {SMALL} BE f64: {hg.size} iterations, last {hg[-1]:.6e}, "
          f"max |gpu-cpu| {err.max():.3e} (rtol {SMALL_RTOL:.0e}, atol {atol:.2e}), "
          f"tube max |gpu-cpu| {du:.3e} | {'ok' if ok else 'FAIL'}")
    check(ok, "small config: GPU history differs from the CPU history")
    check(du <= 1e-10, f"small config: GPU tube differs from the CPU tube by {du:.3e}")


def sequential_march(problem0, nt):
    """The plain Heat2D step, nt - 1 times in sequence, every row kept."""
    import torch
    ref = torch.empty((nt,) + tuple(problem0.vector_t_start.shape), dtype=torch.float64,
                      device=problem0.vector_t_start.device)
    ref[0] = problem0.vector_t_start
    t = problem0.t
    for i in range(1, nt):
        ref[i] = problem0._step_spectral(ref[i - 1], t[i - 1], t[i])
    return ref


def phase_main(card):
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    dev = DEVICE

    problem = build_problem(P, device=dev, ops=DISPATCH, **TOMS)
    reset_launch_counts()
    t0 = time.perf_counter()
    mk = P.Mgrit(problem=problem, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)
    hk = mk.solve_compiled()["conv"]
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    counts = launch_counts()
    print(f"[main] launches on the main path: {json.dumps(counts)} "
          f"(setup + first solve {first_seconds:.2f} s)")
    check(mk._condensed0, "main: the condensed carry was declined")
    check(all(counts[k] > 0 for k in SPECTRAL_KERNELS),
          f"main: a kernel of the path was never launched: {counts}")
    check(hk.size >= 2 and bool(np.all(np.diff(hk) < 0)), f"main: history not decreasing: {hk}")
    check(hk[-1] < MAIN_TOL, f"main: history ends at {hk[-1]:.3e}, not below {MAIN_TOL:.0e}")

    mp = P.Mgrit(problem=build_problem(P, device=dev, ops=PLAIN, **TOMS), tol=MAIN_TOL,
                 max_iter=MAIN_MAX_ITER, logging_lvl=30)
    hp = mp.solve_compiled()["conv"]
    atol = residual_floor(mk)
    check(hp.shape == hk.shape, f"main: {hk.size} kernel iterations against {hp.size} plain")
    herr = np.abs(hk - hp)
    h_ok = bool(np.all(herr <= atol + MAIN_RTOL * np.abs(hp)))
    du_plain = float((mk.u[0] - mp.u[0]).abs().max())
    print(f"[main] history kernels vs plain (GPU): max diff {herr.max():.3e}, max rel "
          f"{float(np.max(herr / hp)):.3e} (rtol {MAIN_RTOL:.0e}, atol floor {atol:.2e}); "
          f"tube max diff {du_plain:.3e}; bit for bit: history {np.array_equal(hk, hp)}, tube "
          f"{torch.equal(mk.u[0], mp.u[0])} | {'ok' if h_ok else 'FAIL'}")
    check(h_ok, "main: kernel history differs from the plain history")
    # K1, K2 and K4 round the plain versions' operations once, in their
    # order: the tube is the plain path's, bit for bit (K3's norms, in
    # another summation order, move only the history)
    check(torch.equal(mk.u[0], mp.u[0]), "main: the tube differs from the plain path's")
    del mp
    torch.cuda.empty_cache()

    # materialized tube against a sequential march: with a contractive
    # step, the error of C-point c is at most the sum of the residuals of
    # C-points <= c, so every row's 2-norm error is at most
    # sqrt(nc-1) * ||r||_2 (Cauchy-Schwarz); the march itself rounds at most
    # nt * eps * max|u|.
    tube = mk.u[0]
    nt, nx, nc = TOMS["nt"], TOMS["nx"], mk.levels[0].cpts.size
    check(tuple(tube.shape) == (nt, nx - 2, nx - 2), f"main: tube shape {tuple(tube.shape)}")
    check(bool(torch.isfinite(tube).all()), "main: non-finite values in the tube")
    ref = sequential_march(problem[0], nt)
    row_err = torch.linalg.vector_norm((tube - ref).view(nt, -1), dim=1)
    err = float(row_err.max())
    umax = float(ref.abs().max())
    bound = math.sqrt(nc - 1) * hk[-1] + nt * float(torch.finfo(torch.float64).eps) * umax
    phys = problem[0].to_physical(tube[-1])
    phys_ref = problem[0].to_physical(ref[-1])
    perr = float((phys - phys_ref).abs().max())
    check(tuple(phys.shape) == (nx, nx) and bool(torch.isfinite(phys).all()),
          "main: to_physical of the last row is not a finite nx x nx field")
    print(f"[main] tube {tuple(tube.shape)} vs sequential {nt - 1}-step march: max row 2-norm err "
          f"{err:.3e}, physical last row max err {perr:.3e}, bound {bound:.3e} | "
          f"{'ok' if max(err, perr) <= bound else 'FAIL'}")
    check(max(err, perr) <= bound, f"main: tube error {max(err, perr):.3e} above {bound:.3e}")
    del mk, ref, row_err
    torch.cuda.empty_cache()

    runs, steps = timed_runs(P, dev, **TOMS)
    tk, tp = float(np.median(runs["kernel"])), float(np.median(runs["plain"]))
    print(f"[main] TOMS {nx}x{nx} nt={nt} ms={TOMS['ms']} f64 BE spectral condensed: "
          f"{hk.size} iterations, "
          f"history {[float(f'{h:.6e}') for h in hk]} | solve wall kernel {tk:.4f} s "
          f"(runs {runs['kernel']}), plain {tp:.4f} s (runs {runs['plain']}) | "
          f"{steps} fine steps: {steps / tk:.1f} steps/s kernel, {steps / tp:.1f} steps/s plain | "
          f"{card}")
    return counts, hk, tube


def timed_runs(P, device, order=WALL_ORDER, **cfg):
    """Wall times of fresh solves (setup excluded), in turns kernel, plain
    (or ``order``); returns ({path: [s, ...]}, fine steps of
    one solve)."""
    walls, hists, _, _, mg = strategy_runs(
        P, lambda ops: build_problem(P, device=device, ops=ops, **cfg), "scan", 0, order=order,
        tol=MAIN_TOL, max_iter=MAIN_MAX_ITER)
    steps = sum(count_fine_steps_per_iter(mg, it == 0) for it in range(hists["kernel"].size))
    return walls, steps


def phase_physical(card, h_spec, tube_spec):
    """The main configuration in the physical basis (K3-K7)."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    from pymgrit_tpu_torch.ops.heat_kernels import sine_solve2d_plain
    dev = DEVICE
    cfg = dict(TOMS, basis="physical")

    problem = build_problem(P, device=dev, ops=DISPATCH, **cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_launch_counts()
    t0 = time.perf_counter()
    mk = P.Mgrit(problem=problem, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)
    hk = mk.solve_compiled()["conv"]
    torch.cuda.synchronize()
    first_seconds = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[physical] launches on the physical path: {json.dumps(counts)} "
          f"(setup + first solve {first_seconds:.2f} s); peak device memory {peak:.3f} GiB "
          f"({mem0 / 2 ** 30:.3f} GiB before setup)")
    check(mk._condensed0, "physical: the condensed carry was declined")
    check(all(counts[k] > 0 for k in PHYSICAL_KERNELS),
          f"physical: a kernel of the path was never launched: {counts}")
    check(counts["interval_affine"] == 0 and counts["theta_chain"] == 0,
          f"physical: a spectral kernel ran on the physical path: {counts}")
    check(hk.size >= 2 and bool(np.all(np.diff(hk) < 0)), f"physical: history not decreasing: {hk}")
    check(hk[-1] < MAIN_TOL, f"physical: history ends at {hk[-1]:.3e}, not below {MAIN_TOL:.0e}")

    mp = P.Mgrit(problem=build_problem(P, device=dev, ops=PLAIN, **cfg), tol=MAIN_TOL,
                 max_iter=MAIN_MAX_ITER, logging_lvl=30)
    hp = mp.solve_compiled()["conv"]
    atol = physical_floor(mk)
    ok_p, err_p = histories_agree(hk, hp, atol, MAIN_RTOL)
    du_plain = float((mk.u[0] - mp.u[0]).abs().max())
    del mp
    torch.cuda.empty_cache()
    ok_s, err_s = histories_agree(hk, h_spec, atol, PHYS_SPEC_RTOL)
    print(f"[physical] history kernels vs plain (GPU): max diff {err_p:.3e} (rtol {MAIN_RTOL:.0e}); "
          f"vs the spectral path: max diff {err_s:.3e} (rtol {PHYS_SPEC_RTOL:.0e}); atol floor "
          f"{atol:.2e}; tube kernels vs plain max diff {du_plain:.3e} | "
          f"{'ok' if ok_p and ok_s else 'FAIL'}")
    check(ok_p, f"physical: kernel history {hk} differs from the plain history {hp}")
    check(ok_s, f"physical: history {hk} differs from the spectral history {h_spec}")

    # the materialized tube against the spectral tube brought to the
    # physical basis (plain transform): each tube lies within
    # sqrt(nc-1) * (its last residual) of the exact solution (see phase
    # main), plus the rounding of a march
    tube = mk.u[0]
    nt, nx, nc = TOMS["nt"], TOMS["nx"], mk.levels[0].cpts.size
    check(tuple(tube.shape) == (nt, nx, nx), f"physical: tube shape {tuple(tube.shape)}")
    check(bool(torch.isfinite(tube).all()), "physical: non-finite values in the tube")
    ring = problem[0]._ring
    row_err = torch.empty(nt, dtype=torch.float64, device=tube.device)
    for lo in range(0, nt, 4096):
        hi = min(lo + 4096, nt)
        ref = sine_solve2d_plain(tube_spec[lo:hi], torch.empty_like(tube[lo:hi]),
                                 problem[0]._Sx, problem[0]._Sy, ring=ring)
        row_err[lo:hi] = torch.linalg.vector_norm((tube[lo:hi] - ref).view(hi - lo, -1), dim=1)
    err = float(row_err.max())
    bound = math.sqrt(nc - 1) * (hk[-1] + h_spec[-1]) \
        + nt * float(torch.finfo(torch.float64).eps) * float(tube.abs().max())
    print(f"[physical] tube {tuple(tube.shape)} vs the spectral tube in the physical basis: "
          f"max row 2-norm err {err:.3e}, bound {bound:.3e} | {'ok' if err <= bound else 'FAIL'}")
    check(err <= bound, f"physical: tube error {err:.3e} above {bound:.3e}")
    del mk, tube, row_err, problem
    torch.cuda.empty_cache()

    runs, steps = timed_runs(P, dev, order=E2E_ORDER, **cfg)
    tk, tp = float(np.median(runs["kernel"])), float(np.median(runs["plain"]))
    print(f"[physical] TOMS {nx}x{nx} nt={nt} ms={TOMS['ms']} f64 BE physical condensed: "
          f"{hk.size} iterations, history {[float(f'{h:.6e}') for h in hk]} | solve wall kernel "
          f"{tk:.4f} s (runs {runs['kernel']}), plain {tp:.4f} s (runs {runs['plain']}) | "
          f"{steps} fine steps: {steps / tk:.1f} steps/s kernel, {steps / tp:.1f} steps/s plain | "
          f"{card}")
    return counts


def phase_cn_fe():
    """CN at the TOMS width and a smaller depth; FE on a stable small grid
    (it declines the condensed carry and runs the full-tube executor)."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts

    hist = {}
    for name, ops, basis in (("kernel", DISPATCH, "physical"), ("plain", PLAIN, "physical"),
                             ("spectral", DISPATCH, "spectral")):
        reset_launch_counts()
        mg = P.Mgrit(problem=build_problem(P, device=DEVICE, ops=ops, method="CN", basis=basis,
                                           **CN_CFG), tol=MAIN_TOL, max_iter=MAIN_MAX_ITER,
                     logging_lvl=30)
        hist[name] = mg.solve_compiled()["conv"]
        if name == "kernel":
            counts, atol = launch_counts(), physical_floor(mg)
            check(mg._condensed0, "cn: the condensed carry was declined")
        del mg
        torch.cuda.empty_cache()
    ok_p, err_p = histories_agree(hist["kernel"], hist["plain"], atol, MAIN_RTOL)
    ok_s, err_s = histories_agree(hist["kernel"], hist["spectral"], atol, PHYS_SPEC_RTOL)
    print(f"[cn] {CN_CFG} f64 CN physical: {hist['kernel'].size} iterations, last "
          f"{hist['kernel'][-1]:.6e}; vs plain max diff {err_p:.3e}, vs spectral {err_s:.3e} "
          f"(atol floor {atol:.2e}); launches {json.dumps(counts)} | "
          f"{'ok' if ok_p and ok_s else 'FAIL'}")
    check(all(counts[k] > 0 for k in PHYSICAL_KERNELS), f"cn: a kernel was never launched: {counts}")
    check(hist["kernel"][-1] < MAIN_TOL, "cn: did not converge")
    check(ok_p and ok_s, f"cn: histories differ: {hist}")

    runs = {}
    for device in ("cpu", DEVICE):
        reset_launch_counts()
        mg = P.Mgrit(problem=build_problem(P, device=device, ops=DISPATCH, method="FE",
                                           basis="physical", **FE_CFG),
                     tol=MAIN_TOL, max_iter=FE_MAX_ITER, logging_lvl=30)
        runs[device] = (mg, mg.solve_compiled()["conv"], launch_counts())
    (mc, hc, _), (mg, hg, counts) = runs["cpu"], runs[DEVICE]
    atol = max(1e-14, residual_floor(mc))
    ok, err = histories_agree(hg, hc, atol, SMALL_RTOL)
    du = float((mg.u[0].cpu() - mc.u[0]).abs().max())
    print(f"[fe] {FE_CFG} f64 FE physical, full tube ({mg._cnd_decline_reason}): "
          f"{hg.size} iterations, last {hg[-1]:.6e}; GPU vs CPU max diff {err:.3e} "
          f"(rtol {SMALL_RTOL:.0e}, atol {atol:.2e}), tube {du:.3e}; launches {json.dumps(counts)} "
          f"| {'ok' if ok and du <= 1e-10 else 'FAIL'}")
    check(not mg._condensed0 and "declined" in str(mg._cnd_decline_reason),
          "fe: the condensed carry was not declined by the hook")
    check(counts["theta_rhs2d"] > 0 and counts["sine_solve2d"] == 0,
          f"fe: expected K7 steps only: {counts}")
    check(ok and du <= 1e-10, "fe: GPU and CPU disagree")


def dahlquist_problem(P, ops):
    d0 = P.Dahlquist(t_start=0, t_stop=DAHLQUIST["t_end"], nt=DAHLQUIST["nt"], device=DEVICE,
                     ops=ops)
    return [d0, P.Dahlquist(t_interval=d0.t[::DAHLQUIST["m"]], device=DEVICE, ops=ops)]


def strategy(P, name, problem, k, **kw):
    """A solver with one coarsest-level strategy: 'scan' (the sequential
    march), 'at' (AtMgrit(k)) or 'prefix' (coarsest_prefix=True)."""
    if name == "at":
        return P.AtMgrit(k, problem=problem, logging_lvl=30, **kw)
    return P.Mgrit(problem=problem, logging_lvl=30, coarsest_prefix=name == "prefix", **kw)


def strategy_runs(P, build, name, k, warm=False, order=WALL_ORDER,
                  **kw):
    """Fresh solves of one strategy in turns kernel, plain (or the given
    order; setup excluded from the walls), after one untimed
    kernel solve if warm (the first solve pays the one-time costs: the
    kernel library's load, the models' device tables).
    The first timed kernel run is the path's run: the launch counts are set
    to 0 before its setup and read after its solve, with its peak device
    memory above what was allocated before it; its solver is kept.  Returns
    (walls {path: [s, s]}, histories {path: first history}, counts, peak
    GiB, kept solver)."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    walls, hists, counts, peak, kept = {"plain": [], "kernel": []}, {}, None, None, None
    if warm:
        strategy(P, name, build(DISPATCH), k, **kw).solve_compiled()
        torch.cuda.empty_cache()
    for path in order:
        first = path == "kernel" and counts is None
        torch.cuda.synchronize()
        if first:
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            reset_launch_counts()
        mg = strategy(P, name, build(DISPATCH if path == "kernel" else PLAIN), k, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = mg.solve_compiled()["conv"]
        torch.cuda.synchronize()
        walls[path].append(time.perf_counter() - t0)
        check(bool(np.all(np.isfinite(h))), f"{name} {path}: non-finite history {h}")
        hists.setdefault(path, h)
        if first:
            counts, kept = launch_counts(), mg
            peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
        del mg
        torch.cuda.empty_cache()
    return walls, hists, counts, peak, kept


def fmt_walls(walls):
    return (f"kernel {np.median(walls['kernel']):.4f} s (runs {[round(w, 4) for w in walls['kernel']]}), "
            f"plain {np.median(walls['plain']):.4f} s (runs {[round(w, 4) for w in walls['plain']]})")


def check_coarsest_counts(label, counts, name):
    """The prefix run launches K8 and not K9; the AT run K9 and not K8; the
    scan neither."""
    want = {"scan": (), "prefix": ("affine_prefix",), "at": ("affine_windows",)}[name]
    for kern in COARSEST_KERNELS:
        check((counts[kern] > 0) == (kern in want),
              f"{label} {name}: launches {counts} (expected {want or 'none'} of {COARSEST_KERNELS})")


def phase_coarsest_dahlquist(card):
    """bench.py's equal-accuracy row: scan, AtMgrit(128) and the prefix on
    Dahlquist, coarsest nt = 8193."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, launch_counts, reset_launch_counts
    cfg = DAHLQUIST
    kw = dict(tol=1e-300, max_iter=cfg["max_iter"])

    def build(ops):
        return dahlquist_problem(P, ops)

    # the port's sequential scan is a Python loop of 65536 batched steps
    # per forward solve: timed once
    reset_launch_counts()
    t0 = time.perf_counter()
    ms = strategy(P, "scan", build(DISPATCH), cfg["k"], **kw)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hs = ms.solve_compiled()["conv"]
    torch.cuda.synchronize()
    scan_wall, scan_setup = time.perf_counter() - t1, t1 - t0
    check_coarsest_counts("dahlquist", launch_counts(), "scan")
    floor = residual_floor(ms)
    del ms
    torch.cuda.empty_cache()

    res = {name: strategy_runs(P, build, name, cfg["k"], **kw) for name in ("prefix", "at")}
    (wp, hp, cp, _, mp), (wa, ha, ca, _, ma) = res["prefix"], res["at"]
    check_coarsest_counts("dahlquist", cp, "prefix")
    check_coarsest_counts("dahlquist", ca, "at")
    ok_ps, err_ps = histories_agree(hp["kernel"], hs, floor, MAIN_RTOL)
    ok_pp, err_pp = histories_agree(hp["kernel"], hp["plain"], floor, MAIN_RTOL)
    ok_ap, err_ap = histories_agree(ha["kernel"], ha["plain"], floor, MAIN_RTOL)
    at_rel = float(np.max(np.abs(ha["kernel"] - hs) / np.abs(hs))) \
        if ha["kernel"].shape == hs.shape else float("inf")
    # the prefix tube against the exact BE march u_i = (1 + dt)^-i: with a
    # contractive step every row errs by at most sqrt(nc-1) * ||r||_2 (see
    # phase main), plus the rounding of a march
    info = mp.levels[0]
    dt = cfg["t_end"] / (cfg["nt"] - 1)
    exact = torch.as_tensor((1.0 / (1.0 + dt)) ** np.arange(cfg["nt"]), device=mp.u[0].device)
    terr = float((mp.u[0] - exact).abs().max())
    bound = math.sqrt(info.cpts.size - 1) * hp["kernel"][-1] + cfg["nt"] * float(
        torch.finfo(torch.float64).eps)
    print(f"[coarsest] Dahlquist BE nt={cfg['nt']} m={cfg['m']} (coarsest nt="
          f"{mp.levels[1].nt}) f64, {cfg['max_iter']} iterations: histories scan "
          f"{[float(f'{h:.6e}') for h in hs]}, prefix {[float(f'{h:.6e}') for h in hp['kernel']]}, "
          f"AT k={cfg['k']} {[float(f'{h:.6e}') for h in ha['kernel']]} | prefix vs scan max diff "
          f"{err_ps:.3e} (rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}); AT vs scan max rel "
          f"{at_rel:.3e} (tol {AT_SCAN_RTOL:.0e}); kernel vs plain (GPU) prefix {err_pp:.3e}, AT "
          f"{err_ap:.3e}; prefix tube vs (1+dt)^-i max err {terr:.3e} (bound {bound:.3e}) | "
          f"{'ok' if ok_ps and ok_pp and ok_ap and at_rel < AT_SCAN_RTOL and terr <= bound else 'FAIL'}")
    print(f"[coarsest] Dahlquist solve walls: scan {scan_wall:.4f} s (kernel ops, once; setup with "
          f"the nested-iteration march {scan_setup:.2f} s); prefix {fmt_walls(wp)}; AT "
          f"{fmt_walls(wa)} | launches prefix run K8 {cp['affine_prefix']}, AT run K9 "
          f"{ca['affine_windows']} | {card}")
    check(hs.size == cfg["max_iter"] and bool(np.all(np.diff(hs) < 0)),
          f"dahlquist: scan history {hs}")
    check(ok_ps, f"dahlquist: prefix history {hp['kernel']} differs from the scan's {hs}")
    check(ok_pp and ok_ap, "dahlquist: kernel and plain histories differ")
    check(at_rel < AT_SCAN_RTOL, f"dahlquist: AT history {ha['kernel']} differs from the scan's")
    check(terr <= bound, f"dahlquist: prefix tube error {terr:.3e} above {bound:.3e}")
    del mp, ma, exact
    torch.cuda.empty_cache()
    return cp, ca


def phase_coarsest_toms(card):
    """The TOMS width with two levels (coarsest 2049 x 16129): the scan (K2)
    and the prefix (K8) to 1e-10, AtMgrit(64) (K9) for three iterations."""
    import torch
    import pymgrit_tpu_torch as P
    nt, nx = TOMS2["nt"], TOMS2["nx"]

    def build(ops):
        return build_problem(P, device=DEVICE, ops=ops, **TOMS2)

    runs = {name: strategy_runs(P, build, name, TOMS2_AT_K, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER)
            for name in ("scan", "prefix")}
    runs["at"] = strategy_runs(P, build, "at", TOMS2_AT_K, tol=1e-300, max_iter=TOMS2_AT_ITERS)
    for name, r in runs.items():
        check_coarsest_counts("toms", r[2], name)
        check(r[4]._condensed0, f"toms {name}: the condensed carry was declined")
    (ws, hs, cs, ps, ms), (wp, hp, cp, pp, mp), (wa, ha, ca, pa, ma) = (
        runs["scan"], runs["prefix"], runs["at"])
    floor = residual_floor(ms)
    ok_ps, err_ps = histories_agree(hp["kernel"], hs["kernel"], floor, MAIN_RTOL)
    agree = {name: histories_agree(r[1]["kernel"], r[1]["plain"], floor, MAIN_RTOL)
             for name, r in runs.items()}
    nc = ms.levels[0].cpts.size
    row_err = torch.linalg.vector_norm((mp.u[0] - ms.u[0]).view(nt, -1), dim=1)
    terr = float(row_err.max())
    bound = math.sqrt(nc - 1) * (hs["kernel"][-1] + hp["kernel"][-1]) \
        + nt * float(torch.finfo(torch.float64).eps) * float(ms.u[0].abs().max())
    at_tube_ok = tuple(ma.u[0].shape) == (nt, nx - 2, nx - 2) and bool(torch.isfinite(ma.u[0]).all())
    ok = ok_ps and all(a for a, _ in agree.values()) and terr <= bound and at_tube_ok
    print(f"[coarsest] TOMS {nx}x{nx} nt={nt} ms={TOMS2['ms']} (coarsest {mp.levels[1].nt} x "
          f"{(nx - 2) ** 2}) f64 BE spectral: scan {hs['kernel'].size} iterations "
          f"{[float(f'{h:.6e}') for h in hs['kernel']]}; prefix {hp['kernel'].size} iterations, vs "
          f"scan max diff {err_ps:.3e} (rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}), tube max row "
          f"2-norm diff {terr:.3e} (bound {bound:.3e}); AT k={TOMS2_AT_K} {TOMS2_AT_ITERS} iterations "
          f"{[float(f'{h:.6e}') for h in ha['kernel']]}; kernel vs plain (GPU) max diff "
          + ", ".join(f"{name} {e:.3e}" for name, (_, e) in agree.items())
          + f" | {'ok' if ok else 'FAIL'}")
    print(f"[coarsest] TOMS solve walls: scan {fmt_walls(ws)}; prefix {fmt_walls(wp)}; AT "
          f"{fmt_walls(wa)} | launches: scan run K2 {cs['theta_chain']}, prefix run K8 "
          f"{cp['affine_prefix']}, AT run K9 {ca['affine_windows']} | peak device memory scan "
          f"{ps:.3f} GiB, prefix {pp:.3f} GiB, AT {pa:.3f} GiB | {card}")
    check(hs["kernel"][-1] < MAIN_TOL, f"toms: scan history ends at {hs['kernel'][-1]:.3e}")
    check(ok_ps, f"toms: prefix history {hp['kernel']} differs from the scan's {hs['kernel']}")
    check(all(a for a, _ in agree.values()), f"toms: kernel and plain histories differ: {agree}")
    check(terr <= bound, f"toms: prefix tube differs from the scan tube by {terr:.3e}")
    check(ha["kernel"].size == TOMS2_AT_ITERS and at_tube_ok, "toms: AT run incomplete")
    del runs, ms, mp, ma, row_err
    torch.cuda.empty_cache()
    return cp, ca


def heat1d_rhs(x, t):
    return -np.sin(np.pi * x) * (np.sin(t) - 1 * np.pi ** 2 * np.cos(t))


def phase_coarsest_golden():
    """The Heat1D AT-MGRIT golden (3 levels, k = 2): the physical basis
    (masked batched steps) and the spectral basis (K9), GPU against CPU."""
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import launch_counts, reset_launch_counts
    for basis in ("physical", "spectral"):
        runs = {}
        for device in ("cpu", DEVICE):
            problem = [P.Heat1D(x_start=0, x_end=2, nx=5, a=1, rhs=heat1d_rhs,
                                init_cond=lambda x: np.sin(np.pi * x), t_start=0, t_stop=2,
                                nt=nt, basis=basis, device=device) for nt in (65, 17, 5)]
            reset_launch_counts()
            mg = P.AtMgrit(k=2, problem=problem, cf_iter=1, nested_iteration=False, max_iter=2,
                           random_init_guess=False, logging_lvl=30)
            runs[device] = (mg, mg.solve()["conv"], launch_counts())
        (mc, hc, _), (mg, hg, counts) = runs["cpu"], runs[DEVICE]
        atol = max(1e-14, residual_floor(mc))
        ok, err = histories_agree(hg, hc, atol, SMALL_RTOL)
        golden = hg.shape == AT_GOLDEN.shape and bool(
            np.all(np.abs(hg - AT_GOLDEN) <= AT_GOLDEN_RTOL * AT_GOLDEN))
        k9 = counts["affine_windows"]
        print(f"[coarsest] Heat1D AT-MGRIT golden k=2, 3 levels, {basis}: GPU history "
              f"{[float(f'{h:.7e}') for h in hg]}, CPU {[float(f'{h:.7e}') for h in hc]}, max diff "
              f"{err:.3e} (rtol {SMALL_RTOL:.0e}, atol {atol:.2e}); golden {AT_GOLDEN.tolist()} "
              f"(rtol {AT_GOLDEN_RTOL:.0e}); K9 launches {k9} | "
              f"{'ok' if ok and golden else 'FAIL'}")
        check(ok and golden, f"golden {basis}: GPU {hg}, CPU {hc}")
        check((k9 > 0) == (basis == "spectral"), f"golden {basis}: K9 launches {k9}")


def allen_cahn_problem(P, ops, nx, method, t_stop, nt, ms, device=None, **_):
    a0 = P.AllenCahn(nx=nx, method=method, t_start=0, t_stop=t_stop, nt=nt,
                     device=device or DEVICE, ops=ops)
    problem, stride = [a0], 1
    for m in ms:
        stride *= m
        problem.append(P.AllenCahn(nx=nx, method=method, t_interval=a0.t[::stride],
                                   device=device or DEVICE, ops=ops))
    return problem


def allen_cahn_run(P, card, cfg, label):
    """One Allen-Cahn configuration in turns kernel, plain:
    launches of the first kernel run, history against the plain path at
    rtol 1e-9 with the floor of four length-n products per step, walls,
    fine steps/s, peak memory, Newton and CG counts, the final radius."""
    import torch
    walls, hists, counts, peak, mg = strategy_runs(
        P, lambda ops: allen_cahn_problem(P, ops, **cfg), "scan", 0, warm=True, tol=cfg["tol"],
        max_iter=cfg["max_iter"])
    hk, hp = hists["kernel"], hists["plain"]
    floor = residual_floor(mg, 4 * math.sqrt(cfg["nx"]) + FLOOR_OPS)
    ok, err = histories_agree(hk, hp, floor, MAIN_RTOL)
    want = AC_KERNELS[cfg["method"]]
    # the returned history drops exact zeros (a two-level solve can end at
    # 0), so the iterations are the solver's count
    iters = mg.solve_iter
    steps = sum(count_fine_steps_per_iter(mg, it == 0) for it in range(iters))
    tk = float(np.median(walls["kernel"]))
    stats = [p.stats for p in mg.problem]
    newton = {k: [st[k] for st in stats] for k in ("steps", "newton", "cg", "newton_max", "cg_max")}
    tube = mg.u[0]
    radius, exact = mg.problem[0].compute_radius(tube[-1]), mg.problem[0].exact_radius(cfg["t_stop"])
    print(f"[allen_cahn] {label} {cfg['nx']}^2 {cfg['method']} nt={cfg['nt']} ms={cfg['ms']} f64: "
          f"{iters} iterations, history {[float(f'{h:.6e}') for h in hk]} | kernel vs plain "
          f"(GPU) max diff {err:.3e} (rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}) | launches "
          f"{json.dumps({k: counts[k] for k in counts if counts[k]})} | solve wall {fmt_walls(walls)} | "
          f"{steps} fine steps: {steps / tk:.1f} steps/s kernel | peak device memory {peak:.3f} GiB "
          f"| radius at t={cfg['t_stop']}: {radius:.6f} (exact {exact:.6f}) | {card}")
    if cfg["method"] != "IMEX":
        print(f"[allen_cahn] {label} Newton-CG per level (setup + first kernel solve): "
              f"{json.dumps(newton)}")
    check(all(counts[k] > 0 for k in want), f"allen_cahn {label}: a kernel never ran: {counts}")
    check(cfg["method"] != "IMEX" or counts["allen_cahn_pointwise"] == 0,
          f"allen_cahn {label}: K11 ran on the IMEX path: {counts}")
    check(tuple(tube.shape) == (cfg["nt"], cfg["nx"], cfg["nx"]) and bool(torch.isfinite(tube).all()),
          f"allen_cahn {label}: tube {tuple(tube.shape)} not finite")
    check(ok, f"allen_cahn {label}: kernel history {hk} differs from the plain history {hp}")
    return hk, counts, mg


def phase_allen_cahn(card):
    import torch
    import pymgrit_tpu_torch as P
    hb, counts_imex, mg = allen_cahn_run(P, card, AC_BENCH, "bench row")
    rel1 = abs(hb[0] - AC_BENCH_REF_ITER1) / AC_BENCH_REF_ITER1
    print(f"[allen_cahn] bench row iteration 1 {hb[0]:.10e} vs the reference's "
          f"{AC_BENCH_REF_ITER1:.10e}: rel {rel1:.3e} (rtol {AC_REF_RTOL:.0e}) | "
          f"{'ok' if rel1 <= AC_REF_RTOL else 'FAIL'}")
    check(hb.size == AC_BENCH["max_iter"] and bool(np.all(np.isfinite(hb))),
          f"allen_cahn bench row: history {hb}")
    check(rel1 <= AC_REF_RTOL, "allen_cahn bench row: iteration 1 differs from the reference")
    del mg
    torch.cuda.empty_cache()
    counts = {}
    for cfg, label in ((AC_IMPL, "example IMPL"), (AC_CN, "CN")):
        h, counts[cfg["method"]], mg = allen_cahn_run(P, card, cfg, label)
        check(mg.conv[mg.solve_iter] < cfg["tol"],
              f"allen_cahn {label}: history {h} ends above {cfg['tol']}")
        del mg
        torch.cuda.empty_cache()
    return counts_imex, counts["IMPL"]


def ode_problem(P, model, ops, nt, m, device=None, **_):
    device = device or DEVICE
    cls = getattr(P, model)
    p0 = cls(t_start=0, t_stop=T_ORBIT if model == "ArenstorfOrbit" else 12, nt=nt,
             device=device, ops=ops)
    return [p0, cls(t_interval=p0.t[::m], device=device, ops=ops)]


def phase_ode(card):
    """Arenstorf (K12) at the example's configuration, the user-defined
    criterion, the Brusselator (K13)."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    cfg = ARENSTORF
    kw = dict(cf_iter=cfg["cf_iter"], tol=cfg["tol"], logging_lvl=30)

    # CPU plain reference, an untimed kernel solve, then in turns kernel,
    # plain (solve())
    mc = P.Mgrit(problem=ode_problem(P, "ArenstorfOrbit", DISPATCH, device="cpu", **cfg), **kw)
    hc = mc.solve()["conv"]
    P.Mgrit(problem=ode_problem(P, "ArenstorfOrbit", DISPATCH, **cfg), **kw).solve()
    runs, walls = {}, {"plain": [], "kernel": []}
    for path in WALL_ORDER:
        first = path == "kernel" and "kernel" not in runs
        torch.cuda.synchronize()
        if first:
            reset_launch_counts()
        mg = P.Mgrit(problem=ode_problem(P, "ArenstorfOrbit", DISPATCH if path == "kernel" else PLAIN,
                                         **cfg), **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = mg.solve()["conv"]
        torch.cuda.synchronize()
        walls[path].append(time.perf_counter() - t0)
        if first:
            counts = launch_counts()
        runs.setdefault(path, (mg, h))
    (mk, hk), (mp, hp) = runs["kernel"], runs["plain"]
    att = [(int(p.attempts), p.steps, int(p.attempts_max)) for p in mk.problem]
    att_p = [(int(p.attempts), p.steps) for p in mp.problem]
    nc = mk.levels[0].cpts
    uk, up, uc = (x[nc].double().cpu() for x in (mk.u[0], mp.u[0], mc.u[0]))
    scale = float(uc.abs().max())
    dk_p, dk_c = float((uk - up).abs().max()) / scale, float((uk - uc).abs().max()) / scale
    ok_h = (hk.shape == hp.shape == hc.shape and np.allclose(hk, hp, rtol=ORBIT_RTOL, atol=0)
            and np.allclose(hk, hc, rtol=ORBIT_RTOL, atol=0))
    ok = ok_h and max(dk_p, dk_c) <= ORBIT_STATE_RTOL and hk[-1] < cfg["tol"]
    print(f"[ode] Arenstorf nt={cfg['nt']} m={cfg['m']} cf_iter=0 tol {cfg['tol']} f64: "
          f"{hk.size} iterations, history kernel {list(hk)}, plain (GPU) {list(hp)}, CPU {list(hc)} "
          f"(rtol {ORBIT_RTOL:.0e}); C-points kernel vs plain {dk_p:.3e}, vs CPU {dk_c:.3e} (rel to "
          f"max, tol {ORBIT_STATE_RTOL:.0e}) | attempts (total, steps, max per step) per level kernel "
          f"{att}, plain {att_p} | launches K12 {counts['dopri45_arenstorf']} | solve wall "
          f"{fmt_walls(walls)} | {'ok' if ok else 'FAIL'} | {card}")
    check(counts["dopri45_arenstorf"] > 0, f"ode: K12 never ran: {counts}")
    check(att == [(a, s, att[i][2]) for i, (a, s) in enumerate(att_p)],
          f"ode: attempt counts differ between K12 {att} and the plain path {att_p}")
    check(ok, "ode: the Arenstorf solve differs between kernels, plain and CPU")
    del runs, mk, mp, mc
    torch.cuda.empty_cache()

    class RelativeChange(P.Mgrit):
        """examples/example_convergence_criterion.py on the port."""

        def __init__(self, *args, **kwargs):
            self.last_it = None
            super().__init__(*args, **kwargs)
            self.convergence_criterion(iteration=0)

        def convergence_criterion(self, iteration):
            new = self.u[0][self.levels[0].cpts].cpu().numpy()
            last = np.zeros_like(new) if self.last_it is None else self.last_it
            self.conv[iteration] = 100 * np.max(np.abs(np.abs(np.divide(
                new - last, new, out=np.zeros_like(new), where=new != 0))))
            self.last_it = np.copy(new)

    reset_launch_counts()
    mg = RelativeChange(problem=ode_problem(P, "ArenstorfOrbit", DISPATCH, **CRITERION),
                        tol=CRITERION["tol"], logging_lvl=30)
    conv = mg.solve()["conv"]
    k12 = launch_counts()["dopri45_arenstorf"]
    rel = abs(conv[1] - CRITERION_ITER1) / CRITERION_ITER1 if conv.size > 1 else float("inf")
    ok = conv.size == 4 and rel <= CRITERION_RTOL and k12 > 0
    print(f"[ode] custom criterion (relative C-point change) nt={CRITERION['nt']} "
          f"m={CRITERION['m']}: history {list(conv)}; iteration 1 vs golden {CRITERION_ITER1} rel "
          f"{rel:.3e} (rtol {CRITERION_RTOL:.0e}); K12 launches {k12} | {'ok' if ok else 'FAIL'}")
    check(ok, f"ode: custom criterion history {conv}")

    hist = {}
    for path, ops in (("plain", PLAIN), ("kernel", DISPATCH)):
        reset_launch_counts()
        mg = P.Mgrit(problem=ode_problem(P, "Brusselator", ops, **BRUSSELATOR),
                     tol=BRUSSELATOR["tol"], logging_lvl=30)
        hist[path] = (mg.solve()["conv"], launch_counts(), mg)
    (hk, counts_b, mk), (hp, _, _) = hist["kernel"], hist["plain"]
    floor = residual_floor(mk, 8 * BRUSSELATOR["m"])
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    golden = hk.size >= 4 and bool(np.all(np.abs(hk[:4] - BRUSSELATOR_GOLDEN)
                                          <= BRUSSELATOR_RTOL * BRUSSELATOR_GOLDEN))
    print(f"[ode] Brusselator nt={BRUSSELATOR['nt']} m={BRUSSELATOR['m']} f64: history "
          f"{list(hk)}; vs plain (GPU) max diff {err_p:.3e} (rtol {MAIN_RTOL:.0e}, atol floor "
          f"{floor:.2e}); golden {BRUSSELATOR_GOLDEN.tolist()} (rtol {BRUSSELATOR_RTOL:.0e}); "
          f"K13 launches {counts_b['rk4_brusselator']} | {'ok' if ok_p and golden else 'FAIL'}")
    check(counts_b["rk4_brusselator"] > 0, f"ode: K13 never ran: {counts_b}")
    check(ok_p and golden, f"ode: Brusselator history {hk} (plain {hp})")
    return counts, counts_b


def level_problems(P, model, cfg, ops, device=None, **model_kw):
    """A model's hierarchy: level 0 on [0, t_stop] with nt points, each
    coarser level every ms[l]-th point of the one above."""
    cls, device = getattr(P, model), device or DEVICE
    p0 = cls(t_start=0, t_stop=cfg["t_stop"], nt=cfg["nt"], device=device, ops=ops, **model_kw)
    problem, stride = [p0], 1
    for m in cfg["ms"]:
        stride *= m
        problem.append(cls(t_interval=p0.t[::stride], device=device, ops=ops, **model_kw))
    return problem


def slice_run(P, card, label, model, cfg, want, name="scan", k=0, order=None, solver_kw=None,
              **model_kw):
    """One configuration of the slice's models, kernels against plain on the
    card: launches of the first kernel run (every kernel of ``want``
    launched), the history against the plain path at rtol 1e-9 with the
    floor of four length-n products per step, walls, peak memory.  Returns
    (kernel history, launch counts, kept kernel solver)."""
    import torch
    kw = dict(tol=cfg["tol"], max_iter=cfg["max_iter"], **(solver_kw or {}))
    walls, hists, counts, peak, mg = strategy_runs(
        P, lambda ops: level_problems(P, model, cfg, ops, **model_kw), name, k,
        order=order or WALL_ORDER, **kw)
    hk, hp = hists["kernel"], hists["plain"]
    floor = residual_floor(mg, 4 * math.sqrt(cfg.get("nx", 128)) + FLOOR_OPS)
    ok, err = histories_agree(hk, hp, floor, MAIN_RTOL)
    tube = mg.u[0]
    phase, what = label.split(" ", 1)
    print(f"[{phase}] {what} nt={cfg['nt']} ms={cfg['ms']} f64: {hk.size} iterations, "
          f"history {[float(f'{h:.6e}') for h in hk]} | kernel vs plain (GPU) max diff {err:.3e} "
          f"(rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}) | launches "
          f"{json.dumps({c: counts[c] for c in counts if counts[c]})} | solve wall "
          f"{fmt_walls(walls)} "
          f"| peak device memory {peak:.3f} GiB | {'ok' if ok else 'FAIL'} | {card}")
    check(all(counts[c] > 0 for c in want), f"{label}: a kernel of the path never ran: {counts}")
    check(bool(torch.isfinite(tube).all()), f"{label}: non-finite values in the tube")
    check(ok, f"{label}: kernel history {hk} differs from the plain history {hp}")
    return hk, counts, mg


def newton_stats(mg):
    """Newton (and BiCGStab) counts per level of a kept solver's problems."""
    out = []
    for p in mg.problem:
        if hasattr(p, "stats"):
            out.append({k: p.stats[k] for k in ("steps", "newton", "bicgstab", "newton_max",
                                                "bicgstab_max")})
        else:
            out.append(dict(steps=p.steps, newton=int(p.newton_iters),
                            newton_max=int(p.newton_max)))
    return out


def phase_gray_scott(card):
    """The AT-MGRIT Gray-Scott demo at the reference's size (K10 with the
    species axis and the Gray-Scott prologue) and the demo's Parareal run,
    whose C-points are held against the sequential fine march through K10;
    IMPL (K10 + K14 in Newton-BiCGStab) and EXPL (K14)."""
    import torch
    import pymgrit_tpu_torch as P
    cfg = GS_AT
    gs = dict(nx=cfg["nx"], method="IMEX")
    want = SLICE_KERNELS["gray_scott"]["IMEX"]
    h_at, counts_at, mg = slice_run(P, card, f"gray_scott AtMgrit(k={cfg['k']}) {cfg['nx']}^2 IMEX",
                                    "GrayScott2D", cfg, want, name="at", k=cfg["k"], **gs)
    check(counts_at["gray_scott_pointwise"] == 0,
          f"gray_scott: K14 ran on the IMEX path: {counts_at}")
    check(bool(np.all(np.diff(h_at) < 0)), f"gray_scott: AT history not decreasing: {h_at}")
    u_at = mg.u[0]
    del mg
    h_pr, _, mg = slice_run(P, card, f"gray_scott Parareal {cfg['nx']}^2 IMEX", "GrayScott2D",
                            dict(GS_PARAREAL), want, order=("plain", "kernel"),
                            solver_kw=dict(cf_iter=0), **gs)
    # the sequential march (the example's run_ts) through K10, one launch a step
    p0, nt = mg.problem[0], cfg["nt"]
    march = torch.empty((1, nt - 1) + tuple(p0.vector_t_start.shape), dtype=torch.float64,
                        device=p0.vector_t_start.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p0.step_chain(p0.vector_t_start[None], p0.t[:-1, None], p0.t[1:, None], march)
    torch.cuda.synchronize()
    march_wall = time.perf_counter() - t0
    cpts = torch.as_tensor(mg.levels[0].cpts[1:], device=march.device)
    err = float((mg.u[0][cpts] - march[0, cpts - 1]).abs().max())
    err_at = float((u_at[cpts] - march[0, cpts - 1]).abs().max())
    # a C-point's error is at most the sum of the residuals of the C-points
    # before it, each amplified by the steps after it: the sum is at most
    # sqrt(nc - 1) ||r||_2; the implicit diffusion does not amplify, the
    # reaction by at most e^(lip t_end), lip the row-sum norm of its Jacobian
    # [[-v^2 - a, -2uv], [v^2, 2uv - b]] on the march's C-point states
    nc = cpts.numel() + 1
    uc, vc = march[0, cpts - 1, 0], march[0, cpts - 1, 1]
    lip = float((vc * vc + 2 * (uc * vc).abs()).max()) + GS_COEF["a"] + GS_COEF["b"]
    bound = math.sqrt(nc - 1) * h_pr[-1] * math.exp(lip * cfg["t_stop"]) \
        + nt * float(torch.finfo(torch.float64).eps)
    print(f"[gray_scott] C-points vs the sequential {nt - 1}-step march (K10, {march_wall:.2f} s): "
          f"Parareal max err {err:.3e} (bound {bound:.3e}); AtMgrit after {h_at.size} iterations "
          f"max err {err_at:.3e} | {'ok' if err <= bound else 'FAIL'}")
    check(h_pr[-1] < cfg["tol"], f"gray_scott: Parareal history {h_pr}")
    check(err <= bound, f"gray_scott: C-points differ from the march by {err:.3e} > {bound:.3e}")
    del mg, march, u_at
    torch.cuda.empty_cache()
    out = {"IMEX": counts_at}
    for cfg_m in (GS_IMPL, GS_EXPL):
        method = cfg_m["method"]
        h, out[method], mg = slice_run(
            P, card, f"gray_scott {method} {cfg_m['nx']}^2", "GrayScott2D", cfg_m,
            SLICE_KERNELS["gray_scott"][method], order=("plain", "kernel"), nx=cfg_m["nx"],
            method=method)
        if method == "IMPL":
            print(f"[gray_scott] IMPL Newton-BiCGStab per level (first kernel solve): "
                  f"{json.dumps(newton_stats(mg))}")
        check(method != "EXPL" or out[method]["periodic_solve2d"] == 0,
              f"gray_scott: K10 ran on the EXPL path: {out[method]}")
        check(mg.conv[mg.solve_iter] < cfg_m["tol"], f"gray_scott {method}: history {h}")
        del mg
        torch.cuda.empty_cache()
    return out


def phase_burgers(card):
    """examples/example_burgers.py against its JAX golden, a deeper
    Burgers1D grid (K16 on 256 lanes a launch), Burgers2D at nx = 64."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, launch_counts, reset_launch_counts
    cfg = BURGERS_EX
    reset_launch_counts()
    mg = P.Mgrit(problem=level_problems(P, "Burgers1D", cfg, DISPATCH, nx=cfg["nx"], nu=cfg["nu"]),
                 tol=cfg["tol"], logging_lvl=30)
    h = mg.solve()["conv"]
    counts = launch_counts()
    floor = residual_floor(mg)
    ok, err = histories_agree(h, BURGERS_GOLDEN, floor, GOLDEN_RTOL)
    print(f"[burgers] example Burgers1D nx={cfg['nx']} nu={cfg['nu']} nt={cfg['nt']} m=4 f64: "
          f"history {[float(x) for x in h]}; vs the JAX golden max diff {err:.3e} "
          f"(rtol {GOLDEN_RTOL:.0e}, atol "
          f"floor {floor:.2e}); Newton per level {json.dumps(newton_stats(mg))}; K16 launches "
          f"{counts['burgers1d_newton']} | {'ok' if ok else 'FAIL'}")
    check(counts["burgers1d_newton"] > 0, f"burgers: K16 never ran: {counts}")
    check(ok, f"burgers: example history {h} differs from the golden {BURGERS_GOLDEN}")
    del mg
    cfg = BURGERS_DEEP
    _, counts_1d, mg = slice_run(P, card, f"burgers Burgers1D nx={cfg['nx']}", "Burgers1D", cfg,
                                 SLICE_KERNELS["Burgers1D"], nx=cfg["nx"], nu=cfg["nu"])
    print(f"[burgers] Burgers1D deep Newton per level (first kernel solve): "
          f"{json.dumps(newton_stats(mg))}")
    del mg
    cfg = BURGERS_2D
    h2, counts_2d, mg = slice_run(P, card, f"burgers Burgers2D nx={cfg['nx']}", "Burgers2D", cfg,
                                  SLICE_KERNELS["Burgers2D"], order=("plain", "kernel"),
                                  nx=cfg["nx"], nu=cfg["nu"])
    print(f"[burgers] Burgers2D Newton-BiCGStab per level (first kernel solve): "
          f"{json.dumps(newton_stats(mg))}")
    check(mg.conv[mg.solve_iter] < cfg["tol"], f"burgers 2D: history {h2}")
    del mg
    torch.cuda.empty_cache()
    return counts_1d, counts_2d


def phase_advection(card):
    """examples/example_advection.py against its JAX golden, and a deeper
    grid whose level 0 runs K17 on 4096 lanes a launch."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, launch_counts, reset_launch_counts
    cfg = ADVECTION_EX
    reset_launch_counts()
    problem = [P.Advection1D(c=1, x_start=-1, x_end=1, nx=cfg["nx"], t_start=0, t_stop=2, nt=nt,
                             device=DEVICE, ops=DISPATCH)
               for nt in (cfg["nt"], (cfg["nt"] + 1) // 2)]
    mg = P.Mgrit(problem=problem, cf_iter=1, nested_iteration=False, logging_lvl=30)
    h = mg.solve()["conv"]
    counts = launch_counts()
    floor = residual_floor(mg)
    ok, err = histories_agree(h, ADVECTION_GOLDEN, floor, GOLDEN_RTOL)
    print(f"[advection] example nx={cfg['nx']} nt={cfg['nt']}/65 FCF f64: history "
          f"{[float(x) for x in h]}; vs the "
          f"JAX golden max diff {err:.3e} (rtol {GOLDEN_RTOL:.0e}, atol floor {floor:.2e}); K17 "
          f"launches {counts['circulant_solve1d']} | {'ok' if ok else 'FAIL'}")
    check(counts["circulant_solve1d"] > 0, f"advection: K17 never ran: {counts}")
    check(ok, f"advection: example history {h} differs from the golden {ADVECTION_GOLDEN}")
    del mg
    cfg = dict(ADVECTION_DEEP, t_stop=2.0)
    _, counts_deep, mg = slice_run(P, card, f"advection nx={cfg['nx']}", "Advection1D", cfg,
                                   SLICE_KERNELS["Advection1D"], c=1, x_start=-1, x_end=1,
                                   nx=cfg["nx"])
    del mg
    torch.cuda.empty_cache()
    return counts_deep


def spatial_problem(P, ops, device=None):
    """bench.py's spatial65 hierarchy (build_problem with spatial sizes)."""
    t = np.linspace(0, 1, SPATIAL["nt"])
    problem, stride = [], 1
    for lvl, n in enumerate(SPATIAL["sizes"]):
        problem.append(P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=n, ny=n, a=1.0, rhs=rhs,
                                init_cond=init_cond, t_interval=t[::stride],
                                device=device or DEVICE, ops=ops))
        if lvl < len(SPATIAL["ms"]):
            stride *= SPATIAL["ms"][lvl]
    return problem


def spatial_hooks_ab(P, pairs=SPATIAL_AB_PAIRS):
    """spatial65 on the kernel path with the heat transfers' fused hooks
    (K18 / K19 fuse the FAS right-hand side and the correction) and without
    them (a subclass that overrides restriction and interpolation with the
    same batched K18 / K19 calls, so the solver takes its unfused route: the
    transfer, then K4), after one untimed solve of each, in alternating
    pairs (fused, unfused, then unfused, fused, ...; setup excluded from
    the walls).  Returns (walls {kind: [s]}, per-pair unfused - fused
    [s], first histories, launches of each kind's first timed run)."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, launch_counts, reset_launch_counts

    class Unfused(P.GridTransferHeat2D):
        def restriction(self, u, ops=DISPATCH):
            return super().restriction(u, ops)

        def interpolation(self, u, ops=DISPATCH):
            return super().interpolation(u, ops)

    kinds = {"fused": P.GridTransferHeat2D, "unfused": Unfused}

    def solve(kind):
        transfer = [kinds[kind](n, n) for n in SPATIAL["sizes"][:-1]]
        mg = P.Mgrit(problem=spatial_problem(P, DISPATCH), transfer=transfer, tol=SPATIAL["tol"],
                     max_iter=SPATIAL["max_iter"], logging_lvl=30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = mg.solve_compiled()["conv"]
        torch.cuda.synchronize()
        return mg, h, time.perf_counter() - t0

    for kind in kinds:
        solve(kind)
    walls, hists, counts, diffs = {k: [] for k in kinds}, {}, {}, []
    for i in range(pairs):
        pair = ("fused", "unfused") if i % 2 == 0 else ("unfused", "fused")
        got = {}
        for kind in pair:
            first = kind not in hists
            if first:
                reset_launch_counts()
            mg, h, wall = solve(kind)
            if first:
                counts[kind], hists[kind] = launch_counts(), h
            walls[kind].append(wall)
            got[kind] = wall
            del mg
            torch.cuda.empty_cache()
        diffs.append(got["unfused"] - got["fused"])
    return walls, diffs, hists, counts


def phase_spatial(card):
    """bench.py's spatial65 row on the card: K18 and K19 carry the
    transfers; kernels against plain in alternating pairs, against the JAX
    package's history; launches, walls, fine steps/s, peak memory."""
    import torch
    import pymgrit_tpu_torch as P
    transfer = [P.GridTransferHeat2D(n, n) for n in SPATIAL["sizes"][:-1]]
    walls, hists, counts, peak, mg = strategy_runs(
        P, lambda ops: spatial_problem(P, ops), "scan", 0, warm=True, order=E2E_ORDER,
        tol=SPATIAL["tol"], max_iter=SPATIAL["max_iter"], transfer=transfer)
    hk, hp = hists["kernel"], hists["plain"]
    floor = physical_floor(mg)
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    ok_j, err_j = histories_agree(hk, SPATIAL_JAX, floor, GOLDEN_RTOL)
    steps = sum(count_fine_steps_per_iter(mg, it == 0) for it in range(hk.size))
    tk, tp = float(np.median(walls["kernel"])), float(np.median(walls["plain"]))
    tube = mg.u[0]
    nt, n0 = SPATIAL["nt"], SPATIAL["sizes"][0]
    print(f"[spatial] spatial65 {'/'.join(f'{n}^2' for n in SPATIAL['sizes'])} nt={nt} "
          f"ms={SPATIAL['ms']} f64 BE physical condensed FCF: {hk.size} iterations, history "
          f"{[float(f'{h:.6e}') for h in hk]} | kernel vs plain (GPU) max diff {err_p:.3e} (rtol "
          f"{MAIN_RTOL:.0e}); vs the JAX history max diff {err_j:.3e} (rtol {GOLDEN_RTOL:.0e}); "
          f"atol floor {floor:.2e} | K18 {counts['restrict_combine']} and K19 "
          f"{counts['interpolate_combine']} launches; {json.dumps({c: counts[c] for c in counts if counts[c]})} "
          f"| solve wall {fmt_walls(walls)} | {steps} fine steps: {steps / tk:.1f} steps/s kernel, "
          f"{steps / tp:.1f} steps/s plain | peak device memory {peak:.3f} GiB | "
          f"{'ok' if ok_p and ok_j else 'FAIL'} | {card}")
    check(mg._condensed0, "spatial: the condensed carry was declined")
    # the hooks take K4's place in the FAS residual and the correction
    check(all(counts[k] > 0 for k in TRANSFER_KERNELS + SPATIAL_KERNELS)
          and counts["cpoint_combine"] == 0,
          f"spatial: launches {counts} (expected {TRANSFER_KERNELS + SPATIAL_KERNELS}, no K4)")
    check(tuple(tube.shape) == (nt, n0, n0) and bool(torch.isfinite(tube).all()),
          f"spatial: tube {tuple(tube.shape)} not a finite ({nt}, {n0}, {n0}) tube")
    check(hk.size == SPATIAL["max_iter"] and bool(np.all(np.diff(hk) < 0)),
          f"spatial: history {hk}")
    check(ok_p, f"spatial: kernel history {hk} differs from the plain history {hp}")
    check(ok_j, f"spatial: history {hk} differs from the JAX history {SPATIAL_JAX}")
    del mg, tube
    torch.cuda.empty_cache()
    ab_walls, diffs, ab_hists, ab_counts = spatial_hooks_ab(P)
    ok_ab, err_ab = histories_agree(ab_hists["unfused"], ab_hists["fused"], floor, MAIN_RTOL)
    wins = sum(d > 0 for d in diffs)
    print(f"[spatial] hooks A/B (kernel path, {len(diffs)} alternating pairs): fused "
          f"{np.median(ab_walls['fused']):.4f} s (runs {[round(w, 4) for w in ab_walls['fused']]}), "
          f"unfused {np.median(ab_walls['unfused']):.4f} s (runs "
          f"{[round(w, 4) for w in ab_walls['unfused']]}); unfused - fused per pair "
          f"{[round(d * 1e3, 2) for d in diffs]} ms (median {np.median(diffs) * 1e3:.2f} ms; fused "
          f"faster in {wins} of {len(diffs)}) | launches K4/K18/K19 fused "
          f"{[ab_counts['fused'][k] for k in ('cpoint_combine',) + TRANSFER_KERNELS]}, unfused "
          f"{[ab_counts['unfused'][k] for k in ('cpoint_combine',) + TRANSFER_KERNELS]} | "
          f"histories max diff {err_ab:.3e} | {'ok' if ok_ab else 'FAIL'} | {card}")
    check(ab_counts["fused"]["cpoint_combine"] == 0 and ab_counts["unfused"]["cpoint_combine"] > 0
          and all(ab_counts["unfused"][k] > 0 for k in TRANSFER_KERNELS),
          f"spatial A/B: launches {ab_counts}")
    check(ok_ab, f"spatial A/B: unfused history {ab_hists['unfused']} differs from "
                 f"{ab_hists['fused']}")
    return counts


def heat1d_spatial_problem(P, ops, device=None):
    """examples/example_spatial_coarsening.py's hierarchy."""
    kw = dict(x_start=0, x_end=2, a=1, rhs=heat1d_rhs, init_cond=lambda x: np.sin(np.pi * x),
              device=device or DEVICE, ops=ops)
    h0 = P.Heat1D(nx=2 ** 4 + 1, t_start=0, t_stop=2, nt=2 ** 7 + 1, **kw)
    h1 = P.Heat1D(nx=2 ** 3 + 1, t_interval=h0.t[::2], **kw)
    h2 = P.Heat1D(nx=2 ** 2 + 1, t_interval=h1.t[::2], **kw)
    h3 = P.Heat1D(nx=2 ** 2 + 1, t_interval=h2.t[::2], **kw)
    return [h0, h1, h2, h3]


def phase_spatial1d(card):
    """examples/example_spatial_coarsening.py on the card (K18, K19 in 1D,
    K20 for Heat1D's physical steps):
    against the golden of test_solver_goldens_2.py, the JAX history and the
    plain path."""
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    runs = {}
    for path, ops in (("kernel", DISPATCH), ("plain", PLAIN)):
        transfer = [P.GridTransferHeat(), P.GridTransferHeat(), P.GridTransferCopy()]
        reset_launch_counts()
        mg = P.Mgrit(problem=heat1d_spatial_problem(P, ops), transfer=transfer, logging_lvl=30)
        runs[path] = (mg, mg.solve()["conv"], launch_counts())
    (mk, hk, counts), (_, hp, _) = runs["kernel"], runs["plain"]
    floor = residual_floor(mk)
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    ok_j, err_j = histories_agree(hk, SPATIAL1D_JAX, floor, GOLDEN_RTOL)
    ok_g = hk.shape == SPATIAL1D_GOLDEN.shape and bool(
        np.allclose(hk, SPATIAL1D_GOLDEN, rtol=SPATIAL1D_GOLDEN_RTOL))
    print(f"[spatial1d] example Heat1D 17/9/5/5 nt=129 GridTransferHeat f64: history "
          f"{[float(x) for x in hk]}; vs the golden (rtol {SPATIAL1D_GOLDEN_RTOL:.0e}) "
          f"{'agrees' if ok_g else 'differs'}; vs the JAX history max diff {err_j:.3e} (rtol "
          f"{GOLDEN_RTOL:.0e}); vs plain (GPU) {err_p:.3e}; atol floor {floor:.2e} | K18 "
          f"{counts['restrict_combine']}, K19 {counts['interpolate_combine']}, K20 "
          f"{counts['sine_solve1d']} launches; {json.dumps({c: counts[c] for c in counts if counts[c]})} | "
          f"{'ok' if ok_g and ok_j and ok_p else 'FAIL'} | {card}")
    check(all(counts[k] > 0 for k in SPATIAL1D_KERNELS),
          f"spatial1d: launches {counts} (expected {SPATIAL1D_KERNELS})")
    check(ok_g, f"spatial1d: history {hk} differs from the golden {SPATIAL1D_GOLDEN}")
    check(ok_j and ok_p, f"spatial1d: history {hk} differs from JAX's or the plain path's")
    return counts


def phase_c2(card):
    """bench.py's toms257 physical row (nt = 4097) for two iterations: K5
    and K6 past their one-tile side, kernels against plain."""
    import torch
    import pymgrit_tpu_torch as P
    cfg = dict(nx=TOMS257["nx"], nt=TOMS257["nt"], ms=TOMS257["ms"], basis="physical")
    walls, hists, counts, peak, mg = strategy_runs(
        P, lambda ops: build_problem(P, device=DEVICE, ops=ops, **cfg), "scan", 0,
        order=E2E_ORDER, tol=TOMS257["tol"], max_iter=TOMS257["max_iter"])
    hk, hp = hists["kernel"], hists["plain"]
    floor = physical_floor(mg)
    ok, err = histories_agree(hk, hp, floor, MAIN_RTOL)
    tube = mg.u[0]
    nt, nx = TOMS257["nt"], TOMS257["nx"]
    print(f"[c2] toms257 {nx}x{nx} nt={nt} ms={TOMS257['ms']} f64 BE physical condensed, "
          f"{hk.size} iterations: history {[float(f'{h:.6e}') for h in hk]} | kernel vs plain (GPU) "
          f"max diff {err:.3e} (rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}) | launches "
          f"{json.dumps({c: counts[c] for c in counts if counts[c]})} | solve wall "
          f"{fmt_walls(walls)} | peak device memory {peak:.3f} GiB | {'ok' if ok else 'FAIL'} | {card}")
    check(mg._condensed0, "c2: the condensed carry was declined")
    check(all(counts[k] > 0 for k in PHYSICAL_KERNELS), f"c2: a kernel never ran: {counts}")
    check(tuple(tube.shape) == (nt, nx, nx) and bool(torch.isfinite(tube).all()),
          f"c2: tube {tuple(tube.shape)} not a finite ({nt}, {nx}, {nx}) tube")
    check(hk.size == TOMS257["max_iter"] and ok, f"c2: kernel history {hk} differs from {hp}")
    del mg, tube
    torch.cuda.empty_cache()


def ragged_problem(P, ops):
    """bench.py's ragged_nonuniform hierarchy in the port."""
    return [P.Heat2D(x_start=0, x_end=1, y_start=0, y_end=1, nx=RAGGED["nx"], ny=RAGGED["nx"],
                     a=1.0, rhs=rhs, init_cond=lambda x, y: 0 * x * y, t_interval=g.copy(),
                     device=DEVICE, ops=ops) for g in ragged_grids()]


def varying_problem(P, ops):
    d0 = P.Dahlquist(t_start=0, t_stop=5, nt=65, device=DEVICE, ops=ops)
    levels = [d0, P.Dahlquist(t_interval=d0.t[VARYING_IDX], device=DEVICE, ops=ops)]
    for _ in range(3):
        levels.append(P.Dahlquist(t_interval=levels[-1].t[::2], device=DEVICE, ops=ops))
    return levels


def phase_ragged(card):
    """Non-uniform coarsening on the card: bench.py's ragged_nonuniform row
    (K21 for every gather, drop-scatter and indexed sum; K5 / K7 for the
    ragged chains' steps), kernels against plain in alternating pairs after
    a warm solve and against the JAX history; then the varying_coarsening
    golden (Dahlquist, a run of adjacent C-points, weight_c 1 and 0.5)."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    kw = dict(tol=RAGGED["tol"], max_iter=RAGGED["max_iter"])
    walls, hists, counts, peak, mg = strategy_runs(P, lambda ops: ragged_problem(P, ops), "scan",
                                                   0, warm=True, order=E2E_ORDER, **kw)
    hk, hp = hists["kernel"], hists["plain"]
    floor = physical_floor(mg)
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    ok_j, err_j = histories_agree(hk, RAGGED_JAX, floor, GOLDEN_RTOL)
    info = mg.levels
    tube = mg.u[0]
    nt, nx = RAGGED["nt"], RAGGED["nx"]
    steps = sum(count_fine_steps_per_iter(mg, it == 0) for it in range(hk.size))
    tk = float(np.median(walls["kernel"]))
    print(f"[ragged] ragged_nonuniform Heat2D physical {nx}^2 levels "
          f"{'/'.join(str(li.nt) for li in info)} (uniform {[li.uniform for li in info]}; level 0 "
          f"J={info[0].chains.seed.size} chains, Lmax={info[0].chains.lmax}) f64 FCF, "
          f"{mg._cnd_decline_reason}: {hk.size} iterations, history "
          f"{[float(f'{h:.6e}') for h in hk]} | kernel vs plain (GPU) max diff {err_p:.3e} (rtol "
          f"{MAIN_RTOL:.0e}); vs the JAX history max diff {err_j:.3e} (rtol {GOLDEN_RTOL:.0e}); atol "
          f"floor {floor:.2e} | launches K21 {counts['indexed_combine']}, K5 "
          f"{counts['sine_solve2d']}, K7 {counts['theta_rhs2d']}; "
          f"{json.dumps({c: counts[c] for c in counts if counts[c]})} | solve wall {fmt_walls(walls)} "
          f"| {steps} fine steps: {steps / tk:.1f} steps/s kernel | peak device memory "
          f"{peak:.3f} GiB | {'ok' if ok_p and ok_j else 'FAIL'} | {card}")
    check(not info[0].uniform and not info[1].uniform and info[2].uniform,
          f"ragged: levels uniform {[li.uniform for li in info]}")
    check(all(counts[k] > 0 for k in RAGGED_KERNELS),
          f"ragged: launches {counts} (expected {RAGGED_KERNELS})")
    check(tuple(tube.shape) == (nt, nx, nx) and bool(torch.isfinite(tube).all()),
          f"ragged: tube {tuple(tube.shape)} not a finite ({nt}, {nx}, {nx}) tube")
    check(ok_p, f"ragged: kernel history {hk} differs from the plain history {hp}")
    check(ok_j, f"ragged: history {hk} differs from the JAX history {RAGGED_JAX}")
    del mg, tube
    torch.cuda.empty_cache()

    for weight_c in (1.0, 0.5):
        runs = {}
        for path, ops in (("kernel", DISPATCH), ("plain", PLAIN)):
            m = P.Mgrit(problem=varying_problem(P, ops), tol=1e-10, nested_iteration=False,
                        weight_c=weight_c, logging_lvl=30)
            m.solve()
            runs[path] = (m, m.conv[1:m.solve_iter + 1])
        (mk, hk), (_, hp) = runs["kernel"], runs["plain"]
        floor = residual_floor(mk)
        ok_p, err_p = histories_agree(hk, hp, floor, 1e-12)
        ok_g = weight_c != 1.0 or (hk.shape == VARYING_GOLDEN.shape
                                   and bool(np.allclose(hk, VARYING_GOLDEN, rtol=2e-3)))
        print(f"[ragged] varying_coarsening Dahlquist 65/16/8/4/2 weight_c {weight_c} (level-0 "
              f"runs of adjacent C-points: Rmax {mk.levels[0].c_chains.rmax}): history "
              f"{[float(f'{h:.6e}') for h in hk]}; vs plain (GPU) max diff {err_p:.3e} (rtol 1e-12, "
              f"atol floor {floor:.2e})" + ("; vs the reference golden (rtol 2e-3) "
                                           + ("agrees" if ok_g else "differs")
                                           if weight_c == 1.0 else "")
              + f" | {'ok' if ok_p and ok_g else 'FAIL'}")
        check(ok_p and ok_g, f"ragged: varying_coarsening weight_c {weight_c}: {hk} vs {hp}")
    return counts


def pytree_app(P, xp, kind, device=None, ops=None, **grid):
    """The [pytree] phase's backward-Euler application, in the package P
    with the array module xp (the port and torch here; the JAX package and
    jax.numpy in tests/test_torch_chip_histories.py, which recomputes
    PYTREE_JAX): a (3,) leaf ``a`` decaying at rates 1..3 and forced by t;
    kind "vector": a alone, with ``state_norm = max |a|``; "tuple" and
    "dict": a beside a (2,) leaf ``b`` forced by the sum of a, as ``(a, b)``
    or ``{"vel": b, "pos": a}`` (inserted out of key order)."""
    dev = {} if device is None else {"device": device}

    def arr(v):
        return xp.asarray(np.asarray(v, dtype=np.float64), **dev)

    lam, mu, c = arr([1.0, 2.0, 3.0]), arr([0.5, 4.0]), arr([0.2, -0.1, 0.4])

    def pack(a, b):
        return a if kind == "vector" else (a, b) if kind == "tuple" else {"vel": b, "pos": a}

    class App(P.Application):
        def __init__(self, **kw):
            super().__init__(**kw)
            a0, b0 = arr([1.0, 0.5, -0.25]), arr([0.3, -1.0])
            self.vector_t_start = pack(a0, b0)
            self.vector_template = pack(0 * a0, 0 * b0)
            if kind == "vector":
                self.state_norm = lambda u: xp.max(xp.abs(u))
            if ops is not None:
                self.ops = ops

        def step(self, u, t_start, t_stop):
            dt = t_stop - t_start
            a = u if kind == "vector" else u[0] if kind == "tuple" else u["pos"]
            a1 = (a + dt * t_stop * c) / (1 + dt * lam)
            if kind == "vector":
                return a1
            b = u[1] if kind == "tuple" else u["vel"]
            return pack(a1, (b + dt * (0.5 * xp.sum(a1))) / (1 + dt * mu))

    return App(**grid)


def pytree_grids(case):
    """The time grids of a [pytree] case: nt = 33 with m = 4 on two levels,
    or a three-level hierarchy whose level-0 C-points are not evenly
    strided."""
    t = np.linspace(0, 1, PYTREE["nt"])
    if case != "ragged":
        return [t, t[::PYTREE["m"]]]
    t = np.linspace(0, 1, 65)
    idx1 = np.array([0, 3, 7, 8, 13, 17, 22, 24, 29, 33, 36, 41, 44, 45, 50, 55, 58, 64])
    return [t, t[idx1], t[idx1][::2]]


def pytree_run(P, xp, case, device=None, ops=None):
    """(solver, history) of a [pytree] case: (kind, grids, solve entry,
    conv_crit) from PYTREE_CASES."""
    kind, grids, entry, crit = PYTREE_CASES[case]
    problem = [pytree_app(P, xp, kind, device, ops, t_interval=g) for g in pytree_grids(grids)]
    mg = P.Mgrit(problem=problem, tol=PYTREE["tol"], max_iter=PYTREE["max_iter"],
                 conv_crit=crit, logging_lvl=30)
    getattr(mg, entry)()
    return mg, mg.conv[1:mg.solve_iter + 1]


def phase_pytree(card):
    """C4 and C5 on the card: multi-leaf (dict, tuple) states and the
    application's state_norm hook, kernels (K4, K3 or the hook, K21 on the
    ragged level) against the plain path and against the JAX package's
    histories (PYTREE_JAX)."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.core import vector
    from pymgrit_tpu_torch.ops import PLAIN, launch_counts, reset_launch_counts
    out = {}
    for case in PYTREE_CASES:
        torch.cuda.synchronize()
        reset_launch_counts()
        mk, hk = pytree_run(P, torch, case, DEVICE)
        torch.cuda.synchronize()
        counts = launch_counts()
        mp, hp = pytree_run(P, torch, case, DEVICE, PLAIN)
        leaves = vector.leaves(mk.u[0])
        rows = torch.cat([x.reshape(x.shape[0], -1) for x in leaves], dim=1)
        u_c = rows[torch.as_tensor(mk.levels[0].cpts, device=rows.device)]
        floor = ((8 + 4 * math.sqrt(rows.shape[1])) * float(torch.finfo(torch.float64).eps)
                 * float(torch.linalg.vector_norm(u_c)))
        ok_j, err_j = histories_agree(hk, PYTREE_JAX[case], floor, PYTREE_RTOL)
        ok_p, err_p = histories_agree(hk, hp, floor, PYTREE_RTOL)
        du = max(float((x - y).abs().max()) for x, y in zip(leaves, vector.leaves(mp.u[0])))
        kind, grids, entry, crit = PYTREE_CASES[case]
        hook = mk.state_norm is not None
        ok_k = (counts["residual_row_norms"] == 0) == hook
        print(f"[pytree] {case}: {kind} state, levels {'/'.join(str(li.nt) for li in mk.levels)}, "
              f"{entry}, conv_crit {crit}{', state_norm max |x|' if hook else ''}: history "
              f"{[float(f'{h:.6e}') for h in hk]} | vs JAX max diff {err_j:.3e}, vs plain (GPU) "
              f"{err_p:.3e}, tube {du:.3e} (rtol {PYTREE_RTOL:.0e}, atol floor {floor:.2e}) | "
              f"tube leaves {[tuple(x.shape) for x in leaves]} | launches "
              f"{json.dumps({c: counts[c] for c in counts if counts[c]})} | "
              f"{'ok' if ok_j and ok_p and ok_k else 'FAIL'} | {card}")
        check(ok_j and ok_p, f"pytree {case}: history {hk} differs from JAX's {PYTREE_JAX[case]} "
                             f"or the plain path's {hp}")
        check(ok_k, f"pytree {case}: K3 launches {counts['residual_row_norms']} with the hook "
                    f"{'set' if hook else 'absent'}")
        check(counts["cpoint_combine"] > 0, f"pytree {case}: K4 never ran")
        out[case] = counts
    return out


def bdf_problem(P, ops):
    """examples/example_heat_1d_bdf2.py's hierarchy (numpy rhs)."""
    nt, t_stop = BDF["nt"], BDF["t_stop"]
    ti = np.linspace(0, t_stop, nt // 2 + 1)
    kw = dict(x_start=0, x_end=1, nx=BDF["nx"], a=1, dtau=t_stop / nt, rhs=heat1d_rhs,
              init_cond=lambda x: np.sin(np.pi * x), device=DEVICE, ops=ops)
    return [P.Heat1DBDF2(t_interval=ti, **kw), P.Heat1DBDF1(t_interval=ti[::2], **kw),
            P.Heat1DBDF1(t_interval=ti[::4], **kw)]


def phase_bdf(card):
    """The BDF pair-state example at its full width: K20 in its BE mode
    (BDF1 levels) and its BDF2 mode (level 0), against the JAX history and
    the plain path."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import (DISPATCH, PLAIN, heat_kernels, launch_counts,
                                       reset_launch_counts)
    runs = {}
    for path, ops in (("kernel", DISPATCH), ("plain", PLAIN)):
        torch.cuda.synchronize()
        reset_launch_counts()
        mg = P.Mgrit(problem=bdf_problem(P, ops), tol=BDF["tol"], max_iter=BDF["max_iter"],
                     logging_lvl=30)
        t0 = time.perf_counter()
        mg.solve()
        torch.cuda.synchronize()
        runs[path] = (mg, mg.conv[1:mg.solve_iter + 1], time.perf_counter() - t0,
                      launch_counts(), dict(heat_kernels.sine_solve1d.mode_launches))
    (mk, hk, wk, counts, modes), (mp, hp, wp, _, _) = runs["kernel"], runs["plain"]
    floor = residual_floor(mk, 4 * math.sqrt(BDF["nx"] - 2) + FLOOR_OPS)
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    ok_j, err_j = histories_agree(hk, BDF_JAX, floor, GOLDEN_RTOL)
    tube = mk.u[0]
    du = float((tube - mp.u[0]).abs().max())
    print(f"[bdf] example_heat_1d_bdf2 nx={BDF['nx']} pair grids "
          f"{'/'.join(str(li.nt) for li in mk.levels)} BDF2/BDF1/BDF1 f64: {hk.size} iterations, "
          f"history {[float(f'{h:.6e}') for h in hk]} | vs the JAX history max diff {err_j:.3e} "
          f"(rtol {GOLDEN_RTOL:.0e}); vs plain (GPU) {err_p:.3e}, tube {du:.3e}; atol floor "
          f"{floor:.2e} | K20 launches {counts['sine_solve1d']} (by mode {json.dumps(modes)}) | "
          f"solve wall kernel {wk:.4f} s, plain {wp:.4f} s | {'ok' if ok_p and ok_j else 'FAIL'} | "
          f"{card}")
    check(modes["bdf2"] > 0 and modes["be"] > 0, f"bdf: K20 launches by mode {modes}")
    check(tuple(tube.shape) == (BDF["nt"] // 2 + 1, 2, BDF["nx"] - 2)
          and bool(torch.isfinite(tube).all()), f"bdf: tube {tuple(tube.shape)}")
    check(ok_p and ok_j, f"bdf: history {hk} differs from the plain {hp} or JAX {BDF_JAX}")
    return counts, modes


def phase_diffusion(card):
    """examples/example_diffusion_2d.py at n = 20 through K22 against its
    JAX history, then a deeper two-level grid (nt = 1025, m = 8), kernels
    against plain on the same problem instances (no second eigh per
    problem); mass conservation; setup (assembly and eigh) apart from the
    solve walls."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts

    def build(nts):
        t0 = time.perf_counter()
        problem = [P.Diffusion2D(n=DIFFUSION["n"], length=10.0, kappa=0.1, t_start=0, t_stop=10,
                                 nt=nt, device=DEVICE) for nt in nts]
        return problem, time.perf_counter() - t0

    def solve(problem, ops, first=False, **kw):
        """(solver, history, solve wall, K22 calls of the constructor, of
        the solve)."""
        for p in problem:
            p.ops = ops
        torch.cuda.synchronize()
        if first:
            reset_launch_counts()
        c0 = launch_counts()["eig_step"]
        mg = P.Mgrit(problem=problem, logging_lvl=30, **kw)
        c1 = launch_counts()["eig_step"]
        t0 = time.perf_counter()
        mg.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return mg, mg.conv[1:mg.solve_iter + 1], wall, c1 - c0, launch_counts()["eig_step"] - c1

    problem, setup = build(DIFFUSION["nts"])
    kw = dict(tol=DIFFUSION["tol"], max_iter=DIFFUSION["max_iter"])
    mk, hk, wk, *calls = solve(problem, DISPATCH, first=True, **kw)
    counts = launch_counts()
    mp, hp, wp, *_ = solve(problem, PLAIN, **kw)
    floor = residual_floor(mk, 4 * math.sqrt(6 * DIFFUSION["n"] ** 2) + FLOOR_OPS)
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    ok_j, err_j = histories_agree(hk, DIFFUSION_JAX, floor, GOLDEN_RTOL)
    print(f"[diffusion] example Diffusion2D n={DIFFUSION['n']} (N={6 * DIFFUSION['n'] ** 2}) "
          f"nt {DIFFUSION['nts']} f64: setup (assembly + eigh, {len(problem)} models) {setup:.2f} s | "
          f"history {[float(f'{h:.6e}') for h in hk]}; vs the JAX history max diff {err_j:.3e} (rtol "
          f"{GOLDEN_RTOL:.0e}); vs plain (GPU) {err_p:.3e}; atol floor {floor:.2e} | K22 launches "
          f"{counts['eig_step']} (constructor {calls[0]}, solve {calls[1]}) | solve wall kernel "
          f"{wk:.4f} s, plain {wp:.4f} s | "
          f"{'ok' if ok_p and ok_j else 'FAIL'} | {card}")
    check(counts["eig_step"] > 0, f"diffusion: K22 never ran: {counts}")
    check(ok_p and ok_j, f"diffusion: history {hk} differs from plain {hp} or JAX {DIFFUSION_JAX}")
    del mk, mp, problem
    torch.cuda.empty_cache()

    cfg = DIFFUSION_DEEP
    problem, setup = build((cfg["nt"], (cfg["nt"] - 1) // cfg["m"] + 1))
    kw = dict(tol=cfg["tol"], max_iter=cfg["max_iter"])
    walls = {"kernel": [], "plain": []}
    hists, counts_deep = {}, None
    for path in WALL_ORDER:
        mg, h, wall, *c = solve(problem, DISPATCH if path == "kernel" else PLAIN,
                                first=path == "kernel" and counts_deep is None, **kw)
        if path == "kernel" and counts_deep is None:
            counts_deep, kept, calls = launch_counts(), mg, c
        walls[path].append(wall)
        hists.setdefault(path, h)
    hk, hp = hists["kernel"], hists["plain"]
    floor = residual_floor(kept, 4 * math.sqrt(6 * cfg["n"] ** 2) + FLOOR_OPS)
    ok_p, err_p = histories_agree(hk, hp, floor, MAIN_RTOL)
    tube = kept.u[0]
    d0 = problem[0]
    m0, m1 = float(d0.total_mass(tube[0])), float(d0.total_mass(tube[-1]))
    ok_m = abs(m1 - m0) <= MASS_RTOL * abs(m0)
    print(f"[diffusion] deep Diffusion2D n={cfg['n']} nt={cfg['nt']} m={cfg['m']} (level 0: "
          f"{(cfg['nt'] - 1) // cfg['m']} lanes x {cfg['m'] - 1} steps) f64: setup {setup:.2f} s | "
          f"history {[float(f'{h:.6e}') for h in hk]}; kernel vs plain (GPU) max diff {err_p:.3e} "
          f"(rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}) | total mass first {m0:.15e}, last "
          f"{m1:.15e} (rel diff {abs(m1 - m0) / abs(m0):.2e}, tol {MASS_RTOL:.0e}) | K22 launches "
          f"{counts_deep['eig_step']} (constructor {calls[0]}, solve {calls[1]}) | solve wall "
          f"{fmt_walls(walls)} | "
          f"{'ok' if ok_p and ok_m else 'FAIL'} | {card}")
    check(counts_deep["eig_step"] > 0, f"diffusion deep: K22 never ran: {counts_deep}")
    check(tuple(tube.shape) == (cfg["nt"], 6 * cfg["n"] ** 2) and bool(torch.isfinite(tube).all()),
          f"diffusion deep: tube {tuple(tube.shape)}")
    check(ok_p, f"diffusion deep: kernel history {hk} differs from plain {hp}")
    check(ok_m, f"diffusion deep: total mass {m0} -> {m1}")
    del kept, tube, problem
    torch.cuda.empty_cache()
    return counts_deep


def dd_runs(P, build, max_iter, tol, warm=True):
    """Fresh DD solves in turns kernel, plain after one
    untimed kernel solve: walls (setup excluded), the first history and
    level-0 tube of each path, the kernel run's launch counts and peak
    device memory (as strategy_runs)."""
    import torch
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    walls, hists, tubes, counts, peak, kept = {"plain": [], "kernel": []}, {}, {}, None, None, None
    if warm:
        P.Mgrit(problem=build(DISPATCH), tol=tol, max_iter=max_iter, logging_lvl=30).solve()
        torch.cuda.empty_cache()
    for path in WALL_ORDER:
        first = path == "kernel" and counts is None
        torch.cuda.synchronize()
        if first:
            torch.cuda.reset_peak_memory_stats()
            mem0 = torch.cuda.memory_allocated()
            reset_launch_counts()
        mg = P.Mgrit(problem=build(DISPATCH if path == "kernel" else PLAIN), tol=tol,
                     max_iter=max_iter, logging_lvl=30)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mg.solve()
        torch.cuda.synchronize()
        walls[path].append(time.perf_counter() - t0)
        h = mg.conv[1:mg.solve_iter + 1]
        check(bool(np.all(np.isfinite(h))), f"dd {path}: non-finite history {h}")
        if path not in hists:
            hists[path], tubes[path] = h, mg.u[0]
        if first:
            counts, kept = launch_counts(), mg
            peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
        del mg
        torch.cuda.empty_cache()
    return walls, hists, tubes, counts, peak, kept


def check_dd_counts(label, counts, needed):
    check(all(counts[k] > 0 for k in needed),
          f"{label}: a DD kernel of the path never ran: {counts}")
    check(all(counts[k] == 0 for k in DD_FORBIDDEN),
          f"{label}: a float64 kernel ran on the DD path: {counts}")


def phase_dd(card):
    """precision='dd' on the card.  bench.py's dd_toms129 row (spectral,
    condensed level 0: K23-K25 and K3) and dd65 row (physical: K25, K26
    and K3), each kernels against plain in alternating pairs after a warm
    solve and against the JAX package's history; then the Dahlquist README
    golden in DD and Diffusion2D in DD against the port's float64 history.
    Returns the launch counts of dd_toms129 and of dd65."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN, launch_counts, reset_launch_counts
    out = {}
    for label, cfg, basis, ref, needed in (
            ("dd_toms129", DD_TOMS, "spectral", DD_TOMS_JAX,
             ("dd_interval_affine", "dd_theta_chain", "dd_arith", "residual_row_norms")),
            ("dd65", DD65, "physical", DD65_JAX, ("dd_matmul", "dd_arith", "residual_row_norms"))):
        def build(ops, cfg=cfg, basis=basis):
            return build_problem(P, cfg["nx"], cfg["nt"], cfg["ms"], DEVICE, ops, basis=basis,
                                 precision="dd")
        walls, hists, tubes, counts, peak, mg = dd_runs(P, build, cfg["max_iter"], cfg["tol"])
        hk, hp = hists["kernel"], hists["plain"]
        nt, n = cfg["nt"], cfg["nx"] - 2 if basis == "spectral" else cfg["nx"]
        tube = tubes["kernel"]
        same_tube = bool(torch.equal(tube.view(torch.int32), tubes["plain"].view(torch.int32)))
        del tubes
        ok_p, err_p = histories_agree(hk, hp, 0.0, DD_RTOL)
        above = hk.size if label == "dd65" else DD_TOMS_FLOOR_FROM
        floor, floor_j = hk[above:], ref[above:]
        ok_j, err_j = histories_agree(hk[:above], ref[:above], DD_ATOL, DD_RTOL)
        ok_floor = hk.size == ref.size and (floor.size == 0 or bool(
            np.all(floor >= DD_FLOOR_MIN) and np.all(floor <= DD_FLOOR_FACTOR * floor_j.max())
            and np.all(floor >= floor_j.min() / DD_FLOOR_FACTOR)))
        it10 = int(np.argmax(hk <= 1e-10)) + 1 if np.any(hk <= 1e-10) else None
        it10_j = int(np.argmax(ref <= 1e-10)) + 1
        steps = sum(count_fine_steps_per_iter(mg, it == 0) for it in range(hk.size))
        tk, tp = float(np.median(walls["kernel"])), float(np.median(walls["plain"]))
        shape = (nt, 2, n, n)
        print(f"[dd] {label} {cfg['nx']}^2 nt={nt} ms={cfg['ms']} BE {basis} precision='dd'"
              f"{' condensed' if mg._condensed0 else ''}: {hk.size} iterations, 1e-10 at "
              f"iteration {it10} (JAX {it10_j}), history {[float(f'{h:.6e}') for h in hk]} | vs "
              f"JAX max diff {err_j:.3e} above the floor (rtol {DD_RTOL:.0e}); floor "
              f"{[float(f'{h:.4e}') for h in floor]} vs JAX's {[float(f'{h:.4e}') for h in floor_j]} "
              f"(within {DD_FLOOR_FACTOR:.0f}x, above {DD_FLOOR_MIN:.0e}) | kernel vs plain (GPU) "
              f"history max diff {err_p:.3e}, tube bit for bit: {same_tube} | launches "
              f"{json.dumps({k: v for k, v in counts.items() if v})} | solve wall "
              f"{fmt_walls(walls)} | {steps} fine steps: {steps / tk:.1f} steps/s kernel, "
              f"{steps / tp:.1f} steps/s plain | peak device memory {peak:.3f} GiB | "
              f"{'ok' if ok_p and ok_j and ok_floor else 'FAIL'} | {card}")
        check_dd_counts(label, counts, needed)
        check(tuple(tube.shape) == shape and tube.dtype == torch.float32
              and bool(torch.isfinite(tube).all()), f"{label}: tube {tuple(tube.shape)} "
              f"{tube.dtype} is not a finite float32 pair tube {shape}")
        check(ok_j and it10 == it10_j, f"{label}: history {hk} against JAX's {ref}")
        check(ok_floor, f"{label}: floor {floor} against JAX's {floor_j}")
        check(ok_p, f"{label}: kernel history {hk} differs from the plain {hp}")
        if label == "dd_toms129":
            check(mg._condensed0, "dd_toms129: the condensed carry was declined")
            check(same_tube, "dd_toms129: the kernel tube differs from the plain tube")
        out[label] = counts
        del mg, tube
        torch.cuda.empty_cache()

    # the Dahlquist README golden in DD
    torch.cuda.synchronize()
    reset_launch_counts()
    d = P.Dahlquist(t_start=0, t_stop=5, nt=101, precision="dd", device=DEVICE)
    mg = P.Mgrit(problem=P.simple_setup_problem(problem=d, level=2, coarsening=2), tol=1e-10,
                 logging_lvl=30)
    t0 = time.perf_counter()
    mg.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    h = mg.conv[1:mg.solve_iter + 1]
    counts = launch_counts()
    ok = h.size == DD_DAHLQUIST_GOLDEN.size and bool(
        np.all(np.abs(h - DD_DAHLQUIST_GOLDEN) <= 2e-3 * DD_DAHLQUIST_GOLDEN)) and h[-1] < 1e-11
    print(f"[dd] Dahlquist nt=101 two levels precision='dd': history "
          f"{[float(f'{x:.6e}') for x in h]} vs the README golden (rtol 2e-3, tail below 1e-11) | "
          f"K25 launches {counts['dd_arith']} | solve wall {wall:.4f} s | "
          f"{'ok' if ok else 'FAIL'} | {card}")
    check_dd_counts("dd Dahlquist", counts, ("dd_arith",))
    check(ok, f"dd Dahlquist: history {h} against the golden {DD_DAHLQUIST_GOLDEN}")

    # Diffusion2D in DD (K26 + K25) against the port's float64 history
    cfg = DD_DIFFUSION
    hists = {}
    for prec in (None, "dd"):
        problem = [P.Diffusion2D(n=cfg["n"], length=10.0, kappa=0.1, t_start=0, t_stop=10,
                                 nt=nt, precision=prec, device=DEVICE) for nt in cfg["nts"]]
        torch.cuda.synchronize()
        reset_launch_counts()
        mg = P.Mgrit(problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)
        mg.solve()
        torch.cuda.synchronize()
        hists[prec], counts = mg.conv[1:mg.solve_iter + 1], launch_counts()
    h, h64 = hists["dd"], hists[None]
    ok = h.size == h64.size and bool(np.all(np.abs(h[:-1] - h64[:-1]) <= 1e-4 * h64[:-1])) \
        and h[-1] < cfg["tol"]
    print(f"[dd] Diffusion2D n={cfg['n']} nt {cfg['nts']} precision='dd': history "
          f"{[float(f'{x:.6e}') for x in h]} vs float64 {[float(f'{x:.6e}') for x in h64]} (rtol "
          f"1e-4, the last below {cfg['tol']:.0e}) | K26 {counts['dd_matmul']}, K25 "
          f"{counts['dd_arith']} launches | {'ok' if ok else 'FAIL'} | {card}")
    check_dd_counts("dd Diffusion2D", counts, ("dd_matmul", "dd_arith"))
    check(ok, f"dd Diffusion2D: history {h} against float64 {h64}")
    return out["dd_toms129"], out["dd65"]


def profile_cells(card):
    """``--profile``: one profiled kernel-path solve of each cell of the
    periodic models, the Brusselator, the spectral and physical TOMS solves, the ragged row,
    the spatial65 row, the BDF example, the `[coarsest]` prefix (K8) and
    AtMgrit solves at the TOMS width, the `[ode]` Arenstorf solve (K12), the two DD rows and the deep diffusion grid (after one
    untimed solve of the same configuration), torch.profiler with CPU and
    CUDA activities:
    the profiled wall, the card's busy time (the kernels' device time
    summed; one stream, so they do not overlap) and idle share, the three
    device ops that took longest, K18's, K19's and K21's device time,
    launches and device time a launch inside the solve (phase 3's "device"
    column times one case with a cold L2), and the host's kernel launches
    and stream synchronisations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, launch_counts, reset_launch_counts

    def solver(model, cfg, name="scan", k=0, ops=DISPATCH, **kw):
        def run():
            problem = level_problems(P, model, cfg, ops, **kw)
            return strategy(P, name, problem, k, tol=cfg["tol"], max_iter=cfg["max_iter"])
        return run

    def advection_example():
        problem = [P.Advection1D(c=1, x_start=-1, x_end=1, nx=129, t_start=0, t_stop=2, nt=nt,
                                 device=DEVICE) for nt in (129, 65)]
        return P.Mgrit(problem=problem, cf_iter=1, nested_iteration=False, logging_lvl=30)

    # a wrapper's host time a call (its checks, its launch and what it
    # allocates), timed around each call: K11 in the Allen-Cahn cells, K13
    # in the Brusselator, K12 in Arenstorf, K14 in Gray-Scott IMPL, K15 in
    # Burgers2D, K23-K25 in the DD cells (every DD operation of the solve
    # reads the kernel set of the problem's states), K8 and K9 in the
    # coarsest prefix and AT cells
    host = {}

    def timed(*names):
        def wrap(name):
            fn = getattr(DISPATCH, name)

            def call(*args, **kw):
                t0 = time.perf_counter()
                r = fn(*args, **kw)
                rec = host.setdefault(name, [0, 0.0])
                rec[0] += 1
                rec[1] += time.perf_counter() - t0
                return r
            return call
        return DISPATCH._replace(**{name: wrap(name) for name in names})

    def allen_cahn(cfg):
        return lambda: strategy(P, "scan", allen_cahn_problem(
            P, timed("allen_cahn_pointwise"), **cfg), 0, tol=cfg["tol"],
            max_iter=cfg["max_iter"])

    def dd_cell(cfg, basis):
        return lambda: P.Mgrit(
            problem=build_problem(P, cfg["nx"], cfg["nt"], cfg["ms"], DEVICE,
                                  timed("dd_arith", "dd_theta_chain", "dd_interval_affine"),
                                  basis=basis, precision="dd"),
            tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)

    gs = dict(nx=GS_AT["nx"], method="IMEX")
    cells = [
        ("allen_cahn IMPL", allen_cahn(AC_IMPL)),
        ("allen_cahn CN", allen_cahn(AC_CN)),
        ("gray_scott AtMgrit(k=8)", solver("GrayScott2D", GS_AT, "at", GS_AT["k"], **gs)),
        ("gray_scott Parareal", lambda: P.Mgrit(
            problem=level_problems(P, "GrayScott2D", GS_PARAREAL, DISPATCH, **gs), cf_iter=0,
            tol=GS_PARAREAL["tol"], max_iter=GS_PARAREAL["max_iter"], logging_lvl=30)),
        ("gray_scott IMPL", solver("GrayScott2D", GS_IMPL, ops=timed("gray_scott_pointwise"),
                                   nx=GS_IMPL["nx"], method="IMPL")),
        ("gray_scott EXPL", solver("GrayScott2D", GS_EXPL, nx=GS_EXPL["nx"], method="EXPL")),
        ("burgers example", solver("Burgers1D", BURGERS_EX, nx=BURGERS_EX["nx"],
                                   nu=BURGERS_EX["nu"])),
        ("burgers Burgers1D deep", solver("Burgers1D", BURGERS_DEEP, nx=BURGERS_DEEP["nx"],
                                          nu=BURGERS_DEEP["nu"])),
        ("burgers Burgers2D", solver("Burgers2D", BURGERS_2D, ops=timed("burgers2d_pointwise"),
                                     nx=BURGERS_2D["nx"], nu=BURGERS_2D["nu"])),
        ("advection example", advection_example),
        ("ode Brusselator", lambda: P.Mgrit(
            problem=ode_problem(P, "Brusselator", timed("rk4_brusselator"), **BRUSSELATOR),
            tol=BRUSSELATOR["tol"], logging_lvl=30)),
        ("advection deep", solver("Advection1D", dict(ADVECTION_DEEP, t_stop=2.0), c=1,
                                  x_start=-1, x_end=1, nx=ADVECTION_DEEP["nx"])),
        ("spectral toms129", lambda: P.Mgrit(
            problem=build_problem(P, device=DEVICE, ops=DISPATCH, **TOMS),
            tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)),
        ("physical toms129", lambda: P.Mgrit(
            problem=build_problem(P, device=DEVICE, ops=DISPATCH, basis="physical", **TOMS),
            tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)),
        ("ragged ragged65", lambda: P.Mgrit(problem=ragged_problem(P, DISPATCH),
                                            tol=RAGGED["tol"], max_iter=RAGGED["max_iter"],
                                            logging_lvl=40)),
        ("spatial spatial65", lambda: P.Mgrit(
            problem=spatial_problem(P, DISPATCH),
            transfer=[P.GridTransferHeat2D(n, n) for n in SPATIAL["sizes"][:-1]],
            tol=SPATIAL["tol"], max_iter=SPATIAL["max_iter"], logging_lvl=30)),
        ("bdf example", lambda: P.Mgrit(problem=bdf_problem(P, DISPATCH), tol=BDF["tol"],
                                        max_iter=BDF["max_iter"], logging_lvl=30)),
        ("coarsest toms prefix", lambda: strategy(
            P, "prefix", build_problem(P, device=DEVICE, ops=timed("affine_prefix"), **TOMS2),
            0, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER)),
        ("ode Arenstorf", lambda: P.Mgrit(
            problem=ode_problem(P, "ArenstorfOrbit", timed("dopri45_arenstorf"), **ARENSTORF),
            cf_iter=ARENSTORF["cf_iter"], tol=ARENSTORF["tol"], logging_lvl=30)),
        (f"coarsest toms AtMgrit(k={TOMS2_AT_K})", lambda: strategy(
            P, "at", build_problem(P, device=DEVICE, ops=timed("affine_windows"), **TOMS2),
            TOMS2_AT_K, tol=1e-300, max_iter=TOMS2_AT_ITERS)),
        ("dd dd_toms129", dd_cell(DD_TOMS, "spectral")),
        ("dd dd65", dd_cell(DD65, "physical")),
        ("diffusion deep", lambda: P.Mgrit(
            problem=[P.Diffusion2D(n=DIFFUSION_DEEP["n"], length=10.0, kappa=0.1, t_start=0,
                                   t_stop=10, nt=nt, device=DEVICE)
                     for nt in (DIFFUSION_DEEP["nt"],
                                (DIFFUSION_DEEP["nt"] - 1) // DIFFUSION_DEEP["m"] + 1)],
            tol=DIFFUSION_DEEP["tol"], max_iter=DIFFUSION_DEEP["max_iter"], logging_lvl=30)),
    ]

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    for label, build in cells:
        build().solve()
        mg = build()
        torch.cuda.synchronize()
        reset_launch_counts()
        host.clear()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            h = mg.solve()["conv"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        dev = [e for e in events if device_us(e) > 0 and "Memcpy" not in e.key
               and "Memset" not in e.key]
        busy = sum(device_us(e) for e in dev) / 1e3
        top = sorted(dev, key=device_us, reverse=True)[:3]
        launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                            "cuLaunchKernelEx"))
        syncs = sum(e.count for e in events if "Synchronize" in e.key)
        calls = launch_counts()
        # K20, K22 and K26 calls against the product tile's device kernels
        # they launched in the same window (a call: one or two products, each
        # with a reduction pass where its plan splits the inner index; K20's
        # first pass forming its rhs on the wide tile)
        tile = {k: (sum(e.count for e in dev if k in e.key),
                    sum(device_us(e) for e in dev if k in e.key) / 1e3)
                for k in ("tile_product", "reduce_", "form_rhs")}
        # the row kernels' device kernels: K18, K19, K21; K5's and K6's (the
        # one-tile kernels, K6's coefficient pass and the band kernel past
        # 128), K7's, and the spectral path's K1, K2 and K4, with their
        # wrappers' calls (a name matches where no letter or "_" precedes
        # it: theta_chain is not dd_theta_chain)
        names = ("restrict_combine", "interpolate_combine", "indexed_combine", "sine_solve2d",
                 "sine_affine2d", "affine_tile", "band_product", "theta_rhs", "theta_chain",
                 "interval_affine", "cpoint_combine", "periodic_solve2d", "periodic_rhs",
                 "allen_cahn", "gray_scott", "burgers2d", "burgers1d_newton", "dd_arith",
                 "circulant_solve1d", "dd_theta_chain", "dd_interval_affine", "affine_windows",
                 "rk4_brusselator", "prefix_wide", "prefix_narrow", "dopri45_arenstorf")
        row = {}
        for k in names:
            mine = [e for e in dev if re.search(r"(?<![A-Za-z_])" + k, e.key)]
            row[k] = (sum(e.count for e in mine), sum(device_us(e) for e in mine) / 1e3)
        print(f"[profile] {label}: {h.size} iterations, profiled solve {wall * 1e3:.1f} ms, device "
              f"busy {busy:.1f} ms, idle {100 * (1 - busy / (wall * 1e3)):.1f} % | leading device "
              "time " + "; ".join(f"{e.key[:48]} {device_us(e) / 1e3:.2f} ms ({e.count})"
                                  for e in top)
              + "".join(f" | {k} {n} launches {ms:.2f} ms ({ms / n:.4f} ms a launch)"
                        for k, (n, ms) in row.items() if n)
              + "".join(f" | {name} calls {calls[key]}"
                        for name, key in (("K1", "interval_affine"), ("K2", "theta_chain"),
                                          ("K4", "cpoint_combine"), ("K5", "sine_solve2d"),
                                          ("K6", "sine_affine2d"), ("K7", "theta_rhs2d"),
                                          ("K10", "periodic_solve2d"),
                                          ("K11", "allen_cahn_pointwise"),
                                          ("K14", "gray_scott_pointwise"),
                                          ("K15", "burgers2d_pointwise"),
                                          ("K16", "burgers1d_newton"),
                                          ("K13", "rk4_brusselator"),
                                          ("K17", "circulant_solve1d"), ("K20", "sine_solve1d"),
                                          ("K8", "affine_prefix"), ("K9", "affine_windows"),
                                          ("K12", "dopri45_arenstorf"),
                                          ("K23", "dd_interval_affine"),
                                          ("K24", "dd_theta_chain"), ("K25", "dd_arith"))
                        if calls[key])
              + "".join(f" | {name} wrapper host time {s * 1e3 / n:.4f} ms a call ({n} calls)"
                        for name, (n, s) in host.items())
              + f" | host: {launches} kernel launches, {syncs} synchronisations"
              + (f" | product tile: {calls['sine_solve1d']} K20, {calls['eig_step']} K22 and "
                 f"{calls['dd_matmul']} K26 calls, "
                 f"{tile['tile_product'][0]} product kernels {tile['tile_product'][1]:.2f} ms, "
                 f"{tile['reduce_'][0]} reductions {tile['reduce_'][1]:.2f} ms, "
                 f"{tile['form_rhs'][0]} K20 rhs passes {tile['form_rhs'][1]:.2f} ms"
                 if calls["eig_step"] + calls["dd_matmul"] + calls["sine_solve1d"] else "")
              + f" | {card}")
        del mg, prof
        torch.cuda.empty_cache()


def max_jump_class(P):
    """A solver whose criterion is the largest change of a C-point value
    from the previous iterate, in solve() and in solve_compiled() (the
    pattern of tests/core/test_compiled_solve.py:47-87)."""
    import torch

    class MaxJumpMgrit(P.Mgrit):
        def _cpts(self):
            return torch.as_tensor(self.levels[0].cpts, device=self.device)

        def convergence_criterion(self, iteration):
            u_c = self.u[0][self._cpts()].cpu().numpy()
            prev = getattr(self, "_prev", None)
            conv = np.max(np.abs(u_c - (np.zeros_like(u_c) if prev is None else prev)))
            self.conv[iteration] = conv
            self._all_below = conv < self.tol
            self._prev = u_c

        def compiled_convergence_criterion(self, state, aux):
            u_c = state[0][0][self._cpts()]
            conv = torch.max(torch.abs(u_c - aux))
            return conv, conv < self.tol, u_c

        def compiled_conv_aux_init(self):
            return torch.zeros_like(self.u[0][self._cpts()])

    return MaxJumpMgrit


def profile_phase_keys(lvl_max):
    """The keys of the JAX package's ``Mgrit.profile_phases``."""
    keys = [f"{p}[{lvl}]" for lvl in range(lvl_max - 1)
            for p in ("f_relax", "c_relax", "fas_residual")]
    return set(keys + [f"forward_solve[{lvl_max - 1}]", "convergence", "full_iteration"])


def reset_peak():
    """Reset the card's peak-memory count; the bytes allocated now, which a
    peak read later is taken from."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def synced_wall(fn):
    """(fn's result, its wall in s), the card synchronised before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_observe(card):
    """The solver's observability on the full spectral TOMS solve:
    ``profile_phases``, ``solve_profiled`` and a compiled custom criterion."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.ops import DISPATCH, launch_counts, reset_launch_counts

    # one problem for every solver: its tables take seconds to build
    problem = build_problem(P, device=DEVICE, ops=DISPATCH, **TOMS)

    def solver(cls=P.Mgrit):
        return cls(problem=problem, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)

    ma = solver()
    phases = ma.profile_phases(repeats=2)
    print("[observe] profile_phases(repeats=2), ms a call: "
          + ", ".join(f"{k} {v * 1e3:.4f}" for k, v in phases.items()) + f" | {card}")
    check(set(phases) == profile_phase_keys(ma.lvl_max),
          f"observe: profile_phases keys {sorted(phases)} are not the JAX package's")
    check(all(v > 0 for v in phases.values()), f"observe: a phase time is not positive: {phases}")
    ha = ma.solve_compiled()["conv"]
    base = reset_peak()
    mb = solver()
    hb, wall_cnd = synced_wall(lambda: mb.solve_compiled()["conv"])
    peak_cnd = torch.cuda.max_memory_allocated() - base
    same = np.array_equal(ha, hb) and torch.equal(ma.u[0], mb.u[0])
    print(f"[observe] solve after profile_phases vs without: {ha.size} / {hb.size} iterations, "
          f"history and tube bit for bit {same} | {'ok' if same else 'FAIL'}")
    check(same, "observe: profile_phases changed the next solve")
    del ma, mb
    torch.cuda.empty_cache()

    mc = solver()
    hc, wall_solve = synced_wall(lambda: mc.solve()["conv"])
    md = solver()
    with tempfile.TemporaryDirectory() as trace_dir:
        hd, wall_prof = synced_wall(lambda: md.solve_profiled(trace_dir)["conv"])
        traces = sorted(Path(trace_dir).glob("*.json"))
        text = traces[0].read_text() if traces else ""
        size = traces[0].stat().st_size if traces else 0
    named = {s: s in text for s in OBSERVE_SYMBOLS}
    ok = bool(traces) and all(named.values()) and np.array_equal(hc, hd)
    print(f"[observe] solve_profiled: trace {[t.name for t in traces]} ({size} bytes), kernels "
          f"named {named}; history equals solve()'s {np.array_equal(hc, hd)} | solve wall "
          f"{wall_solve:.4f} s, profiled {wall_prof:.4f} s | {'ok' if ok else 'FAIL'}")
    check(ok, "observe: the profiled solve's trace is missing, lacks K1-K4, or its history moved")
    del mc, md
    torch.cuda.empty_cache()

    MaxJump = max_jump_class(P)
    base = reset_peak()
    me = solver(MaxJump)
    check(not me._condensed0 and me._cnd_decline_reason is not None,
          "observe: the condensed carry was not declined under a custom criterion")
    reset_launch_counts()
    he, wall_custom = synced_wall(lambda: me.solve_compiled()["conv"])
    counts = launch_counts()
    peak_custom = torch.cuda.max_memory_allocated() - base
    reason = me._cnd_decline_reason
    del me
    torch.cuda.empty_cache()
    hf = solver(MaxJump).solve()["conv"]
    ok = he.shape == hf.shape and bool(np.allclose(he, hf, rtol=OBSERVE_RTOL, atol=0.0))
    print(f"[observe] max-C-point-jump criterion: condensed carry declined "
          f"({reason}); solve_compiled {he.size} iterations "
          f"{[float(f'{h:.6e}') for h in he]} vs solve() {hf.size}: max rel "
          f"{float(np.max(np.abs(he - hf) / np.abs(hf))) if he.shape == hf.shape else 'n/a'} "
          f"(rtol {OBSERVE_RTOL:.0e}); launches {json.dumps({k: counts[k] for k in SPECTRAL_KERNELS})} "
          f"| wall {wall_custom:.4f} s, peak {peak_custom / 2 ** 30:.3f} GiB (setup and solve); "
          f"condensed solve_compiled {wall_cnd:.4f} s, peak {peak_cnd / 2 ** 30:.3f} GiB | "
          f"{'ok' if ok else 'FAIL'} | {card}")
    check(ok, "observe: the compiled custom criterion's history differs from solve()'s")
    # the criterion takes the place of the residual: K3 is not launched
    check(all(counts[k] > 0 for k in ("interval_affine", "theta_chain", "cpoint_combine"))
          and counts["residual_row_norms"] == 0,
          f"observe: the custom-criterion solve's launches are not K1, K2, K4 alone: {counts}")


def host_heat1d_step(nx, x_end):
    """A backward-Euler Heat1D step on the host: (I + dt L) u' = u with the
    3-point Laplacian of the nx - 2 interior points, one dense LU a step
    size (scipy)."""
    from scipy.linalg import lu_factor, lu_solve
    n = nx - 2
    fac = 1.0 / (x_end / (nx - 1)) ** 2
    lap = fac * (2 * np.eye(n) - np.eye(n, k=1) - np.eye(n, k=-1))
    lus = {}

    def host_step(u, t_start, t_stop):
        dt = t_stop - t_start
        if dt not in lus:
            lus[dt] = lu_factor(np.eye(n) + dt * lap)
        return lu_solve(lus[dt], u)
    return host_step


class Counted:
    """Counts the calls of a function, calling it unchanged."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kw):
        self.calls += 1
        return self.fn(*args, **kw)


def phase_callback(card):
    """A ``CallbackApplication`` stepping Heat1D on the host, against the
    port's Heat1D on the card."""
    import torch
    import pymgrit_tpu_torch as P
    from pymgrit_tpu_torch.coupling import callback
    from pymgrit_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = CALLBACK
    x = np.linspace(0, 2, cfg["nx"])[1:-1]
    t, strides = np.linspace(0, cfg["t_stop"], cfg["nt"]), np.cumprod((1,) + cfg["ms"])
    host_step = Counted(host_heat1d_step(cfg["nx"], 2.0))
    apps = [callback.CallbackApplication(host_step=host_step, vector_template=np.zeros(x.size),
                                         vector_t_start=np.sin(np.pi * x), t_interval=t[::s],
                                         device=DEVICE) for s in strides]
    for app in apps:
        app.step_batched = Counted(app.step_batched)
    moves = {name: Counted(getattr(callback, name)) for name in ("to_host", "to_device")}
    saved = {name: getattr(callback, name) for name in moves}
    kw = dict(tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30)
    try:
        for name, fn in moves.items():
            setattr(callback, name, fn)
        mg = P.Mgrit(problem=apps, **kw)
        setup_moves = {k: v.calls for k, v in moves.items()}
        reset_launch_counts()
        hc, wall_cb = synced_wall(lambda: mg.solve()["conv"])
        counts = launch_counts()
    finally:
        for name, fn in saved.items():
            setattr(callback, name, fn)
    batched = sum(app.step_batched.calls for app in apps)
    trips = {k: v.calls for k, v in moves.items()}
    native = P.Mgrit(problem=[P.Heat1D(x_start=0, x_end=2, nx=cfg["nx"], a=1,
                                       init_cond=lambda xx: np.sin(np.pi * xx), t_interval=t[::s],
                                       device=DEVICE) for s in strides], **kw)
    hn, wall_nat = synced_wall(lambda: native.solve()["conv"])
    ok_h = hc.shape == hn.shape and bool(np.allclose(hc, hn, rtol=CALLBACK_RTOL, atol=0.0))
    ok_trips = trips["to_host"] == trips["to_device"] == batched > 0
    du = float((mg.u[0] - native.u[0]).abs().max())
    print(f"[callback] Heat1D nx={cfg['nx']} nt={cfg['nt']} ms={cfg['ms']} on the host "
          f"(scipy LU): {hc.size} iterations {[float(f'{h:.6e}') for h in hc]} vs the port's "
          f"Heat1D {hn.size}: max rel {float(np.max(np.abs(hc - hn) / np.abs(hn))) if ok_h else 'n/a'} "
          f"(rtol {CALLBACK_RTOL:.0e}), tube max diff {du:.3e} | solve: {batched} batched calls, "
          f"{host_step.calls} host steps, round trips to host {trips['to_host']}, to the card "
          f"{trips['to_device']} (setup: {setup_moves}); K3 {counts['residual_row_norms']}, "
          f"K4 {counts['cpoint_combine']} launches | wall {wall_cb:.4f} s, native {wall_nat:.4f} s "
          f"| {'ok' if ok_h and ok_trips else 'FAIL'} | {card}")
    check(ok_h, "callback: the host-stepped history differs from the port's Heat1D")
    check(ok_trips, f"callback: not one round trip each way a batched call: {trips}, {batched}")
    check(counts["residual_row_norms"] > 0 and counts["cpoint_combine"] > 0,
          f"callback: K3 or K4 was never launched: {counts}")


def machine_env(directory):
    """The mock GetDP (``MOCK_GETDP``), its problem file, grid files and an
    empty argv log, written into directory; the InductionMachine keywords
    that point at them, and the log's path."""
    d = Path(directory)
    log, mock = d / "argv.log", d / "mock_getdp"
    mock.write_text(MOCK_GETDP.format(python=sys.executable, num_dofs=MACHINE_MIDDLE + 8 + 15,
                                      log=str(log)))
    mock.chmod(mock.stat().st_mode | stat.S_IEXEC)
    (d / "im_3kW.pro").write_text("/* mock problem file */\n")
    (d / "grid.msh").write_text("$MeshFormat\n4 0 8\n$EndMeshFormat\n")
    # pre_file reads content[9:-35]: row[1] the node tag, row[4] the
    # unknown (0/-1/1: a boundary node)
    header = ["$Resolution /* fixture */", "1 1", "$EndResolution", "$DofData  /* #0 */", "1 1",
              "0", "0", "1 %d" % MACHINE_MIDDLE, "dummy"]
    rows = ["1 %d 0 0 %d" % (k + 1, 10 + k) for k in range(MACHINE_MIDDLE)]
    rows += ["1 100 0 0 0", "1 101 0 0 0"]
    footer = ["footer"] * 34 + ["$EndDofData"]
    (d / "grid.pre").write_text("\n".join(header + rows + footer) + "\n")
    log.write_text("")
    return dict(grid="grid", path_im3kw=str(d) + os.sep, path_getdp=str(mock)), str(log)


def two_mesh_env(directory):
    """The committed im fixture meshes (tests/models/fixtures/im: 64
    unknowns on the fine mesh, 32 on the coarse) copied into directory, a
    mock GetDP a mesh (its DOF count) logging into one argv log: the
    InductionMachine keywords of each grid, and the path of the meshes."""
    d = Path(directory)
    fixtures = ROOT / "tests" / "models" / "fixtures" / "im"
    (d / "im_3kW.pro").write_text("/* mock problem file */\n")
    kws = {}
    for grid, middle in (("machine_fine", 64), ("machine_coarse", 32)):
        for ext in (".pre", ".msh"):
            shutil.copy(fixtures / (grid + ext), d / (grid + ext))
        mock = d / f"getdp_{grid}"
        mock.write_text(MOCK_GETDP.format(python=sys.executable, num_dofs=middle + 8 + 15,
                                          log=str(d / "argv.log")))
        mock.chmod(mock.stat().st_mode | stat.S_IEXEC)
        kws[grid] = dict(grid=grid, path_im3kw=str(d) + os.sep, path_getdp=str(mock))
    return kws, str(d) + os.sep


def two_mesh_machine(mgrit, machine, transfer, kws, path, max_iter, **dev):
    """A two-level machine solver (nt 17 and 9 on [0, 0.8]) whose levels
    sit on the fine and the coarse mesh, a transfer between them; the
    classes (``Mgrit``, ``InductionMachine``, ``GridTransferMachine``) of
    either package."""
    t = np.linspace(0, 0.8, 17)
    apps = [machine(**kws[grid], t_interval=t[::s], **dev)
            for grid, s in (("machine_fine", 1), ("machine_coarse", 2))]
    return mgrit(problem=apps, transfer=[transfer("machine_coarse", "machine_fine", path)],
                 tol=1e-14, max_iter=max_iter, logging_lvl=30, nested_iteration=True)


def getdp_calls(log):
    """The -restart lines of the mock's argv log, and its -pre count."""
    lines = [ln for ln in Path(log).read_text().splitlines() if ln]
    return [ln for ln in lines if "-restart" in ln], sum(" -pre " in ln for ln in lines)


def machine_march(n_steps, dt):
    """The sequential backward-Euler march of the mock's dynamics from 0."""
    u = np.zeros(MACHINE_MIDDLE + 8 + 15)
    for _ in range(n_steps):
        u = (u + dt) / (1.0 + dt)
    return u


def phase_machine(card):
    """The induction machine against a mock GetDP: ``MgritMachineConvJl``
    in solve() and solve_compiled(), ``MgritMachine``'s PWM switch, and a
    machine on two meshes with ``GridTransferMachine``."""
    import torch
    from pymgrit_tpu_torch import Mgrit
    from pymgrit_tpu_torch.coupling import callback
    from pymgrit_tpu_torch.models.induction_machine import (InductionMachine, MgritMachine,
                                                            MgritMachineConvJl)
    from pymgrit_tpu_torch.models.induction_machine.machine_state import get_values
    from pymgrit_tpu_torch.ops import launch_counts, reset_launch_counts
    cfg = MACHINE
    with tempfile.TemporaryDirectory() as tmp:
        env, log = machine_env(tmp)

        def apps(c, **kw):
            return [InductionMachine(**env, t_start=0.0, t_stop=c["t_stop"], nt=nt,
                                     device=DEVICE, **kw) for nt in c["nts"]]

        runs = {}
        for method in ("solve", "solve_compiled"):
            problem = apps(cfg)
            Path(log).write_text("")
            moves = Counted(callback.to_host)
            callback.to_host = moves
            try:
                reset_launch_counts()
                mg, wall = synced_wall(lambda: MgritMachineConvJl(
                    problem=problem, tol=cfg["tol"], max_iter=cfg["max_iter"], logging_lvl=30,
                    nested_iteration=True))
                _, wall_solve = synced_wall(getattr(mg, method))
                counts = launch_counts()
            finally:
                callback.to_host = moves.fn
            restarts, pres = getdp_calls(log)
            runs[method] = mg
            print(f"[machine] MgritMachineConvJl nt {cfg['nts']} {method}: {mg.solve_iter} "
                  f"iterations, history {mg.conv[:mg.solve_iter + 1].tolist()} | {len(restarts)} "
                  f"GetDP round trips ({pres} -pre, {len(restarts)} -restart) in "
                  f"{moves.calls} batched host round trips | K4 {counts['cpoint_combine']} "
                  f"launches | setup {wall:.3f} s, solve {wall_solve:.3f} s")
            check(counts["cpoint_combine"] > 0, f"machine: K4 was never launched: {counts}")
        s, c = runs["solve"], runs["solve_compiled"]
        hs, hc = s.conv[:s.solve_iter + 1], c.conv[:c.solve_iter + 1]
        same = s.solve_iter == c.solve_iter and bool(np.allclose(hc, hs, rtol=MAIN_RTOL, atol=0))
        jax_ok = hs.shape == MACHINE_JAX.shape and bool(
            np.allclose(hs, MACHINE_JAX, rtol=MAIN_RTOL, atol=0))
        ref = machine_march(cfg["nts"][0] - 1, cfg["t_stop"] / (cfg["nts"][0] - 1))
        errs = []
        for mg in (s, c):
            last = {k: v[-1] for k, v in mg.u[0].items()}
            u_last = get_values(last).cpu().numpy()
            errs.append(float(np.max(np.abs(u_last - ref) / np.abs(ref))))
            errs.append(abs(float(last["scalars"][0]) - float(np.sum(ref ** 2)))
                        / float(np.sum(ref ** 2)))
        march_ok = max(errs) <= MACHINE_RTOL
        print(f"[machine] solve vs solve_compiled: iterations {s.solve_iter} / {c.solve_iter}, "
              f"histories equal (rtol {MAIN_RTOL:.0e}) {same}, bit for bit {np.array_equal(hs, hc)}; "
              f"vs MACHINE_JAX {jax_ok}; final state and joule losses vs the "
              f"{cfg['nts'][0] - 1}-step march: max rel {max(errs):.3e} (rtol {MACHINE_RTOL:.0e}) | "
              f"{'ok' if same and jax_ok and march_ok else 'FAIL'}")
        check(same, "machine: solve and solve_compiled differ")
        check(jax_ok, f"machine: history {hs.tolist()} is not the JAX package's")
        check(march_ok, f"machine: final state off the sequential march by {max(errs):.3e}")
        del runs, s, c

        pc = MACHINE_PWM
        problem = apps(pc, pwm=1)
        Path(log).write_text("")
        mg, wall = synced_wall(lambda: MgritMachine(problem=problem, tol=pc["tol"],
                                                    max_iter=pc["max_iter"], logging_lvl=30,
                                                    nested_iteration=True))
        nested, _ = getdp_calls(log)
        restored = [float(p.fopt[-1]) for p in problem]
        Path(log).write_text("")
        _, wall_solve = synced_wall(mg.solve)
        cycle, _ = getdp_calls(log)
        pwm_nested = [ln.split()[-1] for ln in nested]
        pwm_cycle = [ln.split()[-1] for ln in cycle]
        ok = (bool(nested) and all(v == "0" for v in pwm_nested) and bool(cycle)
              and all(float(v) == 1.0 for v in pwm_cycle) and all(r == 1 for r in restored))
        print(f"[machine] MgritMachine pwm=1 nt {pc['nts']}: Flag_PWM on {len(nested)} "
              f"nested-iteration -restart calls {sorted(set(pwm_nested))}, on {len(cycle)} cycle "
              f"calls {sorted(set(pwm_cycle))}, restored {restored} | setup {wall:.3f} s, solve "
              f"{wall_solve:.3f} s | {'ok' if ok else 'FAIL'} | {card}")
        check(ok, "machine: the PWM flag was not 0 in nested iteration and restored after")

    from pymgrit_tpu_torch.models.induction_machine import GridTransferMachine
    with tempfile.TemporaryDirectory() as tmp:
        kws, path = two_mesh_env(tmp)
        mg = two_mesh_machine(Mgrit, InductionMachine, GridTransferMachine, kws, path,
                              TWO_MESH_JAX.size, device=DEVICE)
        h, wall = synced_wall(lambda: mg.solve()["conv"])
        shapes = {lvl: tuple(mg.u[lvl]["middle"].shape) for lvl in (0, 1)}
        finite = all(bool(torch.isfinite(x).all()) for x in mg.u[0].values())
    ok = h.shape == TWO_MESH_JAX.shape and bool(np.allclose(h, TWO_MESH_JAX, rtol=MAIN_RTOL,
                                                            atol=0)) and finite
    print(f"[machine] two meshes, GridTransferMachine between them (middle leaf {shapes}): "
          f"history {h.tolist()} vs TWO_MESH_JAX (rtol {MAIN_RTOL:.0e}) | solve {wall:.3f} s | "
          f"{'ok' if ok else 'FAIL'} | {card}")
    check(ok, "machine: the two-mesh history is not the JAX package's, or the tube not finite")



# ---------------------------------------------------------------------------
# [shard]: the time-sharded executor (pymgrit_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

# the TOMS solve at P = 1 (an NCCL world of one in this process) and at
# P = 2 (two gloo processes on cuda:0: the collectives stage CUDA tensors
# through pinned host buffers); at P = 2 also ShardedAtMgrit(64) on TOMS2,
# the varying-coarsening golden (the general path) and dd_toms129
SHARD_P = 2
SHARD_INIT_S, SHARD_JOIN_S = 60, 120      # rendezvous timeout, the P = 2 world's join limit
# the reference's varying_coarsening history (tests/parallel/test_shard_nonuniform.py),
# held at the JAX package's own rtol
SHARD_VARYING_GOLDEN = np.array([0.037311841611405, 0.003124171062320715, 3.129166834664884e-05,
                                 1.8514542798812671e-07, 4.995916285724713e-10,
                                 4.82164655680165e-13])
SHARD_GOLDEN_RTOL = 1e-6
SHARD_TUBE_RTOL = 1e-12      # fine_solution() against the serial tube, of its largest entry


def shard_env():
    """Process-local bootstrap settings of the collectives (inherited by the
    spawned ranks): the loopback interface, no InfiniBand probe."""
    if os.path.exists("/sys/class/net/lo"):
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")
    os.environ.setdefault("NCCL_IB_DISABLE", "1")


def shard_cases(P):
    """(label, problem builder, solver arguments) of the P = 2 world."""
    from pymgrit_tpu_torch.ops import DISPATCH
    return [
        ("toms", lambda: build_problem(P, device=DEVICE, ops=DISPATCH, **TOMS),
         dict(tol=MAIN_TOL, max_iter=MAIN_MAX_ITER)),
        ("at64", lambda: build_problem(P, device=DEVICE, ops=DISPATCH, **TOMS2),
         dict(k=TOMS2_AT_K, tol=1e-300, max_iter=TOMS2_AT_ITERS)),
        ("varying", lambda: varying_problem(P, DISPATCH),
         dict(tol=1e-10, nested_iteration=False)),
        ("dd_toms129", lambda: build_problem(P, DD_TOMS["nx"], DD_TOMS["nt"], DD_TOMS["ms"], DEVICE,
                                             DISPATCH, precision="dd"),
         dict(tol=DD_TOMS["tol"], max_iter=DD_TOMS["max_iter"])),
    ]


def shard_run(mesh, build, entry="solve_compiled", k=None, **kw):
    """One sharded solve on this rank: the solver, its history, setup and
    solve walls, the launches of setup and solve, the communication per
    iteration of the solve and the peak device memory of setup and solve
    above what was allocated before (the problem's tables included)."""
    import torch
    import pymgrit_tpu_torch.parallel as PP
    from pymgrit_tpu_torch.ops import launch_counts, reset_launch_counts
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    problem, built = synced_wall(build)
    reset_launch_counts()
    cls, args = (PP.ShardedAtMgrit, (k,)) if k else (PP.ShardedMgrit, ())
    mg, setup = synced_wall(lambda: cls(*args, problem=problem, mesh=mesh, logging_lvl=30, **kw))
    comms = [c for c in (mg.comm, mg.space_comm) if c is not None]
    for c in comms:
        c.reset_counts()
    _, wall = synced_wall(getattr(mg, entry))
    it = mg.solve_iter
    per_it = [{c: n / it for c, n in comm.counts.items()} for comm in comms]
    return dict(mg=mg, hist=mg.conv[1:it + 1].copy(), build=built, setup=setup, wall=wall,
                launches=launch_counts(), modes=mode_launches(), comm=per_it[0],
                stats=[dict(p.stats) for p in problem if hasattr(p, "stats")],
                space_comm=per_it[1] if len(per_it) > 1 else None,
                staged=mg.comm.staged, backend=mg.comm.backend,
                peak=(torch.cuda.max_memory_allocated() - mem0) / 2 ** 30)


def mode_launches():
    """K3's, K7's, K11's, K14's, K15's and K20's launches by mode since the
    last reset."""
    from pymgrit_tpu_torch.ops import heat_kernels, pointwise, row_norms, theta_rhs
    return {f"{fn.__name__} {k}": v
            for fn in (row_norms.residual_row_norms, theta_rhs.theta_rhs2d,
                       heat_kernels.sine_solve1d, pointwise.allen_cahn_pointwise,
                       pointwise.gray_scott_pointwise, pointwise.burgers2d_pointwise)
            for k, v in fn.mode_launches.items()}


def comm_latency(group, reps=50):
    """ms a call of three collectives on the card, each timed over ``reps``
    calls between two synchronisations, with a communicator of their own
    (every rank makes the same calls): an all_reduce of a 0-d float64, a
    shift and a broadcast of one TOMS-width state (127^2 float64)."""
    import torch
    from pymgrit_tpu_torch.parallel.comm import Comm
    comm = Comm(group, DEVICE)
    x = torch.zeros((), dtype=torch.float64, device=DEVICE)
    s = torch.zeros((TOMS["nx"] - 2,) * 2, dtype=torch.float64, device=DEVICE)
    out = {}
    for name, fn in (("all_reduce", lambda: comm.all_reduce(x)), ("shift", lambda: comm.shift(s)),
                     ("broadcast", lambda: comm.broadcast(s, 0))):
        fn()
        _, wall = synced_wall(lambda: [fn() for _ in range(reps)])
        out[name] = 1e3 * wall / reps
    return out


def fmt_latency(lat):
    return ", ".join(f"{name} {ms:.4f}" for name, ms in lat.items())


def shard_worker(rank, size, store, directory):
    """A rank of the P = 2 world: the cases of ``shard_cases`` in order, its
    results pickled into ``directory`` (a traceback there if it raised)."""
    import datetime
    import pickle
    import traceback
    import torch
    import torch.distributed as dist
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=SHARD_INIT_S))
    try:
        mesh = PP.make_time_space_mesh()
        out = {}
        for label, build, kw in shard_cases(P):
            r = shard_run(mesh, build, **kw)
            del r["mg"]
            out[label] = r
        out["latency"] = comm_latency(mesh.group)
        tmp = os.path.join(directory, f".rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(directory, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def shard_world(directory, worker=None, size=SHARD_P, join_s=SHARD_JOIN_S, label="shard"):
    """Spawn a world of ``size`` ranks running ``worker`` (the P = 2 world's
    by default), join it within ``join_s``, and return each rank's results;
    a rank's exception or the time limit fails the run."""
    import pickle
    import torch.multiprocessing as mp
    ctx = mp.start_processes(worker or shard_worker,
                             args=(size, os.path.join(directory, "store"), directory),
                             nprocs=size, join=False, start_method="spawn")
    deadline = time.monotonic() + join_s
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            check(time.monotonic() < deadline,
                  f"{label}: the world of {size} did not finish within {join_s} s")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errs = sorted(Path(directory).glob("rank*.err"))
        fail(f"{label}: a rank of the world of {size} failed: {e}\n"
             + "".join(p.read_text() for p in errs))
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
    ranks = []
    for r in range(size):
        with open(os.path.join(directory, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def fmt_counts(counts, names):
    return ", ".join(f"{n} {counts[n]}" for n in names)


def phase_shard(card):
    """The time-sharded executor on the card: TOMS at P = 1 in an NCCL
    world of one (solve and solve_compiled with kernels, once with the plain
    versions; against the serial condensed solve's history and tube), then
    a two-process gloo world on cuda:0 (TOMS against P = 1, ShardedAtMgrit(64)
    against the serial AtMgrit(64), the varying-coarsening golden and
    dd_toms129 against the JAX package's history), every rank's history
    equal to rank 0's."""
    import datetime
    import torch
    import torch.distributed as dist
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    t_phase = time.perf_counter()
    shard_env()

    # serial references, in this run; one TOMS problem serves the serial
    # solve and the P = 1 runs (the plain run sets its levels' ops)
    problem = build_problem(P, device=DEVICE, ops=DISPATCH, **TOMS)
    ms = P.Mgrit(problem=problem, tol=MAIN_TOL, max_iter=MAIN_MAX_ITER, logging_lvl=30)
    _, wall_serial = synced_wall(ms.solve_compiled)
    h_serial, tube_serial = ms.conv[1:ms.solve_iter + 1].copy(), ms.u[0]
    floor = residual_floor(ms)
    check(ms._condensed0, "shard: the serial TOMS solve declined the condensed carry")
    del ms
    ma = P.AtMgrit(TOMS2_AT_K, problem=build_problem(P, device=DEVICE, ops=DISPATCH, **TOMS2),
                   tol=1e-300, max_iter=TOMS2_AT_ITERS, logging_lvl=30)
    ma.solve_compiled()
    h_at, floor_at = ma.conv[1:ma.solve_iter + 1].copy(), residual_floor(ma)
    del ma
    torch.cuda.empty_cache()

    # P = 1: an NCCL world of one in this process
    toms = dict(tol=MAIN_TOL, max_iter=MAIN_MAX_ITER)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=SHARD_INIT_S))
        try:
            mesh = PP.make_time_space_mesh()
            one = {}
            # the first run (untimed) pays the communicator's and the
            # wrappers' first calls
            for label, ops, entry in (("warm", DISPATCH, "solve_compiled"),
                                      ("compiled", DISPATCH, "solve_compiled"),
                                      ("solve", DISPATCH, "solve"),
                                      ("plain", PLAIN, "solve_compiled")):
                for p in problem:
                    p.ops = ops
                one[label] = shard_run(mesh, lambda: problem, entry=entry, **toms)
                if label == "warm":
                    lat1 = comm_latency(mesh.group)
                if label == "compiled":
                    tube = one[label]["mg"].fine_solution()
                    check(tuple(tube.shape) == tuple(tube_serial.shape),
                          f"shard: fine_solution {tuple(tube.shape)} against the serial "
                          f"{tuple(tube_serial.shape)}")
                    tube_err = float((tube - tube_serial).abs().max()) \
                        / float(tube_serial.abs().max())
                    del tube
                del one[label]["mg"]
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    del tube_serial, problem
    torch.cuda.empty_cache()
    c1, s1, p1 = one["compiled"], one["solve"], one["plain"]
    hk = c1["hist"]
    ok_serial, err_serial = histories_agree(hk, h_serial, floor, MAIN_RTOL)
    ok_plain, err_plain = histories_agree(hk, p1["hist"], floor, MAIN_RTOL)
    ok_entry, err_entry = histories_agree(s1["hist"], hk, floor, MAIN_RTOL)
    ok_tube = tube_err <= SHARD_TUBE_RTOL
    ok1 = ok_serial and ok_plain and ok_entry and ok_tube
    print(f"[shard] P = 1 ({c1['backend']}, staged {c1['staged']}) TOMS {TOMS['nx']}^2 "
          f"nt={TOMS['nt']} ms={TOMS['ms']} ShardedMgrit: {hk.size} iterations, history "
          f"{[float(f'{h:.6e}') for h in hk]} | vs the serial condensed history max diff "
          f"{err_serial:.3e} (rtol {MAIN_RTOL:.0e}, atol floor {floor:.2e}); vs plain (GPU) "
          f"{err_plain:.3e}; solve vs solve_compiled {err_entry:.3e}, bit for bit "
          f"{np.array_equal(s1['hist'], hk)}; fine_solution vs the serial tube max rel "
          f"{tube_err:.3e} (rtol {SHARD_TUBE_RTOL:.0e}) | {'ok' if ok1 else 'FAIL'}")
    print(f"[shard] P = 1 walls: sharded solve_compiled {c1['wall']:.4f} s (setup {c1['setup']:.4f}), "
          f"solve {s1['wall']:.4f} s, plain {p1['wall']:.4f} s; serial condensed solve_compiled "
          f"{wall_serial:.4f} s | launches (setup + solve) {fmt_counts(c1['launches'], SPECTRAL_KERNELS)} "
          f"| per iteration {c1['comm']['ops']:.1f} collectives, {c1['comm']['bytes']:.0f} bytes "
          f"moved, {c1['comm']['staged']:.0f} staged | peak device memory {c1['peak']:.3f} GiB "
          f"| {card}")
    check(all(c1["launches"][k] > 0 for k in SPECTRAL_KERNELS),
          f"shard: a kernel of the path never ran at P = 1: {c1['launches']}")
    check(ok_serial, f"shard: P = 1 history {hk} against the serial {h_serial}")
    check(ok_plain, f"shard: P = 1 kernel history {hk} against plain {p1['hist']}")
    check(ok_entry, f"shard: solve {s1['hist']} against solve_compiled {hk}")
    check(ok_tube, f"shard: fine_solution off the serial tube by {tube_err:.3e}")

    # P = 2: two gloo processes on cuda:0
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = shard_world(tmp)
        world_s = time.perf_counter() - t0
    refs = {"toms": (hk, floor, MAIN_RTOL, "P = 1"),
            "at64": (h_at, floor_at, MAIN_RTOL, "the serial AtMgrit(64)"),
            "varying": (SHARD_VARYING_GOLDEN, 1e-15, SHARD_GOLDEN_RTOL, "the reference golden")}
    needed = {"toms": SPECTRAL_KERNELS, "at64": ("affine_windows",), "varying": ("cpoint_combine", "indexed_combine"),
              "dd_toms129": ("dd_interval_affine", "dd_theta_chain", "dd_arith",
                             "residual_row_norms")}
    for label, _, _ in shard_cases(P):
        rs = [r[label] for r in ranks]
        h = rs[0]["hist"]
        same = all(np.array_equal(r["hist"], h) for r in rs)
        if label == "dd_toms129":
            above = DD_TOMS_FLOOR_FROM
            ok_r, err = histories_agree(h[:above], DD_TOMS_JAX[:above], DD_ATOL, DD_RTOL)
            fl, fl_j = h[above:], DD_TOMS_JAX[above:]
            ok_r = ok_r and h.size == DD_TOMS_JAX.size and bool(
                np.all(fl >= DD_FLOOR_MIN) and np.all(fl <= DD_FLOOR_FACTOR * fl_j.max())
                and np.all(fl >= fl_j.min() / DD_FLOOR_FACTOR))
            vs = (f"vs DD_TOMS_JAX max diff {err:.3e} above the floor (rtol {DD_RTOL:.0e}, atol "
                  f"{DD_ATOL:.1e}), floor {[float(f'{x:.4e}') for x in fl]}")
            for r in rs:
                check_dd_counts(f"shard dd_toms129 rank", r["launches"], needed[label])
        else:
            ref, atol, rtol, name = refs[label]
            ok_r, err = histories_agree(h, ref, atol, rtol)
            vs = f"vs {name} max diff {err:.3e} (rtol {rtol:.0e}, atol {atol:.2e})"
        names = needed[label]
        print(f"[shard] P = {SHARD_P} ({rs[0]['backend']}, staged {rs[0]['staged']}) {label}: "
              f"{h.size} iterations, history {[float(f'{x:.6e}') for x in h]} | ranks equal bit for "
              f"bit {same} | {vs} | walls (problem + setup + solve) "
              + "; ".join(f"rank {i} {r['build']:.3f} + {r['setup']:.3f} + {r['wall']:.4f} s"
                          for i, r in enumerate(rs))
              + " | launches " + "; ".join(f"rank {i} {fmt_counts(r['launches'], names)}"
                                          for i, r in enumerate(rs))
              + " | per iteration " + "; ".join(
                  f"rank {i} {r['comm']['ops']:.1f} collectives, {r['comm']['bytes']:.0f} bytes "
                  f"moved, {r['comm']['staged']:.0f} staged" for i, r in enumerate(rs))
              + " | peak device memory " + ", ".join(f"{r['peak']:.3f}" for r in rs)
              + f" GiB | {'ok' if same and ok_r else 'FAIL'} | {card}")
        check(same, f"shard {label}: the ranks' histories differ: {[r['hist'] for r in rs]}")
        check(ok_r, f"shard {label}: history {h} {vs}")
        check(all(all(r["launches"][k] > 0 for k in names) for r in rs),
              f"shard {label}: a kernel of the path never ran on a rank: "
              f"{[r['launches'] for r in rs]}")
        check(all(r["staged"] and r["comm"]["staged"] > 0 for r in rs),
              f"shard {label}: the gloo ranks on the card staged nothing")
    print(f"[shard] collectives, ms a call (50 calls between synchronisations): P = 1 "
          f"({c1['backend']}) {fmt_latency(lat1)}; P = {SHARD_P} ({ranks[0]['toms']['backend']}, "
          f"staged {ranks[0]['toms']['staged']}) " + "; ".join(f"rank {i} {fmt_latency(r['latency'])}"
                                  for i, r in enumerate(ranks)) + f" | {card}")
    print(f"[shard] P = {SHARD_P} world (spawn, CUDA start, four cases) {world_s:.1f} s; "
          f"phase {time.perf_counter() - t_phase:.1f} s | {card}")


# ---------------------------------------------------------------------------
# [space]: the sharded executor on a ('time', 'space') mesh
# ---------------------------------------------------------------------------

# a four-process gloo world on cuda:0 at (2, 2); widths of 130 (interior
# 128: two slabs of 64 coefficient rows, or of 65 field rows; the TOMS
# width 129 does not split in two, as in the JAX package); each case also
# at (2, 1) (ranks 0 and 1), with the plain versions at (2, 2), and
# serially on rank 0
SPACE_MESH = (2, 2)
SPACE_TOMS = dict(nx=130, nt=2 ** 14 + 1, ms=(32, 16, 4, 4))
SPACE_PHYS = dict(nx=130, nt=2 ** 11 + 1, ms=(32, 16, 4))         # CN_CFG's cut
SPACE_AT = dict(nx=130, nt=2 ** 14 + 1, ms=(8,))                  # TOMS2 at width 130
# Heat2D FE at width 130 (K7's halo mode): t_end 2^-13, so that the
# coarsest dt (16 fine steps, 7.6e-6) is half FE's bound dx^2 / (4 a) =
# 1.50e-5; no nested iteration, to MAIN_TOL (two iterations on the CPU)
SPACE_FE = dict(basis="physical", method="FE", nx=130, nt=257, ms=(4, 4), t_end=2.0 ** -13)
SPACE_FE_MAX_ITER = 4
# spectral DD at width 130 (K23 / K24 on the slabs' DD tables, K3's squares
# mode on K25's float32 resid rows): dd_toms129's hierarchy cut in nt
# (16385 -> 4097, three levels) and iterations (14 -> 4, tol 0)
SPACE_DD = dict(basis="spectral", precision="dd", nx=130, nt=2 ** 12 + 1, ms=(32, 16, 4))
SPACE_DD_ITERS = 4
# an application without a space axis, run whole on every space rank:
# the [spatial1d] example (Heat1D 17 / 9 / 5 / 5, GridTransferHeat)
SPACE_REPLICATED = dict(build="spatial1d", nx=17, nt=129)
# the physical cell's history at (2, 2) with kernels as the pencil route
# gave it when K7 ran on the slab widened by ghost rows; K7's halo mode
# takes the same operations on the same values, so it stays bit for bit
SPACE_PHYSICAL_HISTORY = tuple(float.fromhex(x) for x in (
    "0x1.61d8adb17bcf3p-3", "0x1.b44e6c1f7c7edp-7", "0x1.1c2e837a1c667p-10",
    "0x1.7b83c9dff500ep-14", "0x1.011928b0d893cp-17", "0x1.5f8948c13ef87p-21",
    "0x1.e34880f999680p-25", "0x1.4c6e658d81e66p-28", "0x1.c5338ae702c1bp-32",
    "0x1.2ca2ecdea3cf9p-35"))
# the cells whose fine tube is compared with the (2, 1) run's, bit for bit
# (a SHA-1 of each rank's tube)
SPACE_DIGEST = ("fe", "dd_spectral", "replicated")
# the periodic models' cells (each at (2, 2) and (2, 1), and serially on
# rank 0), at full width, cut in nt with the step size kept and in
# iterations: Allen-Cahn IMEX (bench.py's row, AC_BENCH: 8/8, nt 4097 ->
# 1025, five iterations -> 3; also with the plain versions at (2, 2)),
# Gray-Scott AtMgrit(8) IMEX (GS_AT: 16/4, nt 16385 -> 4097, 12 iterations
# -> 2), Gray-Scott IMPL (GS_IMPL: nt 33 -> 17, 10 iterations -> 2),
# Burgers2D 64^2 (BURGERS_2D: 10 iterations -> 2) and Allen-Cahn CN
# (AC_CN: nt 33 -> 17, 10 iterations -> 2).  Two iterations, so that each
# cell runs a correction cycle after the first (at nt 9 Burgers2D's two
# coarse intervals are exact after one).  The three Newton-Krylov cells
# stage 4500-7500 collectives an iteration through the host and took 12-50
# s a rank each at (2, 2): cut so that the script stays inside its time
# limit
SPACE_AC = dict(AC_BENCH, model="AllenCahn", nt=1025, t_stop=AC_BENCH["t_stop"] / 4, max_iter=3)
SPACE_GS_AT = dict(GS_AT, model="GrayScott2D", nt=2 ** 12 + 1, t_stop=GS_AT["t_stop"] / 4,
                   max_iter=2)
SPACE_GS_IMPL = dict(GS_IMPL, model="GrayScott2D", nt=17, t_stop=GS_IMPL["t_stop"] / 2,
                     max_iter=2)
SPACE_B2 = dict(BURGERS_2D, model="Burgers2D", max_iter=2)
SPACE_AC_CN = dict(AC_CN, model="AllenCahn", nt=17, t_stop=AC_CN["t_stop"] / 2, max_iter=2)
SPACE_INIT_S, SPACE_JOIN_S = 300, 900     # rendezvous and collective timeout, the world's limit
SPACE_REPS = 50


def space_cases():
    """(label, problem configuration, solver arguments, AT window or None,
    whether the plain versions run at (2, 2) too)."""
    heat = [
        ("toms", dict(basis="spectral", **SPACE_TOMS), dict(tol=MAIN_TOL, max_iter=MAIN_MAX_ITER),
         None, True),
        ("physical", dict(basis="physical", **SPACE_PHYS),
         dict(tol=MAIN_TOL, max_iter=MAIN_MAX_ITER), None, True),
        ("at64", dict(basis="spectral", **SPACE_AT),
         dict(tol=1e-300, max_iter=TOMS2_AT_ITERS), TOMS2_AT_K, True),
        ("fe", SPACE_FE, dict(tol=MAIN_TOL, max_iter=SPACE_FE_MAX_ITER, nested_iteration=False),
         None, True),
        ("dd_spectral", SPACE_DD, dict(tol=0.0, max_iter=SPACE_DD_ITERS), None, False),
        ("replicated", SPACE_REPLICATED, {}, None, False),
    ]
    periodic = [("ac_imex", SPACE_AC, True), ("gs_at8", SPACE_GS_AT, False),
                ("gs_impl", SPACE_GS_IMPL, False), ("burgers2d", SPACE_B2, False),
                ("ac_cn", SPACE_AC_CN, False)]
    return heat + [(label, cfg, dict(tol=cfg["tol"], max_iter=cfg["max_iter"]), cfg.get("k"),
                    plain) for label, cfg, plain in periodic]


def space_problem(P, cfg, ops):
    """A [space] cell's problem: Heat2D (``build_problem``), a periodic
    model's hierarchy (``level_problems``) or the [spatial1d] example's."""
    if cfg.get("build") == "spatial1d":
        return heat1d_spatial_problem(P, ops)
    if "model" not in cfg:
        return build_problem(P, device=DEVICE, ops=ops, **cfg)
    return level_problems(P, cfg["model"], cfg, ops,
                          **{k: cfg[k] for k in ("nx", "method", "nu") if k in cfg})


def space_transfer(P, cfg):
    """A [space] cell's transfer arguments: the [spatial1d] example's
    GridTransferHeat, else none (a transfer object a solve)."""
    if cfg.get("build") != "spatial1d":
        return {}
    return {"transfer": [P.GridTransferHeat(), P.GridTransferHeat(), P.GridTransferCopy()]}


def tube_digest(tube):
    """The SHA-1 of a tube's bytes (two tubes compared bit for bit)."""
    import hashlib
    return hashlib.sha1(tube.contiguous().cpu().numpy().tobytes()).hexdigest()


def tube_values(tube):
    """A tube's values in float64: a packed DD tube (nt, 2, ...) as hi + lo."""
    import torch
    if tube.dtype == torch.float32 and tube.dim() > 1 and tube.shape[1] == 2:
        return tube[:, 0].double() + tube[:, 1].double()
    return tube


def space_latency(mesh, reps=SPACE_REPS):
    """ms a call of the space group's two operations on the card, each over
    ``reps`` calls between two synchronisations: an all_to_all of one state's
    pencil exchange at width 130 (64 x 64 values to and from the other rank)
    and a row halo of one 130-point row each way."""
    import torch
    from pymgrit_tpu_torch.parallel.comm import Comm
    comm = Comm(mesh.space_group, DEVICE)
    half = (SPACE_TOMS["nx"] - 2) // mesh.n_space
    x = torch.zeros(mesh.n_space * half * half, dtype=torch.float64, device=DEVICE)
    sizes = [half * half] * mesh.n_space
    row = torch.zeros(SPACE_TOMS["nx"], dtype=torch.float64, device=DEVICE)
    out = {}
    for name, fn in (("all_to_all", lambda: comm.all_to_all(x, sizes, sizes)),
                     ("row_halo", lambda: comm.row_halo(row, row))):
        fn()
        _, wall = synced_wall(lambda: [fn() for _ in range(reps)])
        out[name] = 1e3 * wall / reps
    return out


def space_worker(rank, size, store, directory):
    """A rank of the [space] world: for each case of ``space_cases`` the
    (2, 2) run with kernels (then ``fine_solution``, collective), the same
    problem with the plain versions, the (2, 1) run on ranks 0 and 1 and,
    on rank 0, the serial solve on the (2, 1) run's problem against which
    its fine solution is held; its results pickled into ``directory`` (a
    traceback there if it raised).  The problem's wall is the build of the
    first run's problem (0 for a problem built before)."""
    import datetime
    import pickle
    import traceback
    import torch
    import torch.distributed as dist
    import pymgrit_tpu_torch as P
    import pymgrit_tpu_torch.parallel as PP
    from pymgrit_tpu_torch.ops import DISPATCH, PLAIN
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=SPACE_INIT_S))
    try:
        grid = PP.make_time_space_mesh(*SPACE_MESH)
        time_only = PP.make_time_space_mesh(SPACE_MESH[0])
        out = {"latency": space_latency(grid)}
        for label, cfg, kw, k, with_plain in space_cases():
            res, built = {}, {}

            def build(key, ops):
                """The case's problem: one for the (2, 2) runs (the plain run
                sets its levels' ops), one whole-state for (2, 1) and the
                serial solve."""
                if key not in built:
                    built[key] = space_problem(P, cfg, ops)
                for p in built[key]:
                    p.ops = ops
                return built[key]

            dist.barrier()                  # the ranks start each case together
            for run, mesh, key, ops in (("kernel", grid, "grid", DISPATCH),
                                        ("plain", grid, "grid", PLAIN),
                                        ("time", time_only, "whole", DISPATCH)):
                if mesh is None or (run == "plain" and not with_plain):
                    continue
                r = shard_run(mesh, lambda: build(key, ops), k=k, **kw,
                              **space_transfer(P, cfg))
                if run == "kernel":
                    tube = r["mg"].fine_solution()
                    res["tube_shape"] = tuple(tube.shape)
                    if label in SPACE_DIGEST:
                        r["digest"] = tube_digest(tube)
                    if rank != 0:
                        del tube
                elif run == "time" and label in SPACE_DIGEST:
                    r["digest"] = tube_digest(r["mg"].fine_solution())
                if run == "plain" or (run == "kernel" and not with_plain):
                    del built["grid"]
                del r["mg"]
                torch.cuda.empty_cache()
                res[run] = r
            if rank == 0:
                problem = built.pop("whole")
                tkw = space_transfer(P, cfg)
                ms = (P.AtMgrit(k, problem=problem, logging_lvl=30, **kw) if k else
                      P.Mgrit(problem=problem, logging_lvl=30, **kw, **tkw))
                _, wall = synced_wall(ms.solve_compiled)
                ref = ms.u[0]
                floor = (DD_ATOL if cfg.get("precision") == "dd"
                         else residual_floor(ms, 4 * math.sqrt(cfg["nx"]) + FLOOR_OPS)
                         if "model" in cfg else physical_floor(ms)
                         if cfg.get("basis") == "physical" else residual_floor(ms))
                val, ref = tube_values(tube), tube_values(ref)
                res["serial"] = dict(
                    hist=ms.conv[1:ms.solve_iter + 1].copy(), wall=wall, floor=floor,
                    tube_err=float((val - ref).abs().max()) / float(ref.abs().max()),
                    finite=bool(torch.isfinite(val).all()))
                del val
                del ms, problem, ref, tube
                torch.cuda.empty_cache()
            out[label] = res
        tmp = os.path.join(directory, f".rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(out, f)
        os.replace(tmp, os.path.join(directory, f"rank{rank}.pkl"))
    except BaseException:
        with open(os.path.join(directory, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def fmt_comm(c):
    if c is None:
        return "no group (replicated)"
    return f"{c['ops']:.1f} ops, {c['bytes']:.0f} B moved, {c['staged']:.0f} B staged"


_PENCIL = ("sine_solve1d transform", "sine_solve1d be lam table")
SPACE_NEEDED = {
    "toms": ("interval_affine", "theta_chain", "residual_row_norms", "cpoint_combine"),
    "physical": ("theta_rhs2d", "sine_solve1d", "interval_affine", "residual_row_norms",
                 "cpoint_combine"),
    "at64": ("interval_affine", "affine_windows", "residual_row_norms", "cpoint_combine"),
    "ac_imex": ("allen_cahn_pointwise", "sine_solve1d", "residual_row_norms", "cpoint_combine"),
    "gs_at8": ("gray_scott_pointwise", "sine_solve1d", "residual_row_norms", "cpoint_combine"),
    "gs_impl": ("gray_scott_pointwise", "sine_solve1d", "residual_row_norms"),
    "burgers2d": ("burgers2d_pointwise", "sine_solve1d", "residual_row_norms"),
    "ac_cn": ("allen_cahn_pointwise", "sine_solve1d", "residual_row_norms"),
    "fe": ("theta_rhs2d", "residual_row_norms", "cpoint_combine"),
    "dd_spectral": ("dd_interval_affine", "dd_theta_chain", "dd_arith", "residual_row_norms"),
    "replicated": SPATIAL1D_KERNELS,
}
# the launches [space] prints a rank: K1-K7, K9-K11, K14, K15, K18-K20, K23-K25
SPACE_PRINTED = ("interval_affine", "theta_chain", "residual_row_norms", "cpoint_combine",
                 "sine_solve2d", "sine_affine2d", "theta_rhs2d", "affine_windows", "sine_solve1d",
                 "periodic_solve2d", "allen_cahn_pointwise", "gray_scott_pointwise",
                 "burgers2d_pointwise", "restrict_combine", "interpolate_combine",
                 "dd_interval_affine", "dd_theta_chain", "dd_arith")
SPACE_MODES = {"toms": ("residual_row_norms squares",),
               "physical": ("residual_row_norms squares", "theta_rhs2d halo", *_PENCIL),
               "at64": ("residual_row_norms squares",),
               "ac_imex": ("residual_row_norms squares", "allen_cahn_pointwise prologue", *_PENCIL),
               "gs_at8": ("residual_row_norms squares", "gray_scott_pointwise prologue", *_PENCIL),
               "gs_impl": ("residual_row_norms squares", "gray_scott_pointwise halo", *_PENCIL),
               "burgers2d": ("residual_row_norms squares", "burgers2d_pointwise halo", *_PENCIL),
               "ac_cn": ("residual_row_norms squares", "allen_cahn_pointwise halo", *_PENCIL),
               "fe": ("residual_row_norms squares", "theta_rhs2d halo"),
               "dd_spectral": ("residual_row_norms squares float32",),
               "replicated": ()}
# what a space shard must never launch: the whole-state kernels and modes
SPACE_WHOLE = ("sine_solve2d", "sine_affine2d", "periodic_solve2d")
SPACE_WHOLE_MODES = ("allen_cahn_pointwise whole", "gray_scott_pointwise whole",
                     "burgers2d_pointwise whole", "theta_rhs2d whole")
# the summary's launches of the periodic slabs' kernel modes: (row, [space]
# cell, mode) on rank 0
SPACE_ROW_LAUNCHES = (("allen_cahn_pointwise_halo", "ac_cn", "allen_cahn_pointwise halo"),
                      ("allen_cahn_pointwise_prologue", "ac_imex", "allen_cahn_pointwise prologue"),
                      ("gray_scott_pointwise_halo", "gs_impl", "gray_scott_pointwise halo"),
                      ("gray_scott_pointwise_prologue", "gs_at8", "gray_scott_pointwise prologue"),
                      ("burgers2d_pointwise_halo", "burgers2d", "burgers2d_pointwise halo"),
                      ("sine_solve1d_hartley", "ac_imex", "sine_solve1d transform"),
                      ("sine_solve1d_hartley_lam_table", "gs_at8", "sine_solve1d be lam table"),
                      ("theta_rhs2d_halo_fe", "fe", "theta_rhs2d halo"))


def fmt_stats(stats, iters):
    """Newton and Krylov totals of level 0 and of all levels, and per
    iteration."""
    if not stats:
        return "no Newton"
    kry = next(k for k in stats[0] if k not in ("steps", "newton") and not k.endswith("_max"))
    tot = {k: sum(s[k] for s in stats) for k in ("steps", "newton", kry)}
    return (f"steps {tot['steps']}, Newton {tot['newton']} ({tot['newton'] / iters:.1f} an "
            f"iteration), {kry} {tot[kry]} ({tot[kry] / iters:.1f} an iteration; level 0 "
            f"{stats[0][kry]}, max a step {max(s[kry + '_max'] for s in stats)})")


def phase_space(card):
    """The sharded executor on a ('time', 'space') mesh: a four-process gloo
    world on cuda:0 at (2, 2) runs spectral TOMS at width 130, the physical
    basis (BE, the pencil route: K7 on ghost rows, K20 with its lam table,
    all_to_all) at CN_CFG's depth and spectral ShardedAtMgrit(64); each held
    against the same case at (2, 1), against the serial solve (history and
    fine tube) and against the plain versions on the same world; every
    rank's history equal to rank 0's; walls, peak memory at n_space 2 and 1,
    launches and communication a rank.  Then the periodic models' cells
    (``space_cases``: Allen-Cahn IMEX and CN, Gray-Scott AtMgrit(8) IMEX and
    IMPL, Burgers2D; the Hartley pencil on K20, K11/K14/K15 in their halo
    and prologue modes), each against (2, 1) (history and every rank's
    Newton and Krylov counts) and the serial solve, Allen-Cahn IMEX also
    against the plain versions at (2, 2), with the Newton-Krylov counts and
    the collectives per iteration.  Then Heat2D FE (K7's halo mode; plain
    at (2, 2) too; below MAIN_TOL within 4 iterations), spectral DD (K23,
    K24, K25 and K3's float32 squares mode; no float64 kernel) and an
    application without a space axis, run replicated (the [spatial1d]
    example: every rank its (2, 1) time shard's history and time-group
    collectives, bit for bit, and no space group); the fine tubes of these
    three equal to the (2, 1) tubes bit for bit, and the physical cell's
    history bit for bit that of the widened-slab route it had before K7's
    halo mode.  Returns the launches of K3's squares mode (toms), K20's lam
    table (physical) and the slabs' kernel modes (``SPACE_ROW_LAUNCHES``)."""
    t_phase = time.perf_counter()
    shard_env()
    size = SPACE_MESH[0] * SPACE_MESH[1]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = shard_world(tmp, space_worker, size, SPACE_JOIN_S, "space")
        world_s = time.perf_counter() - t0
    grid = f"({SPACE_MESH[0]}, {SPACE_MESH[1]})"
    S_ = SPACE_MESH[1]
    for label, cfg, kw, k, with_plain in space_cases():
        rs = [r[label] for r in ranks]
        kern = [r["kernel"] for r in rs]
        h = kern[0]["hist"]
        same = all(np.array_equal(r["hist"], h) for r in kern)
        t_only = [r["time"] for r in rs if "time" in r]
        same_t = all(np.array_equal(r["hist"], t_only[0]["hist"]) for r in t_only)
        ser = rs[0]["serial"]
        dd_cell = cfg.get("precision") == "dd"
        replicated = label == "replicated"
        floor, rtol = (DD_ATOL, DD_RTOL) if dd_cell else (ser["floor"], MAIN_RTOL)
        ok_t, err_t = histories_agree(h, t_only[0]["hist"], floor, rtol)
        ok_s, err_s = histories_agree(h, ser["hist"], floor, rtol)
        ok_p, err_p = (histories_agree(h, rs[0]["plain"]["hist"], floor, rtol) if with_plain
                       else (True, float("nan")))
        n = cfg["nx"]
        if replicated:
            want_shape = (cfg["nt"], n - 2)
        elif "model" in cfg:
            want_shape = (cfg["nt"],) + ((n, n) if cfg["model"] == "AllenCahn" else (2, n, n))
        else:
            want_shape = (cfg["nt"],) + ((n, n) if cfg["basis"] == "physical" else
                                         (2, n - 2, n - 2) if dd_cell else (n - 2, n - 2))
        tube_rtol = DD_RTOL if dd_cell else SHARD_TUBE_RTOL
        ok_tube = (ser["tube_err"] <= tube_rtol and ser["finite"]
                   and all(r["tube_shape"] == want_shape for r in rs))
        names, modes = SPACE_NEEDED[label], SPACE_MODES[label]
        ok_launch = all(all(r["launches"][x] > 0 for x in names)
                        and all(r["modes"][x] > 0 for x in modes)
                        and all(r["launches"][x] == 0 for x in SPACE_WHOLE)
                        and all(r["modes"][x] == 0 for x in SPACE_WHOLE_MODES)
                        and not (dd_cell and any(r["launches"][x] for x in DD_FORBIDDEN))
                        for r in kern)
        ok_plain = all(sum(r["plain"]["launches"].values()) == 0 for r in rs if "plain" in r)
        # every shard of a time shard takes its lanes' Newton and Krylov
        # iterations, those of the (2, 1) run's time shard
        ok_stats = all(r["stats"] == t_only[i // S_]["stats"] for i, r in enumerate(kern))
        ok_stage = all((r["space_comm"] is None if replicated else r["space_comm"]["staged"] > 0)
                       and r["comm"]["staged"] > 0 for r in kern)
        # the slice's own checks: a replicated run is its time shard's, bit
        # for bit, with its collectives (none on the space group); the FE,
        # DD and replicated tubes are the (2, 1) tube bit for bit; the
        # physical cell keeps its history; FE converges within its cut
        ok_own, own = True, []
        if replicated:
            ok_rep = all(np.array_equal(r["hist"], t_only[i // S_]["hist"])
                         and r["comm"] == t_only[i // S_]["comm"] for i, r in enumerate(kern))
            ok_own &= ok_rep
            own.append(f"every rank's history and time-group collectives its (2, 1) time "
                       f"shard's, bit for bit: {ok_rep}; space group: no collective "
                       f"(no space Comm on any rank: {all(r['space_comm'] is None for r in kern)})")
        if label in SPACE_DIGEST:
            ok_dig = len({r["digest"] for r in kern + t_only}) == 1
            ok_own &= ok_dig
            own.append(f"fine tube equal to the (2, 1) tube bit for bit (SHA-1, every rank): "
                       f"{ok_dig}")
        if label == "physical":
            ok_hist = h.shape == (len(SPACE_PHYSICAL_HISTORY),) and all(
                a == b for a, b in zip(h, SPACE_PHYSICAL_HISTORY))
            ok_own &= ok_hist
            own.append(f"history equal bit for bit to the widened-slab route's: {ok_hist}")
        if label == "fe":
            ok_conv = h.size <= SPACE_FE_MAX_ITER and h[-1] < kw["tol"]
            ok_own &= ok_conv
            own.append(f"below tol {kw['tol']:.0e} within {SPACE_FE_MAX_ITER} iterations: "
                       f"{ok_conv}")
        if dd_cell:
            own.append("no float64 kernel launched (" + ", ".join(DD_FORBIDDEN) + "): "
                       + str(not any(r["launches"][x] for r in kern for x in DD_FORBIDDEN)))
        ok = same and same_t and ok_t and ok_s and ok_p and ok_tube and ok_launch and ok_plain \
            and ok_stage and ok_stats and ok_own
        what = f"AtMgrit({k})" if k else "Mgrit"
        print(f"[space] {label} {cfg} {grid} ({kern[0]['backend']}, staged {kern[0]['staged']}): "
              f"{h.size} iterations, history "
              f"{[float(f'{x:.6e}') for x in h]} | ranks equal bit for bit {same} ((2, 1): "
              f"{same_t}) | vs (2, 1) max diff {err_t:.3e}, vs the serial {what} {err_s:.3e}, vs "
              f"plain {grid} " + (f"{err_p:.3e}" if with_plain else "not run") +
              f" (rtol {rtol:.0e}, atol floor {floor:.2e}) | Newton/Krylov counts equal to "
              f"(2, 1)'s: {ok_stats} | "
              f"fine_solution {rs[0]['tube_shape']} vs the serial tube max rel "
              f"{ser['tube_err']:.3e} (rtol {tube_rtol:.0e}) | {'ok' if ok else 'FAIL'} "
              f"| {card}")
        if own:
            print(f"[space] {label} {grid}: " + "; ".join(own) + f" | {card}")
        print(f"[space] {label} walls (problem + setup + solve) {grid}: "
              + "; ".join(f"rank {i} {r['build']:.3f} + {r['setup']:.3f} + {r['wall']:.4f} s"
                          for i, r in enumerate(kern))
              + f" | (2, 1): " + "; ".join(f"rank {i} {r['build']:.3f} + {r['setup']:.3f} + "
                                           f"{r['wall']:.4f} s" for i, r in enumerate(t_only))
              + (f" | plain {grid} rank 0 {rs[0]['plain']['wall']:.4f} s" if with_plain else "")
              + f" | serial {ser['wall']:.4f} s | {card}")
        print(f"[space] {label} peak device memory a rank (GiB, above the start): n_space 2 "
              + ", ".join(f"{r['peak']:.3f}" for r in kern) + "; n_space 1 (2, 1) "
              + ", ".join(f"{r['peak']:.3f}" for r in t_only)
              + f" | launches (setup + solve) " + "; ".join(
                  f"rank {i} {fmt_counts(r['launches'], SPACE_PRINTED)}"
                  f", {fmt_counts(r['modes'], modes)}" for i, r in enumerate(kern))
              + f" | per iteration, time group: " + "; ".join(
                  f"rank {i} {fmt_comm(r['comm'])}" for i, r in enumerate(kern))
              + "; space group: " + "; ".join(
                  f"rank {i} {fmt_comm(r['space_comm'])}" for i, r in enumerate(kern))
              + f" | {card}")
        if "model" in cfg:
            print(f"[space] {label} Newton-Krylov a rank {grid}: " + "; ".join(
                f"rank {i} {fmt_stats(r['stats'], h.size)}" for i, r in enumerate(kern))
                + f" | (2, 1): " + "; ".join(f"rank {i} {fmt_stats(r['stats'], h.size)}"
                                           for i, r in enumerate(t_only)) + f" | {card}")
        check(same and same_t, f"space {label}: the ranks' histories differ")
        # a periodic cell runs a correction cycle after its first
        check("model" not in cfg or h.size == cfg["max_iter"],
              f"space {label}: {h.size} iterations of {cfg.get('max_iter')}")
        check(ok_t and ok_s and ok_p, f"space {label}: history {h} against (2, 1) "
              f"{t_only[0]['hist']}, serial {ser['hist']}, plain "
              f"{rs[0]['plain']['hist'] if with_plain else 'not run'}")
        check(ok_tube, f"space {label}: fine_solution off the serial tube by {ser['tube_err']:.3e}")
        check(ok_launch, f"space {label}: a kernel of the path never ran on a rank, or a "
                         f"whole-state kernel ran: {[(r['launches'], r['modes']) for r in kern]}")
        check(ok_plain, f"space {label}: the plain run launched a kernel")
        check(ok_stats, f"space {label}: Newton/Krylov counts differ from (2, 1)'s: "
                        f"{[r['stats'] for r in kern]} vs {[r['stats'] for r in t_only]}")
        check(ok_stage, f"space {label}: the gloo ranks on the card staged nothing, or a "
                        "replicated run made a space group")
        check(ok_own, f"space {label}: " + "; ".join(own))
    print(f"[space] collectives, ms a call ({SPACE_REPS} calls between synchronisations), "
          f"space group {grid}: " + "; ".join(
              f"rank {i} {fmt_latency(r['latency'])}" for i, r in enumerate(ranks)) + f" | {card}")
    print(f"[space] world of {size} (spawn, CUDA start, {len(space_cases())} cases) "
          f"{world_s:.1f} s; phase {time.perf_counter() - t_phase:.1f} s | {card}")
    return {"residual_row_norms_squares": ranks[0]["toms"]["kernel"]["modes"][
                "residual_row_norms squares"],
            "sine_solve1d_lam_table": ranks[0]["physical"]["kernel"]["modes"][
                "sine_solve1d be lam table"],
            **{row: ranks[0][cell]["kernel"]["modes"][mode]
               for row, cell, mode in SPACE_ROW_LAUNCHES}}


REPLACES = {
    "interval_affine":("cuda", "pymgrit_tpu_torch/ops/csrc/interval_affine.cu",
                        "pymgrit_tpu/models/heat_2d.py:538"),
    "theta_chain": ("cuda", "pymgrit_tpu_torch/ops/csrc/theta_chain.cu",
                    "pymgrit_tpu/models/heat_2d.py:419"),
    "residual_row_norms": ("cuda", "pymgrit_tpu_torch/ops/csrc/residual_row_norms.cu",
                           "pymgrit_tpu/core/solver.py:1056"),
    "cpoint_combine": ("cuda", "pymgrit_tpu_torch/ops/csrc/indexed_combine.cu",
                       "pymgrit_tpu/core/solver.py:914"),
    "sine_solve2d": ("cuda", "pymgrit_tpu_torch/ops/csrc/sine_solve2d.cu",
                     "pymgrit_tpu/models/heat_2d.py:372"),
    "sine_affine2d": ("cuda", "pymgrit_tpu_torch/ops/csrc/sine_affine2d.cu",
                      "pymgrit_tpu/models/heat_2d.py:543"),
    "theta_rhs2d": ("cuda", "pymgrit_tpu_torch/ops/csrc/theta_rhs2d.cu",
                    "pymgrit_tpu/models/heat_2d.py:382"),
    "affine_prefix": ("cuda", "pymgrit_tpu_torch/ops/csrc/affine_prefix.cu",
                      "pymgrit_tpu/ops/prefix.py:41"),
    "affine_windows": ("cuda", "pymgrit_tpu_torch/ops/csrc/affine_windows.cu",
                       "pymgrit_tpu/core/at_mgrit.py:37"),
    "periodic_solve2d": ("cuda", "pymgrit_tpu_torch/ops/csrc/periodic_solve2d.cu",
                         "pymgrit_tpu/models/allen_cahn.py:82"),
    "allen_cahn_pointwise": ("cuda", "pymgrit_tpu_torch/ops/csrc/allen_cahn_pointwise.cu",
                             "pymgrit_tpu/models/allen_cahn.py:92"),
    "dopri45_arenstorf": ("cuda", "pymgrit_tpu_torch/ops/csrc/dopri45_arenstorf.cu",
                          "pymgrit_tpu/ops/runge_kutta.py:67"),
    "rk4_brusselator": ("cuda", "pymgrit_tpu_torch/ops/csrc/rk4_brusselator.cu",
                        "pymgrit_tpu/ops/runge_kutta.py:38"),
    "gray_scott_pointwise": ("cuda", "pymgrit_tpu_torch/ops/csrc/gray_scott_pointwise.cu",
                             "pymgrit_tpu/models/gray_scott_2d.py:102"),
    "burgers2d_pointwise": ("cuda", "pymgrit_tpu_torch/ops/csrc/burgers2d_pointwise.cu",
                            "pymgrit_tpu/models/burgers.py:121"),
    "burgers1d_newton": ("cuda", "pymgrit_tpu_torch/ops/csrc/burgers1d_newton.cu",
                         "pymgrit_tpu/models/burgers.py:53"),
    "circulant_solve1d": ("cuda", "pymgrit_tpu_torch/ops/csrc/circulant_solve1d.cu",
                          "pymgrit_tpu/models/advection_1d.py:41"),
    "restrict_combine": ("cuda", "pymgrit_tpu_torch/ops/csrc/restrict_combine.cu",
                         "pymgrit_tpu/models/grid_transfer_heat.py:94"),
    "interpolate_combine": ("cuda", "pymgrit_tpu_torch/ops/csrc/interpolate_combine.cu",
                            "pymgrit_tpu/models/grid_transfer_heat.py:98"),
    "sine_solve1d": ("cuda", "pymgrit_tpu_torch/ops/csrc/sine_solve1d.cu",
                     "pymgrit_tpu/models/heat_1d.py:235"),
    "indexed_combine": ("cuda", "pymgrit_tpu_torch/ops/csrc/indexed_combine.cu",
                        "pymgrit_tpu/core/solver.py:740"),
    "eig_step": ("cuda", "pymgrit_tpu_torch/ops/csrc/eig_step.cu",
                 "pymgrit_tpu/models/diffusion_2d.py:195"),
    "dd_interval_affine": ("cuda", "pymgrit_tpu_torch/ops/csrc/dd_interval_affine.cu",
                           "pymgrit_tpu/models/heat_2d.py:533"),
    "dd_theta_chain": ("cuda", "pymgrit_tpu_torch/ops/csrc/dd_theta_chain.cu",
                       "pymgrit_tpu/models/heat_2d.py:419"),
    "dd_arith": ("cuda", "pymgrit_tpu_torch/ops/csrc/dd_arith.cu", "pymgrit_tpu/ops/dd.py:270"),
    "dd_matmul": ("cuda", "pymgrit_tpu_torch/ops/csrc/dd_matmul.cu",
                  "pymgrit_tpu/ops/ozaki.py:129"),
    # the [space] path's two kernel modes: K3 without its root (the sharded
    # norm's sum, reduced over the space group before the root) and K20's
    # solve with a lam table (the physical solve's x-pass, 1 + dt Lam[i, j])
    "residual_row_norms_squares": ("cuda", "pymgrit_tpu_torch/ops/csrc/residual_row_norms.cu",
                                   "pymgrit_tpu/parallel/shard_solver.py:1135"),
    "sine_solve1d_lam_table": ("cuda", "pymgrit_tpu_torch/ops/csrc/sine_solve1d.cu",
                               "pymgrit_tpu/models/heat_2d.py:372"),
    # the periodic models' space slabs: K11, K14, K15 in their halo modes
    # (the stencils of a state split over 'space'), K11's and K14's IMEX
    # prologues and K20 on the Hartley basis (the pencil of the FFT solves)
    "allen_cahn_pointwise_halo": ("cuda", "pymgrit_tpu_torch/ops/csrc/allen_cahn_pointwise.cu",
                                  "pymgrit_tpu/models/allen_cahn.py:76"),
    "gray_scott_pointwise_halo": ("cuda", "pymgrit_tpu_torch/ops/csrc/gray_scott_pointwise.cu",
                                  "pymgrit_tpu/models/gray_scott_2d.py:71"),
    "burgers2d_pointwise_halo": ("cuda", "pymgrit_tpu_torch/ops/csrc/burgers2d_pointwise.cu",
                                 "pymgrit_tpu/models/burgers.py:102"),
    "allen_cahn_pointwise_prologue": ("cuda",
                                      "pymgrit_tpu_torch/ops/csrc/allen_cahn_pointwise.cu",
                                      "pymgrit_tpu/models/allen_cahn.py:126"),
    "gray_scott_pointwise_prologue": ("cuda",
                                      "pymgrit_tpu_torch/ops/csrc/gray_scott_pointwise.cu",
                                      "pymgrit_tpu/models/gray_scott_2d.py:96"),
    "sine_solve1d_hartley": ("cuda", "pymgrit_tpu_torch/ops/csrc/sine_solve1d.cu",
                             "pymgrit_tpu/models/allen_cahn.py:82"),
    "sine_solve1d_hartley_lam_table": ("cuda", "pymgrit_tpu_torch/ops/csrc/sine_solve1d.cu",
                                       "pymgrit_tpu/models/gray_scott_2d.py:83"),
    # Heat2D FE's space slabs: K7 in its halo mode (the neighbours' edge
    # rows as operands, the ring rows only at the grid's edge)
    "theta_rhs2d_halo_fe": ("cuda", "pymgrit_tpu_torch/ops/csrc/theta_rhs2d.cu",
                            "pymgrit_tpu/models/heat_2d.py:629"),
}


def main():
    card = phase_device()
    import torch
    phase_build()
    only = next((a.split("=", 1)[1].split(",") for a in sys.argv[1:]
                 if a.startswith("--kernels=")), None)
    if only is not None:
        # phase 3 for the named kernels alone: no path ran, no "ok"
        rows = phase_kernels(only)
        rows.update(phase_dd_kernels(only))
        print(json.dumps({"kernels": [dict(name=k, **rows[k]) for k in only if k in rows]}))
        print(card)
        print(json.dumps({"kernels_only": True, "device": {"platform": "gpu",
                                                           "kind": torch.cuda.get_device_name(0),
                                                           "count": torch.cuda.device_count()}}))
        return
    if "--profile" in sys.argv[1:]:
        # no checks ran: the last line says so and carries no "ok"
        profile_cells(card)
        print(card)
        print(json.dumps({"profile": True, "device": {"platform": "gpu",
                                                      "kind": torch.cuda.get_device_name(0),
                                                      "count": torch.cuda.device_count()}}))
        return
    clock = [time.perf_counter()]

    def lap(name):
        """Print the seconds a phase took (the run has a time limit: a
        later slice reads where it goes)."""
        now = time.perf_counter()
        print(f"[time] {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    rows = phase_kernels()
    lap("kernels")
    rows.update(phase_dd_kernels())
    lap("dd-kernels")
    phase_small()
    phase_pytree(card)
    lap("small, pytree")
    counts, h_spec, tube_spec = phase_main(card)
    counts_phys = phase_physical(card, h_spec, tube_spec)
    del tube_spec
    phase_cn_fe()
    lap("main, physical, cn, fe")
    phase_coarsest_dahlquist(card)
    prefix_counts, at_counts = phase_coarsest_toms(card)
    phase_coarsest_golden()
    lap("coarsest")
    counts_imex, counts_impl = phase_allen_cahn(card)
    counts_orbit, counts_bruss = phase_ode(card)
    lap("allen_cahn, ode")
    counts_gs = phase_gray_scott(card)
    counts_b1, counts_b2 = phase_burgers(card)
    counts_adv = phase_advection(card)
    lap("gray_scott, burgers, advection")
    counts_spatial = phase_spatial(card)
    phase_spatial1d(card)
    phase_c2(card)
    counts_ragged = phase_ragged(card)
    lap("spatial, spatial1d, c2, ragged")
    counts_bdf, _ = phase_bdf(card)
    counts_diffusion = phase_diffusion(card)
    counts_dd_toms, counts_dd65 = phase_dd(card)
    lap("bdf, diffusion, dd")
    phase_observe(card)
    lap("observe")
    phase_callback(card)
    lap("callback")
    phase_machine(card)
    lap("machine")
    phase_shard(card)
    lap("shard")
    counts_space = phase_space(card)
    lap("space")
    # launches: each kernel's count on the main path it belongs to (K3, K4
    # run on both bases; the spectral run's count is reported; K8 and K9
    # from the TOMS-width prefix and AT runs; K10 from the Allen-Cahn bench
    # row, K11 from the IMPL run, K12 from the Arenstorf run, K13 from the
    # Brusselator run, K14 from the Gray-Scott IMPL run, K15 from the
    # Burgers2D run, K16 from the deep Burgers1D run, K17 from the deep
    # advection run, K18 and K19 from the spatial65 run, K20 from the BDF
    # example's run, K21 from the ragged row, K22 from the deep diffusion
    # grid, K23-K25 from dd_toms129, K26 from dd65)
    launches = {**counts_phys, **{k: counts[k] for k in SPECTRAL_KERNELS},
                "affine_prefix": prefix_counts["affine_prefix"],
                "affine_windows": at_counts["affine_windows"],
                "periodic_solve2d": counts_imex["periodic_solve2d"],
                "allen_cahn_pointwise": counts_impl["allen_cahn_pointwise"],
                "dopri45_arenstorf": counts_orbit["dopri45_arenstorf"],
                "rk4_brusselator": counts_bruss["rk4_brusselator"],
                "gray_scott_pointwise": counts_gs["IMPL"]["gray_scott_pointwise"],
                "burgers2d_pointwise": counts_b2["burgers2d_pointwise"],
                "burgers1d_newton": counts_b1["burgers1d_newton"],
                "circulant_solve1d": counts_adv["circulant_solve1d"],
                **{k: counts_spatial[k] for k in TRANSFER_KERNELS},
                "sine_solve1d": counts_bdf["sine_solve1d"],
                "indexed_combine": counts_ragged["indexed_combine"],
                "eig_step": counts_diffusion["eig_step"],
                **{k: counts_dd_toms[k] for k in ("dd_interval_affine", "dd_theta_chain",
                                                  "dd_arith")},
                "dd_matmul": counts_dd65["dd_matmul"], **counts_space}
    kernels = [dict(name=name, route=route, source=source, replaces=replaces,
                    launches=launches[name], **rows[name])
               for name, (route, source, replaces) in REPLACES.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
