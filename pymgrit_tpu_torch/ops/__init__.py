"""Hand-written GPU kernels of the port and their plain PyTorch versions.

Twenty-six kernels carry the Heat2D paths (condensed level 0), the
coarsest-level strategies, the nonlinear models, spatial and non-uniform
coarsening, Diffusion2D, and the double-double precision mode:

* K1 ``interval_affine`` (CUDA C++, ``csrc/interval_affine.cu``)
* K2 ``theta_chain`` (CUDA C++, ``csrc/theta_chain.cu``)
* K3 ``residual_row_norms`` (CUDA C++, ``csrc/residual_row_norms.cu``, wrapper in
  ``row_norms``)
* K4 ``cpoint_combine`` (Triton)
* K5 ``sine_solve2d`` (CUDA C++, ``csrc/sine_solve2d.cu``)
* K6 ``sine_affine2d`` (CUDA C++, ``csrc/sine_affine2d.cu``)
* K7 ``theta_rhs2d`` (Triton)
* K8 ``affine_prefix`` (CUDA C++, ``csrc/affine_prefix.cu``)
* K9 ``affine_windows`` (CUDA C++, ``csrc/affine_windows.cu``)
* K10 ``periodic_solve2d`` (CUDA C++, ``csrc/periodic_solve2d.cu``)
* K11 ``allen_cahn_pointwise`` (Triton)
* K12 ``dopri45_arenstorf`` (CUDA C++, ``csrc/dopri45_arenstorf.cu``)
* K13 ``rk4_brusselator`` (Triton)
* K14 ``gray_scott_pointwise`` (Triton)
* K15 ``burgers2d_pointwise`` (Triton)
* K16 ``burgers1d_newton`` (CUDA C++, ``csrc/burgers1d_newton.cu``)
* K17 ``circulant_solve1d`` (CUDA C++, ``csrc/circulant_solve1d.cu``)
* K18 ``restrict_combine`` (CUDA C++, ``csrc/restrict_combine.cu``, wrapper in
  ``transfer``)
* K19 ``interpolate_combine`` (CUDA C++, ``csrc/interpolate_combine.cu``, wrapper in
  ``transfer``)
* K20 ``sine_solve1d`` (CUDA C++, ``csrc/sine_solve1d.cu``; BE and BDF2 modes)
* K21 ``indexed_combine`` (CUDA C++, ``csrc/indexed_combine.cu``, wrapper in
  ``indexed``)
* K22 ``eig_step`` (CUDA C++, ``csrc/eig_step.cu``, FP64 tensor cores)
* K23 ``dd_interval_affine`` (CUDA C++, ``csrc/dd_interval_affine.cu``)
* K24 ``dd_theta_chain`` (CUDA C++, ``csrc/dd_theta_chain.cu``)
* K25 ``dd_arith`` (CUDA C++, ``csrc/dd_arith.cu``, wrapper in ``dd``)
* K26 ``dd_matmul`` (CUDA C++, ``csrc/dd_matmul.cu``, FP64 tensor cores,
  wrapper in ``dd_matmul``)

The spectral basis runs K1-K4; the physical basis K3-K7; the coarsest
level of ``Mgrit(coarsest_prefix=True)`` K8 and that of ``AtMgrit`` K9;
Allen-Cahn K10 (IMEX) or K10 and K11 (IMPL, CN, with the Newton-CG control
of ``cg.py``); the Arenstorf orbit K12; the Brusselator K13; Gray-Scott K10
(IMEX, with its species axis and prologue), K14 (EXPL) or both (IMPL, with
the Newton-BiCGStab control of ``cg.py``); Burgers 1D K16; Burgers 2D K15
and K10 (Newton-BiCGStab); advection K17; the heat grid transfers
(``GridTransferHeat``, ``GridTransferHeat2D``) K18 and K19; Heat1D's
physical basis K20 (and K1 in its interval relaxation); the BDF pair-state
models ``Heat1DBDF1`` / ``Heat1DBDF2`` K20 (BE and BDF2 modes); Diffusion2D
K22; every level whose C-points are not evenly strided K21;
``precision='dd'`` (float32 pairs, ``dd``) K23 and K24 (the spectral heat
models' closed form and chains), K25 (every other DD operation, the
solver's combines and residual differences among them) and K26 (DD
products: physical Heat1D/Heat2D, Diffusion2D).  K3 and K4 serve every
float64 solve; a DD solve launches K3 on the float32 residual rows K25
writes, and no K4.  ``DISPATCH``
holds the wrappers (CPU tensors: plain version; CUDA tensors: the kernel).
``PLAIN`` holds the plain versions with the same signatures; an application
built with ``ops=PLAIN`` runs the plain versions on any device, which is
how the kernels are checked end to end on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from pymgrit_tpu_torch.ops import (dd, dd_matmul, dense_newton, eig_step, heat_kernels, indexed,
                                   periodic, prefix, row_norms, runge_kutta, transfer,
                                   triton_kernels)


class Ops(NamedTuple):
    interval_affine: Callable
    theta_chain: Callable
    residual_row_norms: Callable
    cpoint_combine: Callable
    sine_solve2d: Callable
    sine_affine2d: Callable
    theta_rhs2d: Callable
    affine_prefix: Callable
    affine_windows: Callable
    periodic_solve2d: Callable
    allen_cahn_pointwise: Callable
    dopri45_arenstorf: Callable
    rk4_brusselator: Callable
    gray_scott_pointwise: Callable
    burgers2d_pointwise: Callable
    burgers1d_newton: Callable
    circulant_solve1d: Callable
    restrict_combine: Callable
    interpolate_combine: Callable
    sine_solve1d: Callable
    indexed_combine: Callable
    eig_step: Callable
    dd_interval_affine: Callable
    dd_theta_chain: Callable
    dd_arith: Callable
    dd_matmul: Callable


DISPATCH = Ops(heat_kernels.interval_affine, heat_kernels.theta_chain,
               row_norms.residual_row_norms, triton_kernels.cpoint_combine,
               heat_kernels.sine_solve2d, heat_kernels.sine_affine2d,
               triton_kernels.theta_rhs2d, prefix.affine_prefix, prefix.affine_windows,
               periodic.periodic_solve2d, triton_kernels.allen_cahn_pointwise,
               runge_kutta.dopri45_arenstorf, triton_kernels.rk4_brusselator,
               triton_kernels.gray_scott_pointwise, triton_kernels.burgers2d_pointwise,
               dense_newton.burgers1d_newton, periodic.circulant_solve1d,
               transfer.restrict_combine, transfer.interpolate_combine,
               heat_kernels.sine_solve1d, indexed.indexed_combine, eig_step.eig_step,
               heat_kernels.dd_interval_affine, heat_kernels.dd_theta_chain, dd.dd_arith,
               dd_matmul.dd_matmul)
PLAIN = Ops(heat_kernels.interval_affine_plain, heat_kernels.theta_chain_plain,
            row_norms.residual_row_norms_plain, triton_kernels.cpoint_combine_plain,
            heat_kernels.sine_solve2d_plain, heat_kernels.sine_affine2d_plain,
            triton_kernels.theta_rhs2d_plain, prefix.affine_prefix_plain,
            prefix.affine_windows_plain, periodic.periodic_solve2d_plain,
            triton_kernels.allen_cahn_pointwise_plain, runge_kutta.dopri45_arenstorf_plain,
            triton_kernels.rk4_brusselator_plain, triton_kernels.gray_scott_pointwise_plain,
            triton_kernels.burgers2d_pointwise_plain, dense_newton.burgers1d_newton_plain,
            periodic.circulant_solve1d_plain, transfer.restrict_combine_plain,
            transfer.interpolate_combine_plain, heat_kernels.sine_solve1d_plain,
            indexed.indexed_combine_plain, eig_step.eig_step_plain,
            heat_kernels.dd_interval_affine_plain, heat_kernels.dd_theta_chain_plain,
            dd.dd_arith_plain, dd_matmul.dd_matmul_plain)


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in DISPATCH._asdict().items()}


def reset_launch_counts() -> None:
    for fn in DISPATCH:
        fn.launches = 0
        for mode in getattr(fn, "mode_launches", {}):
            fn.mode_launches[mode] = 0
