"""Hand-written GPU kernels of the port and their plain PyTorch versions.

Nine kernels carry the Heat2D paths (condensed level 0) and the
coarsest-level strategies:

* K1 ``interval_affine`` (CUDA C++, ``csrc/interval_affine.cu``)
* K2 ``theta_chain`` (CUDA C++, ``csrc/theta_chain.cu``)
* K3 ``residual_row_norms`` (Triton)
* K4 ``cpoint_combine`` (Triton)
* K5 ``sine_solve2d`` (CUDA C++, ``csrc/sine_solve2d.cu``)
* K6 ``sine_affine2d`` (CUDA C++, ``csrc/sine_affine2d.cu``)
* K7 ``theta_rhs2d`` (Triton)
* K8 ``affine_prefix`` (CUDA C++, ``csrc/affine_prefix.cu``)
* K9 ``affine_windows`` (CUDA C++, ``csrc/affine_windows.cu``)

The spectral basis runs K1-K4; the physical basis K3-K7; the coarsest
level of ``Mgrit(coarsest_prefix=True)`` K8 and that of ``AtMgrit`` K9.  ``DISPATCH``
holds the wrappers (CPU tensors: plain version; CUDA tensors: the kernel).
``PLAIN`` holds the plain versions with the same signatures; an application
built with ``ops=PLAIN`` runs the plain versions on any device, which is
how the kernels are checked end to end on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from pymgrit_tpu_torch.ops import heat_kernels, prefix, triton_kernels


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


DISPATCH = Ops(heat_kernels.interval_affine, heat_kernels.theta_chain,
               triton_kernels.residual_row_norms, triton_kernels.cpoint_combine,
               heat_kernels.sine_solve2d, heat_kernels.sine_affine2d,
               triton_kernels.theta_rhs2d, prefix.affine_prefix, prefix.affine_windows)
PLAIN = Ops(heat_kernels.interval_affine_plain, heat_kernels.theta_chain_plain,
            triton_kernels.residual_row_norms_plain, triton_kernels.cpoint_combine_plain,
            heat_kernels.sine_solve2d_plain, heat_kernels.sine_affine2d_plain,
            triton_kernels.theta_rhs2d_plain, prefix.affine_prefix_plain,
            prefix.affine_windows_plain)


def launch_counts() -> dict:
    """Kernel launches counted by each wrapper since the last reset."""
    return {name: fn.launches for name, fn in DISPATCH._asdict().items()}


def reset_launch_counts() -> None:
    for fn in DISPATCH:
        fn.launches = 0
