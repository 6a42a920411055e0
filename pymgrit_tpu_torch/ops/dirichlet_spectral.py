"""Orthonormal sine eigenbasis of the 1D Dirichlet Laplacian.

Counterpart of ``sine_eigenbasis``, ``solve_shifted_1d``,
``solve_helmholtz_1d`` and ``solve_shifted_2d`` in
``pymgrit_tpu/ops/dirichlet_spectral.py``.
The n-point stencil fac*[-1, 2, -1] has the analytically known basis

    S[j, k] = sqrt(2/(n+1)) * sin((j+1)(k+1) pi / (n+1)),
    lam_k   = fac * (2 - 2 cos((k+1) pi/(n+1))),

so an implicit heat step is elementwise in coefficient space.
"""

from __future__ import annotations

import numpy as np


def sine_eigenbasis(n: int, fac: float):
    """Orthonormal eigenbasis (S, lam) of the n-point Dirichlet stencil
    fac * [-1, 2, -1], as float64 numpy arrays.  S is symmetric and
    orthogonal: S @ S == I."""
    j = np.arange(1, n + 1)
    S = np.sqrt(2.0 / (n + 1)) * np.sin(np.outer(j, j) * np.pi / (n + 1))
    lam = fac * (2.0 - 2.0 * np.cos(j * np.pi / (n + 1)))
    return S, lam


def solve_shifted_1d(S, lam, shift_scale, b):
    """Solve (I + shift_scale * L) x = b where L = S diag(lam) S, for b of
    shape (n,) (tensors or numpy arrays)."""
    bh = S @ b
    xh = bh / (1.0 + shift_scale * lam)
    return S @ xh


def solve_helmholtz_1d(S, lam, coeff, b):
    """Solve (L + coeff * I) x = b where L = S diag(lam) S, for b of shape
    (n,) (tensors or numpy arrays; BDF2's solve)."""
    bh = S @ b
    return S @ (bh / (lam + coeff))


def solve_shifted_2d(Sx, lamx, Sy, lamy, shift_scale, b):
    """Solve (I + shift_scale * (Lx (x) I + I (x) Ly)) x = b for b of shape
    (nx, ny) (tensors): two-sided diagonalization, all matmuls."""
    bh = Sx @ b @ Sy
    denom = 1.0 + shift_scale * (lamx[:, None] + lamy[None, :])
    return Sx @ (bh / denom) @ Sy
