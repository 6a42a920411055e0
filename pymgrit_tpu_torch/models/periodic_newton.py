"""The shape the periodic Newton-Krylov models share (Allen-Cahn,
Gray-Scott, Burgers 2D).

Each diagonalises its periodic 5-point Laplacian in the real Hartley basis
(``ops/periodic.py``), so K10 ``periodic_solve2d`` solves
(I - fac coef_s Lap) x = b per lane and species; each solves its implicit
steps by a lane-masked Newton loop whose linear solves run a Krylov method
(``pcg`` or ``bicgstab``, ``ops/cg.py``) preconditioned by K10; and each
takes a chain of steps one batch of lanes at a time.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops.cg import bicgstab, newton, newton_stats, pcg, tally
from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs

KRYLOV = {"cg": pcg, "bicgstab": bicgstab}


class PeriodicNewtonKrylov(ChainSteps):
    """Base of a periodic Newton-Krylov model; comes before ``Application``
    among its bases.  The model names its Krylov method in ``krylov``,
    calls ``_periodic_tables`` in its constructor after setting ``device``
    and ``ops``, and supplies ``g_of(u, rhs, fac)`` (the Newton residual and
    its per-lane max |.|), ``jac_mv(u, v, fac)`` and
    ``_step_into(u, dt, out, g)``; its tolerances and caps are
    ``newton_tol``, ``newton_maxiter``, ``lin_tol`` and ``lin_maxiter`` unless
    it overrides ``_newton_tols``."""

    krylov = "bicgstab"

    def _periodic_tables(self, nx, dx, coef=None):
        """The Hartley tables of K10 and the step-time cache; coef: one
        diffusion coefficient per species (None: one species, 1)."""
        self.lap_eigs = periodic_lap_eigs(nx, dx)
        self._H = self._tensor(hartley_basis(nx))
        self._lam = self._tensor(-self.lap_eigs)       # (I - sL) has 1 + s*lam
        self._coef = None if coef is None else self._tensor(coef)
        self._times = StepTimes(self.device)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    def _diffusion_solve(self, fac, b):
        """(I - fac_b coef_s Lap)^-1 b per lane and species; fac: (B,)
        tensor (K10)."""
        return self.ops.periodic_solve2d(b, torch.empty_like(b), self._H, self._lam, fac,
                                         coef=self._coef)

    def _newton_tols(self):
        return self.newton_tol, self.newton_maxiter, self.lin_tol, self.lin_maxiter

    def _newton_krylov(self, rhs, fac, u0):
        """Solve g_of(u, rhs, fac) = 0 per lane from u0; returns (u, Newton
        iterations, Krylov iterations) with (B,) counts."""
        newton_tol, newton_maxiter, lin_tol, lin_maxiter = self._newton_tols()
        solve = KRYLOV[self.krylov]

        def linear_solve(u, g):
            return solve(lambda v: self.jac_mv(u, v, fac), g,
                         lambda v: self._diffusion_solve(fac, v), lin_tol, lin_maxiter)

        return newton(lambda u: self.g_of(u, rhs, fac), linear_solve, u0, newton_tol,
                      newton_maxiter)

    def _newton_into(self, rhs, fac, u0, out, g=None):
        """out = [g +] the Newton solution, its counts added to ``stats``."""
        x, n, k = self._newton_krylov(rhs, fac, u0)
        out.copy_(x if g is None else g + x)
        tally(self.stats, n, k, self.krylov)

    def reset_stats(self) -> None:
        self.stats = newton_stats(self.krylov)

    def _lane_step(self, x, k, dts, out, g):
        """Step k of ``ChainSteps.step_chain``: ``_step_into`` with the
        chain's step sizes dts[k]."""
        self._step_into(x, dts[k], out, g)
