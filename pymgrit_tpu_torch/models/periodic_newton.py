"""The shape the periodic Newton-Krylov models share (Allen-Cahn,
Gray-Scott, Burgers 2D).

Each diagonalises its periodic 5-point Laplacian in the real Hartley basis
(``ops/periodic.py``), so K10 ``periodic_solve2d`` solves
(I - fac coef_s Lap) x = b per lane and species; each solves its implicit
steps by a lane-masked Newton loop whose linear solves run a Krylov method
(``pcg`` or ``bicgstab``, ``ops/cg.py``) preconditioned by K10; and each
takes a chain of steps one batch of lanes at a time.

Under a ('time', 'space') mesh with n_space > 1 (``parallel.ShardedMgrit``)
the solver hands each level its space shard (``_space_slab``): the state
becomes rows [s R, (s + 1) R) of the x axis (``space_sharding_axis``: 0 for
Allen-Cahn's (nx, nx) state, 1 for the (2, nx, nx) pairs; R = nx /
n_space), the axis JAX's GSPMD splits.  On the slab (``_PeriodicSlab``):

* the diffusion solve is a Hartley pencil on K20 ``sine_solve1d`` (the
  normalised Hartley matrix H is real, symmetric and orthogonal, so K20's
  contract holds for it): the y-transform x H of the slab's rows, the
  exchange to column slabs (``parallel.pencil.PencilExchange``), K20's
  x-pass ((x H) / (1 + dt coef_s Lam[:, j])) H with a lam table of the
  slab's columns j, the exchange back and the y-transform; an IMEX step
  forms its right-hand side first (K11's or K14's prologue mode, K10's
  fused prologue) and adds g through K4;
* the stencils (residuals, Jacobian matvecs, CN's right-hand side, the
  EXPL step) run K11, K14 and K15 in their halo modes on the rows above
  and below the slab from the neighbouring shards (``Comm.row_halo``,
  periodic);
* the Krylov loops' inner products and Newton's max |g| are reduced over
  the space group (``ops/cg.py``'s ``red``), so every shard of a lane takes
  the same iterations.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops.cg import bicgstab, newton, newton_stats, pcg, tally
from pymgrit_tpu_torch.ops.periodic import hartley_basis, periodic_lap_eigs
from pymgrit_tpu_torch.parallel.pencil import PencilExchange

KRYLOV = {"cg": pcg, "bicgstab": bicgstab}


class PeriodicNewtonKrylov(ChainSteps):
    """Base of a periodic Newton-Krylov model; comes before ``Application``
    among its bases.  The model names its Krylov method in ``krylov``,
    calls ``_periodic_tables`` in its constructor after setting ``device``
    and ``ops``, and supplies ``g_of(u, rhs, fac)`` (the Newton residual and
    its per-lane max |.|), ``jac_mv(u, v, fac)`` and
    ``_step_into(u, dt, out, g)``; its tolerances and caps are
    ``newton_tol``, ``newton_maxiter``, ``lin_tol`` and ``lin_maxiter`` unless
    it overrides ``_newton_tols``.  On a space shard (``_space_slab``) its
    stencils take the rows ``_halo`` exchanges, and its diffusion solves
    and Newton-Krylov loops run on the slab (module docstring)."""

    krylov = "bicgstab"
    _slab = None          # the space shard (``_PeriodicSlab``) once ``_space_slab`` ran

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
        tensor (K10; on a space shard the pencil, ``_PeriodicSlab.solve``)."""
        return self._preconditioner(fac)(b)

    def _preconditioner(self, fac):
        """b -> (I - fac_b coef_s Lap)^-1 b for the (B,) steps fac, what the
        Krylov loops call: K10, or a space shard's pencil (the x-pass's
        per-lane steps formed once)."""
        if self._slab is None:
            return lambda b: self.ops.periodic_solve2d(b, torch.empty_like(b), self._H,
                                                       self._lam, fac, coef=self._coef)
        slab, dt = self._slab, self._slab.lane_dt(fac)
        return lambda b: slab.solve(b, dt).view(b.shape)

    def _halo(self, x):
        """The rows above and below x's slabs (B, [2,] R, nx) from the
        neighbouring space shards (None: whole states, the kernels wrap)."""
        return None if self._slab is None else self._slab.halo(x)

    def _jacobian(self, u, fac):
        """v -> the Jacobian of g at u applied to v (``jac_mv``)."""
        return lambda v: self.jac_mv(u, v, fac)

    def _newton_tols(self):
        return self.newton_tol, self.newton_maxiter, self.lin_tol, self.lin_maxiter

    def _newton_krylov(self, rhs, fac, u0):
        """Solve g_of(u, rhs, fac) = 0 per lane from u0; returns (u, Newton
        iterations, Krylov iterations) with (B,) counts."""
        newton_tol, newton_maxiter, lin_tol, lin_maxiter = self._newton_tols()
        solve = KRYLOV[self.krylov]
        red = None if self._slab is None else self._slab.comm
        M = self._preconditioner(fac)

        def linear_solve(u, g):
            return solve(self._jacobian(u, fac), g, M, lin_tol, lin_maxiter, red)

        return newton(lambda u: self.g_of(u, rhs, fac), linear_solve, u0, newton_tol,
                      newton_maxiter, red)

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

    def _imex_into(self, r, dt, out, g):
        """out = [g +] (I - dt coef_s Lap)^-1 r on a space shard: r is the
        IMEX right-hand side (the prologue mode's), solved by the pencil,
        g added by K4."""
        slab = self._slab
        x = slab.solve(r, slab.lane_dt(dt))
        B = out.shape[0]
        if g is None:
            out.copy_(x.view(out.shape))
        else:
            self.ops.cpoint_combine(out.view(B, -1), [g.view(B, -1), x.view(B, -1)], [1.0, 1.0])

    # ------------------------------------------------------------------
    # the 'space' mesh axis
    # ------------------------------------------------------------------

    def _space_slab(self, s: int, n_space: int, comm) -> None:
        """Make this level the space shard s of n_space (``parallel``'s
        ``ShardedMgrit`` calls it, with the space group's ``Comm``): the
        state becomes rows [s R, (s + 1) R) of the x axis
        (``space_sharding_axis``) and the diffusion solve, the stencils and
        the Newton-Krylov loops their slab routes.  A level made a shard
        stays one: a later solver may take it on the same shard of the
        same count."""
        if self._slab is not None:
            if (self._slab.s, len(self._slab.rows)) != (s, n_space):
                raise ValueError(f"this level is space shard {self._slab.s} of "
                                 f"{len(self._slab.rows)}; build it anew for shard {s} of "
                                 f"{n_space}")
            self._slab.comm = comm
            return
        shape, ax = tuple(self.vector_template.shape), self.space_sharding_axis
        if self.nx % n_space:
            raise ValueError(f"the state's shape {shape} does not split over n_space = "
                             f"{n_space} along axis {ax}")
        self._slab = _PeriodicSlab(self, s, n_space, comm)
        R = self._slab.R
        self.vector_t_start = self.vector_t_start.narrow(ax, s * R, R).clone()
        self.vector_template = torch.zeros(shape[:ax] + (R,) + shape[ax + 1:],
                                           dtype=self.vector_template.dtype, device=self.device)


class _PeriodicSlab(PencilExchange):
    """A periodic model's space shard s of n (``_space_slab``): rows [s R,
    (s + 1) R) of each species' (nx, nx) plane and, between the pencil
    solve's passes, the columns [c0[s], c0[s + 1]) (``PencilExchange``).
    ``lam`` holds the x-pass's table: row c the eigenvalues Lam[:, j] of
    the slab's column j = c0[s] + c."""

    def __init__(self, model: PeriodicNewtonKrylov, s: int, n: int, comm):
        nx = model.nx
        R = self.R = nx // n
        super().__init__(comm, s, [R] * n, [t * R for t in range(n)],
                         [nx * t // n for t in range(n + 1)])
        self.model = model
        self.lam = model._lam[:, self.c0[s]:self.c0[s + 1]].T.contiguous()

    def halo(self, x):
        """(above, below): the rows past the first and last of the slabs x
        (B, [2,] R, nx), the neighbouring shards' (periodic)."""
        return self.comm.row_halo(x.select(-2, 0), x.select(-2, self.R - 1), periodic=True)

    def lane_dt(self, dt):
        """The x-pass's per-lane steps of B lanes' (B,) steps dt: its lanes
        are (lane, species, column), lane j's species s dt_j coef_s (K10's
        product)."""
        coef = self.model._coef
        s = dt[:, None] if coef is None else dt[:, None] * coef[None, :]
        return s.reshape(-1).repeat_interleave(self.cols[self.s])

    def solve(self, b, lane_dt):
        """(I - dt coef_s Lap)^-1 of the slabs b (B, [S,] R, nx) by the
        Hartley pencil (K20 three times, two exchanges); returns the (B S R,
        nx) rows of the result (a fresh tensor)."""
        m = self.model
        ops, H, nx = m.ops, m._H, m.nx
        J = b.numel() // (self.R * nx)                     # lanes times species
        y = torch.empty((J * self.R, nx), dtype=b.dtype, device=b.device)
        ops.sine_solve1d(b.reshape(J * self.R, nx), y, H)
        X = self.to_cols(y, J)
        ops.sine_solve1d(X, X, H, self.lam, lane_dt)
        Y = self.to_rows(X, J)
        ops.sine_solve1d(Y, y, H)
        return y
