"""Viscous Burgers equation, 1D and 2D, periodic, backward Euler + Newton.

Counterpart of ``pymgrit_tpu/models/burgers.py``:

* ``Burgers1D``: u_t + u u_x = nu u_xx with periodic central differences
  and IC sin(2 pi x); each step is a dense Newton solve.  The solver's
  chains of steps go to K16 ``burgers1d_newton`` in one launch (the whole
  Newton loop of a lane in one block, LU in shared memory).
* ``Burgers2D``: the velocity field u_t + (u . grad) u = nu Lap(u), IC
  (sin(pi x), 0); Newton with BiCGStab (``ops/cg.py``), the residual and
  the linearised-convection matvec from K15 ``burgers2d_pointwise`` and K10
  ``periodic_solve2d`` (coefficient nu on both components) as the
  preconditioner.  Axis 1 (x) may be split over a mesh's 'space' axis
  (``space_sharding_axis``; ``periodic_newton``'s slab route: K15's halo
  mode, the Hartley pencil as the preconditioner).
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.periodic_newton import PeriodicNewtonKrylov
from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops


class Burgers1D(ChainSteps, Application):
    """1D viscous Burgers, periodic, BE + dense Newton.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state; ``ops`` selects the kernel set (``pymgrit_tpu_torch.ops.DISPATCH``
    by default, ``ops.PLAIN`` runs the plain version on any device).
    ``newton_iters`` and ``newton_max`` count the Newton iterations (device
    scalars: reading them syncs); ``steps`` counts the steps."""

    def __init__(self, nx: int = 128, nu: float = 0.01, x_start: float = 0.0,
                 x_end: float = 1.0, newton_tol: float = 1e-12,
                 newton_maxiter: int = 30, *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.nx = nx
        self.nu = nu
        self.x = np.linspace(x_start, x_end, nx, endpoint=False)
        self.dx = self.x[1] - self.x[0]
        self.newton_tol = newton_tol
        self.newton_maxiter = newton_maxiter
        self.device = model_device(device)
        self.ops = ops
        self._times = StepTimes(self.device)
        self.vector_template = torch.zeros(nx, dtype=torch.float64, device=self.device)
        self.vector_t_start = torch.as_tensor(np.sin(2 * np.pi * self.x), dtype=torch.float64,
                                              device=self.device)
        self.reset_stats()

    def reset_stats(self) -> None:
        self.newton_iters = torch.zeros((), dtype=torch.int64, device=self.device)
        self.newton_max = torch.zeros((), dtype=torch.int32, device=self.device)
        self.steps = 0

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps in one K16 launch: out[:, k] = [g[:, k] +]
        Phi(out[:, k-1]) with out[:, -1] = seed.  t_prev, t_curr: (L, J)
        numpy step times; out, g: (J, L, nx) views.  Returns out."""
        dts = self._times.steps(t_prev, t_curr, seed.dtype)
        iters = torch.empty(dts.shape, dtype=torch.int32, device=seed.device)
        self.ops.burgers1d_newton(seed, dts, out, g, self.nu, float(self.dx), self.newton_tol,
                                  self.newton_maxiter, iters)
        self.newton_iters += iters.sum()
        self.newton_max = torch.maximum(self.newton_max, iters.max())
        self.steps += iters.numel()
        return out


class Burgers2D(PeriodicNewtonKrylov, Application):
    """2D viscous Burgers velocity field, periodic, BE + Newton-Krylov.

    ``device`` and ``ops`` as for ``Burgers1D``; ``stats`` counts the Newton
    and BiCGStab iterations."""

    def __init__(self, nx: int = 64, nu: float = 0.02, newton_tol: float = 1e-10,
                 newton_maxiter: int = 30, lin_tol: float = 1e-12,
                 lin_maxiter: int = 200, *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.nx = nx
        self.nu = nu
        self.dx = 1.0 / nx
        self.newton_tol = newton_tol
        self.newton_maxiter = newton_maxiter
        self.lin_tol = lin_tol
        self.lin_maxiter = lin_maxiter
        self.device = model_device(device)
        self.ops = ops

        self._periodic_tables(nx, self.dx, coef=[nu, nu])
        self.space_sharding_axis = 1

        x = np.linspace(0, 1, nx, endpoint=False)
        X, _ = np.meshgrid(x, x, indexing='ij')
        self.vector_template = torch.zeros((2, nx, nx), dtype=torch.float64, device=self.device)
        self.vector_t_start = self._tensor(np.stack([np.sin(np.pi * X), np.zeros((nx, nx))]))
        self.reset_stats()

    def g_of(self, s, s0, dt):
        """Newton residual s - s0 + dt (C(s) - nu Lap s) and its per-lane
        max |.| (K15)."""
        return self.ops.burgers2d_pointwise("residual", s, torch.empty_like(s), dt, self.nu,
                                            self.dx, r=s0, halo=self._halo(s))

    def jac_mv(self, s, w, dt, s_halo=None):
        """Jacobian of g at s applied to w (K15); on a space shard s's halo
        rows (exchanged here unless given) and w's."""
        if self._slab is not None and s_halo is None:
            s_halo = self._halo(s)
        return self.ops.burgers2d_pointwise("jacobian", s, torch.empty_like(s), dt, self.nu,
                                            self.dx, w=w, halo=s_halo, w_halo=self._halo(w))

    def _jacobian(self, s, dt):
        """v -> the Jacobian at s applied to v, s's halo rows exchanged once
        a Newton iteration."""
        s_halo = self._halo(s)
        return lambda w: self.jac_mv(s, w, dt, s_halo)

    def _step_into(self, s, dt, out, g=None):
        """One backward-Euler Newton-BiCGStab step of every state of s with
        (B,) step sizes dt into out [+ g]."""
        self._newton_into(s, dt, s, out, g)
