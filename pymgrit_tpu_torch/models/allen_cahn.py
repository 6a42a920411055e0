"""2D Allen-Cahn equation with periodic boundary conditions.

Counterpart of ``pymgrit_tpu/models/allen_cahn.py``: u_t = Lap(u) +
u (1 - u^nu) / eps^2 on [-0.5, 0.5]^2 with the periodic 5-point Laplacian,
a tanh circle as initial condition, and three steppers:

* IMEX: the reaction explicit, the diffusion implicit,
  u' = (I - dt L)^-1 (u + dt f(u)): one K10 ``periodic_solve2d`` launch per
  step (prologue and diagonal solve fused);
* IMPL (backward Euler) and CN: Newton's method on
  g(u) = u - fac (L u + f(u)) - rhs with fac = dt (IMPL) or dt/2 (CN,
  rhs = u + fac (L u + f(u)) from K11), each Newton step a CG solve
  preconditioned by the exact inverse of I - fac L.  K11
  ``allen_cahn_pointwise`` computes the CN right-hand side, the residual
  with its per-lane max and the Jacobian matvec, K10 the preconditioner;
  the loops (``ops/cg.py``) are plain PyTorch with per-lane masks.

The JAX package solves with complex dense DFT products; K10 uses the real
Hartley basis (``ops/periodic.py``), so the two agree to rounding.  States
are (nx, nx) tensors; the solver reaches the steppers through
``step_chain`` and ``step_batched``.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.periodic_newton import PeriodicNewtonKrylov
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops.periodic import ipow
from pymgrit_tpu_torch.ops.pointwise import periodic_lap_plain


class AllenCahn(PeriodicNewtonKrylov, Application):
    """u_t = Lap(u) + 1/eps^2 u(1-u^nu), periodic BCs on [-0.5, 0.5]^2.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state and tables; ``ops`` selects the kernel set
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain versions on any device).  ``stats`` counts the Newton and CG
    iterations of the IMPL and CN steps."""

    krylov = "cg"

    def __init__(self, nx: int = 128, nu: int = 2, eps: float = 0.04,
                 newton_maxiter: int = 100, newton_tol: float = 1e-12,
                 lin_tol: float = 1e-12, lin_maxiter: int = 100,
                 radius: float = 0.25, method: str = 'IMPL', *args, device=None,
                 ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.nu = nu
        self.eps = eps
        self.newton_maxiter = newton_maxiter
        self.newton_tol = newton_tol
        self.lin_tol = lin_tol
        self.lin_maxiter = lin_maxiter
        self.radius = radius
        self.nx = nx
        self.ny = nx
        if method not in ('IMPL', 'IMEX', 'CN'):
            raise Exception("Unknown method. Choose IMPL (implicit), IMEX (implicit-explicit) or CN (Crank-Nicolson")
        self.method = method
        self.device = model_device(device)
        self.ops = ops

        self.dx = 1.0 / nx
        self.x = np.linspace(start=-0.5, stop=0.5, num=nx)
        self._periodic_tables(nx, self.dx)
        self._inv_eps2 = 1.0 / eps ** 2
        self._dx2 = self.dx ** 2

        self.vector_template = torch.zeros((nx, nx), dtype=torch.float64, device=self.device)
        r2 = self.x[:, None] ** 2 + self.x[None, :] ** 2
        self.vector_t_start = self._tensor(np.tanh((radius - np.sqrt(r2)) / (np.sqrt(2) * eps)))
        self.reset_stats()

    # ------------------------------------------------------------------
    # the operators, on (B, nx, nx) batches
    # ------------------------------------------------------------------

    def _lap(self, u):
        """Periodic 5-point Laplacian (plain)."""
        return periodic_lap_plain(u, self._dx2)

    def _nonlin(self, u):
        """The reaction u (1 - u^nu) / eps^2 (plain)."""
        return self._inv_eps2 * u * (1.0 - ipow(u, self.nu))

    def g_of(self, u, rhs, fac):
        """Newton residual u - fac (L u + f(u)) - rhs and its per-lane max
        |.| (K11)."""
        return self.ops.allen_cahn_pointwise("residual", u, torch.empty_like(u), fac,
                                             self._inv_eps2, self._dx2, self.nu, rhs=rhs)

    def jac_mv(self, u, v, fac):
        """Jacobian of g at u applied to v (K11)."""
        return self.ops.allen_cahn_pointwise("jacobian", u, torch.empty_like(u), fac,
                                             self._inv_eps2, self._dx2, self.nu, x=v)

    def _step_into(self, u, dt, out, g=None):
        """One step of every state of u with (B,) step sizes dt into out
        [+ g]."""
        if self.method == 'IMEX':
            self.ops.periodic_solve2d(u, out, self._H, self._lam, dt, nu=self.nu,
                                      inv_eps2=self._inv_eps2, g=g)
            return
        if self.method == 'CN':
            fac = dt * 0.5
            rhs = self.ops.allen_cahn_pointwise("rhs", u, torch.empty_like(u), fac,
                                                self._inv_eps2, self._dx2, self.nu)
        else:
            fac, rhs = dt, u
        self._newton_into(rhs, fac, u, out, g)

    # ------------------------------------------------------------------
    # diagnostics (reference allen_cahn.py:246-260)
    # ------------------------------------------------------------------

    def exact_radius(self, t):
        return np.sqrt(max(self.radius ** 2 - 2.0 * t, 0))

    def compute_radius(self, u):
        return np.sqrt(int(torch.count_nonzero(torch.as_tensor(u) >= 0.0)) / np.pi) * self.dx
