"""2D Gray-Scott two-species reaction-diffusion, periodic.

Counterpart of ``pymgrit_tpu/models/gray_scott_2d.py``: species (u, v) on
a periodic L x L grid with
    u_t = du Lap(u) - u v^2 + a (1 - u)
    v_t = dv Lap(v) + u v^2 - b v
and three steppers:

* IMEX: the reaction explicit, the diffusion implicit, one K10
  ``periodic_solve2d`` launch per step (the Gray-Scott prologue forms
  s + dt R(s) and each species is solved with its own coefficient);
* IMPL (backward Euler): Newton's method on g(s) = s - dt (D Lap s + R(s))
  - s0, each Newton step a BiCGStab solve (``ops/cg.py``) with the
  Jacobian matvec of K14 ``gray_scott_pointwise`` and K10 as the
  preconditioner (the exact inverse of I - dt D Lap);
* EXPL (forward Euler): one K14 launch per step.

The JAX package solves the diffusion with complex FFTs; K10 uses the real
Hartley basis (``ops/periodic.py``), so the two agree to rounding.  States
are (2, nx, nx) tensors; the solver reaches the steppers through
``step_chain`` and ``step_batched``.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.periodic_newton import PeriodicNewtonKrylov
from pymgrit_tpu_torch.ops import DISPATCH, Ops


class GrayScott2D(PeriodicNewtonKrylov, Application):
    """Gray-Scott reaction-diffusion with IMEX / IMPL / EXPL steppers.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state and tables; ``ops`` selects the kernel set
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain versions on any device).  ``stats`` counts the Newton and BiCGStab
    iterations of the IMPL steps."""

    def __init__(self, nx: int = 64, L: float = 2.0, du: float = 8e-5, dv: float = 4e-5,
                 a: float = 0.024, b: float = 0.06 + 0.024, method: str = 'IMEX',
                 nlsol_tol: float = 1e-10, nlsol_maxiter: int = 50,
                 lsol_tol: float = 1e-12, lsol_maxiter: int = 200, *args, device=None,
                 ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        if method not in ('IMEX', 'IMPL', 'EXPL'):
            raise Exception("Unknown method. Choose IMPL (implicit) or IMEX (implicit-explicit)")
        self.method = method
        self.nx = nx
        self.ny = nx
        self.L = L
        self.dx = L / nx
        self.du = du
        self.dv = dv
        self.a = a
        self.b = b
        self.nlsol_tol = nlsol_tol
        self.nlsol_maxiter = nlsol_maxiter
        self.lsol_tol = lsol_tol
        self.lsol_maxiter = lsol_maxiter
        self.device = model_device(device)
        self.ops = ops

        self._periodic_tables(nx, self.dx, coef=[du, dv])

        self.vector_template = torch.zeros((2, nx, nx), dtype=torch.float64, device=self.device)
        x = np.linspace(-L / 2, L / 2, nx, endpoint=False)
        X, Y = np.meshgrid(x, x, indexing='ij')
        # classic Gray-Scott seed: a perturbed square in the center
        u0 = 1.0 - 0.5 * np.power(np.sin(np.pi * (X + L / 2) / L), 100) * \
            np.power(np.sin(np.pi * (Y + L / 2) / L), 100)
        v0 = 0.25 * np.power(np.sin(np.pi * (X + L / 2) / L), 100) * \
            np.power(np.sin(np.pi * (Y + L / 2) / L), 100)
        self.vector_t_start = self._tensor(np.stack([u0, v0]))
        self.reset_stats()

    # ------------------------------------------------------------------
    # the operators, on (B, 2, nx, nx) batches with (B,) step sizes dt
    # ------------------------------------------------------------------

    def _pointwise(self, mode, s, dt, **kw):
        return self.ops.gray_scott_pointwise(mode, s, torch.empty_like(s), dt, self.du, self.dv,
                                             self.a, self.b, self.dx ** 2, **kw)

    def g_of(self, s, s0, dt):
        """Newton residual s - dt (D Lap s + R(s)) - s0 and its per-lane
        max |.| (K14)."""
        return self._pointwise("residual", s, dt, r=s0)

    def jac_mv(self, s, w, dt):
        """Jacobian of g at s applied to w (K14)."""
        return self._pointwise("jacobian", s, dt, w=w)

    def _newton_tols(self):
        return self.nlsol_tol, self.nlsol_maxiter, self.lsol_tol, self.lsol_maxiter

    def _step_into(self, s, dt, out, g=None):
        """One step of every state of s with (B,) step sizes dt into out
        [+ g]."""
        if self.method == 'EXPL':
            self.ops.gray_scott_pointwise("expl", s, out, dt, self.du, self.dv, self.a, self.b,
                                          self.dx ** 2, g=g)
            return
        if self.method == 'IMEX':
            self.ops.periodic_solve2d(s, out, self._H, self._lam, dt, g=g, coef=self._coef,
                                      gray_scott=(self.a, self.b))
            return
        self._newton_into(s, dt, s, out, g)
