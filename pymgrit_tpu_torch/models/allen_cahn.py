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

from pymgrit_tpu_torch.core.application import Application
from pymgrit_tpu_torch.models.step_times import StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops.cg import newton, pcg
from pymgrit_tpu_torch.ops.periodic import hartley_basis, ipow
from pymgrit_tpu_torch.ops.triton_kernels import periodic_lap_plain


class AllenCahn(Application):
    """u_t = Lap(u) + 1/eps^2 u(1-u^nu), periodic BCs on [-0.5, 0.5]^2.

    ``device`` places the state and tables; ``ops`` selects the kernel set
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain versions on any device).  ``stats`` counts the Newton and CG
    iterations of the IMPL and CN steps."""

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
        self.device = torch.device(device or "cpu")
        self.ops = ops

        self.dx = 1.0 / nx
        self.x = np.linspace(start=-0.5, stop=0.5, num=nx)
        k = np.arange(nx)
        lam1d = (2.0 * np.cos(2.0 * np.pi * k / nx) - 2.0) / self.dx ** 2
        self.lap_eigs = lam1d[:, None] + lam1d[None, :]
        self._H = self._tensor(hartley_basis(nx))
        self._lam = self._tensor(-self.lap_eigs)       # (I - sL) has 1 + s*lam
        self._inv_eps2 = 1.0 / eps ** 2
        self._dx2 = self.dx ** 2
        self._times = StepTimes(self.device)

        self.vector_template = torch.zeros((nx, nx), dtype=torch.float64, device=self.device)
        r2 = self.x[:, None] ** 2 + self.x[None, :] ** 2
        self.vector_t_start = self._tensor(np.tanh((radius - np.sqrt(r2)) / (np.sqrt(2) * eps)))
        self.reset_stats()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=self.device)

    # ------------------------------------------------------------------
    # the operators, on (B, nx, nx) batches
    # ------------------------------------------------------------------

    def _lap(self, u):
        """Periodic 5-point Laplacian (plain)."""
        return periodic_lap_plain(u, self._dx2)

    def _nonlin(self, u):
        """The reaction u (1 - u^nu) / eps^2 (plain)."""
        return self._inv_eps2 * u * (1.0 - ipow(u, self.nu))

    def _fft_solve(self, shift, b):
        """(I - shift_b L)^-1 b_b; shift: (B,) tensor (K10)."""
        return self.ops.periodic_solve2d(b, torch.empty_like(b), self._H, self._lam, shift)

    def g_of(self, u, rhs, fac):
        """Newton residual u - fac (L u + f(u)) - rhs and its per-lane max
        |.| (K11)."""
        return self.ops.allen_cahn_pointwise("residual", u, torch.empty_like(u), fac,
                                             self._inv_eps2, self._dx2, self.nu, rhs=rhs)

    def jac_mv(self, u, v, fac):
        """Jacobian of g at u applied to v (K11)."""
        return self.ops.allen_cahn_pointwise("jacobian", u, torch.empty_like(u), fac,
                                             self._inv_eps2, self._dx2, self.nu, x=v)

    def _newton_solve(self, rhs, fac, u0):
        """Solve u - fac (L u + f(u)) = rhs per lane from u0; returns (u,
        Newton iterations, CG iterations) with (B,) counts."""
        def linear_solve(u, g):
            return pcg(lambda v: self.jac_mv(u, v, fac), g, lambda v: self._fft_solve(fac, v),
                       self.lin_tol, self.lin_maxiter)

        return newton(lambda u: self.g_of(u, rhs, fac), linear_solve, u0, self.newton_tol,
                      self.newton_maxiter)

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
        x, n, k = self._newton_solve(rhs, fac, u)
        out.copy_(x if g is None else g + x)
        s = self.stats
        s["steps"] += u.shape[0]
        s["newton"] += int(n.sum())
        s["cg"] += int(k.sum())
        s["newton_max"] = max(s["newton_max"], int(n.max()))
        s["cg_max"] = max(s["cg_max"], int(k.max()))

    def reset_stats(self) -> None:
        self.stats = dict(steps=0, newton=0, cg=0, newton_max=0, cg_max=0)

    # ------------------------------------------------------------------
    # stepping
    # ------------------------------------------------------------------

    def step(self, u_start, t_start, t_stop):
        return self.step_batched(u_start[None], [float(t_start)], [float(t_stop)])[0]

    def step_batched(self, u_tube, t_starts, t_stops):
        """One step of each of B states: step_chain with L = 1."""
        out = torch.empty_like(u_tube)
        tp = np.asarray(t_starts, dtype=np.float64).reshape(1, -1)
        tc = np.asarray(t_stops, dtype=np.float64).reshape(1, -1)
        self.step_chain(u_tube, tp, tc, out[:, None])
        return out

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps: out[:, k] = [g[:, k] +] Phi(out[:, k-1]) with
        out[:, -1] = seed.  seed: (J, nx, nx); t_prev, t_curr: (L, J) numpy
        step times; out, g: (J, L, nx, nx) views (g optional) that must not
        overlap seed.  Returns out."""
        dts = self._times.steps(t_prev, t_curr, seed.dtype)
        x = seed
        for k in range(dts.shape[0]):
            self._step_into(x, dts[k], out[:, k], None if g is None else g[:, k])
            x = out[:, k]
        return out

    # ------------------------------------------------------------------
    # diagnostics (reference allen_cahn.py:246-260)
    # ------------------------------------------------------------------

    def exact_radius(self, t):
        return np.sqrt(max(self.radius ** 2 - 2.0 * t, 0))

    def compute_radius(self, u):
        return np.sqrt(int(torch.count_nonzero(torch.as_tensor(u) >= 0.0)) / np.pi) * self.dx
