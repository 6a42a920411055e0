"""1D advection with periodic BCs, first-order upwind + backward Euler.

Counterpart of ``pymgrit_tpu/models/advection_1d.py``: u_t + c u_x = 0 on
[x_start, x_end) (the duplicated endpoint dropped), IC exp(-x^2).  A step
solves (1 + C) u_i - C u_{i-1} = b_i with C = dt c / dx: a circulant
system, which the JAX package solves by FFT and K17 ``circulant_solve1d``
by a circular convolution with its inverse's closed-form first column.  The
solver's chains of steps go to K17 in one launch.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops


class Advection1D(ChainSteps, Application):
    """u_t + c*u_x = 0 with periodic BCs, upwind/BE discretization.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state; ``ops`` selects the kernel set (``pymgrit_tpu_torch.ops.DISPATCH``
    by default, ``ops.PLAIN`` runs the plain version on any device)."""

    def __init__(self, c: float, x_start: float, x_end: float, nx: int, *args, device=None,
                 ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.c = c
        x = np.linspace(x_start, x_end, nx)
        self.x = x[0:-1]          # periodic: drop duplicated endpoint
        self.nx = nx - 1
        self.dx = self.x[1] - self.x[0]
        self.fac = c / self.dx
        self.device = model_device(device)
        self.ops = ops
        self._times = StepTimes(self.device)
        self.vector_template = torch.zeros(self.nx, dtype=torch.float64, device=self.device)
        self.vector_t_start = torch.as_tensor(np.exp(-self.x ** 2), dtype=torch.float64,
                                              device=self.device)

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps in one K17 launch: out[:, k] = [g[:, k] +]
        Phi(out[:, k-1]) with out[:, -1] = seed.  t_prev, t_curr: (L, J)
        numpy step times; out, g: (J, L, nx) views.  Returns out."""
        dts = self._times.steps(t_prev, t_curr, seed.dtype)
        return self.ops.circulant_solve1d(seed, dts, out, g, float(self.fac))
