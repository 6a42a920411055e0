"""Brusselator: a nonlinear 2-component ODE system.

Counterpart of ``pymgrit_tpu/models/brusselator.py``: x' = A + x^2 y -
(B+1) x, y' = B x - x^2 y with A = 1, B = 3, initial state (0, 1), classic
RK4 steps.  The solver's chains of steps go to K13 ``rk4_brusselator`` in
one launch.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops.triton_kernels import brusselator_f


class Brusselator(ChainSteps, Application):
    """Brusselator system with RK4 time integration.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state; ``ops`` selects the kernel set (``pymgrit_tpu_torch.ops.DISPATCH``
    by default, ``ops.PLAIN`` runs the plain version on any device)."""

    def __init__(self, *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.a = 1.0
        self.b = 3.0
        self.device = model_device(device)
        self.ops = ops
        self._times = StepTimes(self.device)
        self.vector_template = torch.zeros(2, dtype=torch.float64, device=self.device)
        self.vector_t_start = torch.tensor([0.0, 1.0], dtype=torch.float64, device=self.device)

    def _f(self, t, y):
        """The right-hand side of (B, 2) states (plain)."""
        return brusselator_f(self.a, self.b)(t, y)

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L RK4 steps in one K13 launch: out[:, k] = [g[:, k] +]
        Phi(out[:, k-1]) with out[:, -1] = seed.  t_prev, t_curr: (L, J)
        numpy step times; out, g: (J, L, 2) views.  Returns out."""
        tp, tc = self._times.times(t_prev, t_curr, seed.dtype)
        return self.ops.rk4_brusselator(seed, tp, tc, out, g, self.a, self.b)
