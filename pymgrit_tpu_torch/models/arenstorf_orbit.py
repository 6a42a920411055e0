"""Arenstorf orbit: the restricted three-body problem.

Counterpart of ``pymgrit_tpu/models/arenstorf_orbit.py``: a 4-component
ODE with a = 0.012277471, b = 1 - a, initial state
(0.994, 0, 0, -2.00158510637908), integrated over each step by the adaptive
Dormand-Prince 5(4) pair with scipy's RK45 controller (rtol 1e-3, atol
1e-6 by default; ``ops/runge_kutta.py``).  The solver's chains of steps go
to K12 ``dopri45_arenstorf`` in one launch (one thread per lane, the whole
adaptive loop in registers); ``attempts`` counts the controller's attempts.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.models.step_times import ChainSteps, StepTimes
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops.runge_kutta import ARENSTORF_A, arenstorf_f


class ArenstorfOrbit(ChainSteps, Application):
    """Restricted three-body problem integrated with adaptive DOPRI45.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state; ``ops`` selects the kernel set (``pymgrit_tpu_torch.ops.DISPATCH``
    by default, ``ops.PLAIN`` runs the plain version on any device)."""

    def __init__(self, rtol: float = 1e-3, atol: float = 1e-6, *args, device=None,
                 ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.a = ARENSTORF_A
        self.b = 1 - self.a
        self.rtol = rtol
        self.atol = atol
        self.device = model_device(device)
        self.ops = ops
        self._times = StepTimes(self.device)
        self.vector_template = torch.zeros(4, dtype=torch.float64, device=self.device)
        self.vector_t_start = torch.tensor([0.994, 0.0, 0.0, -2.00158510637908],
                                           dtype=torch.float64, device=self.device)
        self.reset_attempts()

    def _f(self, t, y):
        """The right-hand side of (B, 4) states (plain)."""
        return arenstorf_f(self.a)(t, y)

    def reset_attempts(self) -> None:
        """Zero the attempt counters (device scalars: reading them syncs)."""
        self.attempts = torch.zeros((), dtype=torch.int64, device=self.device)
        self.attempts_max = torch.zeros((), dtype=torch.int32, device=self.device)
        self.steps = 0

    def step_chain(self, seed, t_prev, t_curr, out, g=None):
        """J chains of L steps in one K12 launch: out[:, k] = [g[:, k] +]
        Phi(out[:, k-1]) with out[:, -1] = seed.  t_prev, t_curr: (L, J)
        numpy step times; out, g: (J, L, 4) views.  Returns out."""
        tp, tc = self._times.times(t_prev, t_curr, seed.dtype)
        att = torch.empty(tp.shape, dtype=torch.int32, device=seed.device)
        self.ops.dopri45_arenstorf(seed, tp, tc, out, g, self.rtol, self.atol, self.a,
                                   attempts=att)
        self.attempts += att.sum()
        self.attempts_max = torch.maximum(self.attempts_max, att.max())
        self.steps += att.numel()
        return out
