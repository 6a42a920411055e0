"""Dahlquist test equation u' = lambda*u.

Counterpart of ``pymgrit_tpu/models/dahlquist.py`` (BE/FE/TR/MR, IC
u(0) = 1).  The state is a 0-d float64 tensor; every integrator is a
closed-form scalar update, so the solver's batched sweeps are elementwise
tensor ops.  It proves the solver skeleton against the README golden
history.
"""

from __future__ import annotations

import torch

from pymgrit_tpu_torch.core.application import Application


class Dahlquist(Application):
    """u' = lambda*u with lambda = -1 (default) and u(0) = 1."""

    def __init__(self, constant_lambda: float = -1, method: str = 'BE',
                 precision: str = None, *args, device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.lambda_value = constant_lambda
        if method in ('BE', 'FE', 'TR', 'MR'):
            self.method = method
        else:
            raise Exception(
                'Unknown method. Choose BE (Backward Euler), FE (Forward Euler), TR (Trapezoidal rule) ' +
                'or MR (implicit mid-point rule)')
        if precision == 'dd':
            raise NotImplementedError(
                "precision='dd' is not ported yet (ROADMAP A10)")
        device = torch.device(device or "cpu")
        self.vector_template = torch.zeros((), dtype=torch.float64, device=device)
        self.vector_t_start = torch.ones((), dtype=torch.float64, device=device)

    def step(self, u_start, t_start, t_stop):
        z = (t_stop - t_start) * self.lambda_value
        if self.method == 'BE':
            return u_start / (1 - z)
        if self.method == 'FE':
            return (1 + z) * u_start
        if self.method == 'TR':
            return (1 + z / 2) / (1 - z / 2) * u_start
        # MR: implicit mid-point rule with the reference's fixed -1 in k1
        k1 = -1 / (1 - z / 2) * u_start
        return u_start + (t_stop - t_start) * k1
