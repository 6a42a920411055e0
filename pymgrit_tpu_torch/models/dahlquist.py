"""Dahlquist test equation u' = lambda*u.

Counterpart of ``pymgrit_tpu/models/dahlquist.py`` (BE/FE/TR/MR, IC
u(0) = 1).  The state is a 0-d float64 tensor; every integrator is a
closed-form scalar update, so the solver's batched sweeps are elementwise
tensor ops.  It proves the solver skeleton against the README golden
history.  Every integrator is linear in the state, so ``affine_coeffs``
hands the step to the coarsest-level strategies (kernels K8, K9).

``precision='dd'``: the state is a 0-d double-double pair (``ops/dd.py``)
and the same step body runs through the DD operators (each one K25
launch on the card); the step is elementwise, so it is also the batched
step.  DD states define no ``affine_coeffs``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import Application, model_device
from pymgrit_tpu_torch.ops import DISPATCH, Ops
from pymgrit_tpu_torch.ops import dd


class Dahlquist(Application):
    """u' = lambda*u with lambda = -1 (default) and u(0) = 1.

    ``device`` (the CUDA card unless ``"cpu"`` is asked for) places the
    state; ``ops`` selects the kernel set of the solver
    (``pymgrit_tpu_torch.ops.DISPATCH`` by default; ``ops.PLAIN`` runs the
    plain versions on any device)."""

    def __init__(self, constant_lambda: float = -1, method: str = 'BE',
                 precision: str = None, *args, device=None, ops: Ops = DISPATCH, **kwargs):
        super().__init__(*args, **kwargs)
        self.lambda_value = constant_lambda
        if method in ('BE', 'FE', 'TR', 'MR'):
            self.method = method
        else:
            raise Exception(
                'Unknown method. Choose BE (Backward Euler), FE (Forward Euler), TR (Trapezoidal rule) ' +
                'or MR (implicit mid-point rule)')
        self.device = model_device(device)
        self.ops = ops
        if precision == 'dd':
            self.vector_template = dd.from_f64(np.zeros(()), self.device, ops)
            self.vector_t_start = dd.from_f64(np.ones(()), self.device, ops)
            # the step is elementwise: it steps a batch of DD states as it is
            self.step_batched = self.step
            return
        self.vector_template = torch.zeros((), dtype=torch.float64, device=self.device)
        self.vector_t_start = torch.ones((), dtype=torch.float64, device=self.device)
        self.affine_coeffs = self._affine_coeffs

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

    def _affine_coeffs(self, t_start, t_stop):
        """(A, b) with step(u, t0, t1) == A*u + b for every pair of the
        (n,) step times: (n,) tensors on the state's device (b is zero,
        broadcast with stride 0)."""
        dt = np.asarray(t_stop, dtype=np.float64) - np.asarray(t_start, dtype=np.float64)
        z = dt * self.lambda_value
        if self.method == 'BE':
            A = 1 / (1 - z)
        elif self.method == 'FE':
            A = 1 + z
        elif self.method == 'TR':
            A = (1 + z / 2) / (1 - z / 2)
        else:
            # MR keeps the reference's fixed -1 in k1
            A = 1 + dt * (-1 / (1 - z / 2))
        A = torch.as_tensor(A, dtype=torch.float64, device=self.device)
        return A, torch.zeros((), dtype=torch.float64, device=self.device).expand(A.shape)
