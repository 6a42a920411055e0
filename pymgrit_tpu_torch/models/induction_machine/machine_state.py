"""Machine solution state.

Counterpart of ``pymgrit_tpu/models/induction_machine/machine_state.py``
(reference src/pymgrit/induction_machine/vector_machine.py:16-188): the
front/middle/back DOF blocks plus 8 scalar outputs (joule losses, the
phase currents ia/ib/ic, the phase voltages ua/ub/uc, the torque tr).

The state is a dict of tensors (or numpy arrays, on the host side of a
GetDP round trip); the scalars live in one (8,) leaf ordered
[jl, ia, ib, ic, ua, ub, uc, tr].  The solver stores it as one float64 row
a state, leaves in the JAX package's order: back, front, middle, scalars
(``core/vector.py`` ``Layout``).  The norm is the reference's
(vector_machine.py:101-109): the 2-norm over the DOF blocks only, the
scalar outputs excluded, so the application sets it as ``state_norm``.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.application import model_device
from pymgrit_tpu_torch.ops.ieee_sqrt import sqrt_rn

SCALARS = ("jl", "ia", "ib", "ic", "ua", "ub", "uc", "tr")


def MachineState(front, middle, back, scalars=None):
    """Build a machine state (zero scalars by default, of the kind of
    ``front``: a float64 tensor on its device, or a numpy array)."""
    if scalars is None:
        scalars = (torch.zeros(len(SCALARS), dtype=torch.float64, device=front.device)
                   if isinstance(front, torch.Tensor) else np.zeros(len(SCALARS)))
    return {"front": front, "middle": middle, "back": back, "scalars": scalars}


def zero_state(front_size: int, middle_size: int, back_size: int, device=None):
    """A zero state on ``device`` (the CUDA card unless ``"cpu"`` is asked
    for)."""
    dev = model_device(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float64, device=dev)
    return MachineState(zeros(front_size), zeros(middle_size), zeros(back_size))


def machine_norm(u):
    """2-norm over the DOF blocks, scalars excluded
    (reference vector_machine.py:101-109); correctly rounded root."""
    return sqrt_rn(torch.sum(torch.square(u["front"])) +
                   torch.sum(torch.square(u["middle"])) +
                   torch.sum(torch.square(u["back"])))


def get_values(u):
    """Concatenated DOF vector (reference vector_machine.py:137-143)."""
    return torch.cat([torch.atleast_1d(u["front"]), torch.atleast_1d(u["middle"]),
                      torch.atleast_1d(u["back"])])
