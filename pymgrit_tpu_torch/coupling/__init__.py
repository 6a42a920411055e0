"""Couplings to external (non-torch) steppers and solvers."""

from pymgrit_tpu_torch.coupling.callback import CallbackApplication

__all__ = ["CallbackApplication"]
