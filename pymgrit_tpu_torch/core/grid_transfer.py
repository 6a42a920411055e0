"""Spatial grid transfer between consecutive MGRIT levels.

Counterpart of ``pymgrit_tpu/core/grid_transfer.py``, with its contract:
``restriction`` / ``interpolation`` act on a *single* state, and the solver
applies them to every row of a level tube with ``torch.vmap`` (as the JAX
solver does with ``jax.vmap``), so a transfer written per state for the
JAX package or the reference runs unchanged.

A transfer whose methods already take a batch ``(rows, ...)`` of states
says so with the class attribute ``batched = True``; the solver then calls
them on the batch as they are (as it calls an application's
``step_batched`` instead of a vmap of its ``step``), with ``ops=`` (the
solver's kernel set, ``pymgrit_tpu_torch.ops.DISPATCH`` or ``PLAIN``)
where a method declares that keyword.  Such a transfer may also provide
fused hooks:

* ``restrict_combine(out, terms, coeffs, adds, add_coeffs, ops=...)``:
  ``out = R(sum_k coeffs[k] * terms[k]) + sum_j add_coeffs[j] * adds[j]``
  over the rows of (rows, ...) views, in one pass (the FAS right-hand
  side);
* ``interpolate_combine(dst, a, b=None, ops=...)``: ``dst += P(a - b)``
  (the coarse-grid correction), or ``dst = P(a)`` without ``b`` (nested
  iteration).

The solver uses a hook only where the class that defines it also defines
the method it fuses (``restriction`` for ``restrict_combine``,
``interpolation`` for ``interpolate_combine``): a subclass that overrides
``restriction`` alone goes through its own ``restriction`` and K4.
"""

from __future__ import annotations

import abc


class GridTransfer(abc.ABC):
    """Transfer operators between the spatial grids of two consecutive
    time levels.  Both act on one state; set ``batched = True`` on a
    subclass whose methods take a (rows, ...) batch."""

    batched = False

    @abc.abstractmethod
    def restriction(self, u):
        """Restrict fine state u to the coarse spatial grid."""

    @abc.abstractmethod
    def interpolation(self, u):
        """Interpolate coarse state u to the fine spatial grid."""


class GridTransferCopy(GridTransfer):
    """Identity transfer: returns its argument (the solver copies it into
    the destination tube, so no clone is needed here)."""

    batched = True

    def restriction(self, u):
        return u

    def interpolation(self, u):
        return u
