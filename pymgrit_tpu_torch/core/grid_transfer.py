"""Spatial grid transfer between consecutive MGRIT levels.

Counterpart of ``pymgrit_tpu/core/grid_transfer.py``.  The JAX package
vmaps ``restriction`` / ``interpolation`` over the time axis; here they
receive the whole batch of states (a tensor with a leading time axis) and
return a batch.
"""

from __future__ import annotations

import abc


class GridTransfer(abc.ABC):
    """Transfer operators between the spatial grids of two consecutive
    time levels.  Both act on a batch ``(rows, ...)`` of states."""

    @abc.abstractmethod
    def restriction(self, u):
        """Restrict fine states u to the coarse spatial grid."""

    @abc.abstractmethod
    def interpolation(self, u):
        """Interpolate coarse states u to the fine spatial grid."""


class GridTransferCopy(GridTransfer):
    """Identity transfer: returns its argument (the solver copies it into
    the destination tube, so no clone is needed here)."""

    def restriction(self, u):
        return u

    def interpolation(self, u):
        return u
