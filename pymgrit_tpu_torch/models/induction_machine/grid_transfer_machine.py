"""Mesh-to-mesh spatial transfer for the machine model.

Counterpart of
``pymgrit_tpu/models/induction_machine/grid_transfer_machine.py``
(reference src/pymgrit/induction_machine/grid_transfer_machine.py:21-83):
restriction truncates the middle DOF block to the coarse mesh's unknowns
(injection: the coarse unknowns are a prefix of the fine ones);
interpolation keeps the coarse DOFs and fills the new fine unknowns by
Delaunay barycentric interpolation, split into rotor (inner) and stator
(outer) regions.  The middle leaf changes size between levels.

The transfer is ``batched``: both methods take one state or a (rows, ...)
batch of states (the solver hands it a tube's rows), index the last axis
only, and gather with index and weight tensors made once a device.
"""

from __future__ import annotations

import numpy as np
import torch

from pymgrit_tpu_torch.core.grid_transfer import GridTransfer
from pymgrit_tpu_torch.models.induction_machine.io_getdp import (
    check_version, compute_data, compute_mesh_transfer, interpolation_factors)
from pymgrit_tpu_torch.models.induction_machine.machine_state import MachineState

_INDEX = ("mappingInner", "mappingOuter", "mappingInnerNew", "mappingOuterNew",
          "vtxInner", "vtxOuter")


class GridTransferMachine(GridTransfer):
    """Injection restriction / FE interpolation between two machine meshes."""

    batched = True

    def __init__(self, coarse_grid: str, fine_grid: str, path_meshes: str):
        check_version(msh_file=path_meshes + coarse_grid + '.msh')
        data_coarse = compute_data(path_meshes + coarse_grid + '.pre',
                                   path_meshes + coarse_grid + '.msh', 0)
        check_version(msh_file=path_meshes + fine_grid + '.msh')
        data_fine = compute_data(path_meshes + fine_grid + '.pre',
                                 path_meshes + fine_grid + '.msh',
                                 len(data_coarse['corToUn']))
        self.transfer_data = interpolation_factors(data_coarse=data_coarse,
                                                   data_fine=data_fine)
        self._tables_on = {}

    def _tables(self, device):
        """The transfer's index and weight arrays as tensors on device."""
        if device not in self._tables_on:
            td = self.transfer_data
            tables = {k: torch.as_tensor(np.asarray(td[k], dtype=np.int64), device=device)
                      for k in _INDEX}
            for k in ("wtsInner", "wtsOuter"):
                tables[k] = torch.as_tensor(np.asarray(td[k], dtype=np.float64), device=device)
            self._tables_on[device] = tables
        return self._tables_on[device]

    def restriction(self, u):
        td = self.transfer_data
        return MachineState(u["front"], u["middle"][..., :td['sizeLvlStart']],
                            u["back"], u["scalars"])

    def interpolation(self, u):
        td = self.transfer_data
        middle = u["middle"]
        tb = self._tables(middle.device)
        new_middle = middle.new_zeros(middle.shape[:-1]
                                      + (td['sizeLvlStop'] - td['sizeLvlStart'],))
        new_u_inner = compute_mesh_transfer(middle[..., tb['mappingInner']], tb['vtxInner'],
                                            tb['wtsInner'], td['addBoundInner'], 0)
        new_u_outer = compute_mesh_transfer(middle[..., tb['mappingOuter']], tb['vtxOuter'],
                                            tb['wtsOuter'], td['addBoundOuter'], 0)
        new_middle[..., :middle.shape[-1]] = middle
        new_middle[..., tb['mappingInnerNew']] = new_u_inner
        new_middle[..., tb['mappingOuterNew']] = new_u_outer
        return MachineState(u["front"], torch.cat([middle, new_middle], dim=-1),
                            u["back"], u["scalars"])
